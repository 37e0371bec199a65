"""Port parity of the continual-learning slice against the JAX package, in
f32 on the CPU at ``tiny_config()`` sizes, with dither, dropout and
SpecAugment off (JAX keys and torch generators draw different numbers):

  * the pure functions of cl/ewc.py, cl/mas.py and cl/lwf.py and the CL
    metrics against the JAX ones on the same numpy inputs, atol 1e-5;
  * a two-task ``run_sequence`` (hindi, bengali; batch 2, two steps a
    task) for naive, EWC, MAS and LwF: the JAX package's (``rnnt_impl=
    "xla"``) against the port's (``rnnt_impl="pallas"``, the fused joint's
    plain version on the CPU) from the same weights: per-step losses and
    penalty/KD aux rel 1e-5 (atol 1e-4 for values that are 0 in exact
    arithmetic; EWC's ``penalty_gnorm`` rel 1e-4: it is the norm of
    2λF·(θ - θ*), and θ - θ* is one Adam update, whose m̂/√v̂ carries the
    f32 rounding of both packages' gradients at ~1e-5), the EWC Fisher and
    MAS Omega by name within 1e-4 of max|.| (the key-projection and
    depthwise-conv biases, whose gradient is 0 in exact arithmetic, within
    1e-4 of their weights'), identical val/test WER records and BWT curves, and parameters
    after the sequence within atol 2·lr·steps + 1e-6 (Adam's first
    updates are about ±lr·sign(g): a near-zero gradient may round to the
    other sign);
  * BatchNorm statistics untouched by an importance epoch and by the LwF
    teacher's forward; a ``SequenceCheckpointer`` resume.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.audio.features import FrontendConfig as JFrontend
from indic_cl_asr_tpu.cl import ewc as JE
from indic_cl_asr_tpu.cl import lwf as JL
from indic_cl_asr_tpu.cl import mas as JM
from indic_cl_asr_tpu.cl import methods as JCM
from indic_cl_asr_tpu.data.pipeline import BucketSpec as JBuckets
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.train import driver as JD
from indic_cl_asr_tpu.train import metrics as JMetrics
from indic_cl_asr_tpu.train.eval import Transcriber as JTranscriber
from indic_cl_asr_tpu.train.logger import Logger as JLogger
from indic_cl_asr_tpu.train.state import create_train_state
from indic_cl_asr_tpu.train.state import make_optimizer as jax_make_optimizer
from indic_cl_asr_tpu.train.step import StepConfig as JStepConfig
from indic_cl_asr_tpu.train.step import make_train_step as jax_make_train_step
from indic_cl_asr_tpu.utils.checkpoint import load_partial
from indic_cl_asr_tpu.utils.pytree import conformer_freeze_mask
from indic_cl_asr_torch.audio.features import FrontendConfig
from indic_cl_asr_torch.cl import ewc as E
from indic_cl_asr_torch.cl import lwf as L
from indic_cl_asr_torch.cl import mas as M
from indic_cl_asr_torch.cl import methods as CM
from indic_cl_asr_torch.data.pipeline import BucketSpec
from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
from indic_cl_asr_torch.models.conformer import BatchNorm
from indic_cl_asr_torch.models.convert import from_jax_variables, jax_state_dict
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
from indic_cl_asr_torch.train import metrics as PM
from indic_cl_asr_torch.train.driver import DriverConfig, TaskData, run_sequence
from indic_cl_asr_torch.train.eval import Transcriber
from indic_cl_asr_torch.train.logger import Logger
from indic_cl_asr_torch.train.state import make_optimizer
from indic_cl_asr_torch.train.step import StepConfig
from indic_cl_asr_torch.utils.checkpoint import SequenceCheckpointer

from .synth import make_texts, make_wav_dataset

LANGS = ["hindi", "bengali"]
LR = 1e-4
SEED = 3
STEPS = 4  # two tasks x two batches of 2


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


# --- pure functions ---------------------------------------------------------

def _named(rng, shapes):
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


def test_ewc_functions_match_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    fish, grads, params, ckpt, main = (_named(rng, shapes) for _ in range(5))
    cfg, jcfg = E.EWCConfig(e_lambda=7.0, e_gamma=0.5), JE.EWCConfig(e_lambda=7.0, e_gamma=0.5)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    jj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    pg, mon = E.penalty_grads(cfg, tt(main), tt(params), tt(ckpt))
    jpg, jmon = JE.penalty_grads(jcfg, jj(main), jj(params), jj(ckpt))
    acc = E.accumulate_fisher(tt(fish), tt(grads), torch.tensor(2.5))
    jacc = JE.accumulate_fisher(jj(fish), jj(grads), 2.5, 4)
    state = E.end_task(cfg, E.EWCState(main_fish=tt(main)), acc, 6, tt(params))
    jstate = JE.end_task(jcfg, JE.EWCState(main_fish=jj(main)), jacc, 6, jj(params),
                         {k: True for k in shapes})
    first = E.end_task(cfg, E.EWCState(), acc, 6, tt(params))
    jfirst = JE.end_task(jcfg, JE.EWCState(), jacc, 6, jj(params), {k: True for k in shapes})
    for k in shapes:
        for got, want in ((pg[k], jpg[k]), (acc[k], jacc[k]), (state.main_fish[k], jstate.main_fish[k]),
                          (state.checkpoint[k], jstate.checkpoint[k]),
                          (first.main_fish[k], jfirst.main_fish[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(float(mon), float(jmon), rtol=1e-6)
    zero, grads_fn = E.make_penalty_fn(cfg, state)(tt(params))
    assert float(zero) == 0.0 and set(grads_fn) == set(shapes)
    assert E.make_penalty_fn(cfg, E.EWCState()) is None


def _joint_case(seed, B=3, T=11, U1=5, H=16, V1=9, uniform=False):
    rng = np.random.default_rng(seed)
    f = (0.5 * rng.standard_normal((B, T, H))).astype(np.float32)
    g = (0.5 * rng.standard_normal((B, U1, H))).astype(np.float32)
    w = (0.5 * rng.standard_normal((B, H, V1))).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, V1))).astype(np.float32)
    if uniform:
        w, b = np.repeat(w[:1], B, 0), np.repeat(b[:1], B, 0)
    return f, g, w, b


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mas_functions_match_jax(uniform, masked):
    f, g, w, b = _joint_case(1, uniform=uniform)
    ctc = np.random.default_rng(2).standard_normal((3, 11, 7)).astype(np.float32)
    mask = np.array([True, True, False]) if masked else None
    cfg, jcfg = M.MASConfig(mas_ctx=0.4), JM.MASConfig(mas_ctx=0.4)
    kw = dict(chunk_size=4, uniform_head=uniform)  # T 11: chunk padding of 1

    def jfn(*a):
        return JM.mas_surrogate(jcfg, *a, row_mask=None if mask is None else jnp.asarray(mask), **kw)

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in (f, g, w, b, ctc)))
    leaves = [t.requires_grad_(True) for t in _t(f, g, w, b, ctc)]
    v = M.mas_surrogate(cfg, *leaves, row_mask=None if mask is None else torch.from_numpy(mask), **kw)
    grads = torch.autograd.grad(v, leaves)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    energy = M.joint_energy_chunked(*_t(f, g, w, b), chunk_size=3, uniform_head=uniform)
    jenergy = JM.joint_energy_chunked(*(jnp.asarray(x) for x in (f, g, w, b)), chunk_size=3,
                                      uniform_head=uniform)
    np.testing.assert_allclose(float(energy), float(jenergy), rtol=1e-5)
    rng = np.random.default_rng(3)
    omega, params, ckpt = (_named(rng, {"a": (4,), "b": (2, 3)}) for _ in range(3))
    pen = M.penalty(cfg, *(dict(zip(d, _t(*d.values()))) for d in (omega, params, ckpt)))
    jpen = JM.penalty(jcfg, *({k: jnp.asarray(v) for k, v in d.items()} for d in (omega, params, ckpt)))
    np.testing.assert_allclose(float(pen), float(jpen), rtol=1e-6)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    acc = M.accumulate_importance(tt(omega), tt(params))
    jacc = JM.accumulate_importance({k: jnp.asarray(v) for k, v in omega.items()},
                                    {k: jnp.asarray(v) for k, v in params.items()})
    st = M.end_task(M.MASState(), acc, 3, tt(ckpt))
    jst = JM.end_task(JM.MASState(), jacc, 3, {k: jnp.asarray(v) for k, v in ckpt.items()},
                      {"a": True, "b": True})
    for k in omega:
        np.testing.assert_allclose(st.importance[k].numpy(), np.asarray(jst.importance[k]), atol=1e-6)


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
def test_lwf_kd_losses_match_jax(faithful, uniform):
    fs, gs, ws, bs = _joint_case(4, uniform=uniform)
    ft, gt, wt, bt = _joint_case(5, uniform=uniform)
    mask = np.array([True, False, True])
    kw = dict(chunk_size=4, faithful_raw_logits=faithful, uniform_head=uniform)

    def jfn(fs_, gs_, ws_, bs_):
        return JL.joint_kd_chunked(fs_, gs_, *(jnp.asarray(x) for x in (ft, gt)), ws_, bs_,
                                   *(jnp.asarray(x) for x in (wt, bt)),
                                   row_mask=jnp.asarray(mask), **kw)

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (fs, gs, ws, bs)))
    leaves = [t.requires_grad_(True) for t in _t(fs, gs, ws, bs)]
    ft_, gt_, wt_, bt_ = _t(ft, gt, wt, bt)
    v = L.joint_kd_chunked(*leaves[:2], ft_, gt_, *leaves[2:], wt_, bt_,
                           row_mask=torch.from_numpy(mask), **kw)
    grads = torch.autograd.grad(v, leaves)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(6)
    s = np.log(rng.dirichlet(np.ones(7), (3, 5))).astype(np.float32)
    t = np.log(rng.dirichlet(np.ones(7), (3, 5))).astype(np.float32)
    for m in (None, mask):
        got = L.ctc_kd_loss(*_t(s, t), row_mask=None if m is None else torch.from_numpy(m))
        want = JL.ctc_kd_loss(jnp.asarray(s), jnp.asarray(t),
                              row_mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cl_metrics_match_jax():
    rng = np.random.default_rng(7)
    langs = ["hindi", "bengali", "marathi"]
    val = {l: [{"rnnt_wer": float(rng.random()), "ctc_wer": float(rng.random())}
               for _ in range(3 - i)] for i, l in enumerate(langs)}
    for metric in ("rnnt_wer", "ctc_wer"):
        perf, names = PM.compute_perf_matrix(val, metric)
        jperf, jnames = JMetrics.compute_perf_matrix(val, metric)
        assert names == jnames
        np.testing.assert_array_equal(perf, jperf)
        assert PM.compute_bwt_curves(val, metric) == JMetrics.compute_bwt_curves(val, metric)
        np.testing.assert_array_equal(PM.bwt_scores(np.nan_to_num(perf)),
                                      JMetrics.bwt_scores(np.nan_to_num(jperf)))


# --- the sequence -----------------------------------------------------------

_TRANSCRIBE = dict(batch_size=2, max_symbols=3, max_out=48)


def _jax_buckets():
    return JBuckets(boundaries_sec=(2.0,), max_tokens=(32,))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Data, tokenizer and one set of weights for both packages: the JAX
    variables with the joint and CTC heads scaled by 3 so the random tiny
    model emits tokens, and the WER records compare hypotheses with content."""
    root = tmp_path_factory.mktemp("cl")
    data = make_wav_dataset(str(root / "wavs"), LANGS, n_per_lang=8, min_dur=1.0,
                            max_dur=1.9, max_words=2)
    tok = MultilingualTokenizer({l: CharTokenizer.train(make_texts(l, 50)) for l in LANGS})
    per = max(t.vocab_size for t in tok.tokenizers_dict.values())
    overrides = dict(vocab_size_total=per * len(LANGS), n_langs=len(LANGS))
    jcfg = jax_tiny_config(**overrides)
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder, frozen_till=1))
    jmodel, variables = init_model(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda a: np.array(a, dtype=np.float32), variables)
    variables["params"]["joint"]["head_kernel"] *= 3.0
    variables["params"]["ctc_decoder"]["kernel"] *= 3.0
    pcfg = tiny_config(**overrides)
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, frozen_till=1))
    tasks = {l: TaskData(train=e[:4], val_clean=e[4:5], val_noisy=e[5:6], test_clean=e[6:7],
                         test_noisy=e[7:8]) for l, e in data.items()}
    # one JAX transcriber for every run: its jitted decoders take the
    # variables as an argument, so they compile once
    jtr = JTranscriber(model=jmodel, model_cfg=jcfg, tokenizer=tok, languages=LANGS,
                       frontend=JFrontend(n_mels=32), bucket_spec=_jax_buckets(),
                       greedy_impl="framesync", **_TRANSCRIBE)
    return dict(root=root, tok=tok, tasks=tasks, jcfg=jcfg, jmodel=jmodel, variables=variables,
                pcfg=pcfg, jtr=jtr)


def _metrics(path):
    """Per-step train records and the eval records of a metrics.jsonl."""
    steps, evals = [], []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            r.pop("_time")
            if any(k.startswith("train/train_") for k in r):
                steps.append(r)
            elif any(k.startswith(("val/", "test/")) for k in r):
                evals.append(r)
    return steps, evals


def _jax_method(name, w):
    jcfg, model = w["jcfg"], w["jmodel"]
    step_cfg = _jax_step_cfg()
    mask = conformer_freeze_mask(w["variables"]["params"], 1)
    tx = jax_make_optimizer(lr=LR, trainable_mask=mask)
    if name == "naive":
        return JCM.NaiveMethod(), tx, mask
    if name == "ewc":
        return JCM.EWCMethod(JE.EWCConfig(e_lambda=50.0), model, jcfg, step_cfg, mask), tx, mask
    if name == "mas":
        return JCM.MASMethod(JM.MASConfig(mas_lambda=50.0), model, jcfg, step_cfg, mask), tx, mask
    return JCM.LwFMethod(JL.LwFConfig(0.3, 0.5), model, jcfg, step_cfg, tx), tx, mask


def _jax_step_cfg():
    return JStepConfig(frontend=JFrontend(n_mels=32, dither=0.0), use_spec_augment=False,
                       rnnt_chunk_size=8, uniform_lang_head=True)


def _port_method(name, model, step_cfg, opt):
    if name == "naive":
        return CM.NaiveMethod()
    if name == "ewc":
        return CM.EWCMethod(E.EWCConfig(e_lambda=50.0), model, step_cfg, opt)
    if name == "mas":
        return CM.MASMethod(M.MASConfig(mas_lambda=50.0), model, step_cfg, opt)
    return CM.LwFMethod(L.LwFConfig(0.3, 0.5), model, step_cfg, opt)




def _run_jax(name, w):
    method, tx, mask = _jax_method(name, w)
    state = create_train_state(jax.tree.map(jnp.asarray, w["variables"]), tx)
    step_cfg = _jax_step_cfg()
    spec = _jax_buckets()
    logger = JLogger(str(w["root"] / "jax"), run_id=name, use_wandb=False)
    res = JD.run_sequence(
        cfg=JD.DriverConfig(batch_size=2, epochs=1, seed=SEED, n_langs=2, bucket_spec=spec),
        model=w["jmodel"], model_cfg=w["jcfg"], step_cfg=step_cfg, state=state, method=method,
        base_step_builder=lambda pf: jax_make_train_step(w["jmodel"], w["jcfg"], step_cfg, tx, pf),
        task_data={l: JD.TaskData(*(getattr(t, f.name) for f in dataclasses.fields(t)))
                   for l, t in w["tasks"].items()},
        tokenizer=w["tok"], logger=logger, trainable_mask=mask, transcriber=w["jtr"],
        languages=LANGS)
    logger.close()
    params = load_partial(f"{logger.dir}/model_{LANGS[-1]}.npz", w["variables"]["params"])
    final = jax_state_dict({"params": jax.tree.map(np.asarray, params)}, 2)
    importance = None
    if name in ("ewc", "mas"):
        tree = method.state.main_fish if name == "ewc" else method.state.importance
        importance = jax_state_dict({"params": jax.tree.map(np.asarray, tree)}, 2)
    return res, _metrics(f"{logger.dir}/metrics.jsonl"), final, importance, logger.dir


def _port_setup(w, rnnt_impl="pallas"):
    model = from_jax_variables(HybridRNNTCTC(w["pcfg"], device="cpu"), w["variables"])
    opt = make_optimizer(model, lr=LR, freeze_encoder_till=1, device="cpu")
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0), use_spec_augment=False,
                          rnnt_chunk_size=8, uniform_lang_head=True, rnnt_impl=rnnt_impl)
    spec = BucketSpec(boundaries_sec=(2.0,), max_tokens=(32,))
    tr = Transcriber(model=model, tokenizer=w["tok"], languages=LANGS,
                     frontend=FrontendConfig(n_mels=32), bucket_spec=spec, **_TRANSCRIBE)
    return model, opt, step_cfg, spec, tr


def _run_port(w, name, out, checkpointer=None, method=None, setup=None):
    model, opt, step_cfg, spec, tr = setup or _port_setup(w)
    method = method or _port_method(name, model, step_cfg, opt)
    logger = Logger(str(out), run_id=name, use_wandb=False)
    res = run_sequence(
        cfg=DriverConfig(batch_size=2, epochs=1, seed=SEED, n_langs=2, bucket_spec=spec),
        model=model, step_cfg=step_cfg, optimizer=opt, method=method, task_data=w["tasks"],
        tokenizer=w["tok"], logger=logger, transcriber=tr, checkpointer=checkpointer,
        languages=LANGS, device="cpu")
    logger.close()
    return res, model, opt, method, logger.dir


@pytest.mark.parametrize("name", ["naive", "ewc", "mas", "lwf"])
def test_run_sequence_matches_jax(world, name):
    jres, (jsteps, jevals), jfinal, jimp, jdir = _run_jax(name, world)
    res, model, opt, method, pdir = _run_port(world, name, world["root"] / "port")
    steps, evals = _metrics(f"{pdir}/metrics.jsonl")

    assert len(steps) == len(jsteps) == STEPS
    for got, want in zip(steps, jsteps):
        assert got.keys() == want.keys()
        for k, v in want.items():
            scale = max(abs(v), 10.0) if k.startswith(("train/rnnt_kd", "train/ctc_kd")) else abs(v)
            rel = 1e-4 if k.startswith("train/penalty_gnorm") else 1e-5
            assert abs(got[k] - v) <= rel * scale + (1e-4 if v == 0 else 0), (k, got[k], v)
    if name == "ewc":
        assert steps[-1]["train/penalty_gnorm_bengali"] > 0
    if name == "mas":
        assert steps[-1]["train/penalty_bengali"] > 0
    if name == "lwf":
        assert steps[-1]["train/rnnt_kd_bengali"] > 0 and steps[-1]["train/ctc_kd_bengali"] > 0

    trainable = set(opt.names)
    for n, p in model.named_parameters():
        want = jfinal[n]
        tol = 2 * LR * STEPS + 1e-6 if n in trainable else 0.0
        np.testing.assert_allclose(p.detach().numpy(), want, atol=tol, rtol=0, err_msg=n)
    saved = np.load(f"{pdir}/model_bengali.npz")
    assert set(saved.files) == trainable
    if jimp is not None:
        got = method.state.main_fish if name == "ewc" else method.state.importance
        assert set(got) == trainable
        for n, want in jimp.items():
            if n not in trainable:
                assert np.abs(want).max() == 0.0, n
                continue
            ref = jimp[n.replace("linear_k.bias", "linear_k.weight")
                       .replace("depthwise_conv.bias", "depthwise_conv.weight")]
            scale = max(np.abs(ref).max(), 1e-30)
            assert np.abs(got[n].numpy() - want).max() <= 1e-4 * scale, n
    assert res == jres  # val and test WER records, identical
    assert evals == jevals
    # the hypotheses have content: some WER is not that of an empty output
    assert any(r[k] != 1.0 for recs in res["val"].values() for r in recs
               for k in ("rnnt_wer", "ctc_wer"))
    with open(f"{pdir}/bwt_curves.json") as f, open(f"{jdir}/bwt_curves.json") as g:
        assert json.load(f) == json.load(g)


def _bn_stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if "batch_norm" in n}


@pytest.mark.parametrize("name", ["ewc", "mas"])
def test_importance_epoch_keeps_batchnorm_statistics(world, name):
    model, opt, step_cfg, spec, tr = _port_setup(world)
    method = _port_method(name, model, step_cfg, opt)
    from indic_cl_asr_torch.data.pipeline import BatchPipeline
    from indic_cl_asr_torch.train.step import batch_to_device_dict

    before = _bn_stats(model)
    acc = method.begin_importance()
    pipe = BatchPipeline(world["tasks"]["hindi"].train, world["tok"], LANGS, 2, spec=spec)
    for i, b in enumerate(pipe):
        acc = method.importance_batch(acc, batch_to_device_dict(b, "cpu"),
                                      torch.Generator().manual_seed(i))
    after = _bn_stats(model)
    assert all(torch.equal(before[n], after[n]) for n in before)
    assert any(v.abs().max() > 0 for v in acc.values())
    assert not any(isinstance(m, BatchNorm) and not m.update_stats for m in model.modules())


def test_lwf_teacher_forward_keeps_its_statistics(world):
    model, opt, step_cfg, spec, tr = _port_setup(world)
    method = _port_method("lwf", model, step_cfg, opt)
    method.end_task(None, 0, 0)
    teacher = method.teacher
    assert all(not p.requires_grad for p in teacher.parameters())
    step = method.make_train_step(None, 1)
    from indic_cl_asr_torch.data.pipeline import BatchPipeline
    from indic_cl_asr_torch.train.step import batch_to_device_dict

    t_before, s_before = _bn_stats(teacher), _bn_stats(model)
    batch = next(iter(BatchPipeline(world["tasks"]["bengali"].train, world["tok"], LANGS, 2,
                                    spec=spec)))
    aux = step(batch_to_device_dict(batch, "cpu"), torch.Generator().manual_seed(0))
    assert float(aux["rnnt_kd"]) >= -1e-4 and np.isfinite(float(aux["ctc_kd"]))
    t_after, s_after = _bn_stats(teacher), _bn_stats(model)
    assert all(torch.equal(t_before[n], t_after[n]) for n in t_before)
    # the student's train-mode forward does update its own statistics
    assert any(not torch.equal(s_before[n], s_after[n]) for n in s_before)
    bf16 = L.end_task(model, "bfloat16")
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}


def test_sequence_checkpointer_resumes_after_the_completed_task(world, tmp_path):
    """A run stopped after task 1 resumes at task 2 with the model, the
    optimizer, the WER matrix and the EWC state of the full run."""
    ck = SequenceCheckpointer(str(tmp_path / "seq"))
    model, opt, step_cfg, spec, tr = _port_setup(world)
    one = {"hindi": world["tasks"]["hindi"]}
    full_res, full_model, full_opt, full_method, _ = _run_port(world, "ewc", tmp_path / "full")

    method = _port_method("ewc", model, step_cfg, opt)
    logger = Logger(str(tmp_path / "first"), run_id="r", use_wandb=False)
    run_sequence(cfg=DriverConfig(batch_size=2, seed=SEED, n_langs=1, bucket_spec=spec),
                 model=model, step_cfg=step_cfg, optimizer=opt, method=method, task_data=one,
                 tokenizer=world["tok"], logger=logger, transcriber=tr, checkpointer=ck,
                 languages=["hindi"], device="cpu")
    logger.close()
    assert ck.latest_task() == (0, "hindi")
    assert ck.manifest()["completed_tasks"] == ["hindi"]

    fresh = _port_setup(world)
    fresh_method = _port_method("ewc", fresh[0], fresh[2], fresh[1])
    res, model2, opt2, method2, pdir = _run_port(world, "ewc", tmp_path / "resumed",
                                                 checkpointer=ck, method=fresh_method,
                                                 setup=fresh)
    assert res["val"] == full_res["val"]
    # test records of completed tasks are not restored, as in the JAX package
    assert len(res["test"]["hindi"]) == 1
    assert opt2.count == full_opt.count == STEPS
    for n, p in model2.state_dict().items():
        torch.testing.assert_close(p, full_model.state_dict()[n], rtol=0, atol=1e-6)
    for n, f in method2.state.main_fish.items():
        torch.testing.assert_close(f, full_method.state.main_fish[n], rtol=0, atol=1e-6)
    with open(f"{pdir}/metrics.jsonl") as f:
        assert json.loads(f.readline())["resumed_from_task"] == 0
