"""Port parity of the training slice against the JAX package, in f32 on the
CPU at ``tiny_config()`` sizes:

  * ``apply_bands`` against ``spec_augment`` for the same bands, and the
    inclusive bounds of ``draw_bands``;
  * ``BatchPipeline`` plans and batches equal to the JAX package's for the
    same seed;
  * train-mode BatchNorm output and updated statistics against Flax's,
    atol 1e-5;
  * one training step (scanned layout, ``frozen_till=1``, a repeat row
    masked out) against ``make_train_step``: aux losses atol 1e-5, every
    gradient atol 1e-5 by name through models/convert.py, updated
    BatchNorm statistics atol 1e-5, updated parameters atol 2·lr + 1e-6
    (Adam's first step is about ±lr·sign(g): a gradient that is nearly
    zero may round to the other sign);
  * the optimizer alone, fed the same gradients as
    ``make_optimizer(..., stacked_freeze_till=1)``: updated parameters
    atol 1e-7 plus one f32 rounding step (rtol 2^-23) over two steps, with
    and without the global-norm clip, frozen rows and pre_encode unchanged.

JAX keys and torch generators draw different numbers, so the step runs
with dither, dropout and SpecAugment off; the port's own train-mode step
with all of them on is checked for a falling loss and frozen parameters
that stay bit-unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.audio.features import FrontendConfig as JFrontendConfig
from indic_cl_asr_tpu.audio.spec_augment import SpecAugmentConfig as JSpecAugmentConfig
from indic_cl_asr_tpu.audio.spec_augment import spec_augment as jax_spec_augment
from indic_cl_asr_tpu.data.manifest import ManifestEntry as JEntry
from indic_cl_asr_tpu.data.pipeline import BatchPipeline as JBatchPipeline
from indic_cl_asr_tpu.data.pipeline import BucketSpec as JBucketSpec
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.train.state import create_train_state
from indic_cl_asr_tpu.train.state import make_optimizer as jax_make_optimizer
from indic_cl_asr_tpu.train.step import StepConfig as JStepConfig
from indic_cl_asr_tpu.train.step import hybrid_forward_loss as jax_forward_loss
from indic_cl_asr_tpu.train.step import make_train_step as jax_make_train_step
from indic_cl_asr_tpu.utils.pytree import conformer_freeze_mask
from indic_cl_asr_torch.audio.features import FrontendConfig
from indic_cl_asr_torch.audio.spec_augment import SpecAugmentConfig, apply_bands, draw_bands
from indic_cl_asr_torch.data.manifest import ManifestEntry
from indic_cl_asr_torch.data.pipeline import BatchPipeline, BucketSpec
from indic_cl_asr_torch.models.conformer import BatchNorm
from indic_cl_asr_torch.models.convert import from_jax_variables, jax_state_dict
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, init_weights_, tiny_config
from indic_cl_asr_torch.train.state import make_optimizer
from indic_cl_asr_torch.train.step import StepConfig, make_train_step

LR = 1e-3


def test_apply_bands_matches_jax_spec_augment():
    rng = np.random.default_rng(0)
    B, F, T = 3, 32, 60
    spec = rng.standard_normal((B, F, T)).astype(np.float32)
    lens = np.array([60, 31, 7], np.int32)
    cfg = JSpecAugmentConfig(freq_masks=2, time_masks=4, freq_width=9, time_width=0.1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_spec_augment(jnp.asarray(spec), jnp.asarray(lens), key, cfg))
    # the JAX package's own draws (audio/spec_augment.py), fed to the port
    kfs, kfw, kts, ktw = jax.random.split(key, 4)
    w_max = np.maximum(1, (lens.astype(np.float32) * 0.1).astype(np.int32))
    start_ub = np.maximum(1, lens - w_max)
    bands = [
        jax.random.randint(kfs, (B, 2), 0, F - 9 + 1),
        jax.random.randint(kfw, (B, 2), 0, 9 + 1),
        jax.random.randint(kts, (B, 4), 0, jnp.asarray(start_ub + 1)[:, None]),
        jax.random.randint(ktw, (B, 4), 0, jnp.asarray(w_max + 1)[:, None]),
    ]
    got = apply_bands(torch.from_numpy(spec), *(torch.from_numpy(np.array(b)) for b in bands))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_draw_bands_bounds_are_inclusive():
    lens = torch.tensor([100, 25, 1])
    cfg = SpecAugmentConfig(freq_masks=500, time_masks=2000, freq_width=27, time_width=0.05)
    fs, fw, ts, tw = draw_bands(lens, 80, cfg, torch.Generator().manual_seed(0))
    assert (fs.min(), fs.max()) == (0, 80 - 27) and (fw.min(), fw.max()) == (0, 27)
    w_max = [5, 1, 1]  # max(1, int(len * 0.05))
    for b, n in enumerate(lens.tolist()):
        assert (tw[b].min(), tw[b].max()) == (0, w_max[b])
        assert (ts[b].min(), ts[b].max()) == (0, max(1, n - w_max[b]))


class _Tok:
    def text_to_ids(self, text, lang):
        return [(ord(c) + len(lang)) % 50 + 1 for c in text]


def _loader(path):
    n = 3000 + 997 * int(path.split("_")[1])
    return np.sin(np.arange(n, dtype=np.float32) * (1 + n % 7) * 1e-3)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_batch_pipeline_equals_jax(shuffle, drop_last):
    rng = np.random.default_rng(1)
    rows = [(f"utt_{i}_x.wav", float(rng.uniform(0.5, 1.9)), "ab" * (i % 7), ["hi", "ta"][i % 2])
            for i in range(23)]
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last, loader=_loader,
              num_io_threads=2)
    port = BatchPipeline([ManifestEntry(*r) for r in rows], _Tok(), ["hi", "ta"],
                         spec=BucketSpec((0.8, 1.4, 2.0), (8, 12, 16), 4000), **kw)
    ref = JBatchPipeline([JEntry(*r) for r in rows], _Tok(), ["hi", "ta"],
                         spec=JBucketSpec((0.8, 1.4, 2.0), (8, 12, 16), 4000), **kw)
    assert len(port) == len(ref)
    for _ in range(2):  # two epochs: the shuffles depend on the epoch
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.n_real == b.n_real and a.texts == b.texts and a.langs == b.langs
            for f in ("audio", "audio_len", "tokens", "token_len", "lang_ids"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_batchnorm_train_mode_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    B, T, C = 3, 11, 8
    x = (2.0 + 1.5 * rng.standard_normal((B, T, C))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mean0 = (0.3 * rng.standard_normal(C)).astype(np.float32)
    var0 = (0.5 + rng.random(C)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(C)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias), (port.running_mean, mean0),
                     (port.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    port.train()
    got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-5)
    port.eval()  # eval mode normalises with the stored statistics
    ev = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    want_ev = bn.copy(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(want_ev), atol=1e-5)


def test_lstm_sequence_op_matches_the_step_loop():
    """The prediction net's two LSTM paths in f32: one torch.lstm call over
    the sequence (training) and the Python steps (decoding), atol 1e-5 on
    outputs, final state and gradients."""
    from indic_cl_asr_torch.models.rnnt import LSTM

    torch.manual_seed(0)
    lstm = LSTM(24, 16)
    with torch.no_grad():
        for w in (lstm.w_ih, lstm.w_hh):
            w.normal_(0.0, 0.3)
        lstm.bias.normal_(0.0, 0.1)
    x = torch.randn(3, 9, 24, requires_grad=True)
    leaves = [x, lstm.w_ih, lstm.w_hh, lstm.bias]
    results = []
    for fn in (lstm.sequence, lstm.steps):
        out, (h, c) = fn(x)
        grads = torch.autograd.grad((out * out).sum() + c.sum(), leaves)
        results.append((out, h, c, *grads))
    assert results[1][2].dtype == results[0][2].dtype == torch.float32
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    # forward() takes the sequence op only for a whole sequence from zero
    out, _ = lstm(x)
    assert torch.equal(out, results[0][0])
    out1, _ = lstm(x[:, :1])
    torch.testing.assert_close(out1, results[1][0][:, :1], rtol=0, atol=0)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _setup(frozen_till=1, attn_impl="xla"):
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, scan_layers=True, frozen_till=frozen_till))
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    pcfg = tiny_config()
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(
        pcfg.encoder, frozen_till=frozen_till, attn_impl=attn_impl))
    port = from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), _np_tree(variables))
    return jcfg, model, variables, port


def _batch(cfg, B=4, S=8000, U=6):
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_per_lang, (B, U)).astype(np.int32)
    tokens[3] = tokens[2]
    return {
        "audio": (0.1 * rng.standard_normal((B, S))).astype(np.float32),
        "audio_len": np.array([S, S - 1500, S // 2, S // 2], np.int32),
        "tokens": tokens,
        "token_len": np.array([U, U - 2, U - 1, U - 1], np.int32),
        "lang_ids": np.array([0, 1, 2, 2], np.int32),
        "n_valid": 3,
    }


@functools.lru_cache(maxsize=1)
def _jax_step_reference():
    """The JAX package's gradients, one make_train_step and its results
    (computed once for both attention paths of the port)."""
    jcfg, model, variables, _ = _setup()
    jstep_cfg = JStepConfig(frontend=JFrontendConfig(n_mels=32, dither=0.0),
                            use_spec_augment=False, rnnt_chunk_size=8)
    mask = conformer_freeze_mask(variables["params"], 1)
    tx = jax_make_optimizer(lr=LR, trainable_mask=mask, stacked_freeze_till=1)
    state = create_train_state(variables, tx)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        loss, _ = jax_forward_loss(
            model, jcfg, jstep_cfg, params, state.batch_stats, jbatch["audio"],
            jbatch["audio_len"], jbatch["tokens"], jbatch["token_len"],
            jbatch["lang_ids"], key, train=True, n_valid=jbatch["n_valid"])
        return loss

    n_layers = jcfg.encoder.n_layers
    jgrads = jax_state_dict({"params": _np_tree(jax.jit(jax.grad(loss_fn))(state.params))},
                            n_layers)
    state2, jaux = jax.jit(jax_make_train_step(model, jcfg, jstep_cfg, tx))(state, jbatch, key)
    jnew = jax_state_dict({"params": _np_tree(state2.params),
                           "batch_stats": _np_tree(state2.batch_stats)}, n_layers)
    return {k: float(v) for k, v in jaux.items()}, jgrads, jnew


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_one_step_matches_jax_make_train_step(attn_impl):
    jaux, jgrads, jnew = _jax_step_reference()
    jcfg, _, _, port = _setup(attn_impl=attn_impl)
    np_batch = _batch(jcfg)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}

    opt = make_optimizer(port, lr=LR, freeze_encoder_till=1, device="cpu")
    seen = {}
    apply = opt.step

    def record(grads):
        seen["grads"] = [g.clone() for g in grads]
        apply(grads)

    opt.step = record
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0),
                          use_spec_augment=False, rnnt_chunk_size=8)
    step = make_train_step(port, step_cfg, opt, device="cpu")
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in np_batch.items()}
    aux = step(batch, torch.Generator().manual_seed(0))
    for k in ("train_rnnt_loss", "train_ctc_loss", "train_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=1e-5, err_msg=k)

    trainable = set(opt.names)
    assert "encoder.layers.0.self_attn.linear_q.weight" not in trainable
    assert "encoder.pre_encode.out.weight" not in trainable
    for name, g in zip(opt.names, seen["grads"]):
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=1e-5, err_msg=name)
    for name, g in jgrads.items():
        if name not in trainable:
            assert np.abs(g).max() == 0.0, name

    for name, t in port.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=1e-5, err_msg=name)
        elif name in trainable:
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=2 * LR + 1e-6, err_msg=name)
        else:
            assert torch.equal(t, before[name]), name
            np.testing.assert_array_equal(t.numpy(), jnew[name], err_msg=name)


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_optimizer_matches_optax_on_the_same_gradients(grad_clip):
    jcfg, _, variables, port = _setup(frozen_till=0)
    n_layers = jcfg.encoder.n_layers
    params = variables["params"]
    tx = jax_make_optimizer(lr=LR, weight_decay=0.01, grad_clip=grad_clip,
                            trainable_mask=conformer_freeze_mask(params, 1),
                            stacked_freeze_till=1)
    from indic_cl_asr_tpu.train.state import apply_updates

    opt_state = tx.init(params)
    opt = make_optimizer(port, lr=LR, weight_decay=0.01, freeze_encoder_till=1,
                         grad_clip=grad_clip, device="cpu")
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    rng = np.random.default_rng(9)
    for _ in range(2):
        grads = jax.tree.map(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), params)
        updates, opt_state = jax.jit(tx.update)(grads, opt_state, params)
        params = apply_updates(params, updates)
        named = jax_state_dict({"params": grads}, n_layers)
        opt.step([torch.from_numpy(named[n]) for n in opt.names])
    want = jax_state_dict({"params": _np_tree(params)}, n_layers)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=2**-23, atol=1e-7,
                                   err_msg=name)
        frozen = name.startswith(("encoder.pre_encode.", "encoder.layers.0."))
        assert (name in opt.names) != frozen
        if frozen:
            assert torch.equal(p, before[name]), name
        else:
            assert not torch.equal(p, before[name]), name


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    model = HybridRNNTCTC(tiny_config(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_optimizer(model)
    opt = make_optimizer(model, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_train_step(model, StepConfig(), opt)


def test_port_step_trains_with_dropout_dither_and_spec_augment():
    cfg = tiny_config(pred_dropout=0.2, joint_dropout=0.2)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, frozen_till=1, dropout=0.1, dropout_att=0.1, dropout_pre_encoder=0.1,
        attn_impl="flash"))
    model = init_weights_(HybridRNNTCTC(cfg, device="cpu"), torch.Generator().manual_seed(0))
    opt = make_optimizer(model, lr=3e-3, freeze_encoder_till=1, device="cpu")
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32),
                          spec_augment=SpecAugmentConfig(freq_masks=1, time_masks=2),
                          rnnt_chunk_size=8, uniform_lang_head=True, rnnt_remat="full")
    step = make_train_step(model, step_cfg, opt, device="cpu")
    np_batch = _batch(cfg)
    np_batch["lang_ids"][:] = 1
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in np_batch.items()}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in opt.names}
    stats0 = model.encoder.layers[0].conv.batch_norm.running_var.clone()
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(batch, gen)["train_loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    # the frozen layer runs in train mode: its BatchNorm statistics move
    assert not torch.equal(stats0, model.encoder.layers[0].conv.batch_norm.running_var)


def _capturing_step(model, penalty_fn=None):
    opt = make_optimizer(model, lr=LR, freeze_encoder_till=1, device="cpu")
    seen = {}
    apply = opt.step

    def record(grads):
        seen.update(zip(opt.names, (g.clone() for g in grads)))
        apply(grads)

    opt.step = record
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0),
                          use_spec_augment=False, rnnt_chunk_size=8)
    return make_train_step(model, step_cfg, opt, penalty_fn=penalty_fn, device="cpu"), seen


@pytest.mark.parametrize("kind", ["scalar", "grads"])
def test_penalty_hook_adds_to_the_loss_or_the_gradients(kind):
    """The CL hook: a scalar penalty is differentiated with the loss; EWC-
    style explicit gradients are added after the backward and their global
    norm is reported (the JAX package's make_train_step contract)."""
    name = "joint.enc.weight"
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in _batch(tiny_config()).items()}
    runs = {}
    for with_penalty in (False, True):
        model = init_weights_(HybridRNNTCTC(tiny_config(), device="cpu"),
                              torch.Generator().manual_seed(0))
        extra = torch.full_like(model.joint.enc.weight, 0.25)

        def penalty_fn(params):
            if kind == "scalar":
                return 0.5 * (params[name] ** 2).sum(), None
            return torch.zeros(()), {name: extra}

        step, seen = _capturing_step(model, penalty_fn if with_penalty else None)
        w0 = model.joint.enc.weight.detach().clone()
        aux = step(batch, torch.Generator().manual_seed(0))
        runs[with_penalty] = (aux, seen, w0)
    (aux0, g0, w0), (aux1, g1, _) = runs[False], runs[True]
    if kind == "scalar":
        pen = 0.5 * float((w0 ** 2).sum())
        assert float(aux1["penalty"]) == pytest.approx(pen, rel=1e-6)
        assert float(aux1["train_loss"]) == pytest.approx(float(aux0["train_loss"]) + pen,
                                                          rel=1e-6)
        want = g0[name] + w0
    else:
        assert float(aux1["penalty_gnorm"]) == pytest.approx(0.25 * w0.numel() ** 0.5, rel=1e-6)
        want = g0[name] + 0.25
    torch.testing.assert_close(g1[name], want, rtol=0, atol=1e-6)
    other = "joint.pred.weight"
    torch.testing.assert_close(g1[other], g0[other], rtol=0, atol=1e-6)


def test_bf16_model_keeps_f32_master_parameters():
    model = init_weights_(HybridRNNTCTC(tiny_config(dtype=torch.bfloat16), device="cpu"),
                          torch.Generator().manual_seed(0))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    step, seen = _capturing_step(model)
    before = model.joint.enc.weight.detach().clone()
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in _batch(tiny_config()).items()}
    aux = step(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(aux["train_loss"]))
    assert {g.dtype for g in seen.values()} == {torch.float32}
    # an lr-1e-3 AdamW step moves f32 weights by ~1e-3, below one bf16 step
    # of most of them: stored in bf16 the update would be lost
    moved = (model.joint.enc.weight - before).abs()
    assert 0 < moved.max() <= 2 * LR
    assert model.joint.enc.weight.dtype == torch.float32


def test_cast_reuses_the_copy_until_the_parameter_changes():
    from indic_cl_asr_torch.models.common import cast

    p = torch.nn.Parameter(torch.randn(4, 3), requires_grad=False)
    a = cast(p, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and cast(p, torch.bfloat16) is a
    assert cast(p, torch.float32) is p
    with torch.no_grad():
        p.add_(1.0)
    b = cast(p, torch.bfloat16)
    assert b is not a and torch.equal(b, p.detach().to(torch.bfloat16))
    with torch.inference_mode():
        c = cast(p, torch.float16)
    assert not c.is_inference()
    p.requires_grad_(True)
    d = cast(p, torch.bfloat16)  # a gradient flows: the cast is in the graph
    assert d.grad_fn is not None
    (g,) = torch.autograd.grad(d.float().sum(), p)
    assert torch.equal(g, torch.ones_like(p))
