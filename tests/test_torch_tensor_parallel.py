"""The port's model axis (indic_cl_asr_torch/parallel/sharding.py) on the
CPU: ranks are processes of this file's ``__main__`` worker, joined over
gloo (a free localhost port, one intra-op thread each), at
``tiny_config()`` sizes in f32.

  * the split rules without ranks: the port's split of every parameter,
    its shard's shape and its AdamW moments' shapes equal the JAX
    package's ``tree_shardings(state, make_mesh(n_data=1, n_model=2))``,
    at ``tiny_config()`` and at the flagship's widths with two layers
    (heads, CTC head and embedding whole at V+1 257 and 3073,
    ``joint/enc`` split); a head count that does not divide raises;
  * one 1 x 2 launch (two ranks):
      - one step against the JAX package's step on ``make_mesh(n_data=1,
        n_model=2)`` over two virtual CPU devices, from the same weights
        and batch (a repeat row masked out), dither, dropout and
        SpecAugment off: aux losses rtol 2e-4, every gradient atol 1e-5,
        every parameter atol 2e-5 at lr 1e-5, BatchNorm statistics atol
        1e-5 (tests/test_torch_distributed.py's bars), at
        ``tiny_config()`` (eager attention, chunked joint) and at
        ``tiny_config(vocab_size_total=63, n_langs=3)`` (the flash and
        fused-joint routes' plain versions), where every vocabulary rule
        splits (V+1 22, CTC head and embedding 64 rows); the same steps
        against the port's one-process step; the ranks' whole tensors
        equal;
      - dropout on: the whole parameters and statistics bit-identical
        across the two model ranks after a step, the whole model's masks
        equal and the split regions' (attention kernel seeds, FFN masks)
        different;
      - EWC's Fisher, MAS's Ω and an LwF step against one process;
      - a layer-norm conv module with separate global-token projections
        (eager attention) and a two-group group norm with a causal conv,
        each one step against one process;
      - a task checkpoint written by one process loaded into the split
        model and optimizer, gathered back equal;
  * one 2 x 2 launch (four ranks): a step against one process;
  * ``cl_baseline.main`` with ``--mesh.model 2`` on two ranks against one
    process within the step tolerance; its task checkpoint loads into a
    one-process model equal to the gathered state, and its partial saves
    are whole.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from indic_cl_asr_torch.models.hybrid import (HybridRNNTCTC, flagship_config,  # noqa: E402
                                              init_weights_, tiny_config)
from indic_cl_asr_torch.parallel import distributed as D  # noqa: E402
from indic_cl_asr_torch.parallel import sharding as S  # noqa: E402
from indic_cl_asr_torch.train.state import make_optimizer  # noqa: E402
from indic_cl_asr_torch.train.step import make_train_step  # noqa: E402
from tests.test_torch_distributed import (LR, TINY, _captured, _free_port,  # noqa: E402
                                          _jax_step_cfg, _metrics, _no_draws, _numbers,
                                          _own_batch, _own_step_cfg, _run_dirs)

TIMEOUT = 240
# the command line's runs at the steps' lr: Adam's first update is about
# ±lr·sign(g) whatever g's size, and the gradients that are zero but for
# rounding (the key biases', the depthwise bias before its BatchNorm) take
# either sign in another order of sums; at config.yaml's 1e-4 the 2·lr
# that moves a random model's weights flips greedy decodes of the val set
DRIVER = TINY + ["--lr", str(LR)]
# the two vocabularies of the JAX comparison: the tiny one (V+1 17 and 65:
# the heads, CTC head and embedding whole) and one where every rule splits
CASES = {"tiny": ({}, "xla"), "vocab63": ({"vocab_size_total": 63, "n_langs": 3}, "flash")}
VARIANTS = {"layer_norm_global": dict(conv_norm_type="layer_norm", global_tokens=2,
                                      global_tokens_spacing=4, global_attn_separate=True),
            "group_norm_causal": dict(conv_norm_type="group_norm2", causal_conv=True)}


def _cfg(dropout=False, attn_impl="xla", vocab=None, **enc):
    cfg = tiny_config(**(vocab or {}))
    e = dataclasses.replace(cfg.encoder, frozen_till=1, attn_impl=attn_impl, **enc)
    if dropout:
        e = dataclasses.replace(e, dropout=0.1, dropout_att=0.1, dropout_pre_encoder=0.1)
        return dataclasses.replace(cfg, encoder=e, pred_dropout=0.2, joint_dropout=0.2)
    return dataclasses.replace(cfg, encoder=e)


def _model(init_path, cfg, mesh):
    model = HybridRNNTCTC(cfg, device="cpu")
    model.load_state_dict(torch.load(init_path, weights_only=True))
    if mesh is not None:
        S.shard_model(model, mesh)
    return model, make_optimizer(model, lr=LR, freeze_encoder_till=1, device="cpu")


def _whole_of(model, opt, seen):
    """Gradients, state and moments, whole (gathered over a model axis)."""
    state = S.gather_state(model, opt)
    grads = S.gather_named(model, {n: g for n, g in seen.items() if g is not None})
    return {"grads": grads, "state": state["model"], "mu": state["mu"], "nu": state["nu"]}


def _step_run(init_path, batch, cfg, step_cfg, mesh, seed=0):
    """One step; aux, the summed gradients, the state and moments (whole),
    and this rank's whole tensors (parameters not split, statistics)."""
    model, opt = _model(init_path, cfg, mesh)
    seen = _captured(opt)
    if mesh is not None:
        batch = S.place_batch(batch, mesh, "cpu")
    aux = make_train_step(model, step_cfg, opt, device="cpu", mesh=mesh)(
        batch, torch.Generator().manual_seed(seed))
    split = {n for n, p in model.named_parameters() if S.split_of(p) is not None}
    return dict(_whole_of(model, opt, seen), aux={k: v.clone() for k, v in aux.items()},
                local={k: v.clone() for k, v in model.state_dict().items() if k not in split},
                split=sorted(split),
                shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def _cl_run(init_path, batch, cfg, step_cfg, mesh):
    """EWC's Fisher and MAS's Ω of one importance batch (whole), one LwF
    step's aux."""
    from indic_cl_asr_torch.cl import ewc as E
    from indic_cl_asr_torch.cl import lwf as L
    from indic_cl_asr_torch.cl import mas as M
    from indic_cl_asr_torch.cl.methods import EWCMethod, LwFMethod, MASMethod

    if mesh is not None:
        batch = S.place_batch(batch, mesh, "cpu")
    out = {}
    for name, cls, mcfg, seed in (("ewc", EWCMethod, E.EWCConfig(), 1),
                                  ("mas", MASMethod, M.MASConfig(), 2)):
        model, opt = _model(init_path, cfg, mesh)
        method = cls(mcfg, model, step_cfg, opt)
        method.mesh = mesh
        acc = method.importance_batch(method.begin_importance(), batch,
                                      torch.Generator().manual_seed(seed))
        out[name] = S.gather_named(model, acc)
    model, opt = _model(init_path, cfg, mesh)
    lwf = LwFMethod(L.LwFConfig(knowledge_distillation=0.5), model, step_cfg, opt)
    lwf.end_task(None, 0, 0)
    lwf.mesh = mesh
    aux = lwf.make_train_step(None, 1)(batch, torch.Generator().manual_seed(3))
    out["lwf"] = {k: v.clone() for k, v in aux.items()}
    return out


def _recorded_draws():
    """Record every dropout mask of the encoder (by its generator's seed)
    and every attention kernel seed."""
    from indic_cl_asr_torch.models import conformer as C

    masks, seeds = [], []
    drop, flash = C.dropout, C.flash_relpos_mhsa

    def dropout(x, rate, gen, training):
        y = drop(x, rate, gen, training)
        if training and rate > 0:
            masks.append((gen.initial_seed(), y == 0))
        return y

    def flash_relpos_mhsa(*a, **k):
        seeds.append(k["seed"])
        return flash(*a, **k)

    C.dropout, C.flash_relpos_mhsa = dropout, flash_relpos_mhsa
    return masks, seeds


def _load_run(out, mesh):
    """A one-process task checkpoint loaded into the split model and
    optimizer, gathered back."""
    from indic_cl_asr_torch.utils.checkpoint import SequenceCheckpointer

    model, opt = _model(os.path.join(out, "init_own.pt"), _cfg(), mesh)
    SequenceCheckpointer(os.path.join(out, "ckpt")).load_task(0, "hindi", model, opt)
    state = S.gather_state(model, opt)
    return {"state": state["model"], "mu": state["mu"], "nu": state["nu"]}


def _driver_run(out):
    """cl_baseline on the 1 x 2 mesh; the trained model's gathered state."""
    from indic_cl_asr_torch.scripts import cl_baseline

    _no_draws(setattr)
    ctx = {}
    build = cl_baseline.build_all

    def build_all(cfg, ns):
        ctx.update(build(cfg, ns))
        return ctx

    cl_baseline.build_all = build_all
    res = cl_baseline.main(DRIVER + ["--output_dir", os.path.join(out, "split"),
                                   "--mesh.data", "1", "--mesh.model", "2"])
    state = S.gather_state(ctx["model"], ctx["optimizer"])
    return {"val": res["val"], "cfg": ctx["model_cfg"], "state": state["model"],
            "mu": state["mu"],
            "split": sorted(n for n, p in ctx["model"].named_parameters()
                            if S.split_of(p) is not None)}


def _worker(mode, rank, world, port, out):
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    if mode == "driver":
        os.environ.update(INDIC_ASR_MULTIHOST="1", INDIC_ASR_COORDINATOR=f"127.0.0.1:{port}",
                          INDIC_ASR_NUM_PROCESSES=str(world), INDIC_ASR_PROCESS_ID=str(rank))
        result = _driver_run(out)
    else:
        D.setup_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        if mode == "grid":
            mesh = S.make_mesh(2, 2)
            result = {"mesh": (mesh.data_rank, mesh.model_rank),
                      "step": _step_run(os.path.join(out, "init_own.pt"), _own_batch(), _cfg(
                          attn_impl="flash"), _own_step_cfg(), mesh)}
        else:
            mesh = S.make_mesh(1, 2)
            result = {"mesh": (mesh.n_data, mesh.n_model, mesh.data_rank, mesh.model_rank)}
            for case, (vocab, attn) in CASES.items():
                result[case] = _step_run(os.path.join(out, f"init_{case}.pt"),
                                         torch.load(os.path.join(out, f"batch_{case}.pt")),
                                         _cfg(attn_impl=attn, vocab=vocab), _jax_step_cfg(),
                                         mesh)
            for name, enc in VARIANTS.items():
                result[name] = _step_run(os.path.join(out, f"init_{name}.pt"), _own_batch(),
                                         _cfg(**enc), _own_step_cfg(), mesh)
            result["cl"] = _cl_run(os.path.join(out, "init_own.pt"), _own_batch(), _cfg(),
                                   _own_step_cfg(), mesh)
            result["load"] = _load_run(out, mesh)
            masks, seeds = _recorded_draws()
            result["dropout"] = dict(
                _step_run(os.path.join(out, "init_own.pt"), _own_batch(),
                          _cfg(dropout=True, attn_impl="flash"), _own_step_cfg(dither=1e-5),
                          mesh), masks=masks, seeds=seeds)
    D.barrier("exit")
    torch.save(result, os.path.join(out, f"{mode}_rank{rank}.pt"))
    D.shutdown()


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------

def _launch(mode, world, out):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("INDIC_ASR_MULTIHOST", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(world), str(port), str(out)], cwd=str(out), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{mode} rank {r} failed:\n{errs[r][-3000:]}"
    return [torch.load(os.path.join(out, f"{mode}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(vocab):
    from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config

    jcfg = jax_tiny_config(**vocab)
    return dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, scan_layers=True, frozen_till=1))


@pytest.fixture(scope="module")
def jax_inits():
    """Per case: the JAX package's tiny variables (scanned layout,
    frozen_till 1), the port loaded from them, and a batch of four rows,
    the last a repeat."""
    import jax

    from indic_cl_asr_tpu.models.hybrid import init_model
    from indic_cl_asr_torch.models.convert import from_jax_variables

    from .test_torch_train_step import _batch, _np_tree

    out = {}
    for case, (vocab, attn) in CASES.items():
        jcfg = _jax_cfg(vocab)
        variables = jax.jit(lambda key: init_model(jcfg, key)[1])(jax.random.PRNGKey(0))
        port = from_jax_variables(HybridRNNTCTC(_cfg(attn_impl=attn, vocab=vocab),
                                                device="cpu"), _np_tree(variables))
        out[case] = (jcfg, variables, port, _batch(jcfg))
    return out


@pytest.fixture(scope="module")
def tp(tmp_path_factory, jax_inits):
    """The 1 x 2 launch: the JAX cases, the variants, the CL methods, the
    checkpoint load and the dropout step."""
    from indic_cl_asr_torch.utils.checkpoint import SequenceCheckpointer

    out = tmp_path_factory.mktemp("tp")
    for case, (_, _, port, np_batch) in jax_inits.items():
        torch.save(port.state_dict(), out / f"init_{case}.pt")
        torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    for k, v in np_batch.items()}, out / f"batch_{case}.pt")
    own = init_weights_(HybridRNNTCTC(_cfg(), device="cpu"), torch.Generator().manual_seed(3))
    torch.save(own.state_dict(), out / "init_own.pt")
    for i, (name, enc) in enumerate(VARIANTS.items()):
        m = init_weights_(HybridRNNTCTC(_cfg(**enc), device="cpu"),
                          torch.Generator().manual_seed(10 + i))
        torch.save(m.state_dict(), out / f"init_{name}.pt")
    # a one-process task checkpoint (after a step: moments nonzero)
    model, opt = _model(out / "init_own.pt", _cfg(), None)
    make_train_step(model, _own_step_cfg(), opt, device="cpu")(
        _own_batch(), torch.Generator().manual_seed(0))
    SequenceCheckpointer(str(out / "ckpt")).save_task(0, "hindi", model, opt, {})
    return out, _launch("tp", 2, out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _port_dims(path, shape):
    """JAX dim -> port dim of a parameter at ``path`` (models/convert.py's
    forward map, by the shape it gives a tensor of distinct sizes)."""
    from indic_cl_asr_torch.models.convert import port_leaf

    name, arr = port_leaf(path, np.empty(tuple(range(2, 2 + len(shape))), np.float32))
    return name, [arr.shape.index(j + 2) for j in range(len(shape))]


def _jax_splits(jcfg):
    """{port name: (split port dim or None, whole shape in the port's
    layout)} of the params and of the mu leaves, from the JAX package's
    tree_shardings of its TrainState on a 1 x 2 mesh (shapes only)."""
    import jax

    from indic_cl_asr_tpu.models.hybrid import init_model
    from indic_cl_asr_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from indic_cl_asr_tpu.parallel.sharding import tree_shardings
    from indic_cl_asr_tpu.train.state import create_train_state
    from indic_cl_asr_tpu.train.state import make_optimizer as jax_make_optimizer
    from indic_cl_asr_tpu.utils.pytree import conformer_freeze_mask

    def state_of(key):
        variables = init_model(jcfg, key)[1]
        tx = jax_make_optimizer(lr=LR, trainable_mask=conformer_freeze_mask(
            variables["params"], 1), stacked_freeze_till=1)
        return create_train_state(variables, tx)

    shapes = jax.eval_shape(state_of, jax.random.PRNGKey(0))
    sh = tree_shardings(shapes, jax_make_mesh(n_data=1, n_model=2))
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))  # noqa
    flat_sh = {"/".join(map(key, p)): s for p, s in jax.tree_util.tree_flatten_with_path(sh)[0]}
    flat_shape = {"/".join(map(key, p)): s.shape
                  for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    out = {"params": {}, "mu": {}}
    for path, s in flat_sh.items():
        kind = "params" if path.startswith("params/") else "mu" if "/mu/" in path else None
        if kind is None:
            continue
        rel = path.split("params/", 1)[1] if kind == "params" else path.split("/mu/", 1)[1]
        spec, shape = tuple(s.spec), flat_shape[path]
        spec = spec + (None,) * (len(shape) - len(spec))
        if "/stack/layers/" in rel:  # the scanned [L, ...] leaves: one per layer,
            # the moments' of the trainable layers [F, L) only
            first = jcfg.encoder.n_layers - shape[0]
            rows = [(rel.replace("stack/layers", f"layers_{first + i}"), spec[1:], shape[1:])
                    for i in range(shape[0])]
        else:
            rows = [(rel, spec, shape)]
        for r, sp, shp in rows:
            name, dims = _port_dims(r, shp)
            split = dims[sp.index("model")] if "model" in sp else None
            out[kind][name] = (split, tuple(shp[dims.index(i)] for i in range(len(shp))))
    return out


@pytest.mark.parametrize("widths", ["tiny", "flagship"])
def test_split_rules_equal_jax_tree_shardings(widths):
    """The port's split of every parameter, its shard's and its moments'
    shapes, as the JAX package shards its TrainState on a 1 x 2 mesh."""
    from indic_cl_asr_tpu.models.hybrid import flagship_config as jax_flagship_config

    if widths == "tiny":
        jcfg, cfg = _jax_cfg({}), _cfg()
    else:
        import jax.numpy as jnp

        jcfg = jax_flagship_config(dtype=jnp.float32, n_layers=2)
        jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder,
                                                                     frozen_till=1))
        cfg = flagship_config(torch.float32, n_layers=2, frozen_till=1)
    want = _jax_splits(jcfg)
    model = HybridRNNTCTC(cfg, device="cpu")
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(whole) == set(want["params"])
    S.shard_model(model, S.Mesh(1, 2, 0, None, 1, None))
    opt = make_optimizer(model, lr=LR, freeze_encoder_till=1, device="cpu")
    dims = {n: None if S.split_of(p) is None else S.split_of(p).dim
            for n, p in model.named_parameters()}
    assert dims == {n: d for n, (d, _) in want["params"].items()}
    for name, p in model.named_parameters():
        d, shape = want["params"][name]
        assert shape == whole[name], name
        local = list(shape)
        if d is not None:
            local[d] //= 2
        assert tuple(p.shape) == tuple(local), name
    assert set(opt.names) == set(want["mu"])  # the trainable ones carry moments
    for name, mu in zip(opt.names, opt.mu):
        d, shape = want["mu"][name]
        local = list(shape)
        if d is not None:
            local[d] //= 2
        assert tuple(mu.shape) == tuple(local) == tuple(dict(
            model.named_parameters())[name].shape), name
    assert dims["joint.enc.weight"] == 0 and dims["encoder.layers.1.self_attn.linear_q.weight"] == 0
    assert dims["encoder.layers.1.self_attn.linear_out.weight"] == 1
    if widths == "flagship":  # V+1 = 257 and 3073 are odd: whole
        for name in ("joint.head_kernel", "joint.head_bias", "ctc_decoder.kernel",
                     "ctc_decoder.bias", "prediction.embedding"):
            assert dims[name] is None, name
        assert dims["prediction.lstm.0.w_ih"] == 1


def test_shard_model_refuses_what_cannot_split():
    mesh = S.Mesh(1, 3, 0, None, 0, None)
    with pytest.raises(ValueError, match="heads do not split"):
        S.shard_model(HybridRNNTCTC(_cfg(), device="cpu"), mesh)
    with pytest.raises(ValueError, match="groups do not split"):
        S.shard_model(HybridRNNTCTC(_cfg(conv_norm_type="group_norm1"), device="cpu"),
                      S.Mesh(1, 2, 0, None, 0, None))
    # the paired split keeps each rank's value and gate columns
    w = torch.arange(8.0)[:, None]
    split = S.Split(0, S.Mesh(1, 2, 0, None, 0, None), paired=True)
    halves = [S.shard_tensor(w, split, r) for r in (0, 1)]
    assert halves[0].flatten().tolist() == [0, 1, 4, 5]
    assert torch.equal(S.unshard(halves, split), w)


def _jax_mesh_step(jcfg, variables, np_batch):
    """The JAX package's step and its gradients on a 1 x 2 mesh, in one
    jitted program."""
    import jax
    import jax.numpy as jnp

    from indic_cl_asr_tpu.audio.features import FrontendConfig as JFrontendConfig
    from indic_cl_asr_tpu.models.hybrid import HybridRNNTCTC as JHybridRNNTCTC
    from indic_cl_asr_tpu.parallel.sharding import batch_shardings
    from indic_cl_asr_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from indic_cl_asr_tpu.parallel.sharding import tree_shardings
    from indic_cl_asr_tpu.train.state import create_train_state
    from indic_cl_asr_tpu.train.state import make_optimizer as jax_make_optimizer
    from indic_cl_asr_tpu.train.step import StepConfig as JStepConfig
    from indic_cl_asr_tpu.train.step import hybrid_forward_loss as jax_forward_loss
    from indic_cl_asr_tpu.train.step import make_train_step as jax_make_train_step
    from indic_cl_asr_tpu.utils.pytree import conformer_freeze_mask
    from indic_cl_asr_torch.models.convert import jax_state_dict

    from .test_torch_train_step import _np_tree

    jmodel = JHybridRNNTCTC(jcfg)
    jstep_cfg = JStepConfig(frontend=JFrontendConfig(n_mels=32, dither=0.0),
                            use_spec_augment=False, rnnt_chunk_size=8)
    tx = jax_make_optimizer(lr=LR, trainable_mask=conformer_freeze_mask(variables["params"], 1),
                            stacked_freeze_till=1)
    state = create_train_state(variables, tx)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    mesh = jax_make_mesh(n_data=1, n_model=2)
    assert mesh.shape == {"data": 1, "model": 2}
    bsh, ssh = batch_shardings(batch, mesh), tree_shardings(state, mesh)
    key = jax.random.PRNGKey(0)
    step = jax_make_train_step(jmodel, jcfg, jstep_cfg, tx)

    def both(state, b):
        def loss_fn(params):
            return jax_forward_loss(
                jmodel, jcfg, jstep_cfg, params, state.batch_stats, b["audio"],
                b["audio_len"], b["tokens"], b["token_len"], b["lang_ids"], key, train=True,
                n_valid=b["n_valid"])[0]

        return jax.grad(loss_fn)(state.params), step(state, b, key)

    grads, (state2, aux) = jax.jit(both, in_shardings=(ssh, bsh))(
        jax.device_put(state, ssh), jax.device_put(batch, bsh))
    n_layers = jcfg.encoder.n_layers
    new = jax_state_dict({"params": _np_tree(state2.params),
                          "batch_stats": _np_tree(state2.batch_stats)}, n_layers)
    return ({k: float(v) for k, v in aux.items()},
            jax_state_dict({"params": _np_tree(grads)}, n_layers), new)


def _close(got, want, what, atol=1e-5, rtol=1e-5):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: f"{what}: {m}")


def _same_as_one_process(got, want):
    """A split step against the one-process step: the data axis's bars (the sums
    run in another order)."""
    for k, v in want["aux"].items():
        _close(got["aux"][k], v, k)
    for name, g in want["grads"].items():
        _close(got["grads"][name], g, name)
    for name, t in want["state"].items():
        _close(got["state"][name], t, name, rtol=0,
               atol=2 * LR + 1e-6 if name in want["grads"] else 1e-6)


def _ranks_hold_one_model(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    assert a["split"] == b["split"] and a["split"]
    for name, t in a["local"].items():
        assert torch.equal(t, b["local"][name]), name
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_one_by_two_step_matches_the_jax_mesh_step_and_one_process(tp, jax_inits, case):
    out, ranks = tp
    assert ranks[1]["mesh"] == (1, 2, 0, 1)
    jcfg, variables, _, np_batch = jax_inits[case]
    jaux, jgrads, jnew = _jax_mesh_step(jcfg, variables, np_batch)
    got = ranks[0][case]
    for k in ("train_rnnt_loss", "train_ctc_loss", "train_loss"):
        np.testing.assert_allclose(float(got["aux"][k]), jaux[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    assert got["grads"]
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=1e-5, err_msg=name)
    n_stats = 0
    for name, t in got["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=1e-5, err_msg=name)
            n_stats += 1
        elif name in got["grads"]:
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=2e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), jnew[name], err_msg=name)
    assert n_stats == 4
    # the encoder runs on its slices: q and the FFN's linear1 hold 1/2 rows
    cfg = _cfg(attn_impl=CASES[case][1], vocab=CASES[case][0])
    d, ff = cfg.encoder.d_model, cfg.encoder.d_ff
    assert got["shapes"]["encoder.layers.1.self_attn.linear_q.weight"] == (d // 2, d)
    assert got["shapes"]["encoder.layers.1.feed_forward1.linear1.weight"] == (ff // 2, d)
    assert got["shapes"]["encoder.layers.1.conv.pointwise_conv1.weight"] == (d, d)
    if case == "vocab63":  # every vocabulary rule splits
        for name in ("joint.head_kernel", "joint.head_bias", "ctc_decoder.kernel",
                     "ctc_decoder.bias", "prediction.embedding"):
            assert name in got["split"], name
    want = _step_run(out / f"init_{case}.pt", torch.load(out / f"batch_{case}.pt"), cfg,
                     _jax_step_cfg(), None)
    _same_as_one_process(got, want)
    _ranks_hold_one_model(ranks, case)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_by_two_norm_and_attention_variants_match_one_process(tp, variant):
    out, ranks = tp
    want = _step_run(out / f"init_{variant}.pt", _own_batch(), _cfg(**VARIANTS[variant]),
                     _own_step_cfg(), None)
    _same_as_one_process(ranks[0][variant], want)
    _ranks_hold_one_model(ranks, variant)


def test_one_by_two_dropout_keeps_the_whole_model_equal_and_splits_draw_apart(tp):
    _, ranks = tp
    a, b = ranks[0]["dropout"], ranks[1]["dropout"]
    for name, t in a["local"].items():  # whole parameters and statistics
        assert torch.equal(t, b["local"][name]), name
    assert len(a["masks"]) == len(b["masks"])
    n_whole = n_split = 0
    for (sa, ma), (sb, mb) in zip(a["masks"], b["masks"]):
        if sa == sb:  # the whole model's draws: one mask
            assert torch.equal(ma, mb)
            n_whole += 1
        else:  # a split region's: each rank's own
            assert not torch.equal(ma, mb) and ma.float().mean() > 0
            n_split += 1
    assert n_whole > 0 and n_split == 4  # two trainable-or-frozen layers x two FFNs
    assert len(a["seeds"]) == 2 and all(x != y for x, y in zip(a["seeds"], b["seeds"]))
    assert float(a["aux"]["train_loss"]) > 0


def test_one_by_two_importance_epochs_and_lwf_match_one_process(tp):
    out, ranks = tp
    want = _cl_run(out / "init_own.pt", _own_batch(), _cfg(), _own_step_cfg(), None)
    for r in (0, 1):
        got = ranks[r]["cl"]
        for method in ("ewc", "mas"):
            assert set(got[method]) == set(want[method])
            for name, v in want[method].items():
                _close(got[method][name], v, f"{method} {name}",
                       rtol=1e-4 if method == "ewc" else 1e-5)
        for k, v in want["lwf"].items():
            _close(got["lwf"][k], v, f"lwf {k}")


def test_one_process_checkpoint_loads_into_the_split_model(tp):
    out, ranks = tp
    saved = torch.load(out / "ckpt" / "task_0_hindi.pt", weights_only=True)
    for r in (0, 1):
        got = ranks[r]["load"]
        for name, t in saved["model"].items():
            assert torch.equal(got["state"][name], t), name
        for key in ("mu", "nu"):
            assert len(got[key]) == len(saved["optimizer"][key])
            for g, w in zip(got[key], saved["optimizer"][key]):
                assert torch.equal(g, w)
        assert any(float(m.abs().max()) > 0 for m in got["mu"])


def test_two_by_two_step_matches_one_process(tmp_path):
    own = init_weights_(HybridRNNTCTC(_cfg(), device="cpu"), torch.Generator().manual_seed(3))
    torch.save(own.state_dict(), tmp_path / "init_own.pt")
    ranks = _launch("grid", 4, tmp_path)
    assert [r["mesh"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want = _step_run(tmp_path / "init_own.pt", _own_batch(), _cfg(attn_impl="flash"),
                     _own_step_cfg(), None)
    for r in ranks:
        _same_as_one_process(r["step"], want)
    for r in ranks[1:]:
        for name, t in ranks[0]["step"]["state"].items():
            assert torch.equal(t, r["step"]["state"][name]), name


def test_cl_baseline_on_a_model_axis_matches_one_process_and_its_checkpoint_loads(
        tmp_path, monkeypatch):
    from indic_cl_asr_torch.scripts import cl_baseline
    from indic_cl_asr_torch.utils.checkpoint import load_model

    ranks = _launch("driver", 2, tmp_path)
    _no_draws(monkeypatch.setattr)
    single = cl_baseline.main(DRIVER + ["--output_dir", str(tmp_path / "single")])
    (one,) = _run_dirs(tmp_path / "single")
    (run,) = _run_dirs(tmp_path / "split")
    assert ranks[1]["val"] == ranks[0]["val"]
    assert "encoder.layers.1.self_attn.linear_q.weight" in ranks[0]["split"]
    losses = ("train/train_loss_", "train/train_rnnt_loss_", "train/train_ctc_loss_")
    a, b = _numbers(_metrics(run), losses), _numbers(_metrics(one), losses)
    assert [k for k, _ in a] == [k for k, _ in b] and len(a) == 6
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=2e-4, atol=1e-5)
    for lang, recs in single["val"].items():
        got = ranks[0]["val"][lang]
        assert [sorted(r) for r in got] == [sorted(r) for r in recs]
        for g, w in zip(got, recs):
            np.testing.assert_allclose([g[k] for k in sorted(w)], [w[k] for k in sorted(w)],
                                       rtol=2e-4, atol=1e-5, err_msg=lang)
    # the split run's last task checkpoint, read by one process
    cfg_path = os.path.join(run, "sequence", "task_1_bengali.pt")
    saved = torch.load(cfg_path, weights_only=True)
    model = HybridRNNTCTC(ranks[0]["cfg"], device="cpu")
    load_model(cfg_path, model)
    for name, t in model.state_dict().items():
        assert torch.equal(t, ranks[0]["state"][name]), name
        assert torch.equal(t, ranks[1]["state"][name]), name
    for g, w in zip(ranks[0]["mu"], saved["optimizer"]["mu"]):
        assert torch.equal(g, w)
    # and the one-process run's, two steps on: 2·lr a step for the
    # parameters, the JAX bar (1e-5) for the statistics
    theirs = torch.load(os.path.join(one, "sequence", "task_1_bengali.pt"), weights_only=True)
    trainable = set(saved["optimizer"]["names"])
    for name, t in theirs["model"].items():
        _close(model.state_dict()[name], t, name, rtol=0,
               atol=2 * 2 * LR + 1e-6 if name in trainable else 1e-5)
    partial = np.load(os.path.join(run, "model_bengali.npz"))
    for name in partial.files:
        np.testing.assert_array_equal(partial[name], ranks[0]["state"][name].numpy())


if __name__ == "__main__":
    _worker(*sys.argv[1:])
