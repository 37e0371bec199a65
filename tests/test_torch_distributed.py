"""The port's data-parallel runtime (indic_cl_asr_torch/parallel) on the
CPU: ranks are processes of this file's ``__main__`` worker, joined over
gloo (a free localhost port, one intra-op thread each), at
``tiny_config()`` sizes in f32.

  * no process group: ``setup_distributed`` gives (0, 1), the
    collectives are no-ops (the JAX ``test_distributed_single_host_noops``);
  * two ranks: barrier, ``broadcast_from_main`` of objects and tensor
    trees, ``all_hosts_agree``, ``shard_for_host`` equal to the JAX
    function, a 3 x 1 and a 2 x 2 mesh over two ranks raising
    ``ValueError`` (tests/test_torch_tensor_parallel.py runs the model
    axis);
  * the two-rank step against the JAX package's step on
    ``make_mesh(n_data=2)`` over two virtual CPU devices, from the same
    weights and batch (a repeat row masked out), with dither, dropout and
    SpecAugment off: aux losses rtol 2e-4 (the JAX mesh test's), every
    summed gradient atol 1e-5 (the port's single-process parity test's),
    every updated parameter atol 2e-5, BatchNorm statistics atol 1e-5.
    The step runs at lr 1e-5: Adam's first update is about ±lr·sign(g),
    and a gradient near zero may round to the other sign, so the
    parameters can only be held to 2e-5 where 2·lr is below it; the
    gradients carry the comparison;
  * the two-rank step against the port's own one-process step, with
    SpecAugment on and the pallas joint, on a batch whose ``n_valid``
    leaves rank 1 with padding rows only: aux losses and gradients
    within 1e-5 + 1e-5·|x| (the gradient bar of the JAX parity; the sums
    run in another order: each rank sums its share, the all-reduce adds
    the shares; gradients of up to 0.4 differ by up to 1.8e-6),
    BatchNorm statistics within 1e-6 and parameters within 2·lr + 1e-6
    (the key biases' gradients are zero but for rounding, and Adam's
    first update turns their sign into ±lr);
  * a CL penalty, a scalar term (MAS's) or explicit gradients (EWC's),
    enters the two-rank step once, as in one process;
  * the CL importance epochs: EWC's Fisher and MAS's Ω of one batch, and
    an LwF step's losses, on two ranks against one process, within the
    gradients' bar (the Fisher, loss·g², at rtol 1e-4);
  * a group of one against no group, with dropout (attention and joint
    kernels' plain versions included), dither and SpecAugment on: the loss
    and every parameter and statistic bit-identical;
  * ``cl_baseline.main`` on two ranks (``INDIC_ASR_MULTIHOST=1``,
    ``--mesh.data 2``, two synthetic tasks of one step, dither and dropout
    off): rank 0's losses, val WER matrix and BWT equal the one-process
    run's within the step tolerance; one run dir with one ``config.json``,
    rank 1's streams rank-suffixed, a complete ``sequence.json``; a run
    stopped after task 0 resumes with ``--resume_dir`` and trains task 1;
  * the raises: a batch that does not split over the data axis
    (``ValueError``); a 2 x 2 and a 3 x 1 mesh at world size 2 in the
    worker (above).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from indic_cl_asr_torch.audio.features import FrontendConfig  # noqa: E402
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, init_weights_, tiny_config  # noqa: E402
from indic_cl_asr_torch.parallel import distributed as D  # noqa: E402
from indic_cl_asr_torch.parallel.sharding import Mesh, make_mesh, place_batch  # noqa: E402
from indic_cl_asr_torch.train.state import make_optimizer  # noqa: E402
from indic_cl_asr_torch.train.step import StepConfig, make_train_step  # noqa: E402

LR = 1e-5
TIMEOUT = 240
# cl_baseline at tiny widths: two languages of 4 training utterances, one
# step of B4 a task (as tests/test_torch_scripts.py runs it)
TINY = ["--n_langs", "2", "--batch_size", "4", "--synthetic_utts", "4", "--use_wandb",
        "false", "--model.n_layers", "2", "--model.d_model", "64", "--model.n_heads", "4",
        "--model.n_mels", "32", "--model.pred_hidden", "32", "--model.joint_hidden", "32",
        "--model.freeze_encoder_till", "1", "--mixed_precision", "false", "--rnnt_chunk_size",
        "8", "--buckets.boundaries_sec", "2.0", "--buckets.max_tokens", "64",
        "--model.attn_impl", "xla", "--synthetic", "true", "--device", "cpu"]


# ---------------------------------------------------------------------------
# what the worker and the test both run
# ---------------------------------------------------------------------------

def _own_cfg(dropout=False, attn_impl="xla"):
    cfg = tiny_config()
    enc = dataclasses.replace(cfg.encoder, frozen_till=1, attn_impl=attn_impl)
    if dropout:
        enc = dataclasses.replace(enc, dropout=0.1, dropout_att=0.1, dropout_pre_encoder=0.1)
        return dataclasses.replace(cfg, encoder=enc, pred_dropout=0.2, joint_dropout=0.2)
    return dataclasses.replace(cfg, encoder=enc)


def _own_batch(B=4, S=8000, U=6, n_valid=2):
    """One language (the CL workload's batches), every row a different
    length; rows n_valid.. repeat earlier rows as a bucket's padding does."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 16, (B, U)).astype(np.int32)
    audio = (0.1 * rng.standard_normal((B, S))).astype(np.float32)
    lens = np.array([S, S - 1500, S - 3000, S // 2][:B], np.int32)
    for i in range(n_valid, B):
        tokens[i], audio[i], lens[i] = tokens[i - n_valid], audio[i - n_valid], lens[i - n_valid]
    return {"audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(lens),
            "audio_len_host": torch.from_numpy(lens.copy()), "tokens": torch.from_numpy(tokens),
            "token_len": torch.from_numpy(np.array([U, U - 2, U - 1, U - 3][:B], np.int32)),
            "lang_ids": torch.zeros(B, dtype=torch.int32), "n_valid": n_valid}


def _model(init_path, cfg):
    model = HybridRNNTCTC(cfg, device="cpu")
    model.load_state_dict(torch.load(init_path, weights_only=True))
    return model, make_optimizer(model, lr=LR, freeze_encoder_till=1, device="cpu")


def _captured(opt):
    """The gradients ``opt.step`` is given, recorded by name."""
    seen, apply = {}, opt.step

    def record(grads):
        seen.update((n, None if g is None else g.clone()) for n, g in zip(opt.names, grads))
        apply(grads)

    opt.step = record
    return seen


def _penalty(kind):
    """A CL penalty of each kind the step takes: a scalar term (MAS's) or
    explicit gradients (EWC's), on the joint's encoder projection."""
    name = "joint.enc.weight"

    def penalty_fn(params):
        if kind == "scalar":
            return 0.5 * (params[name] ** 2).sum(), None
        return torch.zeros(()), {name: torch.full_like(params[name], 0.25)}

    return penalty_fn


def _step_run(init_path, batch, cfg, step_cfg, mesh, seed=0, penalty=None):
    """One step; returns aux, the summed gradients and the state dict."""
    model, opt = _model(init_path, cfg)
    seen = _captured(opt)
    if mesh is not None:
        batch = place_batch(batch, mesh, "cpu")
    aux = make_train_step(model, step_cfg, opt, device="cpu", mesh=mesh,
                          penalty_fn=penalty and _penalty(penalty))(
        batch, torch.Generator().manual_seed(seed))
    return {"aux": {k: v.clone() for k, v in aux.items()}, "grads": seen,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _cl_run(init_path, batch, cfg, step_cfg, mesh):
    """EWC's Fisher and MAS's Ω of one importance batch, one LwF step."""
    from indic_cl_asr_torch.cl import ewc as E
    from indic_cl_asr_torch.cl import lwf as L
    from indic_cl_asr_torch.cl import mas as M
    from indic_cl_asr_torch.cl.methods import EWCMethod, LwFMethod, MASMethod

    if mesh is not None:
        batch = place_batch(batch, mesh, "cpu")
    out = {}
    for name, cls, mcfg, seed in (("ewc", EWCMethod, E.EWCConfig(), 1),
                                  ("mas", MASMethod, M.MASConfig(), 2)):
        model, opt = _model(init_path, cfg)
        method = cls(mcfg, model, step_cfg, opt)
        method.mesh = mesh
        out[name] = method.importance_batch(method.begin_importance(), batch,
                                            torch.Generator().manual_seed(seed))
    model, opt = _model(init_path, cfg)
    lwf = LwFMethod(L.LwFConfig(knowledge_distillation=0.5), model, step_cfg, opt)
    lwf.end_task(None, 0, 0)
    lwf.mesh = mesh
    aux = lwf.make_train_step(None, 1)(batch, torch.Generator().manual_seed(3))
    out["lwf"] = {k: v.clone() for k, v in aux.items()}
    return out


def _jax_step_cfg():
    return StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0), use_spec_augment=False,
                      rnnt_chunk_size=8)


def _own_step_cfg(dither=0.0):
    return StepConfig(frontend=FrontendConfig(n_mels=32, dither=dither), rnnt_chunk_size=8,
                      rnnt_impl="pallas", uniform_lang_head=True)


def _no_draws(setattr_):
    """Dither and dropout off in the command line's model and front end
    (``setattr_(obj, name, value)``: monkeypatch's, or plain setattr)."""
    from indic_cl_asr_torch.scripts import _common as C

    build = C.build_model_cfg

    def build_model_cfg(*a, **k):
        cfg = build(*a, **k)
        enc = dataclasses.replace(cfg.encoder, dropout=0.0, dropout_att=0.0,
                                  dropout_pre_encoder=0.0)
        return dataclasses.replace(cfg, encoder=enc, pred_dropout=0.0, joint_dropout=0.0)

    setattr_(C, "build_model_cfg", build_model_cfg)
    setattr_(C, "FrontendConfig", lambda **k: FrontendConfig(**k, dither=0.0))


class _Preempted(Exception):
    pass


def _driver_runs(out):
    """The worker's cl_baseline runs: a whole one, then one stopped after
    task 0's checkpoint and resumed from it."""
    from indic_cl_asr_torch.scripts import cl_baseline
    from indic_cl_asr_torch.utils.checkpoint import SequenceCheckpointer

    _no_draws(setattr)
    res = cl_baseline.main(TINY + ["--output_dir", os.path.join(out, "shared"),
                                   "--mesh.data", "2"])
    save = SequenceCheckpointer.save_task

    def save_then_stop(self, task_idx, *a, **k):
        save(self, task_idx, *a, **k)
        raise _Preempted(task_idx)

    SequenceCheckpointer.save_task = save_then_stop
    argv = TINY + ["--output_dir", os.path.join(out, "stopped"), "--mesh.data", "2"]
    try:
        cl_baseline.main(argv)
    except _Preempted:
        pass
    SequenceCheckpointer.save_task = save
    (seq,) = [r for r, _, files in os.walk(os.path.join(out, "stopped"))
              if "sequence.json" in files]
    resumed = cl_baseline.main(argv[:-4] + ["--output_dir", os.path.join(out, "resumed"),
                                            "--mesh.data", "2", "--resume_dir", seq])
    return {"val": res["val"], "resumed_val": resumed["val"]}


def _worker(mode, rank, world, port, out):
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    if mode == "driver":
        os.environ.update(INDIC_ASR_MULTIHOST="1", INDIC_ASR_COORDINATOR=f"127.0.0.1:{port}",
                          INDIC_ASR_NUM_PROCESSES=str(world), INDIC_ASR_PROCESS_ID=str(rank))
        result = _driver_runs(out)
    else:
        assert D.setup_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
        assert D.setup_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
        mesh = make_mesh()
        if mode == "one":
            result = _step_run(os.path.join(out, "init_dropout.pt"), _own_batch(),
                               _own_cfg(dropout=True, attn_impl="flash"),
                               _own_step_cfg(dither=1e-5), mesh)
        else:
            result = {"contract": _contract(rank)}
            result["jax_step"] = _step_run(os.path.join(out, "init_jax.pt"),
                                           torch.load(os.path.join(out, "batch_jax.pt")),
                                           _own_cfg(), _jax_step_cfg(), mesh)
            result["own_step"] = _step_run(os.path.join(out, "init_own.pt"), _own_batch(),
                                           _own_cfg(), _own_step_cfg(), mesh)
            result["cl"] = _cl_run(os.path.join(out, "init_own.pt"), _own_batch(), _own_cfg(),
                                   _own_step_cfg(), mesh)
            for kind in ("scalar", "grads"):
                result[f"penalty_{kind}"] = _step_run(os.path.join(out, "init_own.pt"),
                                                      _own_batch(), _own_cfg(),
                                                      _own_step_cfg(), mesh, penalty=kind)
    D.barrier("exit")
    torch.save(result, os.path.join(out, f"{mode}_rank{rank}.pt"))
    D.shutdown()


def _contract(rank):
    from indic_cl_asr_torch.data.pipeline import shard_for_host

    D.barrier("contract")
    raised = {}
    for name, call in (("data_3", lambda: make_mesh(3)),
                       ("model_2", lambda: make_mesh(2, 2))):
        try:
            call()
        except Exception as e:  # noqa: BLE001 - the type is what is checked
            raised[name] = type(e).__name__
    return {
        "main": D.is_main_process(),
        "object": D.broadcast_from_main({"from": rank, "text": f"rank {rank}"}),
        "tree": D.broadcast_from_main({"a": torch.full((3,), float(rank)),
                                       "b": [torch.arange(4) * (rank + 1)]}),
        "agree_equal": D.all_hosts_agree(42),
        "agree_differ": D.all_hosts_agree(rank),
        "agree_tensor": D.all_hosts_agree(torch.ones(2)),
        "shard": [e for e in shard_for_host(list(range(11)), rank, 2)],
        "raised": raised,
    }


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's tiny variables (scanned layout, frozen_till 1),
    the port loaded from them, and a batch of four rows, the last a repeat."""
    import jax

    from indic_cl_asr_tpu.models.hybrid import HybridRNNTCTC as JHybridRNNTCTC
    from indic_cl_asr_tpu.models.hybrid import init_model
    from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
    from indic_cl_asr_torch.models.convert import from_jax_variables

    from .test_torch_train_step import _batch, _np_tree

    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, scan_layers=True, frozen_till=1))
    # jitted: the eager init takes ~20 s of CPU
    variables = jax.jit(lambda key: init_model(jcfg, key)[1])(jax.random.PRNGKey(0))
    jmodel = JHybridRNNTCTC(jcfg)
    port = from_jax_variables(HybridRNNTCTC(_own_cfg(), device="cpu"), _np_tree(variables))
    return jcfg, jmodel, variables, port, _batch(jcfg)


@pytest.fixture(scope="module")
def dp(tmp_path_factory, jax_init):
    """One two-rank launch: the contract, the step against JAX's inputs,
    the step and the CL methods on the port's own inputs."""
    out = tmp_path_factory.mktemp("dp")
    _, _, _, port, np_batch = jax_init
    torch.save(port.state_dict(), out / "init_jax.pt")
    torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in np_batch.items()}, out / "batch_jax.pt")
    own = init_weights_(HybridRNNTCTC(_own_cfg(), device="cpu"), torch.Generator().manual_seed(3))
    torch.save(own.state_dict(), out / "init_own.pt")
    return out, _launch("dp", 2, out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_no_group_setup_and_collectives_are_no_ops():
    assert not D.initialized()
    assert D.setup_distributed() == (0, 1)
    assert D.is_main_process() and D.process_count() == 1
    D.barrier()  # must not wait
    tree = {"a": torch.ones(3)}
    assert D.broadcast_from_main(tree) is tree
    assert D.all_hosts_agree(42)
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_rank, mesh.group) == (1, 1, 0, None)


def test_two_ranks_barrier_broadcast_agree_and_shard(dp):
    from indic_cl_asr_tpu.data.pipeline import shard_for_host as jax_shard_for_host

    _, ranks = dp
    c0, c1 = ranks[0]["contract"], ranks[1]["contract"]
    assert (c0["main"], c1["main"]) == (True, False)
    for c in (c0, c1):
        assert c["object"] == {"from": 0, "text": "rank 0"}
        assert torch.equal(c["tree"]["a"], torch.zeros(3))
        assert torch.equal(c["tree"]["b"][0], torch.arange(4))
        assert c["agree_equal"] and c["agree_tensor"] and not c["agree_differ"]
        assert c["raised"] == {"data_3": "ValueError", "model_2": "ValueError"}
    for r, c in enumerate((c0, c1)):
        assert c["shard"] == jax_shard_for_host(list(range(11)), r, 2)


def _jax_mesh_step(jax_init):
    """The JAX package's step, and its gradients, on a 2 x 1 mesh."""
    import jax
    import jax.numpy as jnp

    from indic_cl_asr_tpu.audio.features import FrontendConfig as JFrontendConfig
    from indic_cl_asr_tpu.parallel.sharding import batch_shardings, shard_train_state
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

    jcfg, jmodel, variables, _, np_batch = jax_init
    jstep_cfg = JStepConfig(frontend=JFrontendConfig(n_mels=32, dither=0.0),
                            use_spec_augment=False, rnnt_chunk_size=8)
    tx = jax_make_optimizer(lr=LR, trainable_mask=conformer_freeze_mask(variables["params"], 1),
                            stacked_freeze_till=1)
    state = create_train_state(variables, tx)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    mesh = jax_make_mesh(n_data=2)
    assert mesh.shape == {"data": 2, "model": 1}
    bsh, ssh = batch_shardings(batch, mesh), tree_shardings(state, mesh)
    sbatch = jax.device_put(batch, bsh)
    key = jax.random.PRNGKey(0)

    def loss_fn(params, b):
        loss, _ = jax_forward_loss(
            jmodel, jcfg, jstep_cfg, params, state.batch_stats, b["audio"], b["audio_len"],
            b["tokens"], b["token_len"], b["lang_ids"], key, train=True, n_valid=b["n_valid"])
        return loss

    n_layers = jcfg.encoder.n_layers
    grads = jax.jit(jax.grad(loss_fn), in_shardings=(ssh.params, bsh))(state.params, sbatch)
    step = jax.jit(jax_make_train_step(jmodel, jcfg, jstep_cfg, tx),
                   in_shardings=(ssh, bsh, None))
    state2, aux = step(shard_train_state(state, mesh), sbatch, key)
    new = jax_state_dict({"params": _np_tree(state2.params),
                          "batch_stats": _np_tree(state2.batch_stats)}, n_layers)
    return ({k: float(v) for k, v in aux.items()},
            jax_state_dict({"params": _np_tree(grads)}, n_layers), new)


def test_two_rank_step_matches_the_jax_mesh_step(dp, jax_init):
    _, ranks = dp
    jaux, jgrads, jnew = _jax_mesh_step(jax_init)
    got = ranks[0]["jax_step"]
    for k in ("train_rnnt_loss", "train_ctc_loss", "train_loss"):
        np.testing.assert_allclose(float(got["aux"][k]), jaux[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    assert got["grads"], "no gradients recorded"
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=1e-5, err_msg=name)
    trainable = set(got["grads"])
    n_stats = 0
    for name, t in got["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=1e-5, err_msg=name)
            n_stats += 1
        elif name in trainable:
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=2e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), jnew[name], err_msg=name)
    assert n_stats == 4  # two layers' running mean and variance
    # the ranks hold one model
    for name, t in got["state"].items():
        assert torch.equal(t, ranks[1]["jax_step"]["state"][name]), name


def _close(got, want, what, atol=1e-5, rtol=1e-5):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: f"{what}: {m}")


def test_two_rank_step_matches_one_process_with_a_padding_only_rank(dp):
    out, ranks = dp
    batch = _own_batch()
    assert batch["n_valid"] == 2  # rank 1's rows 2 and 3 are both padding
    want = _step_run(out / "init_own.pt", batch, _own_cfg(), _own_step_cfg(), None)
    for r in (0, 1):
        got = ranks[r]["own_step"]
        for k, v in want["aux"].items():
            _close(got["aux"][k], v, k)
        for name, g in want["grads"].items():
            _close(got["grads"][name], g, name)
        for name, t in want["state"].items():
            _close(got["state"][name], t, name, rtol=0,
                   atol=2 * LR + 1e-6 if name in want["grads"] else 1e-6)
    assert float(want["aux"]["train_loss"]) > 0


@pytest.mark.parametrize("kind", ["scalar", "grads"])
def test_two_rank_step_adds_a_cl_penalty_once(dp, kind):
    """The penalty is the same on every rank: a scalar one enters the
    summed gradients once, explicit gradients are added after the sum."""
    out, ranks = dp
    want = _step_run(out / "init_own.pt", _own_batch(), _own_cfg(), _own_step_cfg(), None,
                     penalty=kind)
    got = ranks[0][f"penalty_{kind}"]
    for k, v in want["aux"].items():
        _close(got["aux"][k], v, k)
    for name, g in want["grads"].items():
        _close(got["grads"][name], g, name)
    plain = ranks[0]["own_step"]["grads"]["joint.enc.weight"]
    assert not torch.allclose(want["grads"]["joint.enc.weight"], plain)


def test_two_rank_importance_epochs_and_lwf_match_one_process(dp):
    out, ranks = dp
    want = _cl_run(out / "init_own.pt", _own_batch(), _own_cfg(), _own_step_cfg(), None)
    for r in (0, 1):
        got = ranks[r]["cl"]
        for method in ("ewc", "mas"):
            assert set(got[method]) == set(want[method])
            for name, v in want[method].items():
                # loss·g²: twice the gradient's relative error and the loss's
                _close(got[method][name], v, f"{method} {name}",
                       rtol=1e-4 if method == "ewc" else 1e-5)
            assert any(float(v.abs().max()) > 0 for v in want[method].values())
        for k, v in want["lwf"].items():
            _close(got["lwf"][k], v, f"lwf {k}")
        assert float(want["lwf"]["rnnt_kd"]) >= 0 and "ctc_kd" in want["lwf"]


def test_group_of_one_is_bit_identical_to_no_group(tmp_path):
    cfg = _own_cfg(dropout=True, attn_impl="flash")
    model = init_weights_(HybridRNNTCTC(cfg, device="cpu"), torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), tmp_path / "init_dropout.pt")
    (got,) = _launch("one", 1, tmp_path)
    want = _step_run(tmp_path / "init_dropout.pt", _own_batch(), cfg,
                     _own_step_cfg(dither=1e-5), None)
    assert set(got["aux"]) == set(want["aux"])
    for k, v in want["aux"].items():
        assert torch.equal(got["aux"][k], v), k
    for name, t in want["state"].items():
        assert torch.equal(got["state"][name], t), name
    # dropout was on: a step without it gives another loss
    plain = _step_run(tmp_path / "init_dropout.pt", _own_batch(), _own_cfg(),
                      _own_step_cfg(dither=1e-5), None)
    assert not torch.equal(plain["aux"]["train_loss"], want["aux"]["train_loss"])


def test_place_batch_splits_rows_replicated_keeps_them_and_an_uneven_split_raises():
    batch = _own_batch()
    halves = [place_batch(batch, Mesh(2, 1, r, None), "cpu") for r in (0, 1)]
    for r, h in enumerate(halves):
        assert h["row0"] == 2 * r and h["n_valid"] == 2
        assert torch.equal(h["audio"], batch["audio"][2 * r:2 * r + 2])
        assert torch.equal(h["audio_len_host"], batch["audio_len_host"])  # global
    # a data axis of one is the replicated placement: every row stays
    whole = place_batch(batch, Mesh(1, 1, 0, None), "cpu")
    assert whole["row0"] == 0 and whole["n_valid"] == 2
    assert all(torch.equal(whole[k], v) for k, v in batch.items() if torch.is_tensor(v))
    with pytest.raises(ValueError, match="does not split"):
        place_batch(_own_batch(B=3, n_valid=3), Mesh(2, 1, 0, None), "cpu")


def _metrics(run, suffix=""):
    with open(os.path.join(run, f"metrics{suffix}.jsonl")) as f:
        return [{k: v for k, v in r.items() if k != "_time"} for r in map(json.loads, f)]


def _numbers(recs, prefixes):
    return [(k, v) for r in recs for k, v in r.items()
            if k.startswith(prefixes) and isinstance(v, (int, float))]


def _run_dirs(out):
    return [os.path.join(out, d) for d in sorted(os.listdir(out))
            if os.path.exists(os.path.join(out, d, "config.json"))]


def test_cl_baseline_on_two_ranks_matches_one_process_and_resumes(tmp_path, monkeypatch):
    from indic_cl_asr_torch.scripts import cl_baseline

    ranks = _launch("driver", 2, tmp_path)
    _no_draws(monkeypatch.setattr)
    single = cl_baseline.main(TINY + ["--output_dir", str(tmp_path / "single")])
    (one,) = _run_dirs(tmp_path / "single")
    (run,) = _run_dirs(tmp_path / "shared")  # one run dir, one config.json
    for r in ranks:
        assert r["val"] == ranks[0]["val"]
    assert os.path.exists(os.path.join(run, "metrics.rank1.jsonl"))
    assert os.path.exists(os.path.join(run, "log.rank1.txt"))
    with open(os.path.join(run, "sequence", "sequence.json")) as f:
        assert json.load(f)["completed_tasks"] == ["hindi", "bengali"]
    assert sorted(os.listdir(os.path.join(run, "sequence"))) == [
        "sequence.json", "task_0_hindi.pt", "task_1_bengali.pt"]

    # rank 0's stream against the one-process run's
    mine, theirs = _metrics(run), _metrics(one)
    losses = ("train/train_loss_", "train/train_rnnt_loss_", "train/train_ctc_loss_")
    a, b = _numbers(mine, losses), _numbers(theirs, losses)
    assert [k for k, _ in a] == [k for k, _ in b] and len(a) == 6
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=2e-4, atol=1e-5)
    a, b = _numbers(mine, ("bwt/",)), _numbers(theirs, ("bwt/",))
    assert [k for k, _ in a] == [k for k, _ in b] and a
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=2e-4, atol=1e-5)
    assert set(ranks[0]["val"]) == set(single["val"])
    for lang, recs in single["val"].items():
        got = ranks[0]["val"][lang]
        assert [sorted(r) for r in got] == [sorted(r) for r in recs]
        for g, w in zip(got, recs):
            np.testing.assert_allclose([g[k] for k in sorted(w)], [w[k] for k in sorted(w)],
                                       rtol=2e-4, atol=1e-5, err_msg=lang)
    # rank 1 logs the same losses into its own stream
    assert _numbers(_metrics(run, ".rank1"), losses) == _numbers(mine, losses)

    # stopped after task 0, resumed: it restores task 0 and trains task 1
    (resumed,) = _run_dirs(tmp_path / "resumed")
    recs = _metrics(resumed)
    assert {"resumed_from_task": 0, "resumed_lang": "hindi"} in recs
    trained = {k.rsplit("_", 1)[1] for k, _ in _numbers(recs, ("train/train_loss_",))}
    assert trained == {"bengali"}
    assert len(ranks[0]["resumed_val"]["hindi"]) == 2
    assert ranks[1]["resumed_val"] == ranks[0]["resumed_val"]


if __name__ == "__main__":
    _worker(*sys.argv[1:])
