"""The port's observability (``utils/profiling.py``,
``scripts/{profile_step,flops_audit,bench_eval}.py``) against the JAX
package's scripts, on the CPU at tiny sizes.

  * ``_summarize`` equals the JAX script's on the JAX test's rows and on the
    rows of a recorded card trace fragment (tests/data/, cut by
    ``tools/trace_fragment.py`` from ``profile_step --steps 3`` on an H100:
    one event per kernel name with its launching host operation, and the
    kernel work those steps reported);
  * ``flops_audit`` on a tiny step: the counter's FLOPs equal the GEMM and
    convolution FLOPs of the same shapes exactly, each kernel's its
    analytic work times its calls; beside the JAX package's XLA
    ``cost_analysis()`` of the same tiny loss forward (which counts the
    elementwise work as well) the ratio lies in the band stated there;
  * ``bench_eval --tiny --device cpu`` prints one line per decoder for all
    five, and the fused two go through their wrappers.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from indic_cl_asr_tpu.audio.features import FrontendConfig as JFrontendConfig
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.train.step import StepConfig as JStepConfig
from indic_cl_asr_tpu.train.step import hybrid_forward_loss as jax_forward_loss
from indic_cl_asr_torch.audio.features import output_seq_len
from indic_cl_asr_torch.models.common import Rngs
from indic_cl_asr_torch.models.hybrid import tiny_config
from indic_cl_asr_torch.models.rnnt import lstm_work
from indic_cl_asr_torch.ops import flash_mhsa as fm
from indic_cl_asr_torch.ops import rnnt_loss as rl
from indic_cl_asr_torch.scripts import bench_eval, flops_audit, profile_step
from indic_cl_asr_torch.tools import flagship
from indic_cl_asr_torch.train.step import hybrid_forward_tensors
from indic_cl_asr_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
FRAGMENT = ROOT / "tests" / "data" / "torch_step_trace_fragment.json"
# port FLOPs / XLA's cost_analysis() of the same tiny loss forward (B2,
# 1 s, U 5, unrolled layers): 0.8227 measured on the CPU (jax 0.9.0, torch
# 2.13). XLA counts elementwise work (the lattice, the log-softmax, the
# norms, the activations) that FlopCounterMode does not, and the port's
# flash forward is its analytic count over the valid pairs where XLA
# counts the eager attention's products over every pair; the shapes are
# fixed, so the band only covers the two counters' versions
RATIO_BAND = (0.80, 0.85)
JAX_ROWS = [
    {"hlo_op_name": "fusion.1", "category": "convolution fusion",
     "total_self_time": 600.0, "occurrences": 3, "bound_by": "Compute",
     "measured_memory_bw": 500.0, "model_flop_rate": 9e4,
     "tf_op_name": "jit(step)/conv"},
    {"hlo_op_name": "fusion.2", "category": "loop fusion",
     "total_self_time": 300.0, "occurrences": 12, "bound_by": "HBM",
     "measured_memory_bw": 700.0, "model_flop_rate": 0.0,
     "tf_op_name": "jit(step)/add"},
    {"hlo_op_name": "copy.3", "category": "copy",
     "total_self_time": 100.0, "occurrences": 1, "bound_by": "HBM",
     "measured_memory_bw": 400.0, "model_flop_rate": None,
     "tf_op_name": None},
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of tiny ops: one intra-op thread (see test_torch_scripts)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_profile_step():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_step", ROOT / "scripts" / "profile_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fragment():
    with open(FRAGMENT) as f:
        data = json.load(f)
    return data["traceEvents"], data["work"]


def _tiny_cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, attn_impl="flash", frozen_till=1))


def _tiny_step(device="cpu"):
    return flagship.flagship_step(device, _tiny_cfg(), batch=2, seconds=1.0, tokens=5)


@pytest.mark.parametrize("top", [2, 25])
def test_summarize_equals_the_jax_scripts(top):
    jps = _jax_profile_step()
    assert profile_step._summarize(JAX_ROWS, top) == jps._summarize(JAX_ROWS, top)
    events, work = _fragment()
    rows = profile_step.rows_from_trace(events, work)
    assert profile_step._summarize(rows, top) == jps._summarize(rows, top)


def test_rows_of_a_recorded_trace_fragment():
    """The categoriser on the card's kernel names: the port's kernels by
    name with their bound from the reported work, cuBLAS and cuDNN by
    substring, every device event in one row, the categories summing to
    the device self time."""
    events, work = _fragment()
    rows = profile_step.rows_from_trace(events, work)
    dev = [e for e in events if e.get("cat") in profile_step.DEVICE_CATS]
    assert len(rows) == len({e["name"] for e in dev})
    assert sum(r["total_self_time"] for r in rows) == pytest.approx(sum(e["dur"] for e in dev))
    by = {r["hlo_op_name"]: r for r in rows}
    cats = {r["category"] for r in rows}
    assert {"flash attention forward", "flash attention backward", "rnnt lattice",
            "gemm", "elementwise/reduction", "copy/memset"} <= cats
    for name, r in by.items():
        port = next((w for sub, _, w in profile_step.PORT_KERNELS if sub in name), None)
        if port is not None:
            w = work[port]
            assert r["bound_by"] in ("bytes", "operations")
            assert r["model_flop_rate"] == pytest.approx(w["flops"] / (r["total_self_time"] * 1e3))
        else:
            assert r["bound_by"] == "?" and r["model_flop_rate"] is None
    assert any("alpha_warp_kernel" in n and by[n]["bound_by"] == "bytes" for n in by)
    summary = profile_step._summarize(rows, 25)
    assert sum(c["us"] for c in summary["by_category"]) == pytest.approx(
        summary["total_self_time_us"], abs=0.05 * len(summary["by_category"]))
    assert profile_step.category("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy") == "copy/memset"
    assert profile_step.host_category("aten::addmm") == "gemm"


def test_cli_wires_logdir_and_steps(tmp_path, monkeypatch):
    """--logdir with no trace captures with --steps and --device (stubbed
    here: nothing runs), as the JAX script's test stubs ``_capture``."""
    called = {}

    def fake_capture(steps, logdir, device):
        called["args"] = (steps, logdir, device)
        raise SystemExit(0)

    monkeypatch.setattr(profile_step, "_capture", fake_capture)
    with pytest.raises(SystemExit):
        profile_step.main(["--logdir", str(tmp_path), "--steps", "0", "--device", "cpu"])
    assert called["args"] == (0, str(tmp_path), torch.device("cpu"))


def test_a_tiny_capture_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(profile_step, "flagship_step", lambda dev: _tiny_step(dev))
    out = tmp_path / "summary.json"
    summary = profile_step.main(["--device", "cpu", "--steps", "1", "--top", "5",
                                 "--logdir", str(tmp_path / "tr"), "--json", str(out)])
    printed = capsys.readouterr().out
    assert printed.startswith("host self time:") and "idle share" not in printed
    assert json.loads(out.read_text())["total_self_time_us"] == summary["total_self_time_us"]
    cats = {c["category"] for c in summary["by_category"]}
    assert {"gemm", "convolution", "elementwise/reduction"} <= cats
    assert summary["device"] == "cpu" and summary["steps"] == 1 and summary["wall_ms"] > 0
    assert len(summary["top_ops"]) == 5
    # the CPU launches no kernel: no work is reported
    info = json.loads((tmp_path / "tr" / "capture.json").read_text())
    assert info["work"] == {}
    # reusing the trace does not capture again
    monkeypatch.setattr(profile_step, "_capture", None)
    again = profile_step.main(["--device", "cpu", "--logdir", str(tmp_path / "tr")])
    assert again["total_self_time_us"] == summary["total_self_time_us"]


def test_step_timer_memory_stats_and_trace(tmp_path):
    timer = profiling.StepTimer(warmup=1)
    for i in range(3):
        with timer.step(torch.ones(4) * i):
            pass
    stats = timer.stats()
    assert stats["steps"] == 2 and stats["p50_s"] <= stats["p95_s"]
    got = timer.time_fn(lambda x: {"y": [x + 1]}, torch.ones(3), iters=2)
    assert got["iters"] == 2 and got["mean_s"] > 0 and timer.stats()["steps"] == 3
    assert profiling.StepTimer().stats() == {}
    assert profiling.device_memory_stats("cpu") == {}
    big = torch.zeros(1234, 567)
    assert ((1234, 567), "torch.float32", big.numel() * 4) in profiling.log_live_buffers(
        5, device="cpu")
    with profiling.trace(str(tmp_path), "cpu"):
        with profiling.span("my_span"):
            torch.ones(8) @ torch.ones(8)
    (path,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "my_span" in names and "aten::dot" in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            profiling.trace(str(tmp_path)).__enter__()


def test_the_audit_hides_a_kernels_plain_version_and_keeps_its_gradients():
    """On CPU tensors the flash wrapper's plain version runs inside the
    audit unseen by the counter, its work counted from ``fm.work`` and
    ``fm.work_backward``, and its gradients equal the plain autograd's."""
    g = torch.Generator().manual_seed(0)
    B, T, H, D = 2, 9, 2, 8
    E = H * D
    q, k, v = (torch.randn(B, T, E, generator=g, requires_grad=True) for _ in range(3))
    p = torch.randn(2 * T - 1, E, generator=g, requires_grad=True)
    bu, bv = (torch.randn(H, D, generator=g, requires_grad=True) for _ in range(2))
    lens = torch.tensor([9, 5])
    leaves = (q, k, v, p, bu, bv)
    with FlopCounterMode(display=False) as plain_count:
        out = fm.flash_relpos_mhsa(*leaves, lens, n_heads=H)
        want = torch.autograd.grad(out.square().sum(), leaves)
    assert plain_count.get_total_flops() > 0  # the plain version's products
    with profiling.FlopAudit() as audit:
        out = fm.flash_relpos_mhsa(*leaves, lens, n_heads=H)
        got = torch.autograd.grad(out.square().sum(), leaves)
    assert audit.counted() == 0
    assert audit.flops["flash_relpos_mhsa"] == fm.work(B, T, E, lens, itemsize=4)[1]
    assert audit.flops["flash_relpos_mhsa_backward"] == fm.work_backward(
        B, T, E, lens, H, itemsize=4)[1]
    assert audit.calls == {"flash_relpos_mhsa": 1, "flash_relpos_mhsa_backward": 1}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="do not nest"):
        with profiling.FlopAudit(), profiling.FlopAudit():
            pass
    assert not profiling.auditing()


@pytest.mark.parametrize("groups", [1, 8])
def test_the_audit_counts_a_convolutions_backward_as_two_forwards(groups):
    """dX and dW each take the forward's products; torch's own formula
    counts a depthwise convolution's as if it were dense."""
    w = torch.randn(8, 8 // groups, 5, requires_grad=True)
    x = torch.randn(2, 8, 20, requires_grad=True)
    conv = lambda: torch.nn.functional.conv1d(x, w, padding=2, groups=groups)  # noqa: E731
    forward = 2 * (2 * 8 * 20) * (8 // groups) * 5
    with profiling.FlopAudit() as audit:
        torch.autograd.grad(conv().sum(), (x, w))
    assert audit.counted() == 3 * forward
    with FlopCounterMode(display=False) as torch_count:
        torch.autograd.grad(conv().sum(), (x, w))
    assert (torch_count.get_total_flops() == 3 * forward) == (groups == 1)


def _analytic_loss_forward(fs):
    """The GEMM and convolution FLOPs of the loss forward from the shapes
    its modules see (forward hooks) and the products outside a module (the
    mel filterbank, the CTC heads, the pred projection, the joint's head
    over the chunk-padded T), and the kernels' analytic work."""
    model, cfg, sc = fs.model, fs.model.cfg, fs.step_cfg
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, i[0].shape, o.shape)))
             for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d))]
    batch = fs.batch
    try:
        f_proj, g_proj, _, _, _, f, enc_lens = hybrid_forward_tensors(
            model, sc, batch["audio"], batch["audio_len"], batch["tokens"], batch["lang_ids"],
            Rngs.from_host(torch.Generator().manual_seed(0), model.device), True)
    finally:
        for h in hooks:
            h.remove()
    gemm = 0
    for m, xin, out in seen:
        if isinstance(m, nn.Linear):
            gemm += 2 * math.prod(xin[:-1]) * m.in_features * m.out_features
        elif not isinstance(m, nn.Linear):
            gemm += 2 * math.prod(out) * (m.in_channels // m.groups) * math.prod(m.kernel_size)
    B, S = batch["audio"].shape
    fe = sc.frontend
    T_mel = int(output_seq_len(torch.tensor(S), fe))
    T, U1 = f.shape[1], g_proj.shape[1]
    V1, d, Hj, Hp = cfg.vocab_per_lang + 1, cfg.encoder.d_model, cfg.joint_hidden, cfg.pred_hidden
    T_pad = -(-T // sc.rnnt_chunk_size) * sc.rnnt_chunk_size
    gemm += 2 * B * fe.n_mels * (fe.n_fft // 2 + 1) * T_mel  # mel filterbank
    gemm += 2 * B * T * d * V1                                # CTC head
    gemm += 2 * B * U1 * Hp * Hj                              # pred projection
    gemm += 2 * B * T_pad * U1 * Hj * V1                      # the joint's head
    kernels = {"flash_relpos_mhsa": cfg.encoder.n_layers * fm.work(B, T, d, enc_lens)[1],
               "lstm": lstm_work(B, U1, Hp, Hp, 4)[1], "rnnt_alpha": rl.work(B, T, U1)[1]}
    return gemm, kernels


def _jax_tiny_loss_forward_flops(fs):
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, scan_layers=False, frozen_till=1))
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    sc = JStepConfig(frontend=JFrontendConfig(n_mels=jcfg.encoder.feat_in),
                     rnnt_chunk_size=64, uniform_lang_head=True, rnnt_remat="none")
    b = {k: jnp.asarray(v.cpu().numpy()) for k, v in fs.batch.items()
         if k in ("audio", "audio_len", "tokens", "token_len", "lang_ids")}

    def fwd(params, batch_stats):
        return jax_forward_loss(model, jcfg, sc, params, batch_stats, b["audio"],
                                b["audio_len"], b["tokens"], b["token_len"], b["lang_ids"],
                                jax.random.PRNGKey(0), train=True)[0]

    cost = jax.jit(fwd).lower(variables["params"], variables["batch_stats"]).compile()
    cost = cost.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def test_flops_audit_of_a_tiny_step_is_the_analytic_sum(capsys):
    fs = _tiny_step()
    programs = flops_audit.audit(fs)
    gemm, kernels = _analytic_loss_forward(_tiny_step())
    fwd = programs["loss_fwd"]
    assert fwd["counted_flops"] == gemm
    assert {k: v["flops"] for k, v in fwd["kernels"].items()} == kernels
    assert fwd["flops"] == gemm + sum(kernels.values())
    assert fwd["launches"] == dict.fromkeys(fwd["launches"], 0)  # none on the CPU
    # the backward adds the trainable layer's and the heads' products, the
    # flash and lattice backward; AdamW adds none the counter sees
    step, fb = programs["full_step"], programs["fwd_bwd"]
    assert step["flops"] == fb["flops"] > fwd["flops"]
    assert fb["kernels"]["flash_relpos_mhsa_backward"]["calls"] == 1  # one trainable layer
    assert fb["kernels"]["rnnt_beta"]["calls"] == 1
    jax_flops = _jax_tiny_loss_forward_flops(fs)
    ratio = fwd["flops"] / jax_flops
    print(f"tiny loss forward: port {fwd['flops']} FLOPs, XLA cost_analysis {jax_flops:.0f},"
          f" ratio {ratio:.4f}")
    assert RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio


def test_bench_eval_tiny_gives_a_line_per_decoder(capsys, monkeypatch):
    calls = {"fused": 0, "beam_fused": 0}
    for name, attr in (("fused", "rnnt_greedy_decode_fused"),
                       ("beam_fused", "rnnt_beam_search_fused")):
        wrapped = getattr(bench_eval, attr)

        def counted(*a, _w=wrapped, _n=name, **k):
            calls[_n] += 1
            return _w(*a, **k)
        monkeypatch.setattr(bench_eval, attr, counted)
    recs = bench_eval.main(["--tiny", "--batch", "2", "--secs", "1", "--iters", "1",
                            "--beam_size", "2", "--max_expansions", "2", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines == recs
    assert [r["decoder"] for r in recs] == list(bench_eval.DECODERS)
    for r in recs:
        assert r["metric"] == "eval_utts_per_sec" and r["device"] == "cpu"
        assert r["value"] > 0 and r["batch_ms"] > 0
    # each timed once, after the first call and one warmup
    assert calls == {"fused": 3, "beam_fused": 3}
    with pytest.raises(ValueError, match="decoder"):
        bench_eval.main(["--tiny", "--decoders", "greedy", "--device", "cpu"])
