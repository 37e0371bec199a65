"""Op-level time breakdown of the flagship training step (the port's
scripts/profile_step.py).

Captures a ``torch.profiler`` trace (Chrome trace JSON, through
``utils/profiling.py:trace``) of the steady-state flagship step
(``tools/flagship.py``, the JAX package's bench.py working point) and
parses it into:

  * a time split by category of the device kernels' names: GEMM,
    convolution, the port's own kernels by name, cuDNN's LSTM,
    elementwise/reduction, copy/memset, other;
  * the top-K kernels by self time, each with its roofline verdict
    (``bound_by``, achieved bytes/s and FLOP rate) for the port's kernels,
    from the analytic work their wrappers report while the trace runs
    (``utils/profiling.py:KernelWork``, the functions of their bounds);
    every other kernel gets ``"?"``;
  * the device self time beside the wall time of as many unprofiled steps,
    and the idle share 1 - device busy / wall.

Without a card (``--device cpu``) the rows are the host operations by self
time, and there is no idle share.

Usage:
    python -m indic_cl_asr_torch.scripts.profile_step [--steps 5] [--top 25]
        [--json out.json] [--logdir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

import torch

from ..device import resolve_device
from ..ops import _build
from ..tools.flagship import flagship_step
from ..utils.profiling import KernelWork, trace

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak (the kernel table's bar)

# the port's kernels: a substring of the kernel's name -> (category, the
# wrapper whose analytic work the kernel carries, or None for a helper
# kernel of a wrapper whose work another kernel carries)
PORT_KERNELS = (
    ("flash_relpos_fwd", "flash attention forward", "flash_relpos_mhsa"),
    ("flash_relpos_bwd", "flash attention backward", "flash_relpos_mhsa_backward"),
    ("bwd_finish_kernel", "flash attention backward", None),
    ("alpha_warp_kernel", "rnnt lattice", "rnnt_alpha"),
    ("alpha_block_kernel", "rnnt lattice", "rnnt_alpha"),
    ("beta_warp_kernel", "rnnt lattice", "rnnt_beta"),
    ("beta_block_kernel", "rnnt lattice", "rnnt_beta"),
    ("joint_logits_lse_kernel", "fused joint", "joint_fused_forward"),
    ("joint_dlogits_dx_kernel", "fused joint", "joint_fused_backward"),
    ("joint_", "fused joint", None),
    ("rnnt_greedy_decode_kernel", "fused greedy decode", "rnnt_greedy_decode_fused"),
    ("rnnt_beam_kernel", "fused beam", "rnnt_beam_search_fused"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _has(name: str, *subs: str) -> bool:
    return any(s in name for s in subs)


def category(name: str, cat: str = "kernel") -> str:
    """The category of a device event (``cat`` its trace category) by
    substrings of its name: cuBLAS/cuDNN names are mangled C++, the port's
    kernels plain names."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    for sub, what, _ in PORT_KERNELS:
        if sub in name:
            return what
    low = name.lower()
    if _has(low, "lstm", "rnn_", "persist"):
        return "lstm (cuDNN)"
    if _has(low, "fprop", "dgrad", "wgrad", "conv", "winograd"):
        return "convolution"
    if _has(low, "gemm", "nvjet", "cutlass", "xmma", "cublas", "splitk", "gemv"):
        return "gemm"
    if _has(low, "copy", "memset", "memcpy", "fill"):
        return "copy/memset"
    if _has(low, "at::native", "elementwise", "reduce", "softmax", "norm", "index",
            "scatter", "gather", "cat_", "where", "bn_"):
        return "elementwise/reduction"
    return "other"


def host_category(name: str) -> str:
    """The category of a host operation (a CPU-only trace) by its name."""
    op = name.removeprefix("aten::")
    if op in ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "einsum", "dot", "mv"):
        return "gemm"
    if "conv" in op:
        return "convolution"
    if "lstm" in op:
        return "lstm"
    if op in ("copy_", "_to_copy", "to", "fill_", "zero_", "clone", "contiguous", "empty",
              "empty_like", "zeros", "zeros_like", "full", "cat", "stack", "pad"):
        return "copy/memset"
    return "elementwise/reduction" if name.startswith("aten::") else "other"


def _capture(steps: int, logdir: str, device) -> None:
    """Trace ``steps`` flagship steps into ``logdir`` (after two untraced
    steps and ``steps`` timed ones), with the port's kernel work and the
    unprofiled wall time in ``capture.json`` beside the trace."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _build.build()
    fs = flagship_step(dev)
    gen = torch.Generator().manual_seed(0)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(2):  # kernel loads, cuBLAS handles, the allocator's blocks
        fs.step(fs.batch, gen)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fs.step(fs.batch, gen)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with KernelWork() as work, trace(logdir, dev):
        for _ in range(steps):
            aux = fs.step(fs.batch, gen)
        float(aux["train_loss"])  # a host read inside the trace window
    with open(os.path.join(logdir, "capture.json"), "w") as f:
        json.dump({"steps": steps, "wall_ms": wall_ms,
                   "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "work": work.as_dict()}, f)


def _traces(logdir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(logdir, "**", "trace-*.json"), recursive=True))


def _host_self_times(ops: list[dict]) -> list[float]:
    """Each host op's self time: its duration less its direct children's
    (ops nest by time within a thread)."""
    self_us = [float(e["dur"]) for e in ops]
    by_tid = collections.defaultdict(list)
    for i, e in enumerate(ops):
        by_tid[(e["pid"], e["tid"])].append(i)
    for idx in by_tid.values():
        idx.sort(key=lambda i: (ops[i]["ts"], -ops[i]["dur"]))
        stack: list[int] = []
        for i in idx:
            while stack and ops[i]["ts"] >= ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"]:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= float(ops[i]["dur"])
            stack.append(i)
    return self_us


def rows_from_trace(events: list[dict], work: dict | None = None) -> list[dict]:
    """Rows of the JAX script's hlo_stats table (its keys) from Chrome trace
    events: one per device kernel name, or per host operation when the
    trace holds no device event; ``work`` (``KernelWork.as_dict()`` of the
    traced window) gives the port's kernels their bound and rates."""
    work = work or {}
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if dev:
        launcher = {e.get("args", {}).get("External id"): e["name"] for e in ops}
        named = [(e["name"], float(e["dur"]), category(e["name"], e["cat"]),
                  launcher.get(e.get("args", {}).get("External id"))) for e in dev]
    else:
        named = [(e["name"], t, host_category(e["name"]), None)
                 for e, t in zip(ops, _host_self_times(ops))]
    agg: dict[str, dict] = {}
    for name, us, cat, op in named:
        r = agg.setdefault(name, {"hlo_op_name": name, "category": cat, "total_self_time": 0.0,
                                  "occurrences": 0, "bound_by": "?", "measured_memory_bw": None,
                                  "model_flop_rate": None, "tf_op_name": op})
        r["total_self_time"] += us
        r["occurrences"] += 1
    for r in agg.values():
        wrapper = next((w for sub, _, w in PORT_KERNELS if sub in r["hlo_op_name"]), None)
        w = work.get(wrapper) if dev else None
        if w and r["total_self_time"] > 0:
            ns = r["total_self_time"] * 1e3
            r["measured_memory_bw"] = w["bytes"] / ns          # GB/s
            r["model_flop_rate"] = w["flops"] / ns             # GFLOP/s
            r["bound_by"] = ("bytes" if w["bytes"] / PEAK_BYTES_PER_S
                             >= w["flops"] / PEAK_FLOPS else "operations")
    return list(agg.values())


def _rows(logdir: str) -> list[dict]:
    paths = _traces(logdir)
    if not paths:
        raise SystemExit(f"no trace-*.json under {logdir}")
    with open(paths[-1]) as f:
        events = json.load(f)["traceEvents"]
    capture = _capture_info(logdir)
    return rows_from_trace(events, capture.get("work"))


def _capture_info(logdir: str) -> dict:
    path = os.path.join(logdir, "capture.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _summarize(rows: list[dict], top: int) -> dict:
    total = sum(r["total_self_time"] or 0.0 for r in rows)
    by_cat: dict[str, float] = {}
    by_bound: dict[str, float] = {}
    for r in rows:
        t = r["total_self_time"] or 0.0
        by_cat[r["category"]] = by_cat.get(r["category"], 0.0) + t
        by_bound[r["bound_by"] or "?"] = (
            by_bound.get(r["bound_by"] or "?", 0.0) + t
        )
    cats = sorted(by_cat.items(), key=lambda kv: -kv[1])
    ops = sorted(rows, key=lambda r: -(r["total_self_time"] or 0.0))[:top]
    return {
        "total_self_time_us": total,
        "by_category": [
            {"category": c, "us": round(t, 1), "pct": round(100 * t / total, 2)}
            for c, t in cats
        ],
        "by_bound": {
            k: round(100 * v / total, 2) for k, v in by_bound.items()
        },
        "top_ops": [
            {
                "op": r["hlo_op_name"],
                "category": r["category"],
                "us": round(r["total_self_time"] or 0.0, 1),
                "pct": round(
                    100 * (r["total_self_time"] or 0.0) / total, 2
                ),
                "occurrences": int(r["occurrences"] or 0),
                "bound_by": r["bound_by"],
                "hbm_gbps": round(r["measured_memory_bw"] or 0.0, 1),
                "gflops": round(r["model_flop_rate"] or 0.0, 1),
                "tf_op": (r["tf_op_name"] or "")[:120],
            }
            for r in ops
        ],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--logdir", default=None, help="reuse an existing trace")
    ap.add_argument("--json", default=None, help="write full summary here")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    logdir = args.logdir
    if logdir is None or not _traces(logdir):
        logdir = logdir or tempfile.mkdtemp(prefix="indic_asr_profile_")
        print(f"# capturing {args.steps} steps -> {logdir}", file=sys.stderr)
        _capture(args.steps, logdir, dev)

    rows = _rows(logdir)
    summary = _summarize(rows, args.top)
    info = _capture_info(logdir)
    on_device = info.get("device", "cpu") != "cpu"
    busy_ms = summary["total_self_time_us"] / 1e3
    summary.update(device=info.get("device"), steps=info.get("steps", args.steps),
                   wall_ms=info.get("wall_ms"), logdir=logdir)
    line = (f"{'device' if on_device else 'host'} self time: {busy_ms:.2f} ms "
            f"({summary['steps']} steps)")
    if on_device and summary["wall_ms"]:
        summary["idle_share"] = 1 - busy_ms / summary["wall_ms"]
        line += (f"; wall {summary['wall_ms']:.2f} ms unprofiled, idle share "
                 f"{summary['idle_share']:.3f}")
    print(line)
    print("\nby category:")
    for c in summary["by_category"]:
        print(f"  {c['pct']:6.2f}%  {c['us'] / 1e3:9.3f} ms  {c['category']}")
    print("\nby roofline bound:")
    for k, pct in sorted(summary["by_bound"].items(), key=lambda kv: -kv[1]):
        print(f"  {pct:6.2f}%  {k}")
    print(f"\ntop {args.top} ops by self time:")
    for o in summary["top_ops"]:
        print(
            f"  {o['pct']:5.2f}%  {o['us'] / 1e3:8.3f} ms x{o['occurrences']:<4d}"
            f" [{o['bound_by']:>10s}] {o['op'][:100]}"
            f"  (bw {o['hbm_gbps']} GB/s, {o['gflops']} GFLOP/s)"
        )
        if o["tf_op"]:
            print(f"          {o['tf_op']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
