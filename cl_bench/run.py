"""Run one cell of the port's benchmark once and print its result line.

    python3 -m cl_bench.run --workload <config>.<mix> --seed N --seconds S --trace 0|1

The cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``) are found by name. The benchmark makes the
traffic and the weights from the seed (and calibrates the eval cell's
blank biases); then set-up, which ``setup_s`` times, builds the port's
model, step or transcriber on them and runs its first passes (every
shape, and the steps the check follows).
``--trace 0`` then measures the cell's end-to-end metrics over the whole
passes that fit in ``--seconds``; ``--trace 1`` profiles a fixed number
of passes and reports the per-layer metrics that BENCHMARK.json names for
the cell. Then the program is freed and the plain reference decides
``correct``. The last stdout line is the result; the numbers compared are
the last stderr lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
THREADS = 1  # torch's intra-op threads on the host, whatever its core count
FORBIDDEN = {"jax", "jaxlib", "flax", "indic_cl_asr_tpu"}


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "cl_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or the
    per-layer ones whose end-to-end metric it reports."""
    def has(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if has(m) and m["moves"] in names]


def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(workload: str, seed: int, seconds: float, trace: bool, device=None, overrides=None,
        mix_overrides=None, hooks=None) -> dict:
    """One run of ``workload``; the result as a dict. ``device``,
    ``overrides`` ({section: {key: value}}, merged into the configuration),
    ``mix_overrides`` (into the mix) and ``hooks`` (``step_wrapper(step,
    optimizer)`` / ``decode_wrapper(decode_batch)`` around the timed path)
    serve the harness's own tests."""
    from . import check
    from .cells import EvalCell, TrainCell
    from .metrics import reader
    from .trace import reduce_events
    from .work import tf32_off

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg, mix = load("configs", wl["config"]), load("traffic", wl["traffic"])
    for section, values in (overrides or {}).items():
        cfg[section].update(values)
    mix.update(mix_overrides or {})
    hooks = hooks or {}
    torch.set_num_threads(THREADS)
    tf32_off()
    train = mix["kind"] == "train"
    cell = (TrainCell if train else EvalCell)(workload, cfg, mix, seed, device)
    cell.prepare()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cell.setup(hooks.get("step_wrapper" if train else "decode_wrapper"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    metrics, extra, extra_keys = {}, {}, {}
    wanted = cell_metrics(bench, workload, trace)
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            wall, rec = cell.traced()
        red = reduce_events(prof.events(), wall)
        rec.update(red, model=cfg["model"], train=cfg["train"], frontend=cfg["frontend"])
        for m in wanted:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = rec["attempted"], rec["failed"]
        extra = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    else:
        res = cell.window(seconds)
        res["metrics"]["setup_s"] = setup_s
        for m in wanted:
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
        attempted, failed = res["attempted"], res["failed"]
        breakdown = None
        extra_keys = {"window": res["window"]}
    dev_info = device_info(device, wl["chips"])
    dev_info.update(extra)
    cell.free()

    limits = check.load_limits(workload)
    if train:
        prog = cell.program_readings()
        ref = check.train_reference(cfg, mix, seed, cell.check_steps, cell.by_samples, device)
        numbers = check.train_numbers(prog, ref)
    else:
        picked = check.sample(cell.utts, seed)
        seqs = {}
        for n in picked:
            for d in ("rnnt", "ctc"):
                got = cell.answers.get((d, n))
                if got:
                    seqs[(d, n)] = got[0]
        ref, out = check.eval_reference(cfg, mix, seed, cell.biases, picked, cell.by_samples,
                                        device)
        numbers = check.eval_numbers(ref, out, seqs, cfg["decode"], device)
        numbers["missing_answers"] = float(check.eval_answers(cell.answers, cell.utts))
    cell.cleanup()
    correct, rows = check.judge(numbers, limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(extra_keys, setup={"seconds": setup_s})
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cl_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    cache_dirs()
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    bad = forbidden_modules()
    if bad:
        print(f"cl_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
