"""Readings that set a cell's limits, on the card at the cell's own size:
the program's numbers over many seeds (the lower readings), the control's
(the plain reference in float8 put in the program's place) and, for a
training cell, a planted fault's (half of each batch left out, the mean
taken over the rest) over a few (the upper readings).

    python3 -m cl_bench.limits --workload <name> --seeds 101,102,... [--control 3] [--out FILE]

One JSON line a seed. Benchmark runs never run this: it is how the
numbers in ``limits/<workload>.json`` were read.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check
from .cells import EvalCell, TrainCell
from .run import THREADS, cache_dirs, load
from .work import encoder_frames, mel_frames, tf32_off


class QuickTrain(TrainCell):
    WARMUP_EPOCHS = 1  # the epoch the check follows, no more


def train_seed(name, cfg, mix, seed, device, control: bool) -> dict:
    cell = QuickTrain(name, cfg, mix, seed, device)
    cell.prepare()
    cell.setup()
    prog = cell.program_readings()
    cell.free()
    ref = check.train_reference(cfg, mix, seed, cell.check_steps, cell.by_samples, device)
    out = {"seed": seed, "program": check.train_numbers(prog, ref, True)}
    if control:
        fp8 = check.train_reference(cfg, mix, seed, cell.check_steps, cell.by_samples, device,
                                    prec="fp8")
        out["control"] = check.train_numbers(fp8, ref, True)
        half = check.train_reference(cfg, mix, seed, cell.check_steps, cell.by_samples, device,
                                     rows=mix["batch_size"] // 2)
        out["half_batch"] = check.train_numbers(half, ref, True)
    cell.cleanup()
    return out


def eval_seed(name, cfg, mix, seed, device, control: bool) -> dict:
    cell = EvalCell(name, cfg, mix, seed, device)
    cell.prepare()
    cell.setup()  # its warm-up pass is the pass judged
    cell.free()
    picked = check.sample(cell.utts, seed)
    seqs = {(d, n): cell.answers[(d, n)][0] for n in picked for d in ("rnnt", "ctc")}
    dec = cfg["decode"]
    ref, out = check.eval_reference(cfg, mix, seed, cell.biases, picked, cell.by_samples, device)
    # RNNT tokens a valid encoder frame over every row of the pass, as
    # emit_per_frame.eval reads it
    emitted = sum(len(cell.answers[("rnnt", u.samples)][0]) for u in cell.utts)
    frames = sum(encoder_frames(mel_frames(u.samples), cfg["model"]) for u in cell.utts)
    res = {"seed": seed, "program": check.eval_numbers(ref, out, seqs, dec, device),
           "emit_per_frame": emitted / frames, "biases": cell.biases}
    if control:
        ref8, out8 = check.eval_reference(cfg, mix, seed, cell.biases, picked, cell.by_samples,
                                          device, prec="fp8")
        ctrl = check.control_seqs(ref8, out8, picked, dec)
        res["control"] = check.eval_numbers(ref, out, ctrl, dec, device)
    cell.cleanup()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cache_dirs()
    torch.set_num_threads(THREADS)
    tf32_off()
    bench = json.loads((check.HERE.parent / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg, mix = load("configs", wl["config"]), load("traffic", wl["traffic"])
    device = torch.device("cuda:0")
    one = train_seed if mix["kind"] == "train" else eval_seed
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = one(args.workload, cfg, mix, seed, device, i < args.control)
        res["seconds"] = time.perf_counter() - t0
        line = json.dumps(res)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
