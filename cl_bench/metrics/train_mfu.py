"""The whole training step's share (%) of the card's bf16 peak: the
benchmark's own operation count of each traced step (forward, and the
backward of what trains, no recomputation) over the traced window."""

from cl_bench.work import PEAK_FLOPS, train_step_flops


def read(rec):
    if rec["kind"] != "train" or not rec["steps"] or rec["window_s"] <= 0:
        return None
    flops = sum(train_step_flops(rec["model"], rec["train"], rec["frontend"], s["B"], s["S"],
                                 s["lens"], s["U1"]) for s in rec["steps"])
    return 100.0 * flops / (rec["window_s"] * PEAK_FLOPS)
