"""Share (%) of the flash rel-pos attention forward's roofline in the WER
pass: the least time of every layer's forward of every decoded batch, over
the device time of the forward kernels."""

from cl_bench.metrics import device_seconds
from cl_bench.work import bound_s, flash_forward

PATTERNS = ("flash_relpos_fwd",)


def read(rec):
    if rec["kind"] != "eval":
        return None
    t = device_seconds(rec, PATTERNS)
    if t <= 0:
        return None
    m = rec["model"]
    need = sum(m["n_layers"] * bound_s(*flash_forward(b["B"], b["T"], m["d_model"], b["lens"]))
               for b in rec["batches"])
    return 100.0 * need / t
