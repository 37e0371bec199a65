"""Share (%) of the RNNT alpha/beta lattice kernels' roofline: one alpha
and one beta a step over the slabs' [B, T, U+1], over their device time."""

from cl_bench.metrics import device_seconds
from cl_bench.work import bound_s, lattice

PATTERNS = ("alpha_warp_kernel", "alpha_block_kernel", "beta_warp_kernel", "beta_block_kernel")


def read(rec):
    if rec["kind"] != "train":
        return None
    t = device_seconds(rec, PATTERNS)
    if t <= 0:
        return None
    need = sum(bound_s(*lattice(s["B"], s["T"], s["U1"])) +
               bound_s(*lattice(s["B"], s["T"], s["U1"], beta=True)) for s in rec["steps"])
    return 100.0 * need / t
