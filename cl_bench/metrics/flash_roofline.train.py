"""Share (%) of the flash rel-pos attention kernels' roofline in training:
the least time of every forward (all layers) and backward (the trainable
layers) the traced steps need, over the device time of those kernels."""

from cl_bench.metrics import device_seconds
from cl_bench.work import bound_s, flash_backward, flash_forward

PATTERNS = ("flash_relpos_fwd", "flash_relpos_bwd", "bwd_finish_kernel")


def read(rec):
    if rec["kind"] != "train":
        return None
    t = device_seconds(rec, PATTERNS)
    if t <= 0:
        return None
    m, F = rec["model"], rec["train"]["freeze_encoder_till"]
    need = 0.0
    for s in rec["steps"]:
        need += m["n_layers"] * bound_s(*flash_forward(s["B"], s["T"], m["d_model"], s["lens"]))
        need += (m["n_layers"] - F) * bound_s(*flash_backward(s["B"], s["T"], m["d_model"], s["lens"],
                                                              m["n_heads"]))
    return 100.0 * need / t
