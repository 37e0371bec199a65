"""Share (%) of the fused greedy RNNT decode's roofline: each launch's
least time for the joint evaluations and LSTM steps its returned tokens
imply (a joint a frame and an emission, an LSTM step an emission and the
start), over the device time of the decode kernel."""

from cl_bench.metrics import device_seconds
from cl_bench.work import bound_s, greedy_decode

PATTERNS = ("rnnt_greedy_decode_kernel",)


def read(rec):
    if rec["kind"] != "eval":
        return None
    t = device_seconds(rec, PATTERNS)
    if t <= 0:
        return None
    m = rec["model"]
    V1 = m["vocab_size_total"] // m["n_langs"] + 1
    need = sum(bound_s(*greedy_decode(b["B"], b["T"], m["joint_hidden"], m["pred_hidden"], V1,
                                      b["joint_evals"], b["lstm_steps"]))
               for b in rec["batches"] if b["decoder"] == "rnnt")
    return 100.0 * need / t
