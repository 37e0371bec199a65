"""Host ms a training step spends in its two losses (the port's spans
``asr.rnnt_loss``, the chunked joint and the lattices, and
``asr.ctc_loss``, in ``train/step.py:hybrid_forward_loss``), over the
record's steps. A phase of the step, not the loss kernels' time: the
host's seconds from each span's entry to its exit, so a blocking wait on
the card inside the span (the CTC loss syncs) holds whatever the card
still had queued, the encoder's and the joint's work among it. Traced
runs only."""

from cl_bench.spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "train", "asr.rnnt_loss", "asr.ctc_loss")
