"""Host ms a training step spends in its backward (the port's span
``asr.backward`` around ``torch.autograd.grad`` of the loss), over the
record's steps. Traced runs only."""

from cl_bench.spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "train", "asr.backward")
