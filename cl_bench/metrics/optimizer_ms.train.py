"""Host ms a training step spends in AdamW (the port's span
``asr.optimizer`` around ``optimizer.step``), over the record's steps.
Traced runs only."""

from cl_bench.spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "train", "asr.optimizer")
