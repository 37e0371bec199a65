"""Host ms a training step spends in the encoder (the port's span
``asr.encoder`` around ``model.encode`` in ``train/step.py:
hybrid_forward_tensors``), over the record's steps. The traced run's
reading, inflated by the profiler: compare traced runs only."""

from cl_bench.spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "train", "asr.encoder")
