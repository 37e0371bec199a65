"""Host ms the data producer takes to assemble one training batch (the
port's span ``asr.data.assemble`` around ``_assemble`` on
``BatchPipeline``'s producer thread: WAV read, pad, tokenise), over the
batches it assembled, which may run ahead of the steps; beside
``data_wait_ms.train``, the consumer's wait. Traced runs only."""

from cl_bench.spans import ms_each


def read(rec):
    return ms_each(rec, "train", "asr.data.assemble")
