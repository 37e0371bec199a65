"""Host ms the WER pass takes to assemble one batch and copy it to the
card (the port's span ``asr.eval.assemble`` in ``Transcriber.transcribe``:
WAV read, pad, tokenise, three host-to-device copies), over the batches.
Traced runs only."""

from cl_bench.spans import ms_each


def read(rec):
    return ms_each(rec, "eval", "asr.eval.assemble")
