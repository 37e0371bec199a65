"""Host ms of detokenisation and WER per decoded batch in the WER pass
(the port's spans ``asr.eval.detokenize``, each batch's ``ids_to_text``,
and ``asr.eval.wer``, each set's ``wer``), over the record's decoded
batches. Traced runs only."""

from cl_bench.spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "eval", "asr.eval.detokenize", "asr.eval.wer")
