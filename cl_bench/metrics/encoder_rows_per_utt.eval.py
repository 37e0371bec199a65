"""Real rows the encoder ran per distinct utterance of the WER pass: the
``real`` of every ``asr.eval.encode`` span (the padded repeat rows left
out) over the pass's utterances, which are the record's attempted
decodes (one an utterance and decoder) over the decoders of its batches.
1 is each utterance encoded once; ``run_eval``'s two greedy decoders
encode it twice."""

from cl_bench.spans import arg_sum, recorded


def read(rec):
    spans = recorded(rec, "eval")
    if not spans:
        return None
    utts = rec["attempted"] / len({b["decoder"] for b in rec["batches"]})
    rows = arg_sum(spans, "asr.eval.encode", "real")
    return rows / utts if utts and rows else None
