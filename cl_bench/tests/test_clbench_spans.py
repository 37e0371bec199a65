"""The readers of the port's spans (``cl_bench/spans.py`` and the eight
``metrics/*.py`` that use it) on synthetic span totals: each gives its
value from what the program recorded over the record's steps or batches,
and None where the record is of the other kind, where the program
recorded no span, where the loaded program keeps no totals at all (one
older than its spans), and where the totals hold more than the record's
window."""

import sys

import pytest

from cl_bench.metrics import reader
from cl_bench.spans import PROGRAM

STEPS = 8
TRAIN = {"kind": "train", "steps": [{}] * STEPS}
# two sets of 128 through each of two decoders, in batches of 64
BATCHES = [{"decoder": d} for d in ("rnnt", "ctc") for _ in range(4)]
EVAL = {"kind": "eval", "batches": BATCHES, "attempted": 2 * 256}


def _train_spans(totals):
    for _ in range(STEPS):
        totals.add("asr.frontend", 0.004, None)
        totals.add("asr.encoder", 0.030, None)
        totals.add("asr.predict", 0.006, None)
        totals.add("asr.rnnt_loss", 0.015, None)
        totals.add("asr.ctc_loss", 0.005, None)
        totals.add("asr.backward", 0.100, None)
        totals.add("asr.optimizer", 0.020, None)
    for _ in range(STEPS + 2):  # the producer may assemble ahead of the steps
        totals.add("asr.data.assemble", 0.012, "B=16 S=64000 U=64")


def _eval_spans(totals):
    for _ in range(2):  # decoders
        for _ in range(2):  # sets
            totals.add("asr.eval.wer", 0.004, None)
            for _ in range(2):  # batches
                totals.add("asr.eval.assemble", 0.025, "B=64 S=267200")
                totals.add("asr.eval.encode", 0.05, "B=64 real=64 S=267200")
                totals.add("asr.eval.detokenize", 0.003, None)


TRAIN_WANT = {
    "encoder_ms.train": 30.0,
    "loss_ms.train": 20.0,
    "backward_ms.train": 100.0,
    "optimizer_ms.train": 20.0,
    "assemble_ms.train": 12.0,
}
EVAL_WANT = {
    "assemble_ms.eval": 25.0,
    # 8 batches' detokenisation (3 ms) and 4 sets' WER (4 ms) over 8 batches
    "detok_wer_ms.eval": 1e3 * (8 * 0.003 + 4 * 0.004) / 8,
    "encoder_rows_per_utt.eval": 2.0,
}


@pytest.fixture
def totals():
    from indic_cl_asr_torch.utils.profiling import SPANS

    SPANS.clear()
    yield SPANS
    SPANS.clear()


@pytest.mark.parametrize("name", sorted(TRAIN_WANT) + sorted(EVAL_WANT))
def test_each_reader_reads_the_programs_spans(totals, name):
    read = reader(name)
    train = name in TRAIN_WANT
    rec, other = (TRAIN, EVAL) if train else (EVAL, TRAIN)
    assert read(rec) is None  # nothing recorded
    (_train_spans if train else _eval_spans)(totals)
    want = (TRAIN_WANT if train else EVAL_WANT)[name]
    assert read(rec) == pytest.approx(want, rel=1e-12)
    assert read(other) is None


@pytest.mark.parametrize("name", sorted(TRAIN_WANT) + sorted(EVAL_WANT))
def test_totals_of_two_windows_read_none(totals, name):
    """A process that traced two windows holds both windows' spans; the
    once-a-unit span then counts twice the record's units."""
    fill = _train_spans if name in TRAIN_WANT else _eval_spans
    fill(totals)
    fill(totals)
    assert reader(name)(TRAIN if name in TRAIN_WANT else EVAL) is None


def test_a_program_without_span_totals_reads_none(totals, monkeypatch):
    _train_spans(totals)
    _eval_spans(totals)
    monkeypatch.delattr(sys.modules[PROGRAM], "SPANS")
    for name in TRAIN_WANT:
        assert reader(name)(TRAIN) is None
    for name in EVAL_WANT:
        assert reader(name)(EVAL) is None
    monkeypatch.delitem(sys.modules, PROGRAM)
    assert reader("encoder_ms.train")(TRAIN) is None


def test_padded_rows_are_not_utterances(totals):
    """A last batch of 40 real rows and 24 repeats: the repeats are encoded
    but counted apart, so one decoder over 104 utterances reads 1."""
    rec = {"kind": "eval", "batches": [{"decoder": "rnnt"}] * 2, "attempted": 104}
    for real in (64, 40):
        totals.add("asr.eval.encode", 0.05, f"B=64 real={real} S=267200")
        totals.add("asr.eval.detokenize", 0.003, None)
    assert reader("encoder_rows_per_utt.eval")(rec) == 1.0
