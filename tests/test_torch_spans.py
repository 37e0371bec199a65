"""The port's spans (``utils/profiling.py:span``) at its layer boundaries,
on the CPU at ``tiny_config()`` sizes:

  * a naive train step fed by ``BatchPipeline`` under ``torch.profiler``
    (every thread recorded): each phase span once a step, in the step's
    order, none inside another, the backward's autograd ops inside
    ``asr.backward``, and ``asr.data.assemble`` on the producer thread;
    ``SPANS`` holds the same counts and the batch's shape;
  * an LwF step at task 1: the student's and the teacher's forward phases,
    one backward and one AdamW step;
  * ``Transcriber.compute_wer`` with each greedy decoder: the eval spans
    once a batch (WER once a set), none inside another, the encoded rows
    those of the batches;
  * with no profiler running, a step and a transcription enter no
    ``record_function`` and ``span`` returns one shared no-op; an ``args``
    callable is called only under a profiler;
  * ``SpanTotals`` loses no update under many threads.
"""

import collections
import dataclasses
import sys
import threading

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from indic_cl_asr_torch.audio.features import FrontendConfig
from indic_cl_asr_torch.cl import lwf as L
from indic_cl_asr_torch.cl import methods as CM
from indic_cl_asr_torch.data.pipeline import BatchPipeline, BucketSpec
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
from indic_cl_asr_torch.train.eval import Transcriber
from indic_cl_asr_torch.train.state import make_optimizer
from indic_cl_asr_torch.train.step import StepConfig, batch_to_device_dict, make_train_step
from indic_cl_asr_torch.utils import profiling
from indic_cl_asr_torch.utils.profiling import SPANS, span

from .synth import make_tokenizer, make_wav_dataset

LANGS = ["hindi"]
B = 2
SPEC = BucketSpec(boundaries_sec=(2.0,), max_tokens=(32,))
# the phase spans of a training step, in the order the step opens them
STEP_PHASES = ("asr.frontend", "asr.encoder", "asr.predict", "asr.rnnt_loss", "asr.ctc_loss",
               "asr.backward", "asr.optimizer")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    entries = make_wav_dataset(str(root), LANGS, n_per_lang=4, min_dur=1.0, max_dur=1.9,
                               max_words=2)["hindi"]
    tok = make_tokenizer(LANGS)
    cfg = tiny_config(vocab_size_total=tok.tokenizers_dict["hindi"].vocab_size, n_langs=1)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, frozen_till=1))
    torch.manual_seed(0)
    model = HybridRNNTCTC(cfg, device="cpu")
    opt = make_optimizer(model, freeze_encoder_till=1, device="cpu")
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32), rnnt_chunk_size=8,
                          uniform_lang_head=True)
    return dict(entries=entries, tok=tok, model=model, opt=opt, step_cfg=step_cfg)


def _pipeline(w):
    return BatchPipeline(w["entries"], w["tok"], LANGS, B, spec=SPEC, shuffle=True, seed=1)


def _train(w, step, n_steps=None):
    """Steps over one epoch of the pipeline; the number taken."""
    n = 0
    for batch in _pipeline(w):
        step(batch_to_device_dict(batch, "cpu"), torch.Generator().manual_seed(n))
        n += 1
        if n == n_steps:
            break
    return n


def _profiled(fn):
    """(fn's result, the profiler's events), every thread recorded."""
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        out = fn()
    return out, prof.events()


def _asr(events):
    return [e for e in events if e.name.startswith("asr.")]


def _parent(e):
    """The innermost ``asr.`` span that ``e`` opened in, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("asr."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_train_step_phases_once_a_step_and_the_producer_has_its_own(world):
    step = make_train_step(world["model"], world["step_cfg"], world["opt"], device="cpu")
    steps, events = _profiled(lambda: _train(world, step))
    assert steps == 2
    spans = _asr(events)
    count = collections.Counter(e.name for e in spans)
    assert count == {**{n: steps for n in STEP_PHASES}, "asr.data.assemble": steps}
    # no span opens inside another, so each is the outermost op of its phase
    assert {_parent(e) for e in spans} == {None}
    main = {e.thread for e in spans if e.name == "asr.optimizer"}
    phases = sorted((e for e in spans if e.thread in main), key=lambda e: e.time_range.start)
    assert [e.name for e in phases] == list(STEP_PHASES) * steps
    assert any(_parent(e) == "asr.backward" for e in events if "Backward" in e.name)
    producer = {e.thread for e in spans if e.name == "asr.data.assemble"}
    assert producer and not producer & main
    rec = SPANS.as_dict()
    assert {n: v["count"] for n, v in rec.items()} == count
    assert rec["asr.data.assemble"]["args"] == {f"B={B} S=32000 U=32": steps}
    assert all(rec[n]["seconds"] > 0 for n in STEP_PHASES)


def test_lwf_step_spans_the_student_and_the_teacher(world):
    model, opt, step_cfg = world["model"], world["opt"], world["step_cfg"]
    method = CM.LwFMethod(L.LwFConfig(0.3, 0.5), model, step_cfg, opt)
    method.end_task(None, 0, 0)
    step = method.make_train_step(None, 1)
    _, events = _profiled(lambda: _train(world, step, n_steps=1))
    spans = _asr(events)
    assert {_parent(e) for e in spans} == {None}
    count = collections.Counter(e.name for e in spans if e.name != "asr.data.assemble")
    # the teacher's forward opens the forward phases a second time; its
    # distillation losses sit between the spans
    assert count == {"asr.frontend": 2, "asr.encoder": 2, "asr.predict": 2,
                     "asr.rnnt_loss": 1, "asr.ctc_loss": 1, "asr.backward": 1,
                     "asr.optimizer": 1}


@pytest.mark.parametrize("decoder", ["rnnt", "ctc"])
def test_transcription_spans_once_a_batch_and_encode_the_batches_rows(world, decoder):
    tr = Transcriber(model=world["model"], tokenizer=world["tok"], languages=LANGS,
                     frontend=FrontendConfig(n_mels=32), batch_size=3, bucket_spec=SPEC)
    entries = world["entries"]  # 4: one batch of 3 and one of 1 real row and 2 repeats
    _, events = _profiled(lambda: tr.compute_wer(entries, decoder))
    spans = _asr(events)
    assert {_parent(e) for e in spans} == {None}
    order = [e.name for e in sorted(spans, key=lambda e: e.time_range.start)]
    batch = ["asr.eval.assemble", "asr.eval.encode", "asr.eval.detokenize"]
    assert order == batch * 2 + ["asr.eval.wer"]
    rec = SPANS.as_dict()
    assert rec["asr.eval.encode"]["args"] == {"B=3 real=3 S=32000": 1, "B=3 real=1 S=32000": 1}
    assert rec["asr.eval.assemble"]["args"] == {"B=3 S=32000": 2}


def test_no_profiler_no_record_function(world, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("asr.a") is span("asr.b", lambda: refuse())
    SPANS.clear()
    step = make_train_step(world["model"], world["step_cfg"], world["opt"], device="cpu")
    assert _train(world, step, n_steps=1) == 1
    tr = Transcriber(model=world["model"], tokenizer=world["tok"], languages=LANGS,
                     frontend=FrontendConfig(n_mels=32), batch_size=2, bucket_spec=SPEC)
    assert 0 <= tr.compute_wer(world["entries"], "rnnt")
    assert SPANS.as_dict() == {}


def test_span_args_are_built_only_under_a_profiler():
    calls = []

    def shape():
        calls.append(1)
        return "B=4 S=16000 U=8"

    SPANS.clear()
    with span("asr.x", shape):
        pass
    assert calls == [] and SPANS.as_dict() == {}
    def enter(name, args):
        with span(name, args):
            pass

    _, events = _profiled(lambda: enter("asr.x", shape))
    assert calls == [1] and [e.name for e in _asr(events)] == ["asr.x"]
    assert SPANS.as_dict()["asr.x"]["args"] == {"B=4 S=16000 U=8": 1}
    # a string is taken as it is
    _profiled(lambda: enter("asr.y", "B=1"))
    got = SPANS.as_dict()
    assert list(got) == ["asr.y"] and got["asr.y"]["count"] == 1
    assert got["asr.y"]["args"] == {"B=1": 1} and got["asr.y"]["seconds"] >= 0


def test_span_totals_lose_no_update_across_threads():
    totals = profiling.SpanTotals()
    n_threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            totals.add(f"asr.{i % 2}", 0.5, f"B={i % 3}") for _ in range(per)])
            for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = totals.as_dict()
    assert {n: v["count"] for n, v in got.items()} == {"asr.0": 4000, "asr.1": 4000}
    assert sum(v["seconds"] for v in got.values()) == n_threads * per * 0.5
    assert sum(sum(v["args"].values()) for v in got.values()) == n_threads * per
    totals.clear()
    assert totals.as_dict() == {}
