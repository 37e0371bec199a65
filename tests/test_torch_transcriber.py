"""Port parity end to end: the PyTorch ``Transcriber`` (log-mel -> encoder
-> greedy RNNT (frame-sync or label-looping), greedy CTC or a beam ->
detokenize) against the JAX package's ``Transcriber`` on a few synthetic
WAVs in two languages, with the same weights, at ``tiny_config()`` in f32
on the CPU: identical hypotheses for every decoder, and ``run_eval``'s
metric keys."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.audio.features import FrontendConfig as JaxFrontend
from indic_cl_asr_tpu.data.pipeline import BucketSpec as JaxBuckets
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.train.eval import Transcriber as JaxTranscriber
from indic_cl_asr_torch.audio.features import FrontendConfig
from indic_cl_asr_torch.data.pipeline import BucketSpec
from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
from indic_cl_asr_torch.models.convert import from_jax_variables
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
from indic_cl_asr_torch.train.eval import Transcriber, resolve_decoders, run_eval
from indic_cl_asr_torch.train.step import StepConfig

from .synth import make_texts, make_wav_dataset

LANGS = ["hindi", "tamil"]


class _JitSteps:
    """The flax module with ``pred_step`` and ``joint_step`` jitted: the JAX
    Transcriber's host beam calls them from Python, eagerly otherwise."""

    def __init__(self, model):
        self.model = model
        self.steps = {m: jax.jit(lambda v, *a, m=m: model.apply(v, *a, method=m))
                      for m in ("pred_step", "joint_step")}

    def apply(self, variables, *args, method=None):
        if method in self.steps:
            return self.steps[method](variables, *args)
        return self.model.apply(variables, *args, method=method)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    data = make_wav_dataset(str(root), LANGS, n_per_lang=5, max_dur=1.8)
    tok = MultilingualTokenizer(
        {l: CharTokenizer.train(make_texts(l, 50)) for l in LANGS}
    )
    per = max(t.vocab_size for t in tok.tokenizers_dict.values())
    overrides = dict(vocab_size_total=per * len(LANGS), n_langs=len(LANGS))
    jcfg = jax_tiny_config(**overrides)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    var_np = jax.tree.map(np.asarray, variables)
    port = from_jax_variables(
        HybridRNNTCTC(tiny_config(**overrides), device="cpu"), var_np
    )
    common = dict(batch_size=4, max_symbols=3, max_out=48)
    jt = JaxTranscriber(
        model=model, model_cfg=jcfg, tokenizer=tok, languages=LANGS,
        frontend=JaxFrontend(n_mels=32),
        bucket_spec=JaxBuckets(boundaries_sec=(1.0, 2.0), max_tokens=(48, 64)),
        greedy_impl="framesync", **common,
    )
    pt = Transcriber(
        model=port, tokenizer=tok, languages=LANGS,
        frontend=FrontendConfig(n_mels=32),
        bucket_spec=BucketSpec(boundaries_sec=(1.0, 2.0), max_tokens=(48, 64)),
        **common,
    )
    return data, jt, jax.tree.map(jnp.asarray, var_np), pt


@pytest.mark.parametrize("decoder", ["rnnt", "ctc"])
def test_hypotheses_match_jax(setup, decoder):
    data, jt, jv, pt = setup
    assert pt.greedy_impl == "framesync"  # "auto" on a CPU model
    for lang in LANGS:
        entries = data[lang]
        hyps = pt.transcribe(entries, decoder)
        assert any(hyps)  # the random model emits: the comparison has content
        assert hyps == jt.transcribe(jv, entries, decoder)


def test_mixed_language_batch_and_fused_plain_path(setup):
    """A mixed-language batch goes through the fused wrapper like any
    other (on the CPU, its plain version) and gives the JAX hypotheses."""
    data, jt, jv, pt = setup
    mixed = data["hindi"][:2] + data["tamil"][:2]
    ref = jt.transcribe(jv, mixed, "rnnt")
    fused = dataclasses.replace(pt, greedy_impl="fused")
    assert fused.transcribe(mixed, "rnnt") == ref
    assert set(fused.counts) == {"encoder_batches", "rnnt_batches"}
    single = data["tamil"]
    assert fused.transcribe(single, "rnnt") == jt.transcribe(jv, single, "rnnt")


@pytest.mark.parametrize("decoder", ["rnnt_beam", "rnnt_beam_host", "ctc_beam", "labelsync"])
def test_beam_and_labelsync_hypotheses_match_jax(setup, decoder):
    """The beams on the CPU (``beam_impl`` "auto" is the batched beam there,
    the JAX package's "xla") and label-looping greedy: the JAX
    Transcriber's hypotheses, in a batch that mixes the two languages."""
    data, jt, jv, pt = setup
    assert pt.beam_impl == "xla"
    entries = data["hindi"][:3] + data["tamil"][:3]
    if decoder == "rnnt_beam_host":
        entries = data["hindi"][:2] + data["tamil"][:2]
        jt = dataclasses.replace(jt, model=_JitSteps(jt.model))
    if decoder == "labelsync":
        jt = dataclasses.replace(jt, greedy_impl="labelsync")
        pt = dataclasses.replace(pt, greedy_impl="labelsync", labelsync_window=4)
        jt.labelsync_window = 4
        decoder = "rnnt"
    hyps = pt.transcribe(entries, decoder)
    assert any(hyps)
    assert hyps == jt.transcribe(jv, entries, decoder)


def test_run_eval_metric_keys_and_files(setup):
    data, _, _, pt = setup

    class Log:
        records = []

        def log(self, d):
            self.records.append(d)

    log = Log()
    perf = run_eval(log, "val", pt, data["hindi"][:2], data["hindi"][2:4], 1, 0, "hindi")
    assert set(perf) == {
        f"{m}_{k}" for m in ("rnnt", "ctc") for k in ("wer", "noisy_wer", "avg_wer")
    }
    rec = log.records[0]
    assert rec["val/perf_hindi_ctc_avg_wer"] == perf["ctc_avg_wer"]
    assert rec["epoch"] == 1 and rec["lang"] == 0
    paths = [e.audio_filepath for e in data["tamil"][:3]]
    assert pt.transcribe_files(paths, "tamil") == pt.transcribe(data["tamil"][:3])
    with pytest.raises(ValueError):
        pt.transcribe(data["tamil"][:1], "rnnt_beam_fused")
    with pytest.raises(ValueError, match='beam_impl="xla"'):
        Transcriber(model=HybridRNNTCTC(tiny_config(pred_rnn_layers=2), device="cpu"),
                    tokenizer=pt.tokenizer, languages=LANGS,
                    frontend=FrontendConfig(n_mels=32), beam_impl="fused")


def _model_on(device, layers):
    """A stand-in for a HybridRNNTCTC on ``device``: the Transcriber's
    constructor reads only the model's config and device, so a CUDA model
    is simulated without a card and nothing is launched."""
    return types.SimpleNamespace(cfg=tiny_config(pred_rnn_layers=layers),
                                 device=torch.device(device))


@pytest.mark.parametrize("device,layers,want", [
    ("cuda", 1, ("fused", "fused")),
    ("cuda", 2, ("labelsync", "xla")),
    ("cuda", 3, ("labelsync", "xla")),
    ("cpu", 1, ("framesync", "xla")),
    ("cpu", 2, ("framesync", "xla")),
])
def test_auto_decoders_follow_the_config(device, layers, want):
    """``"auto"`` as the JAX package resolves it: the fused kernels only
    for a single-layer LSTM on CUDA; label-looping greedy and the batched
    beam for a deeper prediction net; the CPU's choices unchanged."""
    assert resolve_decoders("auto", "auto", torch.device(device), layers) == want
    tr = Transcriber(model=_model_on(device, layers), tokenizer=None, languages=LANGS,
                     frontend=FrontendConfig(n_mels=32))
    assert (tr.greedy_impl, tr.beam_impl) == want
    # explicit choices pass through
    assert resolve_decoders("framesync", "xla", torch.device(device), layers) == (
        "framesync", "xla")


@pytest.mark.parametrize("search,widths,want", [
    (dict(beam_size=10), {}, ("fused", "xla")),
    (dict(topk=17), {}, ("fused", "xla")),
    (dict(beam_size=8, topk=16), {}, ("fused", "fused")),
    (dict(beam_size=4, topk=8), dict(n_classes=5), ("fused", "xla")),
    ({}, dict(joint_hidden=100, dtype=torch.bfloat16), ("labelsync", "xla")),
    ({}, dict(pred_hidden=36, dtype=torch.bfloat16), ("labelsync", "xla")),
    ({}, dict(joint_hidden=100), ("fused", "fused")),  # 400 bytes in f32
    ({}, dict(dtype=torch.float16), ("labelsync", "xla")),
])
def test_auto_decoders_send_what_the_kernels_refuse_elsewhere(search, widths, want):
    """``"auto"`` picks a fused kernel only where its wrapper's ``fits``
    holds (beam size 1-8, top-K 1-min(16, V+1), widths of whole 16-byte
    groups in f32 or bf16), as the JAX package gates its kernels on
    ``fits_fused_beam``/``fits_fused_decode``; an explicit ``"fused"`` on
    such a search or model raises."""
    cuda = torch.device("cuda")
    kw = dict(search, **widths)
    assert resolve_decoders("auto", "auto", cuda, 1, "relu", **kw) == want
    assert resolve_decoders("auto", "auto", torch.device("cpu"), 1, "relu", **kw) == (
        "framesync", "xla")
    for what, impl, other in (("greedy", want[0], "labelsync"), ("beam", want[1], "xla")):
        args = ("fused", "auto") if what == "greedy" else ("auto", "fused")
        if impl == "fused":
            assert resolve_decoders(*args, cuda, 1, "relu", **kw)[what == "beam"] == "fused"
            continue
        with pytest.raises(ValueError, match=f'{what}_impl="{other}"'):
            resolve_decoders(*args, cuda, 1, "relu", **kw)


def test_transcriber_passes_its_beam_and_widths_to_the_route():
    """The Transcriber resolves with its own beam size and the model's
    widths, dtype and classes: beam size 10 on a (simulated) CUDA model
    takes the batched beam, and an explicit fused beam there raises at
    construction."""
    model = _model_on("cuda", 1)
    tr = Transcriber(model=model, tokenizer=None, languages=LANGS,
                     frontend=FrontendConfig(n_mels=32), beam_size=10)
    assert (tr.greedy_impl, tr.beam_impl) == ("fused", "xla")
    with pytest.raises(ValueError, match='beam_impl="xla"'):
        Transcriber(model=model, tokenizer=None, languages=LANGS,
                    frontend=FrontendConfig(n_mels=32), beam_size=10, beam_impl="fused")
    narrow = types.SimpleNamespace(
        cfg=tiny_config(joint_hidden=100, dtype=torch.bfloat16), device=torch.device("cuda"))
    tr = Transcriber(model=narrow, tokenizer=None, languages=LANGS,
                     frontend=FrontendConfig(n_mels=32))
    assert (tr.greedy_impl, tr.beam_impl) == ("labelsync", "xla")


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("greedy,beam,match", [
    ("fused", "auto", 'greedy_impl="labelsync"'),
    ("auto", "fused", 'beam_impl="xla"'),
])
def test_explicit_fused_on_a_multilayer_lstm_raises(device, greedy, beam, match):
    with pytest.raises(ValueError, match=match):
        Transcriber(model=_model_on(device, 2), tokenizer=None, languages=LANGS,
                    frontend=FrontendConfig(n_mels=32), greedy_impl=greedy, beam_impl=beam)


def test_run_sequence_default_transcriber_on_a_two_layer_lstm(monkeypatch):
    """``run_sequence`` builds its own Transcriber when given none: on a
    (simulated) CUDA model with a two-layer LSTM it constructs, with
    label-looping greedy and the batched beam, and the sequence goes on to
    its first task (stopped there: nothing is trained or launched)."""
    from indic_cl_asr_torch.train import driver

    class Stop(Exception):
        pass

    class Method:
        def make_train_step(self, make_step, lang_idx):
            raise Stop

    made = []

    def transcriber(**kw):
        made.append(Transcriber(**kw))
        return made[-1]

    monkeypatch.setattr(driver, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(driver, "Transcriber", transcriber)
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32))
    with pytest.raises(Stop):
        driver.run_sequence(cfg=driver.DriverConfig(n_langs=1), model=_model_on("cuda", 2),
                            step_cfg=step_cfg, optimizer=None, method=Method(),
                            task_data={"hindi": None}, tokenizer=None, logger=None,
                            languages=["hindi"])
    assert [(t.greedy_impl, t.beam_impl) for t in made] == [("labelsync", "xla")]
