"""Port parity end to end: the PyTorch ``Transcriber`` (log-mel -> encoder
-> greedy RNNT or CTC -> detokenize) against the JAX package's
``Transcriber`` on a few synthetic WAVs, with the same weights, at
``tiny_config()`` in f32 on the CPU: identical hypotheses for both
decoders, and ``run_eval``'s metric keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from indic_cl_asr_torch.train.eval import Transcriber, run_eval

from .synth import make_texts, make_wav_dataset

LANGS = ["hindi", "tamil"]


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
        pt.transcribe(data["tamil"][:1], "rnnt_beam")
