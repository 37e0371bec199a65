"""The pretrained-checkpoint path of the port (models/pretrained.py,
models/nemo_ingest.py, scripts/eval_pretrained.py, transcribe --nemo)
against the JAX package's, on the CPU in f32 at ``tiny_config()`` widths,
over the fake ``.nemo`` archives of tests/test_nemo_ingest.py:

  * ``convert_nemo_state_dict``: the port's tree equals the JAX function's
    leaf for leaf, exactly (multisoftmax and single-softmax heads, both
    encoder layouts);
  * the strict load: a missing, extra or mis-shaped leaf raises and names
    it;
  * ``model_config_from_nemo``: equal to the JAX mapping field by field;
  * ``restore_pretrained``: encoder, joint and CTC outputs within atol
    1e-5 of the JAX model's; the tokenizers' languages, offsets and a text
    round trip equal;
  * ``eval_pretrained.main`` and ``transcribe.main --nemo``: the same
    records and texts as the JAX scripts; ``download_from_hf`` without
    ``huggingface_hub`` raises ImportError.
"""

import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_nemo_tar
from indic_cl_asr_tpu.data.tokenizer import CharTokenizer as JCharTokenizer
from indic_cl_asr_tpu.data.tokenizer import MultilingualTokenizer as JMultilingualTokenizer
from indic_cl_asr_tpu.models import nemo_ingest as JN
from indic_cl_asr_tpu.models import pretrained as JP
from indic_cl_asr_tpu.models.conformer import subsampled_feat_dim
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_torch.models import nemo_ingest as PN
from indic_cl_asr_torch.models import pretrained as PP
from indic_cl_asr_torch.scripts import eval_pretrained as p_eval_pretrained
from indic_cl_asr_torch.scripts import transcribe as p_transcribe

from .synth import make_texts, make_wav_dataset
from .test_nemo_ingest import LANG_KEYS, make_fake_nemo_tar, make_lang_spm_bytes
from .test_pretrained_convert import make_fake_nemo_sd

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
j_eval_pretrained = importlib.import_module("eval_pretrained")
j_transcribe = importlib.import_module("transcribe")

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many tiny ops: torch's intra-op threads only contend under the
    # tier's parallel workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _single_softmax(sd, cfg, rng):
    """The multisoftmax fake turned into a single-softmax one, with an
    intermediate linear at a lower Sequential index."""
    V1, J = cfg.vocab_per_lang + 1, cfg.joint_hidden
    for lang in LANG_KEYS:
        del sd[f"joint.joint_net.2.{lang}.weight"], sd[f"joint.joint_net.2.{lang}.bias"]
    sd["joint.joint_net.0.weight"] = rng.standard_normal((J, J)).astype(np.float32)
    sd["joint.joint_net.0.bias"] = rng.standard_normal(J).astype(np.float32)
    sd["joint.joint_net.2.weight"] = rng.standard_normal((V1, J)).astype(np.float32)
    sd["joint.joint_net.2.bias"] = rng.standard_normal(V1).astype(np.float32)
    return sd


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("heads", ["multisoftmax", "single_softmax"])
def test_convert_matches_jax_leaf_for_leaf(heads, scan, rng):
    cfg = jax_tiny_config()
    sd = make_fake_nemo_sd(cfg, LANG_KEYS, rng)
    if heads == "single_softmax":
        sd = _single_softmax(sd, cfg, rng)
    kw = dict(n_layers=cfg.encoder.n_layers, sampling_num=cfg.encoder.sampling_num,
              subsampled_feat=subsampled_feat_dim(cfg.encoder),
              conv_channels=cfg.encoder.conv_channels, language_keys=LANG_KEYS,
              scan_layers=scan)
    want = _flat(jax.tree.map(np.asarray, JP.convert_nemo_state_dict(sd, **kw)))
    got = _flat(PP.convert_nemo_state_dict(sd, **kw))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def write_nemo(path, model_config: dict, sd: dict, spm: dict) -> str:
    """A .nemo tar: the config, the numpy state dict and {member: bytes}."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    return write_nemo_tar(path, model_config, sd, spm)


@pytest.fixture(scope="module")
def fake_nemo(tmp_path_factory):
    """The fake .nemo of tests/test_nemo_ingest.py, its config and its state
    dict (read back)."""
    root = tmp_path_factory.mktemp("nemo")
    path, _ = make_fake_nemo_tar(str(root), np.random.default_rng(1234))
    return {"root": root, "path": path, "config": JN.read_nemo_config(path),
            "sd": PP.load_torch_state_dict(path)}


BAD = {
    "missing": ("joint.enc.bias", None, "joint.enc.bias"),
    "missing_statistic": ("encoder.layers.1.conv.batch_norm.running_var", None,
                          "encoder.layers.1.conv.batch_norm.running_var"),
    "extra": ("decoder.prediction.dec_rnn.lstm.weight_ih_l1", "lstm_l1",
              "prediction.lstm.1.w_ih"),
    "mis_shaped": ("encoder.layers.0.feed_forward1.linear1.bias", (5,),
                   "encoder.layers.0.feed_forward1.linear1.bias"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_state_dict_raises_naming_the_leaf(case, fake_nemo, tmp_path):
    key, change, named = BAD[case]
    sd = {k: np.array(v) for k, v in fake_nemo["sd"].items()}
    if change is None:
        del sd[key]
    elif change == "lstm_l1":  # a second LSTM layer the config does not have
        for k in list(sd):
            if k.startswith("decoder.prediction.dec_rnn.lstm.") and k.endswith("_l0"):
                sd[k[:-1] + "1"] = sd[k]
    else:
        sd[key] = np.zeros(change, np.float32)
    spm = {f"{i}abc_tokenizer.model": make_lang_spm_bytes(l) for i, l in enumerate(LANG_KEYS)}
    path = write_nemo(str(tmp_path / "bad.nemo"), fake_nemo["config"], sd, spm)
    with pytest.raises((KeyError, ValueError), match=named.replace(".", r"\.")):
        PN.restore_pretrained(path, str(tmp_path / "w"), with_tokenizer=False, device="cpu")
    with pytest.raises((KeyError, AssertionError)):  # the JAX restore refuses it too
        JN.restore_pretrained(path, str(tmp_path / "w"), with_tokenizer=False)


def _options_config(config):
    cfg = {**config, "encoder": dict(config["encoder"], conv_norm_type="group_norm2",
                                     subsampling_conv_channels=24, xscale=False,
                                     dropout_emb=0.05, pos_emb_max_len=1000),
           "joint": {"jointnet": {"joint_hidden": 32, "activation": "tanh"}}}
    del cfg["aux_ctc"]  # the vocab from joint.num_classes x languages
    cfg["joint"]["num_classes"] = 16
    return cfg


@pytest.mark.parametrize("variant", ["fake", "options"])
def test_model_config_from_nemo_matches_jax(variant, fake_nemo):
    config = fake_nemo["config"]
    if variant == "options":
        config = _options_config(config)
    jcfg = JN.model_config_from_nemo(config)
    pcfg = PN.model_config_from_nemo(config)
    assert pcfg.encoder.attn_impl == "flash"
    assert pcfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    for sub_p, sub_j in ((pcfg, jcfg), (pcfg.encoder, jcfg.encoder)):
        for f in dataclasses.fields(sub_p):
            if f.name not in ("encoder", "dtype", "attn_impl"):
                assert getattr(sub_p, f.name) == getattr(sub_j, f.name), f.name
    # the mapping names no causal conv and no global tokens, in either package
    assert (jcfg.encoder.causal_conv, jcfg.encoder.global_tokens) == (False, 0)
    assert (pcfg.encoder.causal_conv, pcfg.encoder.global_tokens) == (False, 0)
    assert pcfg.encoder.conv_channels == jcfg.encoder.conv_channels


@pytest.fixture(scope="module")
def restored(fake_nemo):
    root = fake_nemo["root"]
    j_model, j_vars, j_cfg, j_tok = JN.restore_pretrained(fake_nemo["path"], str(root / "jw"))
    timings = {}
    port, p_cfg, p_tok = PN.restore_pretrained(fake_nemo["path"], str(root / "pw"),
                                               device="cpu", timings=timings)
    return dict(j=(j_model, j_vars, j_cfg, j_tok), p=(port, p_cfg, p_tok), timings=timings)


def test_restore_pretrained_matches_jax(restored):
    j_model, j_vars, _, j_tok = restored["j"]
    port, p_cfg, p_tok = restored["p"]
    assert set(restored["timings"]) == {"config_s", "read_s", "convert_s", "load_s",
                                        "tokenizer_s"}
    assert port.device.type == "cpu" and p_cfg.encoder.attn_impl == "flash"
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, p_cfg.encoder.feat_in, 48)).astype(np.float32)
    lens = np.array([48, 29], np.int32)
    lang = np.array([0, 3], np.int32)
    f_j, l_j = jax.jit(lambda v, x, n: j_model.apply(v, x, n, False, method="encode"))(
        j_vars, feats, lens)
    f_t, l_t = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL, rtol=0)
    c_j = j_model.apply(j_vars, f_j, jnp.asarray(lang), method="ctc_logprobs")
    c_t = port.ctc_logprobs(f_t, torch.from_numpy(lang))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=0)
    p_j = j_model.apply(j_vars, f_j, method="joint_project_enc")
    p_t = port.joint_project_enc(f_t)
    lab = np.array([p_cfg.blank_local, 3], np.int32)
    g_j, _ = j_model.apply(j_vars, jnp.asarray(lab), None, method="pred_step")
    g_t, _ = port.pred_step(torch.from_numpy(lab), None)
    j_j = j_model.apply(j_vars, p_j[:, 2], g_j, jnp.asarray(lang), method="joint_step")
    j_t = port.joint_step(p_t[:, 2], g_t, torch.from_numpy(lang))
    np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), atol=ATOL, rtol=0)
    # the tokenizers
    assert p_tok.langs == j_tok.langs == LANG_KEYS
    assert p_tok.token_id_offset == j_tok.token_id_offset
    assert p_tok.vocab == j_tok.vocab
    for lang_key in LANG_KEYS:
        ids = p_tok.text_to_ids("kata ka", lang_key)
        assert ids == j_tok.text_to_ids("kata ka", lang_key)
        assert p_tok.ids_to_text(ids, lang_key) == j_tok.ids_to_text(ids, lang_key) == "kata ka"


@pytest.fixture(scope="module")
def wavs(fake_nemo):
    """Four short WAVs with transcripts, as entries of language 'hindi'."""
    return make_wav_dataset(str(fake_nemo["root"] / "wav"), ["hindi"], n_per_lang=4,
                            min_dur=0.6, max_dur=1.4)["hindi"]


def test_transcribe_nemo_prints_the_jax_texts(fake_nemo, wavs, capsys, tmp_path):
    """Under the checkpoint's own language key ('hi'), the languages being
    the restored tokenizer's."""
    from indic_cl_asr_tpu.data.manifest import write_manifest

    manifest = str(tmp_path / "hi.jsonl")
    write_manifest(manifest, [dataclasses.replace(e, lang="hi") for e in wavs])
    args = ["--nemo", fake_nemo["path"], "--manifest", manifest, "--batch_size", "2", "--wer"]
    for decoder in ("rnnt", "ctc"):
        j_hyps = j_transcribe.main([*args, "--decoder", decoder])
        j_out = capsys.readouterr().out.splitlines()
        p_hyps = p_transcribe.main([*args, "--decoder", decoder, "--device", "cpu"])
        p_out = capsys.readouterr().out.splitlines()
        assert p_hyps == j_hyps and len(p_hyps) == len(wavs)
        assert p_out == j_out


def _manifest_dir(root, langs, entries):
    from indic_cl_asr_tpu.data.manifest import write_manifest

    mdir = str(root / "manifests")
    os.makedirs(mdir, exist_ok=True)
    for lang in langs:
        for split in ("train", "val", "noisy_val", "test", "noisy_test"):
            write_manifest(os.path.join(mdir, f"{lang}_{split}.jsonl"),
                           [dataclasses.replace(e, lang=lang) for e in entries])
    return mdir


def test_eval_pretrained_prints_the_jax_records(fake_nemo, wavs, capsys, tmp_path):
    """The languages come from the config (its first n_langs names), each
    row's head from its language's position there: a --local_tokenizer
    under those names decodes the texts."""
    langs = ["hindi", "bengali"]
    mdir = _manifest_dir(tmp_path, langs, wavs)
    tok_dir = str(tmp_path / "tok")
    JMultilingualTokenizer({l: JCharTokenizer.train(make_texts(l, 20)) for l in langs}).save(
        tok_dir)
    argv = ["--nemo", fake_nemo["path"], "--dataset.manifest_dir", mdir, "--n_langs", "2",
            "--batch_size", "2", "--local_tokenizer", tok_dir]
    want = j_eval_pretrained.main(argv)
    j_out = capsys.readouterr().out.splitlines()
    got = p_eval_pretrained.main([*argv, "--device", "cpu"])
    p_out = capsys.readouterr().out.splitlines()
    assert got == want and [r["decoder"] for r in got] == ["rnnt", "ctc"] * 2
    assert p_out == j_out


def test_eval_pretrained_with_the_checkpoint_tokenizer_fails_as_jax(fake_nemo, wavs, tmp_path):
    """Kept from the JAX package: the config's language names (hindi, ...)
    are not the checkpoint tokenizer's keys (hi, ...), so without
    --local_tokenizer both scripts fail at the first tokenizer lookup."""
    mdir = _manifest_dir(tmp_path, ["hindi"], wavs[:1])
    argv = ["--nemo", fake_nemo["path"], "--dataset.manifest_dir", mdir, "--n_langs", "1",
            "--decoder", "ctc", "--spm_out_dir", str(tmp_path / "spm")]
    with pytest.raises(KeyError, match="hindi"):
        j_eval_pretrained.main(argv)
    with pytest.raises(KeyError, match="hindi"):
        p_eval_pretrained.main([*argv, "--device", "cpu"])


def test_download_from_hf_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError):
        PN.download_from_hf("ai4bharat/indicconformer_stt_hi_hybrid_rnnt_large")
