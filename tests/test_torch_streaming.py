"""The port's streaming paths (indic_cl_asr_torch/models/streaming.py, the
greedy decode's continuation, scripts/stream_demo.py) against the JAX
package, on the CPU in f32 at tests/test_streaming.py's tiny causal config
(feat 32, 2 layers, d_model 64 in 4 heads, conv kernel 7, att_context
(8, 0), causal conv), the same weights loaded with ``from_jax_variables``:

  * the decode continuation: chunked decodes with ``carry``/``t_offset``
    equal one offline decode and the JAX carry's decode, token for token;
  * windowed and cache-aware streaming against the JAX streamers (atol
    1e-5: the same f32 arithmetic in another order) and against the port's
    offline encoder (tests/test_streaming.py's bar, atol 2e-4 rtol 1e-3),
    the scanned JAX layout too; the emission schedule equal to the JAX
    streamer's; chunk-size invariance (atol 2e-4 rtol 1e-3); the
    rejections of a non-causal config and of the conv norms the step lacks;
  * ``StreamingASR``, whole and with a zero-padded final chunk under
    ``valid_mel``: tokens equal to the JAX recognizer's and to the offline
    greedy decode's;
  * ``stream_demo.main --device cpu`` on a run dir that holds both
    packages' checkpoints of the same weights: its printed lines equal the
    JAX script's.
"""

import dataclasses
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.models import streaming as JS
from indic_cl_asr_tpu.models.hybrid import HybridRNNTCTC as HybridRNNTCTC_J
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.ops.decoding import rnnt_greedy_decode as jax_greedy
from indic_cl_asr_tpu.utils.checkpoint import save_pytree
from indic_cl_asr_torch.data.synth import make_wav_dataset
from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
from indic_cl_asr_torch.models import streaming as PS
from indic_cl_asr_torch.models.convert import from_jax_variables
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
from indic_cl_asr_torch.ops.decoding import rnnt_greedy_decode
from indic_cl_asr_torch.scripts import _common as C
from indic_cl_asr_torch.scripts import stream_demo
from indic_cl_asr_torch.utils.checkpoint import save_model

from .test_torch_model_options import random_variables

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
j_stream_demo = importlib.import_module("stream_demo")  # the JAX package's script

CAUSAL = dict(feat_in=32, n_layers=2, d_model=64, n_heads=4, ff_expansion_factor=2,
              conv_kernel_size=7, subsampling_factor=4, dropout=0.0, dropout_att=0.0,
              dropout_pre_encoder=0.0, att_context_size=(8, 0), causal_conv=True)
PARITY = dict(atol=1e-5, rtol=0)       # port against the JAX streamers
OFFLINE = dict(atol=2e-4, rtol=1e-3)   # streamed against offline (the JAX tests' bar)


def _pair(seed=0, n_layers=2, scan=False, **enc):
    """(flax module, numpy variables, port model) of the causal config."""
    jcfg, pcfg = jax_tiny_config(), tiny_config()
    opts = {**CAUSAL, "n_layers": n_layers, **enc}
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder, scan_layers=scan,
                                                                 **opts))
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, **opts))
    var_np = random_variables(jcfg, np.random.default_rng(seed))
    return HybridRNNTCTC_J(jcfg), var_np, from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"),
                                                            var_np)


@pytest.fixture(scope="module")
def causal():
    jmodel, var_np, port = _pair()
    return jmodel, jax_tiny_config(encoder=dataclasses.replace(
        jax_tiny_config().encoder, **CAUSAL)), var_np, port


def _enc_vars(v):
    return {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}


def _mel(B, T, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((B, 32, T))).astype(np.float32)


def _offline(port, mel, lens=None):
    B, _, T = mel.shape
    lens = torch.full((B,), T, dtype=torch.int32) if lens is None else lens
    with torch.inference_mode():
        return port.encode(torch.from_numpy(mel), lens)[0].numpy()


def test_receptive_field_matches_jax(causal):
    _, jcfg, _, port = causal
    assert PS.receptive_field_enc(port.cfg.encoder) == JS.receptive_field_enc(jcfg.encoder) \
        == 2 * (8 + 6)


def _jax_steps(jmodel, var_np):
    jit = jax.jit

    def pred_step(last, state):
        return jmodel.apply(var_np, last, state, method="pred_step")

    def joint_step(f_t, g_t, li):
        return jmodel.apply(var_np, f_t, g_t, li, method="joint_step")

    return jit(pred_step), jit(joint_step)


def test_decode_continuation_matches_offline_and_jax(causal):
    """Chunks of 5, 3 and 9 frames with the carry equal one decode over
    all 17 frames (rows of 17, 11 and 4 frames), and the JAX decode that
    carries across the same chunks."""
    jmodel, jcfg, var_np, port = causal
    rng = np.random.default_rng(3)
    B, T = 3, 17
    f_proj = (2.0 * rng.standard_normal((B, T, 32))).astype(np.float32)
    lens = np.array([17, 11, 4], np.int32)
    lang = np.array([0, 2, 1], np.int32)
    kw = dict(blank=port.cfg.blank_local, max_symbols=3, max_out=24)
    pf, pl, pg = (torch.from_numpy(a) for a in (f_proj, lens, lang))
    with torch.inference_mode():
        want = rnnt_greedy_decode(pf, pl, pg, port.pred_step, port.joint_step, None, **kw)
        carry, t0, outs = None, 0, []
        for n in (5, 3, 9):
            ids, ln, carry = rnnt_greedy_decode(
                pf[:, t0:t0 + n], pl, pg, port.pred_step, port.joint_step, None, **kw,
                carry=carry, t_offset=t0, return_carry=True)
            outs.append((ids.clone(), ln.clone()))
            t0 += n
    assert int(want[1].sum()) > 0
    np.testing.assert_array_equal(ids.numpy(), want[0].numpy())
    np.testing.assert_array_equal(ln.numpy(), want[1].numpy())
    # the ids a chunk returned are a prefix of the final ones
    for ids_c, ln_c in outs:
        for b in range(B):
            n = int(ln_c[b])
            np.testing.assert_array_equal(ids_c[b, :n].numpy(), want[0][b, :n].numpy())

    pred_step, joint_step = _jax_steps(jmodel, var_np)
    jcarry, t0 = None, 0
    for n in (5, 3, 9):
        j_ids, j_ln, jcarry = jax_greedy(
            jnp.asarray(f_proj[:, t0:t0 + n]), jnp.asarray(lens), jnp.asarray(lang),
            pred_step, joint_step, None, **kw, carry=jcarry, t_offset=t0, return_carry=True)
        t0 += n
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(j_ln))


def test_windowed_matches_jax_and_offline(causal):
    jmodel, jcfg, var_np, port = causal
    mel = _mel(2, 300, 0)
    scfg = dict(chunk_mel=32, window_mel=256)
    got = PS.stream_full_utterance(PS.StreamingEncoder(port, PS.StreamingConfig(**scfg)),
                                   torch.from_numpy(mel)).numpy()
    want = JS.stream_full_utterance(JS.StreamingEncoder(jmodel, jcfg, JS.StreamingConfig(**scfg)),
                                    var_np, jnp.asarray(mel))
    assert got.shape == want.shape == (2, 75, 64)
    np.testing.assert_allclose(got, want, **PARITY)
    np.testing.assert_allclose(got, _offline(port, mel), **OFFLINE)


def test_windowed_emission_schedule_matches_jax(causal):
    """Frames come out chunk by chunk (not all at the flush), in the JAX
    streamer's counts and window offsets."""
    jmodel, jcfg, var_np, port = causal
    mel = _mel(1, 192, 1)
    pse = PS.StreamingEncoder(port, PS.StreamingConfig(chunk_mel=32, window_mel=128))
    jse = JS.StreamingEncoder(jmodel, jcfg, JS.StreamingConfig(chunk_mel=32, window_mel=128))
    ps, js = pse.init(1), jse.init(1)
    sched = []
    for c0 in range(0, 192, 32):
        f, start, n, ps = pse.step(ps, torch.from_numpy(mel[:, :, c0:c0 + 32]))
        jf, jstart, jn, js = jse.step(var_np, js, jnp.asarray(mel[:, :, c0:c0 + 32]))
        assert (start, n) == (jstart, jn)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), **PARITY)
        sched.append(n)
    _, _, n_final, _ = pse.flush(ps)
    assert n_final == jse.flush(var_np, js)[2] <= 2
    assert all(n > 0 for n in sched) and sum(sched) + n_final == (192 - 1) // 4 + 1


def test_cache_aware_matches_jax_and_offline(causal):
    jmodel, jcfg, var_np, port = causal
    mel = _mel(2, 192, 2)
    got = PS.stream_full_utterance_cached(PS.CacheAwareStreamer(port, 32),
                                          torch.from_numpy(mel)).numpy()
    want = JS.stream_full_utterance_cached(JS.CacheAwareStreamer(jcfg, 32), _enc_vars(var_np),
                                           jnp.asarray(mel))
    assert got.shape == want.shape == (2, 48, 64)
    np.testing.assert_allclose(got, want, **PARITY)
    np.testing.assert_allclose(got, _offline(port, mel), **OFFLINE)


def test_cache_aware_scanned_layout_matches_jax_and_offline():
    """Three layers from the JAX package's scanned (stack/layers) layout,
    a layer_norm conv norm, chunks of 16 mel frames."""
    jmodel, var_np, port = _pair(seed=1, n_layers=3, scan=True, conv_norm_type="layer_norm")
    assert "stack" in var_np["params"]["encoder"]
    mel = _mel(1, 128, 3)
    got = PS.stream_full_utterance_cached(PS.CacheAwareStreamer(port, 16),
                                          torch.from_numpy(mel)).numpy()
    want = JS.stream_full_utterance_cached(JS.CacheAwareStreamer(jmodel.cfg, 16),
                                           {"params": var_np["params"]["encoder"]},
                                           jnp.asarray(mel))
    np.testing.assert_allclose(got, want, **PARITY)
    np.testing.assert_allclose(got, _offline(port, mel), **OFFLINE)


def test_cache_aware_chunk_size_invariance(causal):
    *_, port = causal
    mel = torch.from_numpy(_mel(1, 128, 4))
    a = PS.stream_full_utterance_cached(PS.CacheAwareStreamer(port, 16), mel)
    b = PS.stream_full_utterance_cached(PS.CacheAwareStreamer(port, 64), mel)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **OFFLINE)


def test_streamers_reject_what_they_cannot_stream():
    """As the JAX package asserts: a non-causal config, a right context;
    and the conv norms and global tokens the step has no path for."""
    enc = dataclasses.replace(tiny_config().encoder, att_context_size=(-1, -1))
    port = HybridRNNTCTC(tiny_config(encoder=enc), device="cpu")
    with pytest.raises(ValueError, match="causal_conv"):
        PS.CacheAwareStreamer(port, 32)
    with pytest.raises(AssertionError):
        JS.CacheAwareStreamer(jax_tiny_config(), chunk_mel=32)
    with pytest.raises(ValueError, match="right attention context"):
        PS.StreamingEncoder(port, PS.StreamingConfig(chunk_mel=32, window_mel=256))
    for opts, match in ((dict(att_context_size=(8, 2)), "att_context_size"),
                        (dict(conv_norm_type="group_norm"), "batch_norm/layer_norm"),
                        (dict(global_tokens=2), "global tokens")):
        enc = dataclasses.replace(tiny_config().encoder, **{**CAUSAL, **opts})
        with pytest.raises(ValueError, match=match):
            PS.CacheAwareStreamer(HybridRNNTCTC(tiny_config(encoder=enc), device="cpu"), 32)
    with pytest.raises(ValueError, match="multiple"):
        PS.StreamingConfig(chunk_mel=30)


def _offline_greedy(port, mel, T, kw):
    B = mel.shape[0]
    with torch.inference_mode():
        f, lens = port.encode(torch.from_numpy(mel[:, :, :T]),
                              torch.full((B,), T, dtype=torch.int32))
        return rnnt_greedy_decode(port.joint_project_enc(f), lens,
                                  torch.zeros(B, dtype=torch.int32), port.pred_step,
                                  port.joint_step, None, blank=port.cfg.blank_local, **kw)


@pytest.mark.parametrize("t_real", [128, 112], ids=["whole", "partial_final_chunk"])
def test_streaming_asr_matches_jax_and_offline(causal, t_real):
    """Chunks of 32 mel frames; with 112 real frames the last chunk holds
    16 and is zero-padded, with ``valid_mel`` per chunk."""
    jmodel, jcfg, var_np, port = causal
    B, CH = 2, 32
    mel = np.zeros((B, 32, 128), np.float32)
    mel[:, :, :t_real] = _mel(B, t_real, 5, scale=2.0)
    kw = dict(max_symbols=4, max_out=64)
    want_ids, want_lens = _offline_greedy(port, mel, t_real, kw)
    assert int(want_lens.sum()) > 0

    asr = PS.StreamingASR(port, chunk_mel=CH, **kw)
    jasr = JS.StreamingASR(jmodel, jcfg, var_np, chunk_mel=CH, **kw)
    state, jstate = asr.init(B), jasr.init(B)
    lang = np.zeros(B, np.int32)
    for c0 in range(0, 128, CH):
        valid = np.full(B, min(CH, max(0, t_real - c0)), np.int32)
        (ids, lens), state = asr.step(state, torch.from_numpy(mel[:, :, c0:c0 + CH]),
                                      torch.from_numpy(lang), valid_mel=torch.from_numpy(valid))
        (jids, jlens), jstate = jasr.step(jstate, jnp.asarray(mel[:, :, c0:c0 + CH]),
                                          jnp.asarray(lang), valid_mel=jnp.asarray(valid))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(lens.numpy(), want_lens.numpy())
    np.testing.assert_array_equal(ids.numpy(), want_ids.numpy())


def test_stream_demo_prints_the_jax_line(tmp_path, capsys):
    """One run dir, the config a causal ``cl_baseline`` run writes, the
    tokenizer, and the same weights as the JAX package's orbax task tree
    and the port's ``.pt``: both scripts print the same incremental and
    final lines."""
    run = tmp_path / "run"
    argv = ["--n_langs", "2", "--model.n_layers", "2", "--model.d_model", "64",
            "--model.n_heads", "4", "--model.n_mels", "32", "--model.pred_hidden", "32",
            "--model.joint_hidden", "32", "--model.conv_kernel_size", "7",
            "--model.ff_expansion_factor", "2", "--mixed_precision", "false",
            "--model.attn_impl", "xla", "--model.causal_conv", "true",
            "--model.att_context_left", "8", "--model.att_context_right", "0"]
    cfg, _ = C.setup(argv + ["--output_dir", str(run)])
    langs = C.build_languages(cfg)
    os.makedirs(run / "sequence")
    with open(run / "config.json", "w") as f:
        json.dump(cfg.to_dict(), f, default=str)
    data = make_wav_dataset(str(tmp_path / "wavs"), langs[:1], n_per_lang=1, seed=3)
    tok = MultilingualTokenizer({l: CharTokenizer.train(["namaste dhanyavad pani"])
                                 for l in langs})
    tok.save(str(run / "tokenizer"))
    jcfg = importlib.import_module("_common").build_model_cfg(cfg, tok, langs)
    var_np = random_variables(jcfg, np.random.default_rng(6))
    # blank rarely wins: a random head of this width emits on a few frames
    var_np["params"]["joint"]["head_bias"][:, -1] -= 1.0
    save_pytree(str(run / "sequence" / "task_0_hindi"), var_np)
    port = from_jax_variables(HybridRNNTCTC(C.build_model_cfg(cfg, tok, langs), device="cpu"),
                              var_np)
    save_model(str(run / "sequence" / "task_0_hindi.pt"), port)

    wav = data[langs[0]][0].audio_filepath
    args = [wav, "--run", str(run), "--task", "0:hindi", "--chunk_mel", "32"]
    j_text = j_stream_demo.main(args)
    j_out = capsys.readouterr().out.splitlines()
    p_text = stream_demo.main(args + ["--device", "cpu"])
    p_out = capsys.readouterr().out.splitlines()
    assert p_text == j_text and p_text.strip()
    assert p_out == j_out and len(p_out) > 2
    assert json.loads(p_out[-1])["text"] == p_text
