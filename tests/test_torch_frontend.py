"""Port parity: the PyTorch log-mel front-end against the JAX package's
``log_mel_spectrogram(training=False)`` (its ``fft_impl="fft"`` path), in
f32 on the CPU, atol 1e-4 on the normalised features (f32 FFTs and sums in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.audio import features as jf
from indic_cl_asr_torch.audio import features as tf

ATOL = 1e-4


def _audio(seed, B, S):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, S))).astype(np.float32)
    lens = np.array([S] + [S - 1733 * (i + 1) for i in range(B - 1)], np.int32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    return x, lens


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"n_mels": 32},
        {"normalize": "all_features"},
        {"normalize": "none", "pad_to": 0},
        {"win_length": 320, "n_fft": 400, "hop_length": 128, "n_mels": 64},
    ],
    ids=["default", "mels32", "all_features", "raw", "other_stft"],
)
def test_log_mel_matches_jax(kw):
    x, lens = _audio(len(kw), 3, 16000)
    jcfg = jf.FrontendConfig(fft_impl="fft", **kw)
    tcfg = tf.FrontendConfig(**kw)
    mel_j, len_j = jf.log_mel_spectrogram(
        jnp.asarray(x), jnp.asarray(lens), jcfg, training=False
    )
    mel_t, len_t = tf.log_mel_spectrogram(
        torch.from_numpy(x), torch.from_numpy(lens), tcfg
    )
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert mel_t.shape == mel_j.shape
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=ATOL)


def test_filterbank_window_and_lengths_match_jax():
    np.testing.assert_array_equal(
        tf.mel_filterbank(16000, 512, 80), jf.mel_filterbank(16000, 512, 80)
    )
    np.testing.assert_array_equal(tf.hann_window(400), jf.hann_window(400))
    n = np.array([0, 1, 159, 160, 16000, 128000], np.int64)
    np.testing.assert_array_equal(
        tf.output_seq_len(torch.from_numpy(n), tf.FrontendConfig()).numpy(),
        np.asarray(jf.output_seq_len(n, jf.FrontendConfig())),
    )
