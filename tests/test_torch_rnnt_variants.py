"""The port's multiblank and TDT losses (indic_cl_asr_torch/ops/
rnnt_variants.py) against the JAX package's and against
tests/test_rnnt_variants.py's brute-force NumPy lattice oracles, on the
CPU in f32:

  * per-row NLLs against the oracles (rtol 1e-4 atol 1e-4, the JAX tests'
    bar) and against the JAX losses (atol 1e-5: the same f32 recurrence);
  * every reduction, and the gradients in the log-probs (and the duration
    log-probs) from autograd through the diagonal loop against
    ``jax.grad`` through the JAX scan (atol 1e-5);
  * no big blanks: the multiblank loss is the standard RNNT NLL of
    ops/rnnt_loss.py (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops import rnnt_variants as JV
from indic_cl_asr_torch.ops import rnnt_variants as PV
from indic_cl_asr_torch.ops.rnnt_loss import rnnt_nll_from_logprobs

from .test_rnnt_variants import _rand_logprobs, multiblank_oracle, tdt_oracle

ORACLE = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=0, atol=1e-5)
REDUCTIONS = ["none", "mean_batch", "sum", "mean", "mean_volume"]


def _multiblank_case(seed=0):
    rng = np.random.default_rng(seed)
    B, T, U, V1 = 3, 7, 4, 8
    blank, big_ds = V1 - 1, (2, 3)  # big blanks at indices blank-1, blank-2
    lp = _rand_logprobs(rng, (B, T, U + 1, V1))
    labels = rng.integers(0, blank - len(big_ds), (B, U)).astype(np.int32)
    t_lens = np.array([7, 5, 2], np.int32)  # 2 < the 3-frame big blank
    u_lens = np.array([4, 2, 0], np.int32)
    return lp, labels, t_lens, u_lens, dict(blank=blank, big_blank_durations=big_ds,
                                            sigma=0.05)


def _tdt_case(seed=2):
    rng = np.random.default_rng(seed)
    B, T, U, V1 = 3, 8, 3, 7
    durations = (0, 1, 2, 4)
    lp = _rand_logprobs(rng, (B, T, U + 1, V1))
    lpd = _rand_logprobs(rng, (B, T, U + 1, len(durations)))
    labels = rng.integers(0, V1 - 1, (B, U)).astype(np.int32)
    t_lens = np.array([8, 5, 3], np.int32)
    u_lens = np.array([3, 2, 0], np.int32)
    return lp, lpd, labels, t_lens, u_lens, dict(blank=V1 - 1, durations=durations, sigma=0.02)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_multiblank_matches_oracle_and_jax():
    lp, labels, t_lens, u_lens, kw = _multiblank_case()
    got = PV.multiblank_rnnt_loss(*_t(lp, labels, t_lens, u_lens), reduction="none", **kw)
    want = JV.multiblank_rnnt_loss(*map(jnp.asarray, (lp, labels, t_lens, u_lens)),
                                   reduction="none", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    for b in range(3):
        oracle = multiblank_oracle(lp[b], labels[b], int(t_lens[b]), int(u_lens[b]),
                                   kw["blank"], kw["big_blank_durations"], kw["sigma"])
        np.testing.assert_allclose(float(got[b]), oracle, **ORACLE)


def test_tdt_matches_oracle_and_jax():
    lp, lpd, labels, t_lens, u_lens, kw = _tdt_case()
    got = PV.tdt_loss(*_t(lp, lpd, labels, t_lens, u_lens), reduction="none", **kw)
    want = JV.tdt_loss(*map(jnp.asarray, (lp, lpd, labels, t_lens, u_lens)),
                       reduction="none", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    for b in range(3):
        oracle = tdt_oracle(lp[b], lpd[b], labels[b], int(t_lens[b]), int(u_lens[b]),
                            kw["blank"], kw["durations"], kw["sigma"])
        np.testing.assert_allclose(float(got[b]), oracle, **ORACLE)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_multiblank_reduction_and_gradient_match_jax(reduction):
    lp, labels, t_lens, u_lens, kw = _multiblank_case(seed=4)
    x = torch.tensor(lp, requires_grad=True)
    got = PV.multiblank_rnnt_loss(x, *_t(labels, t_lens, u_lens), reduction=reduction, **kw)
    (grad,) = torch.autograd.grad(got.sum(), x)

    def jloss(y):
        return JV.multiblank_rnnt_loss(y, jnp.asarray(labels), jnp.asarray(t_lens),
                                       jnp.asarray(u_lens), reduction=reduction, **kw).sum()

    want, wgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(lp))
    np.testing.assert_allclose(float(got.sum().detach()), float(want), **ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(wgrad), **ATOL)
    assert np.abs(grad.numpy()).max() > 0.01


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_tdt_reduction_and_gradients_match_jax(reduction):
    lp, lpd, labels, t_lens, u_lens, kw = _tdt_case(seed=5)
    x, xd = torch.tensor(lp, requires_grad=True), torch.tensor(lpd, requires_grad=True)
    got = PV.tdt_loss(x, xd, *_t(labels, t_lens, u_lens), reduction=reduction, **kw)
    grads = torch.autograd.grad(got.sum(), (x, xd))

    def jloss(y, yd):
        return JV.tdt_loss(y, yd, jnp.asarray(labels), jnp.asarray(t_lens),
                           jnp.asarray(u_lens), reduction=reduction, **kw).sum()

    want, wgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(lp),
                                                                       jnp.asarray(lpd))
    np.testing.assert_allclose(float(got.sum().detach()), float(want), **ATOL)
    for g, wg in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **ATOL)
        assert np.abs(g.numpy()).max() > 0.01


def test_multiblank_without_big_blanks_is_the_rnnt_nll():
    rng = np.random.default_rng(1)
    B, T, U, V1 = 2, 6, 3, 6
    blank = V1 - 1
    lp = _rand_logprobs(rng, (B, T, U + 1, V1))
    labels = rng.integers(0, blank, (B, U)).astype(np.int32)
    t_lens, u_lens = np.array([6, 4], np.int32), np.array([3, 2], np.int32)
    got = PV.multiblank_rnnt_loss(*_t(lp, labels, t_lens, u_lens), blank=blank,
                                  big_blank_durations=(), reduction="none")
    labels_pad = np.concatenate([labels, np.zeros((B, 1), np.int32)], 1)
    lp_label = np.take_along_axis(lp, labels_pad[:, None, :, None], axis=3)[..., 0]
    want = rnnt_nll_from_logprobs(*_t(np.ascontiguousarray(lp[..., blank]), lp_label,
                                      t_lens, u_lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATOL)
