"""Port parity of the RNNT loss: the plain lattices (``_alpha_scan``,
``_beta_scan``, the CUDA kernels' plain versions), ``rnnt_nll_from_logprobs``
and the chunked joint loss ``rnnt_loss_fused`` against the JAX package, in
f32 on the CPU.

Tolerances: lattice values rtol 1e-6 / atol 1e-5 on reachable cells (the
cases of tests/test_rnnt_pallas.py); NLLs and slab gradients atol 1e-5;
the fused loss atol 1e-5 and its gradients rtol 1e-5 + atol 1e-5 (f32 sums in another
order; the port computes the blank column in the same product as the
labels). The kernels are held to these plain versions on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops import rnnt_loss as JR
from indic_cl_asr_tpu.ops.rnnt_loss_fused import rnnt_loss_fused as jax_rnnt_loss_fused
from indic_cl_asr_tpu.ops.rnnt_loss_pallas import (
    alpha_diagonals_pallas,
    beta_diagonals_pallas,
)
from indic_cl_asr_torch.ops import rnnt_loss as R
from indic_cl_asr_torch.ops.rnnt_loss_fused import rnnt_loss_fused


def _case(seed=1234):
    rng = np.random.default_rng(seed)
    B, T, U1 = 3, 7, 4
    lb = -np.abs(rng.standard_normal((B, T, U1))).astype(np.float32)
    ll = -np.abs(rng.standard_normal((B, T, U1))).astype(np.float32)
    return lb, ll, np.array([7, 5, 3], np.int32), np.array([3, 2, 1], np.int32)


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


@pytest.mark.parametrize("oracle", ["scan", "pallas_interpret"])
def test_plain_lattices_match_jax(oracle):
    lb, ll, tl, ul = _case()
    jlpb, jlpl, _, _ = JR._prepare(*(jnp.asarray(x) for x in (lb, ll, tl, ul)))
    lpb, lpl, _, _ = R._prepare(*_t(lb, ll, tl, ul))
    np.testing.assert_array_equal(lpb.numpy(), np.asarray(jlpb))
    np.testing.assert_array_equal(lpl.numpy(), np.asarray(jlpl))
    B, T, U1 = lb.shape
    if oracle == "scan":
        want_a = jax.jit(JR._alpha_scan)(jlpb, jlpl)
        want_b = jax.jit(JR._beta_scan)(jlpb, jlpl, jnp.asarray(ul))
    else:
        want_a = JR._from_diagonals(alpha_diagonals_pallas(
            JR._to_diagonals(jlpb, JR.NEG_INF), JR._to_diagonals(jlpl, JR.NEG_INF),
            interpret=True), T)
        pad = jnp.full((B, 1, U1), JR.NEG_INF, jnp.float32)
        want_b = JR._from_diagonals(beta_diagonals_pallas(
            JR._to_diagonals(jnp.concatenate([jlpb, pad], 1), JR.NEG_INF),
            JR._to_diagonals(jnp.concatenate([jlpl, pad], 1), JR.NEG_INF),
            jnp.asarray(ul), T, interpret=True), T + 1)
    got_a = R.rnnt_alpha(lpb, lpl).numpy()
    got_b = R.rnnt_beta(lpb, lpl, torch.from_numpy(ul)).numpy()
    for got, want in ((got_a, np.asarray(want_a)), (got_b, np.asarray(want_b))):
        assert got.shape == want.shape
        reach = want > R.NEG_INF / 2
        np.testing.assert_array_equal(got > R.NEG_INF / 2, reach)
        np.testing.assert_allclose(got[reach], want[reach], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got_b[:, 0, 0], np.asarray(want_b)[:, 0, 0], rtol=1e-6)


def test_nll_and_slab_grads_match_jax():
    lb, ll, tl, ul = _case(7)

    def jloss(a, b):
        return JR.rnnt_nll_from_logprobs(a, b, jnp.asarray(tl), jnp.asarray(ul))

    jv = np.array(jax.jit(jloss)(jnp.asarray(lb), jnp.asarray(ll)))
    jg = jax.jit(jax.grad(lambda a, b: (jloss(a, b) * jnp.arange(1.0, 4.0)).sum(),
                          argnums=(0, 1)))(jnp.asarray(lb), jnp.asarray(ll))
    x, y = (t.requires_grad_(True) for t in _t(lb, ll))
    tl_t, ul_t = _t(tl, ul)
    a0, b0 = R.rnnt_alpha.launches, R.rnnt_beta.launches
    nll = R.rnnt_nll_from_logprobs(x, y, tl_t, ul_t)
    gx, gy = torch.autograd.grad((nll * torch.arange(1.0, 4.0)).sum(), (x, y))
    assert (R.rnnt_alpha.launches, R.rnnt_beta.launches) == (a0, b0)  # CPU: plain
    np.testing.assert_allclose(nll.detach().numpy(), jv, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jg[1]), atol=1e-5)
    ref = R.rnnt_nll_from_logprobs_reference(*_t(lb, ll, tl, ul))
    assert torch.equal(ref, nll.detach())
    # the reductions, with a row mask
    mask = torch.tensor([True, False, True])
    for red in ("mean_batch", "sum", "mean", "mean_volume"):
        want = JR._reduce(jnp.asarray(jv), jnp.asarray(ul), red, jnp.asarray(mask.numpy()))
        got = R._reduce(torch.from_numpy(jv), torch.from_numpy(ul), red, mask)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _fused_inputs(seed, B=3, T=11, U=4, H=16, V1=9):
    rng = np.random.default_rng(seed)
    f = (0.5 * rng.standard_normal((B, T, H))).astype(np.float32)
    g = (0.5 * rng.standard_normal((B, U + 1, H))).astype(np.float32)
    w = (0.5 * rng.standard_normal((B, H, V1))).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, V1))).astype(np.float32)
    labels = rng.integers(0, V1 - 1, (B, U)).astype(np.int32)
    fl = np.array([T, T - 3, 2][:B], np.int32)
    ul = np.array([U, 2, 0][:B], np.int32)
    return f, g, w, b, labels, fl, ul


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_loss_and_grads_match_jax(uniform, remat, masked):
    f, g, w, b, labels, fl, ul = _fused_inputs(3)
    if uniform:
        w, b = np.repeat(w[:1], 3, 0), np.repeat(b[:1], 3, 0)
    mask = np.array([True, True, False]) if masked else None
    kw = dict(blank=w.shape[-1] - 1, chunk_size=4, uniform_head=uniform, remat=remat)

    def jloss(f_, g_, w_, b_):
        return jax_rnnt_loss_fused(
            f_, g_, w_, b_, jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(ul),
            row_mask=None if mask is None else jnp.asarray(mask), **kw)

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x) for x in (f, g, w, b)))
    leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
    loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul),
                           row_mask=None if mask is None else torch.from_numpy(mask), **kw)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jv), atol=1e-5)
    for name, got, want in zip(("f", "g", "w", "b"), grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fused_remat_full_reuses_the_forward_dropout_mask():
    f, g, w, b, labels, fl, ul = _fused_inputs(5)
    out = {}
    for remat in ("none", "full"):
        leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
        loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul), blank=w.shape[-1] - 1,
                               chunk_size=4, dropout_rate=0.3, remat=remat,
                               generator=torch.Generator().manual_seed(11))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    no_drop = rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), blank=w.shape[-1] - 1,
                              chunk_size=4)
    assert not torch.equal(out["none"][0], no_drop)
    assert torch.equal(out["none"][0], out["full"][0])
    for a, c in zip(out["none"][1], out["full"][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), blank=8, remat="save_all")
    with pytest.raises(ValueError):
        rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), blank=8, impl="triton")
