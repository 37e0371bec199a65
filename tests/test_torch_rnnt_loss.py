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

A CPU model of the CUDA lattice kernels' schedules (the warp kernels'
lane columns, boundary shuffle, diagonal-skewed rings poisoned with NaN,
and their lattice and staging warps meeting at two counters, run with an
eager and a lazy staging warp; the block kernels above WARP_MAX_U1) is held
to the plain lattices and the Pallas kernels in interpret mode at the
same tolerances, at U+1 from 1 to WARP_MAX_U1 + 1.
"""

import itertools
import re
import warnings
from pathlib import Path

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


def test_remat_none_over_the_memory_limit_warns_and_takes_full(monkeypatch):
    """``RNNT_REMAT_NONE_LIMIT_GB`` below the residual estimate: ``"none"``
    warns with the JAX package's text and takes ``"full"``, so its loss and
    gradients equal ``"full"``'s bit for bit (dropout 0.3, the same
    generator seed); the default limit keeps ``"none"`` without a word."""
    f, g, w, b, labels, fl, ul = _fused_inputs(5)
    kw = dict(blank=w.shape[-1] - 1, chunk_size=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), remat="none", **kw)
    monkeypatch.setenv("RNNT_REMAT_NONE_LIMIT_GB", "1e-6")
    with pytest.warns(UserWarning) as jax_said:
        jax_rnnt_loss_fused(*(jnp.asarray(x) for x in (f, g, w, b, labels, fl, ul)),
                            remat="none", **kw)
    out = {}
    for remat in ("none", "full"):
        leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul), remat=remat,
                                   dropout_rate=0.3,
                                   generator=torch.Generator().manual_seed(11), **kw)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves), said)
    assert [str(m.message) for m in out["none"][2]] == [str(m.message) for m in jax_said]
    assert "falling back to 'full'" in str(jax_said[0].message)
    assert out["full"][2] == []
    assert torch.equal(out["none"][0], out["full"][0])
    for a, c in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, c)


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


# --- a CPU model of the CUDA lattice kernels' schedules -------------------

_CU = (Path(__file__).resolve().parents[1] / "indic_cl_asr_torch" / "csrc"
       / "rnnt_lattice.cu").read_text()


def _cu_int(pattern):
    return int(re.search(pattern, _CU).group(1))


MAX_SMEM = _cu_int(r"constexpr int MAX_SMEM = (\d+);")  # ring_slots' shared memory
SLACK = _cu_int(r"constexpr int SLACK = (\d+);")  # and rows of slack
NEG = np.float32(R.NEG_INF)
LANES = 32


def _lae(a, b):
    """the kernels' logaddexp in f32: fmaxf ignores a NaN operand"""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.fmax(a, b) + np.log1p(np.exp(-np.abs(a - b)))


G = _cu_int(r"constexpr int G = (\d+);")  # diagonals between the lattice warp's checks


class _Rings:
    """The warp kernels' two staging rings [B, R, 32C], NaN until written (a
    cell that read a place no copy or store had filled would turn NaN). A
    copy lands at its issue here; the staging warp publishes ``landed`` only
    after waiting for all its copies."""

    def __init__(self, B, R, P):
        self.R = R
        self.sb = np.full((B, R, P), np.nan, np.float32)
        self.sl = np.full((B, R, P), np.nan, np.float32)

    def at(self, s0, u):
        """RowPlaces: the slot of column u of the row whose column 0 is at s0"""
        s = s0 + u
        assert (s < 2 * self.R).all()
        return np.where(s >= self.R, s - self.R, s)

    def copy_row(self, lpb, lpl, r, s0, shift):
        U1 = lpb.shape[2]
        u = np.arange(U1)
        s = self.at(s0, u)
        self.sb[:, s, u] = lpb[:, r]
        self.sl[:, s[:U1 - 1], u[:U1 - 1] + shift] = lpl[:, r, :U1 - 1]

    def read_row(self, s0, U1):
        u = np.arange(U1)
        return self.sb[:, self.at(s0, u), u].copy()


class _Stage:
    """The staging warp (csrc/rnnt_lattice.cu:alpha_stage, beta_stage): one
    pass of its loop per ``step``, on the ``stored`` the lattice warp last
    published; rows ascend for alpha and descend for beta."""

    def __init__(self, rings, lpb, lpl, out, beta, batch):
        self.rings, self.lpb, self.lpl, self.out, self.beta = rings, lpb, lpl, out, beta
        self.batch = batch  # rows a pass copies at most (8 in the kernel)
        T, R = lpb.shape[1], rings.R
        if beta:
            self.r, self.s_row, self.t, self.s_out, self.landed = T - 1, (T - 1) % R, T, T % R, T
        else:
            self.r, self.s_row, self.t, self.s_out, self.landed = 0, 1, 0, 0, 0

    def done(self):
        return self.t < 0 if self.beta else self.t >= self.lpb.shape[1]

    def step(self, stored):
        """True where it stored a row or published rows"""
        T, U1, R, step = *self.lpb.shape[1:], self.rings.R, -1 if self.beta else 1
        moved = False
        while not self.done() and (self.t >= stored if self.beta else self.t + U1 <= stored):
            self.out[:, self.t] = self.rings.read_row(self.s_out, U1)
            self.t, self.s_out, moved = self.t + step, (self.s_out + step) % R, True
        n = 0
        while n < self.batch and ((self.r >= 0 and self.r + R > self.t and stored <= self.r + R)
                         if self.beta else (self.r < T and self.r + 1 - R < self.t
                                            and self.r + U1 + 1 - R <= stored)):
            self.rings.copy_row(self.lpb, self.lpl, self.r, self.s_row, 0 if self.beta else 1)
            self.r, self.s_row, n = self.r + step, (self.s_row + step) % R, n + 1
        if moved or n:
            # past the last row, a row "lands" once the places it would take
            # are free
            if self.beta:
                self.landed = self.r + 1 if self.r >= 0 else self.t - R + 1
            else:
                self.landed = self.r if self.r < T else self.t + R - 1
        return moved or n > 0


def _meet(stage, stored, ok, eager):
    """The lattice warp's wait until ``ok(landed)``: an eager staging warp
    has run as far as it can, 8 rows a pass; a lazy one runs only while the
    lattice warp would spin, one row a pass (and must then move, or the two
    deadlock)."""
    if eager:
        while stage.step(stored):
            pass
    while not ok(stage.landed):
        assert stage.step(stored), "the two warps wait on each other"


def _lanes(U1):
    """(C, P, R, cols): lane l's C contiguous columns cols[l] = lC + j, and
    ring_slots(U1)"""
    C = -(-U1 // LANES)
    cols = np.arange(LANES)[:, None] * C + np.arange(C)[None, :]
    R = min(U1 + 2 + SLACK, (MAX_SMEM - 8) // (2 * LANES * C * 4))
    return C, LANES * C, R, cols


def _alpha_warp_model(lpb, lpl, eager):
    """csrc/rnnt_lattice.cu:alpha_warp_kernel: the lattice warp step by step
    on [B, 32, C], its staging warp run at its checks."""
    B, T, U1 = lpb.shape
    C, P, R, cols = _lanes(U1)
    rings = _Rings(B, R, P)
    u = np.arange(U1)
    rings.sb[:, u, u] = NEG
    rings.sl[:, :, 0] = NEG
    out = np.full((B, T, U1), np.nan, np.float32)
    stage = _Stage(rings, lpb, lpl, out, beta=False, batch=8 if eager else 1)
    v = np.broadcast_to(np.where(cols == 0, 0.0, NEG), (B, LANES, C)).astype(np.float32)
    _meet(stage, 0, lambda x: x >= 1, eager)
    s_prev, s_d = 0, 1
    xb, xl = rings.sb[:, s_d, cols], rings.sl[:, s_d, cols]
    n_diag = T + U1 - 1
    # G diagonals a check; the last block's diagonals past the lattice
    for d in range(1, 1 + G * -(-(n_diag - 1) // G)):
        if (d - 1) % G == 0:
            stored = d - 1
            _meet(stage, stored, lambda x: x >= d + G, eager)
        s_next = (s_d + 1) % R
        nb, nl = rings.sb[:, s_next, cols], rings.sl[:, s_next, cols]
        rings.sb[:, s_prev, cols] = v  # diagonal d - 1, one diagonal late
        # one __shfl_up_sync of column C-1 (lane 0 keeps its own)
        left = np.concatenate([v[:, :1, -1:], v[:, :-1, -1:]], axis=1)
        blank = v + xb
        label = np.concatenate([left, v[:, :, :-1]], axis=2) + xl
        t = d - cols
        v = np.where((cols < U1) & (t >= 0) & (t < T), _lae(blank, label), NEG)
        s_prev, s_d = s_d, s_next
        xb, xl = nb, nl
    rings.sb[:, s_prev, cols] = v
    while not stage.done():
        assert stage.step(n_diag), "the staging warp stopped"
    return out


def _beta_warp_model(lpb, lpl, u_lens, eager):
    """csrc/rnnt_lattice.cu:beta_warp_kernel, as ``_alpha_warp_model``, on
    beta's mirrored lanes: lane l's register j is column (31-l)C + C-1-j."""
    B, T, U1 = lpb.shape
    C, P, R, cols = _lanes(U1)
    cols = cols[::-1, ::-1]
    rings = _Rings(B, R, P)
    rings.sl[:, :, U1 - 1] = NEG
    # the exit row's ring values: lpb +1e30 at u == u_len over the NEG of
    # t = T+1 gives 0 exactly, lpb 0 gives NEG
    u = np.arange(U1)
    rings.sb[:, (T + u) % R, u] = np.where(u[None] == u_lens[:, None], 1e30, 0.0)
    rings.sl[:, (T + u) % R, u] = NEG
    out = np.full((B, T + 1, U1), np.nan, np.float32)
    stage = _Stage(rings, lpb, lpl, out, beta=True, batch=8 if eager else 1)
    v = np.full((B, LANES, C), NEG, np.float32)
    n_diag = T + U1
    s_d = (n_diag - 1) % R
    s_prev = (s_d + 1) % R
    xb, xl = rings.sb[:, s_d, cols], rings.sl[:, s_d, cols]
    # G diagonals a check; the last block's diagonals below diagonal 0
    for d in range(n_diag - 1, n_diag - 1 - G * -(-n_diag // G), -1):
        if (n_diag - 1 - d) % G == 0:
            stored = d + 2
            _meet(stage, stored, lambda x: x <= d - G - U1 + 1, eager)
        s_next = (s_d - 1) % R
        nb, nl = rings.sb[:, s_next, cols], rings.sl[:, s_next, cols]
        rings.sb[:, s_prev, cols] = v  # diagonal d + 1, one diagonal late
        # one __shfl_up_sync of register C-1 (lane 0 keeps its own)
        right = np.concatenate([v[:, :1, -1:], v[:, :-1, -1:]], axis=1)
        blank = xb + v
        label = xl + np.concatenate([right, v[:, :, :-1]], axis=2)
        t = d - cols
        v = np.where((cols < U1) & (t >= 0) & (t <= T), _lae(blank, label), NEG)
        s_prev, s_d = s_d, s_next
        xb, xl = nb, nl
    rings.sb[:, s_prev, cols] = v
    while not stage.done():
        assert stage.step(0), "the staging warp stopped"
    return out


def _alpha_block_model(lpb, lpl):
    """csrc/rnnt_lattice.cu:alpha_block_kernel: one thread a column, each
    thread's slab values fetched one diagonal ahead."""
    B, T, U1 = lpb.shape
    u = np.arange(U1)

    def fetch(d):
        t = d - u
        xb = np.where((t >= 1) & (t - 1 < T), lpb[:, np.clip(t - 1, 0, T - 1), u], NEG)
        xl = np.where((u >= 1) & (t >= 0) & (t < T),
                      lpl[:, np.clip(t, 0, T - 1), np.maximum(u - 1, 0)], NEG)
        return xb, xl

    out = np.full((B, T, U1), np.nan, np.float32)
    out[:, 0, 0] = 0.0
    prev = np.broadcast_to(np.where(u == 0, 0.0, NEG), (B, U1)).astype(np.float32)
    ahead = fetch(1)
    for d in range(1, T + U1 - 1):
        (xb, xl), ahead = ahead, fetch(d + 1)
        t = d - u
        blank = np.where(t >= 1, prev + xb, NEG)
        label = np.where(u >= 1, np.concatenate([prev[:, :1], prev[:, :-1]], 1) + xl, NEG)
        inl = (t >= 0) & (t < T)
        prev = np.where(inl, _lae(blank, label), NEG)
        out[:, t[inl], u[inl]] = prev[:, inl]
    return out


def _beta_block_model(lpb, lpl, u_lens):
    """csrc/rnnt_lattice.cu:beta_block_kernel (descending diagonals)."""
    B, T, U1 = lpb.shape
    u = np.arange(U1)
    exit_val = np.where(u[None] == u_lens[:, None], 0.0, NEG).astype(np.float32)

    def fetch(d):
        t = d - u
        inl = (t >= 0) & (t < T)
        tt = np.clip(t, 0, T - 1)
        return np.where(inl, lpb[:, tt, u], NEG), np.where(inl, lpl[:, tt, u], NEG)

    n_diag = T + U1
    out = np.full((B, T + 1, U1), np.nan, np.float32)
    nxt = np.where(u == U1 - 1, exit_val, NEG).astype(np.float32)
    out[:, T, U1 - 1] = nxt[:, U1 - 1]
    ahead = fetch(n_diag - 2)
    for d in range(n_diag - 2, -1, -1):
        (xb, xl), ahead = ahead, fetch(d - 1)
        t = d - u
        blank = xb + nxt
        label = np.where(u + 1 < U1, xl + np.concatenate([nxt[:, 1:], nxt[:, -1:]], 1), NEG)
        val = np.where(t == T, exit_val,
                       np.where((t >= 0) & (t < T), _lae(blank, label), NEG))
        keep = (t >= 0) & (t <= T)
        out[:, t[keep], u[keep]] = val[:, keep]
        nxt = val
    return out


def _schedule_case(T, U1, seed):
    rng = np.random.default_rng(seed)
    B = 4
    lb = -3 * rng.random((B, T, U1), np.float32)
    ll = -3 * rng.random((B, T, U1), np.float32)
    t_lens = np.array([T, 1, max(T - 2, 1), T], np.int32)
    u_lens = np.array([U1 - 1, 0, min(1, U1 - 1), max(U1 - 3, 0)], np.int32)
    return lb, ll, t_lens, u_lens


@pytest.mark.parametrize("U1,T", [(1, 1), (2, 150), (31, 7), (32, 1), (33, 150), (129, 204),
                                  (R.WARP_MAX_U1, 6), (R.WARP_MAX_U1 + 1, 8)])
def test_kernel_schedule_matches_plain_and_jax(U1, T):
    """The schedule the wrappers launch at U+1 = U1 (``lattice_kernel``),
    modelled: the warp kernels' lane columns, boundary shuffle, skewed
    rings and their two warps' counters, with an eager and a lazy staging
    warp; the block kernels' one-ahead fetch. Held to the plain lattices and the JAX package's Pallas kernels
    in interpret mode: rtol 1e-6 / atol 1e-5 on reachable cells, the same
    finite set. U1 2, 33 and 129 wrap the rings (T + U1 > ring_slots)."""
    assert _cu_int(r"#define LATTICE_WARP_MAX_U1 (\d+)") == R.WARP_MAX_U1
    lb, ll, tl, ul = _schedule_case(T, U1, seed=U1 * 31 + T)
    lpb, lpl, _, _ = R._prepare(*_t(lb, ll, tl, ul))
    warp = R.lattice_kernel(U1) == "warp"
    if warp:
        models = [(_alpha_warp_model(lpb.numpy(), lpl.numpy(), eager),
                   _beta_warp_model(lpb.numpy(), lpl.numpy(), ul, eager))
                  for eager in (True, False)]
    else:
        models = [(_alpha_block_model(lpb.numpy(), lpl.numpy()),
                   _beta_block_model(lpb.numpy(), lpl.numpy(), ul))]
    jlpb, jlpl = jnp.asarray(lpb.numpy()), jnp.asarray(lpl.numpy())
    pad = jnp.full((4, 1, U1), JR.NEG_INF, jnp.float32)
    oracles = {
        "plain": (R._alpha_scan(lpb, lpl).numpy(),
                  R._beta_scan(lpb, lpl, torch.from_numpy(ul)).numpy()),
        "pallas_interpret": (
            np.asarray(JR._from_diagonals(alpha_diagonals_pallas(
                JR._to_diagonals(jlpb, JR.NEG_INF), JR._to_diagonals(jlpl, JR.NEG_INF),
                interpret=True), T)),
            np.asarray(JR._from_diagonals(beta_diagonals_pallas(
                JR._to_diagonals(jnp.concatenate([jlpb, pad], 1), JR.NEG_INF),
                JR._to_diagonals(jnp.concatenate([jlpl, pad], 1), JR.NEG_INF),
                jnp.asarray(ul), T, interpret=True), T + 1))),
    }
    for (name, wants), got_ab in itertools.product(oracles.items(), models):
        for got, want in zip(got_ab, wants):
            assert got.shape == want.shape
            reach = want > R.NEG_INF / 2
            np.testing.assert_array_equal(got > R.NEG_INF / 2, reach, err_msg=name)
            np.testing.assert_allclose(got[reach], want[reach], rtol=1e-6, atol=1e-5,
                                       err_msg=name)
