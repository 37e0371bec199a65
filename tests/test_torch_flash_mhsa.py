"""Port parity: the plain version of the flash rel-pos attention kernel
(``indic_cl_asr_torch.ops.flash_mhsa``) against the JAX package's Pallas
kernel in interpret mode and its XLA oracle ``relpos_attention_reference``,
in f32 on the CPU, atol 1e-5. Cases cover a row with lens=0, T=1 and
(left, right) bands. The kernel itself is held against this plain version
on the card by tests/test_torch_kernels_gpu.py.

A CPU model of the bf16 forward kernel's schedule (``_kernel_schedule``:
64-row query tiles and 64-wide key tiles, each warp's 16x80 window product
rounded to the compute dtype and read back at its skewed index, the
online softmax with exps rounded per key tile, O rescaled, one final
division) is held against the plain version and the JAX package's Pallas
kernel in interpret mode: in f32 to atol 1e-5 (outputs and the row
log-sum-exps), in bf16 to the card's bar of 2e-2 (the kernel rounds each
tile's exps before P·V, the plain version the normalised probabilities),
and its position scores to the plain version's rel-shift exactly in f32.

A CPU model of the bf16 backward kernel's schedule (``_bwd_schedule``: the
same tiles and scores, a first walk summing delta = rowsum(dP∘P), dS
rounded to the compute dtype once, dS written skewed into the Z buffer
with its zero band, dQv = Z·Win per warp, dp from Zᵀ·Qv over each block's
window held across the key walk, dK and dV from the staged tiles) is held
against the plain version's autograd and ``jax.vjp`` of the JAX
package's Pallas kernel in interpret mode: in f32 to atol 1e-5, in bf16 to
the card's bar of 2e-2 of max|ref| with and without dropout; with a
(0, 0) band (one key a row, P exactly 1) its dqu, dqv, dk and dp are
exactly zero, as the card test asks of the kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.flash_mhsa import flash_relpos_mhsa as jax_flash
from indic_cl_asr_tpu.ops.flash_mhsa import relpos_attention_reference
from indic_cl_asr_torch.ops.flash_mhsa import (
    _aligned,
    flash_relpos_mhsa_backward_reference,
    _mask,
    dropout_bits,
    flash_relpos_mhsa,
    flash_relpos_mhsa_reference,
    keep_threshold,
    work,
    work_backward,
)

ATOL = 1e-5


def _inputs(seed, B, T, H, D, lens):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    p = rng.standard_normal((2 * T - 1, H * D)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    vb = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    return q, k, v, p, u, vb, np.asarray(lens, np.int32)


def _port(args, H, **kw):
    return flash_relpos_mhsa_reference(
        *(torch.from_numpy(a) for a in args), n_heads=H, **kw
    ).numpy()


CASES = [
    # (T, H, D, lens, (left, right))
    (37, 2, 16, [37, 0, 20], (-1, -1)),
    (1, 2, 16, [1, 0], (-1, -1)),
    (40, 4, 16, [40, 33], (16, 0)),
    (70, 2, 32, [70, 50], (20, 10)),
    (23, 1, 16, [23, 5], (-1, 3)),
]


@pytest.mark.parametrize("T,H,D,lens,band", CASES)
def test_plain_matches_xla_oracle(T, H, D, lens, band):
    B = len(lens)
    args = _inputs(T, B, T, H, D, lens)
    left, right = band
    out = _port(args, H, left=left, right=right)
    q, k, v, p, u, vb, ln = args
    ref = relpos_attention_reference(
        jnp.asarray(q.reshape(B, T, H, D)), jnp.asarray(k.reshape(B, T, H, D)),
        jnp.asarray(v.reshape(B, T, H, D)), jnp.asarray(p.reshape(-1, H, D)),
        jnp.asarray(u), jnp.asarray(vb), jnp.asarray(ln), left=left, right=right,
    )
    np.testing.assert_allclose(out, np.asarray(ref).reshape(B, T, H * D), atol=ATOL)
    # rows past the valid length, and every row of a lens=0 row, are zero
    for b, n in enumerate(lens):
        assert np.abs(out[b, n:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("T,H,D,lens,band", CASES[:3])
def test_plain_matches_pallas_interpret(T, H, D, lens, band):
    B = len(lens)
    args = _inputs(T + 100, B, T, H, D, lens)
    left, right = band
    out = _port(args, H, left=left, right=right)
    ref = jax_flash(
        *(jnp.asarray(a) for a in args), n_heads=H, left=left, right=right,
        interpret=True,
    )
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_wrapper_on_cpu_takes_plain_version_and_checks_inputs():
    args = [torch.from_numpy(a) for a in _inputs(5, 2, 12, 2, 16, [12, 7])]
    before = flash_relpos_mhsa.launches
    out = flash_relpos_mhsa(*args, n_heads=2)
    assert torch.equal(out, flash_relpos_mhsa_reference(*args, n_heads=2))
    assert flash_relpos_mhsa.launches == before  # no kernel launched on the CPU
    dropped = flash_relpos_mhsa(*args, n_heads=2, dropout_rate=0.1, seed=3)
    assert torch.equal(dropped, flash_relpos_mhsa_reference(
        *args, n_heads=2, dropout_rate=0.1, seed=3))
    assert not torch.equal(dropped, out)
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*args, n_heads=2, dropout_rate=1.0)
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*args[:3], args[3][:-1], *args[4:], n_heads=2)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*meta, n_heads=2)


def test_aligned_copies_only_misaligned_operands():
    """The bf16 kernel copies 16-byte chunks: an operand that starts off a
    16-byte boundary is copied, an aligned contiguous one is passed as is."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert _aligned(base) is base
    view = base[1:33]  # 2 bytes past the storage's start
    assert view.data_ptr() % 16 != 0
    got = _aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_work_counts_visible_pairs():
    # q, k, v over the 4 + 2 rows within the lengths, p over offsets -3..3,
    # the two biases, out in full
    nbytes, flops = work(2, 4, 8, [4, 2], itemsize=2)
    assert nbytes == (3 * 6 * 8 + 7 * 8 + 2 * 8 + 2 * 4 * 8) * 2
    assert flops == 3 * 2 * (16 + 4) * 8
    # a band of one key reads p at offset 0 alone; a row of length 0 nothing
    banded_bytes, banded = work(2, 4, 8, [4, 0], left=0, right=0)
    assert banded_bytes == (3 * 4 * 8 + 1 * 8 + 2 * 8 + 2 * 4 * 8) * 2
    assert banded == 3 * 2 * 4 * 8


def test_work_backward_counts_the_rows_within_the_lengths():
    # q, k, v, dO over 6 rows, p over 7 offsets, the biases, lse [B, H, T]
    # f32 over 6 rows; dq, dk, dv, dp in full and the bias gradients
    nbytes, flops = work_backward(2, 4, 8, [4, 2], n_heads=2, itemsize=2)
    read = (4 * 6 * 8 + 7 * 8 + 2 * 8) * 2 + 6 * 2 * 4
    written = (3 * 2 * 4 * 8 + 7 * 8 + 2 * 8) * 2
    assert nbytes == read + written
    assert flops == 8 * 2 * (16 + 4) * 8


# --- a CPU model of the bf16 forward kernel's schedule (csrc/flash_mhsa.cu,
# flash_relpos_fwd_mma_kernel) ---

TQ = TK = 64  # query rows a block, key columns a tile
WARP_ROWS = 16  # query rows a warp
XW = 80  # window rows a warp reads
NEG = -1e30


def _window_scores(qv_t, win, dt):
    """bd of one (query tile, key tile) pair as the kernel forms it: warp w
    multiplies its 16 rows by window rows base .. base+79 (base = 48-16w),
    rounds the 16x80 product to the compute dtype as it stages it, and
    reads bd[i][c] at staging column c - i + 15 (= c - r + 63 - base).
    qv_t [..., 64, D], win [..., 128, D] -> [..., 64, 64] f32."""
    i = torch.arange(WARP_ROWS)[:, None]
    idx = torch.arange(TK)[None, :] - i + (WARP_ROWS - 1)
    parts = []
    for w in range(TQ // WARP_ROWS):
        base = (TQ - WARP_ROWS) - WARP_ROWS * w
        raw = qv_t[..., WARP_ROWS * w:WARP_ROWS * (w + 1), :] @ win[..., base:base + XW, :].mT
        raw = raw.to(dt).float()
        parts.append(torch.gather(raw, -1, idx.expand(*raw.shape[:-1], TK)))
    return torch.cat(parts, dim=-2)


def _tile_rows(x, start, count, limit):
    """Rows start .. start+count-1 of x [B, H, R, D], zero past limit or below 0."""
    out = torch.zeros(*x.shape[:2], count, x.shape[-1])
    lo, hi = max(start, 0), min(start + count, limit)
    if hi > lo:
        out[:, :, lo - start:hi - start] = x[:, :, lo:hi]
    return out


def _kernel_schedule(q, k, v, p, u, vb, lens, H, left=-1, right=-1, rate=0.0,
                     seed=0, with_bd=False):
    """(out [B, T, E] in q's dtype, lse [B, H, T] f32) by the kernel's steps.
    Key tiles the kernel skips (outside the length or the band) hold only
    masked pairs, which change nothing here, so every tile is walked."""
    B, T, E = q.shape
    D = E // H
    dt = q.dtype
    heads = lambda x: x.float().view(x.shape[0], T, H, D).transpose(1, 2)
    qu = heads((q.float() + u.reshape(-1).float()).to(dt))
    qv = heads((q.float() + vb.reshape(-1).float()).to(dt))
    n = lens.to(torch.int64).clamp(0, T)
    kv_ok = (torch.arange(T)[None, :] < n[:, None])[:, None, :, None]
    kh, vh = heads(k) * kv_ok, heads(v) * kv_ok  # rows past the length zero-filled
    ph = p.float().view(2 * T - 1, H, D).transpose(0, 1)[None]  # [1, H, 2T-1, D]
    mask = _mask(T, n, left, right)  # [B, 1, T, T]
    bits = dropout_bits(seed, B, H, T) if rate > 0.0 else None
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, H, T, D)
    lse = torch.zeros(B, H, T)
    bd_all = torch.zeros(B, H, T, T)
    for t0 in range(0, T, TQ):
        rows = min(TQ, T - t0)
        qu_t, qv_t = (_tile_rows(x, t0, TQ, T) for x in (qu, qv))
        m = torch.full((B, H, TQ), NEG)
        l = torch.zeros(B, H, TQ)
        o = torch.zeros(B, H, TQ, D)
        for j0 in range(0, T, TK):
            cols = min(TK, T - j0)
            k_t, v_t = (_tile_rows(x, j0, TK, T) for x in (kh, vh))
            g0 = (T - 1) + j0 - t0 - (TQ - 1)
            win = _tile_rows(ph, g0, TQ + TK - 1, 2 * T - 1)
            win = torch.cat([win, torch.zeros(1, H, 1, D)], dim=2)  # row 127, never read
            bd = _window_scores(qv_t, win, dt)
            bd_all[:, :, t0:t0 + rows, j0:j0 + cols] = bd[..., :rows, :cols]
            ok = torch.zeros(B, 1, TQ, TK, dtype=torch.bool)
            ok[..., :rows, :cols] = mask[..., t0:t0 + rows, j0:j0 + cols]
            s = torch.where(ok, (qu_t @ k_t.mT + bd) * scale, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            ex = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + ex.sum(-1)
            if bits is not None:
                keep = torch.zeros(B, H, TQ, TK, dtype=torch.bool)
                keep[..., :rows, :cols] = (bits[:, :, t0:t0 + rows, j0:j0 + cols]
                                           <= keep_threshold(rate))
                ex = torch.where(keep, ex, 0.0)
            o = o * alpha[..., None] + ex.to(dt).float() @ v_t
            m = m_new
        inv = torch.where(l == 0, 1.0, 1.0 / l) * (1.0 / (1.0 - rate))
        out[:, :, t0:t0 + rows] = (o * inv[..., None])[:, :, :rows]
        lse[:, :, t0:t0 + rows] = torch.where(l > 0, m + torch.log(l), 0.0)[:, :, :rows]
    out = out.transpose(1, 2).reshape(B, T, E).to(dt)
    return (out, lse, bd_all) if with_bd else (out, lse)


def _plain_lse(args, H, left, right):
    """Each row's log-sum-exp of the plain version's masked scores (0 for
    fully masked rows), f32."""
    q, k, v, p, u, vb, lens = args
    B, T, E = q.shape
    D = E // H
    qu = (q + u.reshape(-1)).view(B, T, H, D)
    qv = (q + vb.reshape(-1)).view(B, T, H, D)
    ac = torch.einsum("bthd,bshd->bhts", qu, k.view(B, T, H, D))
    raw = torch.einsum("bthd,phd->bhtp", qv, p.view(-1, H, D))
    t_idx = torch.arange(T)
    shift = (T - 1) + t_idx[None, :] - t_idx[:, None]
    bd = torch.gather(raw, 3, shift.expand(B, H, T, T))
    mask = _mask(T, lens.to(torch.int64), left, right)
    s = torch.where(mask, (ac + bd) / math.sqrt(D), -math.inf)
    out = torch.logsumexp(s, dim=-1)
    return torch.where(mask.any(-1), out, 0.0), bd


EDGE_CASES = CASES + [
    # T at the tile edges, with lens and a band
    (63, 2, 16, [63, 40], (-1, -1)),
    (64, 2, 16, [64, 0, 17], (-1, -1)),
    (65, 1, 32, [65, 64], (-1, -1)),
    (129, 2, 16, [129, 100], (-1, -1)),
    (129, 2, 16, [129, 70], (30, 5)),
]


def _torch_args(T, H, D, lens, dt=torch.float32, seed=None):
    args = [torch.from_numpy(a) for a in _inputs(T + 7 if seed is None else seed,
                                                   len(lens), T, H, D, lens)]
    return [a.to(dt) for a in args[:6]] + [args[6]]


@pytest.mark.parametrize("T,H,D,lens,band", EDGE_CASES)
def test_kernel_schedule_matches_plain_f32(T, H, D, lens, band):
    args = _torch_args(T, H, D, lens)
    left, right = band
    out, lse, bd = _kernel_schedule(*args, H, left=left, right=right, with_bd=True)
    ref = flash_relpos_mhsa_reference(*args, n_heads=H, left=left, right=right)
    assert (out - ref).abs().max().item() <= ATOL
    ref_lse, ref_bd = _plain_lse(args, H, left, right)
    assert (lse - ref_lse).abs().max().item() <= ATOL
    # the window index: every position score is the plain rel-shift's
    assert (bd - ref_bd).abs().max().item() <= ATOL


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,H,D,lens,band", [EDGE_CASES[i] for i in (0, 2, 6, 9)])
def test_kernel_schedule_matches_plain_bf16(T, H, D, lens, band, rate):
    """bf16 rounding points: q+u and q+v, the staged position scores,
    each tile's exps before P·V; held to the card test's bf16 bar."""
    args = _torch_args(T, H, D, lens, dt=torch.bfloat16)
    left, right = band
    kw = dict(left=left, right=right, rate=rate, seed=T)
    out, _ = _kernel_schedule(*args, H, **kw)
    ref = flash_relpos_mhsa_reference(*args, n_heads=H, left=left, right=right,
                                      dropout_rate=rate, seed=T)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_kernel_schedule_f32_dropout_matches_plain():
    args = _torch_args(65, 2, 16, [65, 30])
    out, _ = _kernel_schedule(*args, 2, rate=0.1, seed=11)
    ref = flash_relpos_mhsa_reference(*args, n_heads=2, dropout_rate=0.1, seed=11)
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.parametrize("T,H,D,lens,band", [EDGE_CASES[i] for i in (2, 6, 9)])
def test_kernel_schedule_matches_pallas_interpret(T, H, D, lens, band):
    args = _torch_args(T, H, D, lens)
    left, right = band
    out, _ = _kernel_schedule(*args, H, left=left, right=right)
    ref = jax_flash(
        *(jnp.asarray(a.numpy()) for a in args), n_heads=H, left=left, right=right,
        interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# --- a CPU model of the bf16 backward kernel's schedule (csrc/flash_mhsa.cu,
# flash_relpos_bwd_mma_kernel) ---

WR = 128  # window rows a key tile: the 127 the rel-shift reads, and one never read


def _bwd_schedule(q, k, v, p, u, vb, lens, dout, lse, H, left=-1, right=-1, rate=0.0,
                  seed=0):
    """(dq, dk, dv, dp, d_bias_u, d_bias_v) by the bf16 backward kernel's
    steps, for the forward's row log-sum-exps ``lse`` [B, H, T]. Per
    (64-row query tile, batch row, head): the forward's scores
    (``_window_scores``), P = exp(s - lse), dP = keep ? dO·Vᵀ/(1-rate) : 0;
    a first walk over the key tiles sums delta; the second rounds
    dS = P (dP - delta) scale to the compute dtype once, writes it skewed
    into Z [64, 128] (Z[r][w] = dS[r][w + r - 63], 0 off the band), and
    adds dQu = dS·K, dQv = Z·Win over each warp's 80 window rows, dK =
    dSᵀ·Qu, dV = Pdᵀ·dO (Pd rounded) and Zᵀ·Qv into the block's window of
    dp, whose lower half goes to dp after each tile (no later tile reaches
    it) and whose whole goes after the last. Every key tile is walked:
    those the kernel skips hold only masked pairs, which add zeros."""
    B, T, E = q.shape
    D = E // H
    dt = q.dtype
    heads = lambda x: x.float().view(x.shape[0], T, H, D).transpose(1, 2)
    qu = heads((q.float() + u.reshape(-1).float()).to(dt))
    qv = heads((q.float() + vb.reshape(-1).float()).to(dt))
    n = lens.to(torch.int64).clamp(0, T)
    kv_ok = (torch.arange(T)[None, :] < n[:, None])[:, None, :, None]
    kh, vh = heads(k) * kv_ok, heads(v) * kv_ok  # rows past the length zero-filled
    doh = heads(dout.to(dt))
    ph = p.float().view(2 * T - 1, H, D).transpose(0, 1)[None]
    mask = _mask(T, n, left, right)
    bits = dropout_bits(seed, B, H, T) if rate > 0.0 else None
    scale, dscale = 1.0 / math.sqrt(D), 1.0 / (1.0 - rate)
    # Z's column of dS[r][c]
    zcol = torch.arange(TK)[None, :] - torch.arange(TQ)[:, None] + (TQ - 1)
    dqu, dqv, dk, dv = (torch.zeros(B, H, T, D) for _ in range(4))
    dp = torch.zeros(H, 2 * T - 1, D)

    def add_window(rows, g0):
        for x in range(rows.shape[2]):
            if 0 <= g0 + x < 2 * T - 1:
                dp[:, g0 + x] += rows[:, :, x].sum(0)

    for t0 in range(0, T, TQ):
        rows = min(TQ, T - t0)
        qu_t, qv_t, do_t = (_tile_rows(x, t0, TQ, T) for x in (qu, qv, doh))
        lse_t = torch.zeros(B, H, TQ)
        lse_t[..., :rows] = lse[..., t0:t0 + rows]

        def probs(j0):
            cols = min(TK, T - j0)
            k_t, v_t = (_tile_rows(x, j0, TK, T) for x in (kh, vh))
            g0 = (T - 1) + j0 - t0 - (TQ - 1)
            win = _tile_rows(ph, g0, TQ + TK - 1, 2 * T - 1)
            win = torch.cat([win, torch.zeros(1, H, 1, D)], dim=2)  # row 127, never read
            ok = torch.zeros(B, 1, TQ, TK, dtype=torch.bool)
            ok[..., :rows, :cols] = mask[..., t0:t0 + rows, j0:j0 + cols]
            s = torch.where(ok, (qu_t @ k_t.mT + _window_scores(qv_t, win, dt)) * scale, NEG)
            P = torch.where(ok, torch.exp(s - lse_t[..., None]), 0.0)
            keep = torch.ones(B, H, TQ, TK, dtype=torch.bool)
            if bits is not None:
                keep[..., :rows, :cols] = (bits[:, :, t0:t0 + rows, j0:j0 + cols]
                                           <= keep_threshold(rate))
            dP = torch.where(keep, (do_t @ v_t.mT) * dscale, 0.0)
            Pd = torch.where(keep, P * dscale, 0.0)
            return cols, k_t, win, g0, P, dP, Pd

        delta = torch.zeros(B, H, TQ)
        for j0 in range(0, T, TK):
            _, _, _, _, P, dP, _ = probs(j0)
            delta += (dP * P).sum(-1)
        held = torch.zeros(B, H, WR, D)
        for j0 in range(0, T, TK):
            cols, k_t, win, g0, P, dP, Pd = probs(j0)
            dS = (P * (dP - delta[..., None]) * scale).to(dt).float()
            Z = torch.zeros(B, H, TQ, WR).scatter_(-1, zcol.expand(B, H, TQ, TK), dS)
            dqu[:, :, t0:t0 + rows] += (dS @ k_t)[..., :rows, :]
            for w in range(TQ // WARP_ROWS):
                base = (TQ - WARP_ROWS) - WARP_ROWS * w
                r0 = WARP_ROWS * w
                part = Z[..., r0:r0 + WARP_ROWS, base:base + XW] @ win[..., base:base + XW, :]
                dqv[:, :, t0 + r0:t0 + min(rows, r0 + WARP_ROWS)] += part[..., :max(0, rows - r0), :]
            dk[:, :, j0:j0 + cols] += (dS.mT @ qu_t)[..., :cols, :]
            dv[:, :, j0:j0 + cols] += (Pd.to(dt).float().mT @ do_t)[..., :cols, :]
            held += Z.mT @ qv_t
            if j0 + TK >= T:
                add_window(held, g0)
            else:
                add_window(held[:, :, :TQ], g0)
                held = torch.cat([held[:, :, TQ:], torch.zeros(B, H, TQ, D)], dim=2)
    flat = lambda x: x.transpose(1, 2).reshape(B, T, E)
    dq = flat(dqu + dqv).to(dt)
    return (dq, flat(dk).to(dt), flat(dv).to(dt), dp.transpose(0, 1).reshape(2 * T - 1, E).to(dt),
            dqu.sum((0, 2)).to(dt), dqv.sum((0, 2)).to(dt))


def _bwd_args(T, H, D, lens, dt=torch.float32):
    args = _torch_args(T, H, D, lens, dt=dt)
    rng = np.random.default_rng(T + 11)
    dout = torch.from_numpy(rng.standard_normal((len(lens), T, H * D)).astype(np.float32))
    return args, dout.to(dt)


def _rel_err(got, want, dout):
    """Max abs error over max|ref|, floored at 1% of max|dout| for
    gradients that vanish in exact arithmetic (the card tests' measure)."""
    scale = max(want.float().abs().max().item(), 0.01 * dout.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


@pytest.mark.parametrize("T,H,D,lens,band", EDGE_CASES)
def test_bwd_schedule_matches_plain_f32(T, H, D, lens, band):
    args, dout = _bwd_args(T, H, D, lens)
    left, right = band
    _, lse = _kernel_schedule(*args, H, left=left, right=right)
    got = _bwd_schedule(*args, dout, lse, H, left=left, right=right)
    want = flash_relpos_mhsa_backward_reference(*args, dout, n_heads=H, left=left, right=right)
    for name, g, w in zip(("q", "k", "v", "p", "bias_u", "bias_v"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= ATOL, name


@pytest.mark.parametrize("T,H,D,lens,band", [EDGE_CASES[i] for i in (2, 6, 9)])
def test_bwd_schedule_matches_pallas_interpret(T, H, D, lens, band):
    args, dout = _bwd_args(T, H, D, lens)
    left, right = band
    _, lse = _kernel_schedule(*args, H, left=left, right=right, rate=0.0)
    got = _bwd_schedule(*args, dout, lse, H, left=left, right=right)
    ln = jnp.asarray(args[6].numpy())

    def f(*x):
        return jax_flash(*x, ln, n_heads=H, left=left, right=right, interpret=True)

    leaves = [jnp.asarray(a.numpy()) for a in args[:6]]
    want = jax.vjp(f, *leaves)[1](jnp.asarray(dout.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,H,D,lens,band", [EDGE_CASES[i] for i in (0, 2, 6, 9)])
def test_bwd_schedule_matches_plain_bf16(T, H, D, lens, band, rate):
    """bf16 rounding points: the forward's scores, dS once, Pd for dV;
    held to the card test's bar of 2e-2 of max|ref|."""
    args, dout = _bwd_args(T, H, D, lens, dt=torch.bfloat16)
    left, right = band
    kw = dict(left=left, right=right, rate=rate, seed=T)
    _, lse = _kernel_schedule(*args, H, **kw)
    got = _bwd_schedule(*args, dout, lse, H, **kw)
    want = flash_relpos_mhsa_backward_reference(*args, dout, n_heads=H, left=left,
                                                right=right, dropout_rate=rate, seed=T)
    for name, g, w in zip(("q", "k", "v", "p", "bias_u", "bias_v"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16, name
        assert _rel_err(g, w, dout) <= 2e-2, name


def test_bwd_schedule_f32_dropout_matches_plain():
    args, dout = _bwd_args(65, 2, 16, [65, 30])
    _, lse = _kernel_schedule(*args, 2, rate=0.1, seed=11)
    got = _bwd_schedule(*args, dout, lse, 2, rate=0.1, seed=11)
    want = flash_relpos_mhsa_backward_reference(*args, dout, n_heads=2, dropout_rate=0.1, seed=11)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= ATOL


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_schedule_band_00_gives_exact_zeros_bf16(rate):
    """One visible key a row: the forward's lse is that key's score, so
    P = exp(s - lse) = 1 exactly, delta = dP and dS = 0: dq, dk, dp and the
    bias gradients vanish exactly, dv does not."""
    args, dout = _bwd_args(129, 2, 16, [129, 70, 0], dt=torch.bfloat16)
    kw = dict(left=0, right=0, rate=rate, seed=3)
    _, lse = _kernel_schedule(*args, 2, **kw)
    dq, dk, dv, dp, dbu, dbv = _bwd_schedule(*args, dout, lse, 2, **kw)
    for g in (dq, dk, dp, dbu, dbv):
        assert not g.any()
    assert dv.float().abs().max().item() > 0.1
