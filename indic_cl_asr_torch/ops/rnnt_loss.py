"""RNN-Transducer loss over blank/label log-prob slabs: CUDA lattice
kernels + plain versions.

Port of indic_cl_asr_tpu/ops/rnnt_loss.py. The joint's log-probs are
reduced up front to two [B, T, U+1] slabs (blank and target label), so the
dynamic programme never touches the vocabulary axis:

  * ``_prepare`` applies the free-blank / impossible-label padding: padded
    frames emit blank with log-prob 0, labels past a row's count are
    impossible (-1e30), so the padded lattice's corner is the true one;
  * the forward runs the alpha lattice, the backward the beta lattice
    (extended with an exit row t = T) and the occupancy formula;
  * ``_reduce`` gives the reference's reductions, with ``row_mask`` for
    the repeat rows that pad a bucket's last batch.

The lattices are the CUDA kernels of ``csrc/rnnt_lattice.cu`` (``rnnt_alpha``
and ``rnnt_beta``, which replace the TPU kernels
``ops/rnnt_loss_pallas.py:alpha_diagonals_pallas`` and
``beta_diagonals_pallas``). Their plain versions, ``_alpha_scan`` and
``_beta_scan``, are the JAX package's anti-diagonal recurrences written as
Python loops over diagonals. PyTorch has no fused scan, so on the card the
~332 diagonals of a flagship lattice (T 204 + U+1 129 - 1) are one launch
each way instead of thousands of small ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30  # large-but-finite to keep arithmetic NaN-free


def _logaddexp(a, b):
    """JAX's form: max + log1p(exp(-|a - b|)); the kernels use the same."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _to_diagonals(x: torch.Tensor, fill: float) -> torch.Tensor:
    """[B, T, U1] -> [B, T+U1-1, U1] with out[b, d, u] = x[b, d-u, u]
    (invalid (d-u) slots get ``fill``)."""
    B, T, U1 = x.shape
    D = T + U1 - 1
    d_idx = torch.arange(D, device=x.device)[:, None]
    u_idx = torch.arange(U1, device=x.device)[None, :]
    t_idx = d_idx - u_idx
    valid = (t_idx >= 0) & (t_idx < T)
    out = x[:, t_idx.clamp(0, T - 1), u_idx.expand(D, U1)]
    return torch.where(valid[None], out, fill)


def _from_diagonals(xd: torch.Tensor, T: int) -> torch.Tensor:
    """Inverse of _to_diagonals: [B, D, U1] -> [B, T, U1]."""
    U1 = xd.shape[2]
    t_idx = torch.arange(T, device=xd.device)[:, None]
    u_idx = torch.arange(U1, device=xd.device)[None, :]
    return xd[:, t_idx + u_idx, u_idx.expand(T, U1)]


def _prepare(lp_blank, lp_label, t_lens, u_lens):
    """Apply the free-blank / impossible-label padding masks."""
    B, T, U1 = lp_blank.shape
    t_idx = torch.arange(T, device=lp_blank.device)[None, :, None]
    u_idx = torch.arange(U1, device=lp_blank.device)[None, None, :]
    t_valid = t_idx < t_lens.to(lp_blank.device)[:, None, None]
    label_valid = t_valid & (u_idx < u_lens.to(lp_blank.device)[:, None, None])
    lpb = torch.where(t_valid, lp_blank, 0.0)
    lpl = torch.where(label_valid, lp_label, NEG_INF)
    return lpb, lpl, t_valid, label_valid


def _alpha_scan(lpb, lpl):
    """Plain version of ``rnnt_alpha``: the forward lattice by anti-diagonal
    wavefront (both predecessors of alpha[t,u] lie on diagonal t+u-1).
    Returns alpha [B, T, U+1] (alpha[0,0] = 0)."""
    B, T, U1 = lpb.shape
    lpb_d = _to_diagonals(lpb, NEG_INF)
    lpl_d = _to_diagonals(lpl, NEG_INF)
    neg = torch.full((B, 1), NEG_INF, dtype=lpb.dtype, device=lpb.device)
    alpha = torch.full((B, U1), NEG_INF, dtype=lpb.dtype, device=lpb.device)
    alpha[:, 0] = 0.0
    diags = [alpha]
    for d in range(1, T + U1 - 1):
        blank = alpha + lpb_d[:, d - 1]
        label = torch.cat([neg, (alpha + lpl_d[:, d - 1])[:, :-1]], dim=1)
        alpha = _logaddexp(blank, label)
        diags.append(alpha)
    return _from_diagonals(torch.stack(diags, dim=1), T)


def _beta_scan(lpb, lpl, u_lens):
    """Plain version of ``rnnt_beta``: the backward lattice by anti-diagonal
    wavefront on the lattice extended with a virtual exit row t = T where
    beta[T, u] = 0 iff u == u_len. Returns beta_ext [B, T+1, U+1];
    beta_ext[:, 0, 0] is log Z."""
    B, T, U1 = lpb.shape
    pad_row = torch.full((B, 1, U1), NEG_INF, dtype=lpb.dtype, device=lpb.device)
    lpb_d = _to_diagonals(torch.cat([lpb, pad_row], dim=1), NEG_INF)
    lpl_d = _to_diagonals(torch.cat([lpl, pad_row], dim=1), NEG_INF)
    D = T + U1
    u_iota = torch.arange(U1, device=lpb.device)[None, :]
    exit_row = torch.where(u_iota == u_lens.to(lpb.device)[:, None], 0.0, NEG_INF)
    neg = torch.full((B, 1), NEG_INF, dtype=lpb.dtype, device=lpb.device)
    beta = torch.where((D - 1 - u_iota) == T, exit_row, NEG_INF)
    diags = [beta]
    for d in range(D - 2, -1, -1):
        blank = lpb_d[:, d] + beta
        label = lpl_d[:, d] + torch.cat([beta[:, 1:], neg], dim=1)
        beta = torch.where((d - u_iota) == T, exit_row, _logaddexp(blank, label))
        diags.append(beta)
    return _from_diagonals(torch.stack(diags[::-1], dim=1), T + 1)


def _check_slabs(lpb, lpl):
    if lpb.shape != lpl.shape or lpb.dim() != 3:
        raise ValueError(f"slabs must share one [B, T, U1] shape: {lpb.shape}, {lpl.shape}")
    if lpb.dtype != torch.float32 or lpl.dtype != torch.float32:
        raise TypeError("the lattice runs in float32")
    if lpb.device != lpl.device or lpb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {lpb.device}, {lpl.device}")
    if lpb.shape[2] > 1024:
        raise ValueError(f"U+1 = {lpb.shape[2]} > 1024: one thread per label column")


def rnnt_alpha(lpb: torch.Tensor, lpl: torch.Tensor) -> torch.Tensor:
    """Forward lattice alpha [B, T, U+1] f32 of the prepared slabs.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_slabs(lpb, lpl)
    if lpb.device.type == "cpu":
        return _alpha_scan(lpb, lpl)
    B, T, U1 = lpb.shape
    lpb, lpl = lpb.contiguous(), lpl.contiguous()
    alpha = torch.empty_like(lpb)
    lib = _build.load("rnnt_lattice")
    stream = torch.cuda.current_stream(lpb.device).cuda_stream
    err = lib.rnnt_alpha(_build.ptr(lpb), _build.ptr(lpl), _build.ptr(alpha),
                         B, T, U1, ctypes.c_void_p(stream))
    _build.check(lib, err, "rnnt_alpha")
    rnnt_alpha.launches += 1
    return alpha


def rnnt_beta(lpb: torch.Tensor, lpl: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """Backward lattice beta_ext [B, T+1, U+1] f32 (exit row t = T) of the
    prepared slabs.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_slabs(lpb, lpl)
    if lpb.device.type == "cpu":
        return _beta_scan(lpb, lpl, u_lens)
    B, T, U1 = lpb.shape
    lpb, lpl = lpb.contiguous(), lpl.contiguous()
    ul = u_lens.to(device=lpb.device, dtype=torch.int32).contiguous()
    beta = torch.empty((B, T + 1, U1), dtype=torch.float32, device=lpb.device)
    lib = _build.load("rnnt_lattice")
    stream = torch.cuda.current_stream(lpb.device).cuda_stream
    err = lib.rnnt_beta(_build.ptr(lpb), _build.ptr(lpl), _build.ptr(ul),
                        _build.ptr(beta), B, T, U1, ctypes.c_void_p(stream))
    _build.check(lib, err, "rnnt_beta")
    rnnt_beta.launches += 1
    return beta


rnnt_alpha.launches = 0
rnnt_beta.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rnnt_alpha.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.rnnt_alpha.restype = i
    lib.rnnt_beta.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.rnnt_beta.restype = i


_build.BINDERS["rnnt_lattice"] = _bind


def _nll(lpb, alpha, u_lens):
    u = u_lens.long()[:, None]
    alpha_final = torch.gather(alpha[:, -1, :], 1, u)[:, 0]
    lpb_final = torch.gather(lpb[:, -1, :], 1, u)[:, 0]
    return -(alpha_final + lpb_final)


class _RNNTNLL(torch.autograd.Function):
    """alpha lattice in the forward; beta lattice and the occupancy
    formula in the backward. ``plain`` runs the plain lattices on any
    device (the reference the kernels are held to)."""

    @staticmethod
    def forward(ctx, lp_blank, lp_label, t_lens, u_lens, plain):
        lpb, lpl, _, _ = _prepare(lp_blank, lp_label, t_lens, u_lens)
        alpha = _alpha_scan(lpb, lpl) if plain else rnnt_alpha(lpb, lpl)
        nll = _nll(lpb, alpha, u_lens)
        ctx.save_for_backward(lp_blank, lp_label, t_lens, u_lens, alpha, nll)
        ctx.plain = plain
        return nll

    @staticmethod
    def backward(ctx, g):
        lp_blank, lp_label, t_lens, u_lens, alpha, nll = ctx.saved_tensors
        lpb, lpl, t_valid, label_valid = _prepare(lp_blank, lp_label, t_lens, u_lens)
        B, T, U1 = lpb.shape
        beta = _beta_scan if ctx.plain else rnnt_beta
        beta_ext = beta(lpb, lpl, u_lens)  # [B, T+1, U1], row T = exit
        logZ = -nll  # == beta_ext[:, 0, 0]
        beta_tnext = beta_ext[:, 1:]  # beta[t+1, u] incl. the exit row
        beta_unext = torch.cat(
            [beta_ext[:, :T, 1:],
             torch.full((B, T, 1), NEG_INF, dtype=lpb.dtype, device=lpb.device)],
            dim=2,
        )  # beta[t, u+1]
        occ_blank = -torch.exp(alpha + lpb + beta_tnext - logZ[:, None, None])
        occ_label = -torch.exp(alpha + lpl + beta_unext - logZ[:, None, None])
        g3 = g[:, None, None]
        d_blank = torch.where(t_valid, occ_blank, 0.0) * g3
        d_label = torch.where(label_valid, occ_label, 0.0) * g3
        return d_blank, d_label, None, None, None


def rnnt_nll_from_logprobs(lp_blank, lp_label, t_lens, u_lens):
    """Per-sample RNNT negative log-likelihood [B], differentiable in the
    two slabs; the lattices are ``rnnt_alpha`` and ``rnnt_beta``.

    lp_blank: [B, T, U+1] f32 log p(blank | t, u)
    lp_label: [B, T, U+1] f32 log p(y_{u+1} | t, u) (column U ignored)
    t_lens:   [B] valid encoder frames;  u_lens: [B] valid labels
    """
    return _RNNTNLL.apply(lp_blank, lp_label, t_lens, u_lens, False)


def rnnt_nll_from_logprobs_reference(lp_blank, lp_label, t_lens, u_lens):
    """``rnnt_nll_from_logprobs`` through the plain lattices, on any device."""
    return _RNNTNLL.apply(lp_blank, lp_label, t_lens, u_lens, True)


def _reduce(nll, label_lens, reduction: str, row_mask=None):
    """Reduce per-row NLLs. ``row_mask`` (bool [B]) marks REAL rows; the
    repeat rows that pad a bucket's last batch are left out."""
    if reduction is None or reduction == "none":
        return nll
    label_lens = label_lens.to(nll.device)
    if row_mask is None:
        if reduction == "mean_batch":
            return nll.mean()
        if reduction == "sum":
            return nll.sum()
        if reduction == "mean":
            return (nll / label_lens.clamp(min=1)).mean()
        if reduction == "mean_volume":
            return nll.sum() / label_lens.sum().clamp(min=1)
        raise ValueError(reduction)
    row_mask = row_mask.to(nll.device)
    nll = torch.where(row_mask, nll, 0.0)
    n = row_mask.to(nll.dtype).sum().clamp(min=1.0)
    if reduction == "mean_batch":
        return nll.sum() / n
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / label_lens.clamp(min=1)).sum() / n
    if reduction == "mean_volume":
        tok = torch.where(row_mask, label_lens, 0).sum()
        return nll.sum() / tok.clamp(min=1)
    raise ValueError(reduction)


def work(B: int, T: int, U1: int, beta: bool = False) -> tuple[int, int]:
    """(bytes, flops) of one lattice launch: the two f32 slabs read once
    and the lattice written once (T+1 rows for beta, plus u_lens); per
    cell two adds and a logaddexp (max, sub, abs, exp, log1p, add)."""
    rows = T + 1 if beta else T
    nbytes = 2 * B * T * U1 * 4 + B * rows * U1 * 4 + (B * 4 if beta else 0)
    return nbytes, 8 * B * rows * U1
