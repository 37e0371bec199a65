"""Transformer-XL relative-position MHSA forward: CUDA kernel + plain version.

Replaces the TPU kernel ``indic_cl_asr_tpu/ops/flash_mhsa.py:_flash_fwd``
(``pl.pallas_call`` at line 383, body ``_fwd_kernel`` at line 197). Same
public layout: heads flat in ``[B, T, H*D]``, ``p`` the ``[2T-1, E]``
position projections in XL order (row m encodes relative position
(T-1) - m), per-row valid lengths and an optional (left, right) band.

    out = softmax(((q+u)·kᵀ + rel_shift((q+v)·pᵀ)) / √D, masked) · V

Numerics of the plain version (``flash_relpos_mhsa_reference``), which the
kernel repeats: f32 dot products; the position scores rounded once to the
compute dtype; scale, then -1e30 masking from the lengths and the band;
exp masked to 0, with a zero denominator taken as 1 so that fully masked
rows give 0; probabilities cast to v's dtype before P·V.

The kernel (``csrc/flash_mhsa.cu``) is a first, simple design: one block
per (64-row query tile, head, batch row) with an online softmax over
64-wide key tiles. The rel-shift is an index into a 127-row window of
``p`` held in shared memory, so T is not padded to 128 and has no cap.
At flagship shapes (B16 T204 E512 H8 bf16) the work is about 2 GFLOP and
13 MB per layer, below the card's bf16 ridge: the bound is the bytes
(about 4 µs). The kernel computes with scalar f32 FMAs from shared memory;
tensor cores (``wgmma``) and TMA are the next step.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _mask(T: int, lens: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """[B, 1, T, T] bool: key j visible from query t."""
    idx = torch.arange(T, device=lens.device)
    valid = idx[None, :] < lens[:, None]
    mask = valid[:, :, None] & valid[:, None, :]
    rel = idx[None, :] - idx[:, None]
    if left >= 0:
        mask = mask & (rel >= -left)[None]
    if right >= 0:
        mask = mask & (rel <= right)[None]
    return mask[:, None]


def flash_relpos_mhsa_reference(
    q, k, v, p, bias_u, bias_v, lens, *, n_heads: int, left: int = -1,
    right: int = -1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the TPU kernel's _head_probs and
    relpos_attention_reference semantics); returns [B, T, E] in q's dtype."""
    B, T, E = q.shape
    H = n_heads
    D = E // H
    dt = q.dtype
    qu = (q + bias_u.reshape(-1).to(dt)).view(B, T, H, D)
    qv = (q + bias_v.reshape(-1).to(dt)).view(B, T, H, D)
    ac = torch.einsum("bthd,bshd->bhts", qu.float(), k.view(B, T, H, D).float())
    raw = torch.einsum(
        "bthd,phd->bhtp", qv.float(), p.reshape(-1, H, D).float()
    )  # [B, H, T, 2T-1]
    t_idx = torch.arange(T, device=q.device)
    shift = (T - 1) + t_idx[None, :] - t_idx[:, None]  # [T(t), T(j)]
    bd = torch.gather(raw, 3, shift.expand(B, H, T, T))
    bd = bd.to(dt).float()  # position scores rounded once to the compute dtype
    s = (ac + bd) * (1.0 / math.sqrt(D))
    mask = _mask(T, lens.to(torch.int64), left, right)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    probs = e / torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum(
        "bhts,bshd->bthd", probs.to(v.dtype).float(),
        v.view(B, T, H, D).float(),
    )
    return out.reshape(B, T, E).to(dt)


def flash_relpos_mhsa(
    q: torch.Tensor,        # [B, T, E] compute dtype, E = n_heads * D
    k: torch.Tensor,        # [B, T, E]
    v: torch.Tensor,        # [B, T, E]
    p: torch.Tensor,        # [2T-1, E] position projections (XL order)
    bias_u: torch.Tensor,   # [n_heads, D]
    bias_v: torch.Tensor,   # [n_heads, D]
    lens: torch.Tensor,     # [B] valid lengths
    *,
    n_heads: int,
    left: int = -1,
    right: int = -1,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Fused rel-pos attention forward; [B, T, E] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the training slice"
        )
    B, T, E = q.shape
    if E % n_heads:
        raise ValueError(f"E={E} is not a multiple of n_heads={n_heads}")
    D = E // n_heads
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, T, E] shape")
    if tuple(p.shape) != (2 * T - 1, E):
        raise ValueError(f"p must be [2T-1, E] = [{2 * T - 1}, {E}], got {tuple(p.shape)}")
    if q.device.type == "cpu":
        return flash_relpos_mhsa_reference(
            q, k, v, p, bias_u, bias_v, lens, n_heads=n_heads, left=left,
            right=right,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dt = q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {dt}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {_HEAD_DIMS}, got {D}")
    for name, t in (("k", k), ("v", v), ("p", p)):
        if t.dtype != dt or t.device != q.device:
            raise TypeError(f"{name} must be {dt} on {q.device}")
    q, k, v, p = (t.contiguous() for t in (q, k, v, p))
    bu = bias_u.reshape(-1).to(dt).contiguous()
    bv = bias_v.reshape(-1).to(dt).contiguous()
    lens_i = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("flash_mhsa")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_relpos_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(p),
        _build.ptr(bu), _build.ptr(bv), _build.ptr(lens_i), _build.ptr(out),
        B, T, n_heads, D, int(left), int(right),
        ctypes.c_float(1.0 / math.sqrt(D)), _DTYPES[dt],
        ctypes.c_void_p(stream),
    )
    _build.check(lib, err, "flash_relpos_fwd")
    flash_relpos_mhsa.launches += 1
    return out


flash_relpos_mhsa.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_relpos_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float,
        i, vp,
    ]
    lib.flash_relpos_fwd.restype = i


_build.BINDERS["flash_mhsa"] = _bind


def work(B: int, T: int, E: int, lens, left: int = -1, right: int = -1,
         itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) one call must move and compute for these inputs:
    q, k, v, p read once and out written once; three dot products of
    length D per visible (query, key) pair (ac, bd, P·V)."""
    nbytes = (4 * B * T * E + (2 * T - 1) * E) * itemsize
    lens = torch.as_tensor(lens, dtype=torch.int64).cpu()
    visible = int(_mask(T, lens, left, right).sum())
    return nbytes, 3 * 2 * visible * E
