"""Transformer-XL relative-position MHSA: CUDA kernels + plain versions.

Replaces the TPU kernels ``indic_cl_asr_tpu/ops/flash_mhsa.py:_flash_fwd``
(``pl.pallas_call`` at line 383, body ``_fwd_kernel`` at line 197) and
``_flash_bwd`` (``pl.pallas_call`` at line 416, body ``_bwd_kernel`` at
line 225). Same public layout: heads flat in ``[B, T, H*D]``, ``p`` the
``[2T-1, E]`` position projections in XL order (row m encodes relative
position (T-1) - m), per-row valid lengths and an optional (left, right)
band.

    out = drop(softmax(((q+u)·kᵀ + rel_shift((q+v)·pᵀ)) / √D, masked)) · V

Numerics of the plain version (``flash_relpos_mhsa_reference``), which the
kernels repeat: f32 dot products; the position scores rounded once to the
compute dtype; scale, then -1e30 masking from the lengths and the band;
exp masked to 0, with a zero denominator taken as 1 so that fully masked
rows give 0; inverted dropout on the probabilities; probabilities cast to
v's dtype before P·V.

Dropout keeps a probability where its 32 random bits are at most
``uint32((1-rate)(2^32-1))``, the TPU kernel's threshold (not the 1/256
quantisation of ``models/common.py:dropout``). The bits are a counter-based
hash of (seed, b, h, t, j) (``dropout_bits``, the kernel's
``drop_bits``): the backward draws the same mask again, nothing is stored,
and the plain version computes the very same bits, so kernel and plain
version agree with dropout on.

The kernels (``csrc/flash_mhsa.cu``): one block per (64-row query tile,
head, batch row) walking 64-wide key tiles; the rel-shift reads only a
127-row window of ``p`` per tile pair, so T is not padded and has no cap.
In bf16 both directions run on the tensor cores (``mma.sync.m16n8k16``,
f32 sums): 4 warps of 16 query rows over bf16 tiles in shared memory.
Both rebuild the scores through one device function: each warp computes
the 16x80 product of its rows with the window rows it needs, rounds it to
bf16 into shared memory (the position score's one rounding) and reads
each score back at its skewed column. The forward keeps its softmax
statistics in registers and sends P to the P·V product as bf16 register
fragments; it stores each row's log-sum-exp. The backward rebuilds
P = exp(s - lse) from the very same scores, walks the key tiles twice (a
first walk sums rowsum(dP∘P), a second forms dS, rounded to bf16 once,
and runs dQu, dQv, dK, dV and dp on the tensor cores, dp through dS
written skewed into a buffer, the transpose of the forward's staging),
keeps dq in registers and adds dk, dv and dp (summed over the batch) into
f32 with 16-byte atomic reductions, dp once per window row and block. In
f32 both directions compute with scalar FMAs from shared memory. At
flagship shapes (B16 T204 E512 H8 bf16) both are below the card's bf16
ridge, so the bytes bound them (about 3 µs forward, 6 µs backward).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# the backward at D=128: the bf16 kernel's register accumulators (dq and
# the held dp window) and the f32 kernel's shared tiles would overflow
_BWD_HEAD_DIMS = (16, 32, 64)
_M32 = 0xFFFFFFFF


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


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: int, B: int, H: int, T: int, device=None) -> torch.Tensor:
    """[B, H, T, T] int64 holding the kernel's uint32 dropout bits:
    key = fmix32(seed ^ (b*H+h)·0x9E3779B9), bits = fmix32(key ^ fmix32(t*T+j))."""
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H)
    key = _fmix32((seed & _M32) ^ _mul32(bh, 0x9E3779B9))
    tj = torch.arange(T * T, dtype=torch.int64, device=device).view(T, T)
    return _fmix32(key[:, :, None, None] ^ _fmix32(tj)[None, None])


def keep_threshold(rate: float) -> int:
    """The TPU kernel's keep threshold: keep where bits <= this."""
    return int((1.0 - rate) * (2**32 - 1))


def flash_relpos_mhsa_reference(
    q, k, v, p, bias_u, bias_v, lens, *, n_heads: int, left: int = -1,
    right: int = -1, dropout_rate: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels (the TPU kernel's _head_probs,
    _apply_drop and relpos_attention_reference semantics); differentiable,
    so its autograd is the backward kernel's plain version. Returns
    [B, T, E] in q's dtype."""
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
    if dropout_rate > 0.0:
        keep = dropout_bits(seed, B, H, T, q.device) <= keep_threshold(dropout_rate)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.einsum(
        "bhts,bshd->bthd", probs.to(v.dtype).float(),
        v.view(B, T, H, D).float(),
    )
    return out.reshape(B, T, E).to(dt)


def _check(q, k, v, p, n_heads):
    B, T, E = q.shape
    if E % n_heads:
        raise ValueError(f"E={E} is not a multiple of n_heads={n_heads}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, T, E] shape")
    if tuple(p.shape) != (2 * T - 1, E):
        raise ValueError(f"p must be [2T-1, E] = [{2 * T - 1}, {E}], got {tuple(p.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_cuda(q, k, v, p, n_heads, dims):
    dt = q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {dt}")
    D = q.shape[-1] // n_heads
    if D not in dims:
        raise ValueError(f"flash kernel head dim must be one of {dims}, got {D}")
    for name, t in (("k", k), ("v", v), ("p", p)):
        if t.dtype != dt or t.device != q.device:
            raise TypeError(f"{name} must be {dt} on {q.device}")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in ``dtype``, without a dispatch where it already is (the
    backward wrapper's host time is most of an eager call)."""
    return t if t.dtype == dtype else t.to(dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _drop_args(dropout_rate: float, seed: int):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    on = dropout_rate > 0.0
    return (
        ctypes.c_uint(seed & _M32 if on else 0),
        ctypes.c_uint(keep_threshold(dropout_rate) if on else 0),
        ctypes.c_float(1.0 / (1.0 - dropout_rate)), int(on),
    )


def _launch_fwd(q, k, v, p, bias_u, bias_v, lens, n_heads, left, right,
                dropout_rate, seed, need_lse):
    """The forward kernel -> (out, lse [B, H, T] f32 or None)."""
    _check_cuda(q, k, v, p, n_heads, _HEAD_DIMS)
    B, T, E = q.shape
    dt = q.dtype
    D = E // n_heads
    # the bf16 kernel copies 16-byte chunks of every operand
    q, k, v, p = (_aligned(t) for t in (q, k, v, p))
    bu = _aligned(bias_u.reshape(-1).to(dt))
    bv = _aligned(bias_v.reshape(-1).to(dt))
    lens_i = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((B, n_heads, T), dtype=torch.float32, device=q.device)
           if need_lse else None)
    lib = _build.load("flash_mhsa")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = _build.ptr
    err = lib.flash_relpos_fwd(
        ptr(q), ptr(k), ptr(v), ptr(p), ptr(bu), ptr(bv), ptr(lens_i),
        ptr(out), ptr(lse) if lse is not None else None,
        B, T, n_heads, D, int(left), int(right),
        ctypes.c_float(1.0 / math.sqrt(D)), *_drop_args(dropout_rate, seed),
        _DTYPES[dt], ctypes.c_void_p(stream),
    )
    _build.check(lib, err, "flash_relpos_fwd")
    flash_relpos_mhsa.launches += 1
    return out, lse


def flash_relpos_mhsa_backward(
    q, k, v, p, bias_u, bias_v, lens, lse, dout, *, n_heads: int,
    left: int = -1, right: int = -1, dropout_rate: float = 0.0, seed: int = 0,
):
    """The backward kernel: gradients (dq, dk, dv, dp, d_bias_u, d_bias_v)
    of the forward that gave the row statistics ``lse``, for the cotangent
    ``dout``. dq = dqu + dqv (qu = q+u and qv = q+v); d_bias_u and d_bias_v
    are dqu and dqv summed over B and T, per head. CUDA tensors only: on
    the CPU the plain version's autograd is the backward."""
    _check(q, k, v, p, n_heads)
    if q.device.type != "cuda":
        raise ValueError("flash_relpos_mhsa_backward launches the CUDA kernel; "
                         "on the CPU use autograd through the plain version")
    _check_cuda(q, k, v, p, n_heads, _BWD_HEAD_DIMS)
    B, T, E = q.shape
    dt = q.dtype
    D = E // n_heads
    # the bf16 kernel copies 16-byte chunks of every operand
    q, k, v, p = (_aligned(t) for t in (q, k, v, p))
    dout = _aligned(_as(dout, dt))
    bu = _aligned(_as(bias_u, dt))  # [H, D], read flat
    bv = _aligned(_as(bias_v, dt))
    ok = lens.dtype == torch.int32 and lens.device == q.device and lens.is_contiguous()
    lens_i = lens if ok else lens.to(q.device, torch.int32).contiguous()
    # the launch zeroes an f32 scratch, the kernel writes dq and adds dk,
    # dv, dp and the two bias gradients (dqu's and dqv's column sums) into
    # the scratch, and a second kernel writes those to their outputs. Each
    # output is allocated in its own shape and pointers and scalars go to
    # ctypes as plain ints and floats: the wrapper's host time is most of
    # an eager call, and a view costs about as much as an allocation.
    acc = torch.empty(2 * B * T * E + (2 * T - 1) * E + 2 * E, dtype=torch.float32,
                      device=q.device)
    dq, dk, dv, dp = (torch.empty_like(t) for t in (q, k, v, p))
    d_bu, d_bv = (torch.empty((n_heads, D), dtype=torch.float32, device=q.device)
                  for _ in range(2))
    lib = _build.load("flash_mhsa")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_relpos_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), bu.data_ptr(),
        bv.data_ptr(), lens_i.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dp.data_ptr(), d_bu.data_ptr(),
        d_bv.data_ptr(), acc.data_ptr(), B, T, n_heads, D,
        int(left), int(right), 1.0 / math.sqrt(D), *_drop_args(dropout_rate, seed),
        _DTYPES[dt], stream,
    )
    _build.check(lib, err, "flash_relpos_bwd")
    flash_relpos_mhsa_backward.launches += 1
    return dq, dk, dv, dp, _as(d_bu, bias_u.dtype), _as(d_bv, bias_v.dtype)


def flash_relpos_mhsa_backward_reference(
    q, k, v, p, bias_u, bias_v, lens, dout, *, n_heads: int, left: int = -1,
    right: int = -1, dropout_rate: float = 0.0, seed: int = 0,
):
    """Plain version of the backward kernel: autograd through
    ``flash_relpos_mhsa_reference`` with the same dropout bits."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, p, bias_u, bias_v)]
    with torch.enable_grad():
        out = flash_relpos_mhsa_reference(
            *leaves, lens, n_heads=n_heads, left=left, right=right,
            dropout_rate=dropout_rate, seed=seed,
        )
        grads = torch.autograd.grad(out, leaves, dout)
    return grads


flash_relpos_mhsa_backward.launches = 0


class _Flash(torch.autograd.Function):
    """Forward kernel; backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, p, bias_u, bias_v, lens, n_heads, left, right,
                dropout_rate, seed):
        out, lse = _launch_fwd(q, k, v, p, bias_u, bias_v, lens, n_heads,
                               left, right, dropout_rate, seed, need_lse=True)
        ctx.save_for_backward(q, k, v, p, bias_u, bias_v, lens, lse)
        ctx.args = (n_heads, left, right, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, p, bias_u, bias_v, lens, lse = ctx.saved_tensors
        n_heads, left, right, dropout_rate, seed = ctx.args
        grads = flash_relpos_mhsa_backward(
            q, k, v, p, bias_u, bias_v, lens, lse, dout, n_heads=n_heads,
            left=left, right=right, dropout_rate=dropout_rate, seed=seed,
        )
        return (*grads, None, None, None, None, None, None)


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
    seed: int = 0,
) -> torch.Tensor:
    """Fused rel-pos attention; [B, T, E] in q's dtype. Differentiable:
    the backward kernel computes the gradients.

    CPU tensors take the plain version (autograd is its backward); CUDA
    tensors launch the kernels or raise."""
    _check(q, k, v, p, n_heads)
    _drop_args(dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_relpos_mhsa_reference(
            q, k, v, p, bias_u, bias_v, lens, n_heads=n_heads, left=left,
            right=right, dropout_rate=dropout_rate, seed=seed,
        )
    args = (q, k, v, p, bias_u, bias_v, lens, n_heads, int(left), int(right),
            float(dropout_rate), int(seed))
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, p, bias_u, bias_v)
    ):
        return _Flash.apply(*args)
    return _launch_fwd(*args, need_lse=False)[0]


flash_relpos_mhsa.launches = 0


def flash_dropout_bits_kernel(seed: int, B: int, H: int, T: int, device) -> torch.Tensor:
    """The kernels' dropout bits [B, H, T, T] (int64 holding uint32), drawn
    on the card by the hash the kernels use; for holding it against
    ``dropout_bits``."""
    bits = torch.empty((B, H, T, T), dtype=torch.int32, device=device)
    lib = _build.load("flash_mhsa")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.flash_dropout_bits(ctypes.c_uint(seed & _M32), B, H, T,
                                 _build.ptr(bits), ctypes.c_void_p(stream))
    _build.check(lib, err, "flash_dropout_bits")
    return bits.to(torch.int64) & _M32


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.flash_relpos_fwd.argtypes = [vp] * 9 + [i] * 6 + [f, u, u, f, i, i, vp]
    lib.flash_relpos_fwd.restype = i
    lib.flash_relpos_bwd.argtypes = [vp] * 16 + [i] * 6 + [f, u, u, f, i, i, vp]
    lib.flash_relpos_bwd.restype = i
    lib.flash_dropout_bits.argtypes = [u, i, i, i, vp, vp]
    lib.flash_dropout_bits.restype = i


_build.BINDERS["flash_mhsa"] = _bind


def _needed(T: int, lens, left: int, right: int) -> tuple[int, int, int]:
    """What the data needs of one call: (query/key rows with a visible
    pair, rows of p at an offset j - t of a visible pair, visible pairs)."""
    lens = torch.as_tensor(lens, dtype=torch.int64).cpu()
    mask = _mask(T, lens, left, right)[:, 0]
    rows = int(mask.any(dim=2).sum())
    idx = torch.arange(T)
    offsets = (idx[None, :] - idx[:, None])[mask.any(dim=0)]
    return rows, int(torch.unique(offsets).numel()), int(mask.sum())


def work(B: int, T: int, E: int, lens, left: int = -1, right: int = -1,
         itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) one forward call must move and compute for these
    inputs: q, k and v read once over the rows within the lengths, p over
    the offsets of visible pairs, the two biases, and out written once in
    full; three dot products of length D per visible (query, key) pair
    (ac, bd, P·V)."""
    rows, p_rows, visible = _needed(T, lens, left, right)
    nbytes = (3 * rows * E + p_rows * E + 2 * E + B * T * E) * itemsize
    return nbytes, 3 * 2 * visible * E


def work_backward(B: int, T: int, E: int, lens, n_heads: int, left: int = -1,
                  right: int = -1, itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) one backward call must move and compute: q, k, v and
    dO read once over the rows within the lengths, p over the offsets of
    visible pairs, the two biases and the f32 lse [B, H, T] over those
    rows; dq, dk, dv and dp written once in full, and the two bias
    gradients; per visible pair the two score dots, dO·v, and the five
    products dqu, dqv, dk, dv, dp (eight dot products of length D; the
    kernels' second walk over the keys repeats three of them, and the
    bf16 kernel's tiles run masked pairs too, which the bound does not
    count)."""
    rows, p_rows, visible = _needed(T, lens, left, right)
    nbytes = (4 * rows * E + p_rows * E + 2 * E) * itemsize + rows * n_heads * 4
    nbytes += (3 * B * T * E + (2 * T - 1) * E + 2 * E) * itemsize
    return nbytes, 8 * 2 * visible * E
