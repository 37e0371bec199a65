"""Fused RNNT joint head: CUDA kernels + plain versions.

Replaces the TPU kernels ``indic_cl_asr_tpu/ops/joint_fused_pallas.py:_call_fwd``
(``pl.pallas_call`` at line 201, body ``_fwd_kernel`` at line 44) and ``_bwd``
(``pl.pallas_call`` at line 256, body ``_bwd_kernel`` at line 87), the joint
of ``rnnt_loss_fused(impl="pallas")``:

    x = drop(relu(f_proj[b, t] + g_proj[b, u]))      compute dtype
    z = x · head_w[b] + head_b[b]                     f32 (f32 head, uncast)
    lp_blank = z[blank] - lse(z),  lp_label = z[labels_pad[b, u]] - lse(z)

``joint_slabs`` has the JAX function's semantics (``joint_slabs_pallas``:
both slabs ``[B, T, U+1]`` f32, per-row heads, a label outside the head
reading as logit 0) and its backward: df and dg in the operands' dtype,
dW and db in the head's. The JAX kernel adds dg into a bf16 buffer chunk
by chunk; both versions here sum dg in f32 and round it once.

Dropout keeps x where its 32 random bits are at most
``uint32((1-rate)(2^32-1))`` and scales the kept values by 1/(1-rate),
rounded to the compute dtype. The bits are a counter-based hash of
(seed, b, t, u, h) (``dropout_bits``, the kernels' ``drop_bits``; the
flash kernels' murmur3 finaliser), not the TPU's PRNG stream: the backward
draws the same mask again, and the plain version computes the very same
bits, so kernel and plain version agree with dropout on.

The plain version (``joint_slabs_reference``) runs the forward and a
hand-written backward (the math of ``_fwd_kernel`` and ``_bwd_kernel``)
in chunks of ``PLAIN_CHUNK`` frames to bound memory. On CUDA tensors
``joint_slabs`` launches the kernels of ``csrc/joint_fused.cu``: one
forward kernel a call (scalar f32 FMAs on the CUDA cores), and two
backward kernels a call (dlogits with d_x, df and dg; then dW and db),
with a scratch of the f32 dlogits, B·T·(U+1) rows of V+1 rounded up to 8
(445 MB at the flagship's B16 T204 U+1 129 V+1 257), and the joint input
x as the first kernel formed it (B·T·(U+1) rows of H rounded up to 8 in
the compute dtype, 539 MB in bf16), which the dW kernel reads instead of
forming it again. The forward also keeps each pair's
log-sum-exp for the backward. The backward's three products (the logits
again, d_x = dlogits·Wᵀ, dW = xᵀ·dlogits) run on the tensor cores as
TF32 ``mma.sync`` with split operands (3xTF32: each f32 operand is
tf32(a) + tf32(a - tf32(a)), three passes, two where the operand is a
bf16 joint input, exact in TF32), each mma chain added into an f32 total
every 16 k-steps, so that the backward keeps the plain version's f32
tolerances; ``TF32_PASSES`` counts the passes for the bound.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_mhsa import _M32, _fmix32, _mul32, keep_threshold

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TF32 passes of one pairs x H x V1 product that the backward runs, by the
# joint input's itemsize: the logits and dW 2 (bf16 x exact) or 3, d_x 3
TF32_PASSES = {2: 7, 4: 9}
PLAIN_CHUNK = 16  # frames per chunk of the plain version
_SMEM_MAX = 232448


def dropout_bits(seed: int, B: int, U1: int, H: int, t0: int, t1: int,
                 device=None) -> torch.Tensor:
    """[B, t1-t0, U1, H] int64 holding the kernels' uint32 dropout bits for
    frames [t0, t1): key = fmix32(seed ^ b·0x9E3779B9),
    bits = fmix32(key ^ fmix32(((t·U1 + u)·H + h) mod 2^32))."""
    t = torch.arange(t0, t1, dtype=torch.int64, device=device)
    u = torch.arange(U1, dtype=torch.int64, device=device)
    h = torch.arange(H, dtype=torch.int64, device=device)
    idx = ((t[:, None, None] * U1 + u[None, :, None]) * H + h[None, None, :]) & _M32
    b = torch.arange(B, dtype=torch.int64, device=device)
    key = _fmix32((seed & _M32) ^ _mul32(b, 0x9E3779B9))
    return _fmix32(key[:, None, None, None] ^ _fmix32(idx)[None])


def _chunk_inputs(f_c, g, seed, t0, rate):
    """Joint input x [B, Tc, U1, H] (compute dtype) of frames t0.. and its
    derivative in the pre-activation, ``relu'·keep/(1-rate)`` (f32)."""
    B, Tc, H = f_c.shape
    U1 = g.shape[1]
    pre = f_c[:, :, None, :] + g[:, None, :, :]
    on = pre > 0
    x = torch.relu(pre)
    grad = on.float()
    if rate > 0.0:
        scale = 1.0 / (1.0 - rate)
        keep = dropout_bits(seed, B, U1, H, t0, t0 + Tc, f_c.device) <= keep_threshold(rate)
        x = torch.where(keep, (x.float() * scale).to(x.dtype), 0.0)
        grad = torch.where(keep, grad * scale, 0.0)
    return x, grad


def _chunk_logits(x, w, bias):
    """[B, Tc, U1, H] x [B, H, V1] -> f32 logits [B, Tc, U1, V1]."""
    B, Tc, U1, H = x.shape
    z = torch.matmul(x.float().reshape(B, Tc * U1, H), w)
    return z.view(B, Tc, U1, -1) + bias[:, None, None, :]


def _label_onehot(labels, V1):
    """[B, U1] -> f32 one-hot [B, 1, U1, V1]; labels outside [0, V1) give 0."""
    v = torch.arange(V1, device=labels.device)
    return (labels.long()[:, :, None] == v).float()[:, None]


def _forward_reference(f, g, w, bias, labels, seed, blank, rate):
    B, T, H = f.shape
    V1 = w.shape[2]
    onehot = _label_onehot(labels, V1)
    lpb, lpl = [], []
    for t0 in range(0, T, PLAIN_CHUNK):
        x, _ = _chunk_inputs(f[:, t0:t0 + PLAIN_CHUNK], g, seed, t0, rate)
        z = _chunk_logits(x, w, bias)
        lse = torch.logsumexp(z, dim=-1)
        lpb.append(z[..., blank] - lse)
        lpl.append((z * onehot).sum(-1) - lse)
    return torch.cat(lpb, 1), torch.cat(lpl, 1)


def _backward_reference(f, g, w, bias, labels, seed, blank, rate, dlpb, dlpl):
    """The TPU backward kernel's math, chunked over T: dlogits from the
    softmax identity, d_x = dlogits·Wᵀ masked by relu' and the dropout
    keep, df = Σ_u, dg = Σ_t (f32), dW = Σ xᵀ·dlogits, db = Σ dlogits."""
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    onehot = _label_onehot(labels, V1)
    blank_hot = (torch.arange(V1, device=f.device) == blank).float()
    df = torch.empty((B, T, H), dtype=torch.float32, device=f.device)
    dg = torch.zeros((B, U1, H), dtype=torch.float32, device=f.device)
    dw = torch.zeros((B, H, V1), dtype=torch.float32, device=f.device)
    db = torch.zeros((B, V1), dtype=torch.float32, device=f.device)
    for t0 in range(0, T, PLAIN_CHUNK):
        t1 = min(t0 + PLAIN_CHUNK, T)
        x, grad = _chunk_inputs(f[:, t0:t1], g, seed, t0, rate)
        z = _chunk_logits(x, w, bias)
        softmax = torch.softmax(z, dim=-1)
        cb = dlpb[:, t0:t1, :, None].float()
        cl = dlpl[:, t0:t1, :, None].float()
        dz = cb * blank_hot + cl * onehot - softmax * (cb + cl)  # [B, Tc, U1, V1]
        Tc = t1 - t0
        dz2 = dz.reshape(B, Tc * U1, V1)
        d_pre = torch.matmul(dz2, w.transpose(1, 2)).view(B, Tc, U1, H) * grad
        df[:, t0:t1] = d_pre.sum(2)
        dg += d_pre.sum(1)
        dw += torch.matmul(x.float().reshape(B, Tc * U1, H).transpose(1, 2), dz2)
        db += dz2.sum(1)
    return df, dg, dw, db


def _check(f, g, w, bias, labels, blank, rate):
    if f.dim() != 3 or g.dim() != 3 or w.dim() != 3 or bias.dim() != 2 or labels.dim() != 2:
        raise ValueError("joint_slabs takes f [B,T,H], g [B,U1,H], head_w [B,H,V1], "
                         "head_b [B,V1], labels_pad [B,U1]")
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    if (g.shape[0], g.shape[2]) != (B, H) or tuple(w.shape[:2]) != (B, H) \
            or tuple(bias.shape) != (B, V1) or tuple(labels.shape) != (B, U1):
        raise ValueError(f"shapes disagree: f {tuple(f.shape)}, g {tuple(g.shape)}, "
                         f"head_w {tuple(w.shape)}, head_b {tuple(bias.shape)}, "
                         f"labels_pad {tuple(labels.shape)}")
    if g.dtype != f.dtype:
        raise TypeError(f"f_proj and g_proj must share a dtype: {f.dtype}, {g.dtype}")
    if not 0 <= blank < V1:
        raise ValueError(f"blank={blank} outside the head's {V1} columns")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if f.device.type not in ("cpu", "cuda") or any(
            t.device != f.device for t in (g, w, bias, labels)):
        raise ValueError("joint_slabs' operands must share one cpu or cuda device")


def _kernel_args(f, rate, seed):
    if f.dtype not in _DTYPES:
        raise TypeError(f"joint kernels take float32 or bfloat16 f/g, got {f.dtype}")
    on = rate > 0.0
    return (ctypes.c_uint(seed & _M32 if on else 0),
            ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), int(on), _DTYPES[f.dtype])


def _check_smem(lib, H, V1, dtype_code):
    for backward in (0, 1):
        need = lib.joint_fused_smem(H, V1, dtype_code, backward)
        if need > _SMEM_MAX:
            raise ValueError(f"joint kernels: H={H}, V1={V1} need {need} B of shared "
                             f"memory, over the {_SMEM_MAX} B a block may use")


def joint_fused_forward(f, g, w, bias, labels, seed: int, *, blank: int,
                        dropout_rate: float):
    """The forward kernel -> (lp_blank, lp_label, lse), each [B, T, U1] f32.
    CUDA tensors only."""
    if f.device.type != "cuda":
        raise ValueError("joint_fused_forward launches the CUDA kernel")
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    drop = _kernel_args(f, dropout_rate, seed)
    f, g = f.contiguous(), g.contiguous()
    w = w.float().contiguous()
    bias = bias.float().contiguous()
    labels = labels.to(torch.int32).contiguous()
    out = [torch.empty((B, T, U1), dtype=torch.float32, device=f.device) for _ in range(3)]
    lib = _build.load("joint_fused")
    _check_smem(lib, H, V1, drop[-1])
    stream = torch.cuda.current_stream(f.device).cuda_stream
    ptr = _build.ptr
    err = lib.joint_fused_fwd(ptr(f), ptr(g), ptr(w), ptr(bias), ptr(labels),
                              *(ptr(o) for o in out), B, T, U1, H, V1, int(blank),
                              *drop, ctypes.c_void_p(stream))
    _build.check(lib, err, "joint_fused_fwd")
    joint_fused_forward.launches += 1
    return tuple(out)


def joint_fused_backward(f, g, w, bias, labels, seed: int, lse, dlpb, dlpl, *,
                         blank: int, dropout_rate: float):
    """The backward kernels -> (df, dg, dW, db) in the dtypes of f, g,
    head_w and head_b. CUDA tensors only."""
    if f.device.type != "cuda":
        raise ValueError("joint_fused_backward launches the CUDA kernels")
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    drop = _kernel_args(f, dropout_rate, seed)
    fc, gc = f.contiguous(), g.contiguous()
    wc = w.float().contiguous()
    bc = bias.float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    dlpb = dlpb.float().contiguous()
    dlpl = dlpl.float().contiguous()
    f32 = dict(dtype=torch.float32, device=f.device)
    lib = _build.load("joint_fused")
    _check_smem(lib, H, V1, drop[-1])
    # dlogits, then the joint input as the first kernel formed it
    scratch = torch.empty(lib.joint_fused_bwd_scratch(B, T, U1, H, V1, drop[-1]), **f32)
    df = torch.zeros((B, T, H), **f32)
    dg = torch.zeros((B, U1, H), **f32)
    dw = torch.empty((B, H, V1), **f32)
    db = torch.empty((B, V1), **f32)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    ptr = _build.ptr
    err = lib.joint_fused_bwd(ptr(fc), ptr(gc), ptr(wc), ptr(bc), ptr(lab), ptr(lse),
                              ptr(dlpb), ptr(dlpl), ptr(scratch), ptr(df), ptr(dg),
                              ptr(dw), ptr(db), B, T, U1, H, V1, int(blank), *drop,
                              ctypes.c_void_p(stream))
    _build.check(lib, err, "joint_fused_bwd")
    joint_fused_backward.launches += 1
    return df.to(f.dtype), dg.to(g.dtype), dw.to(w.dtype), db.to(bias.dtype)


joint_fused_forward.launches = 0
joint_fused_backward.launches = 0


class _JointSlabs(torch.autograd.Function):
    """Forward and backward kernels, or (``plain``) their plain versions."""

    @staticmethod
    def forward(ctx, f, g, w, bias, labels, seed, blank, rate, plain):
        kw = dict(blank=blank, dropout_rate=rate)
        if plain:
            lpb, lpl = _forward_reference(f, g, w.float(), bias.float(), labels, seed,
                                          blank, rate)
            lse = None
        else:
            lpb, lpl, lse = joint_fused_forward(f, g, w, bias, labels, seed, **kw)
        ctx.save_for_backward(f, g, w, bias, labels, lse)
        ctx.args = (seed, blank, rate, plain)
        return lpb, lpl

    @staticmethod
    def backward(ctx, dlpb, dlpl):
        f, g, w, bias, labels, lse = ctx.saved_tensors
        seed, blank, rate, plain = ctx.args
        if plain:
            df, dg, dw, db = _backward_reference(f, g, w.float(), bias.float(), labels,
                                                 seed, blank, rate, dlpb, dlpl)
            grads = (df.to(f.dtype), dg.to(g.dtype), dw.to(w.dtype), db.to(bias.dtype))
        else:
            grads = joint_fused_backward(f, g, w, bias, labels, seed, lse, dlpb, dlpl,
                                         blank=blank, dropout_rate=rate)
        return (*grads, None, None, None, None, None)


def joint_slabs(
    f_proj: torch.Tensor,      # [B, T, H] compute dtype
    g_proj: torch.Tensor,      # [B, U+1, H] compute dtype
    head_w: torch.Tensor,      # [B, H, V+1] per-row head (f32 master gather)
    head_b: torch.Tensor,      # [B, V+1]
    labels_pad: torch.Tensor,  # [B, U+1] (column U ignored by the lattice)
    seed: int,
    *,
    blank: int,
    dropout_rate: float = 0.0,
):
    """(lp_blank, lp_label), both [B, T, U+1] f32: the fused relu joint,
    log-softmax and gather. Differentiable in f_proj, g_proj, head_w and
    head_b.

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    _check(f_proj, g_proj, head_w, head_b, labels_pad, blank, dropout_rate)
    return _JointSlabs.apply(f_proj, g_proj, head_w, head_b, labels_pad, int(seed),
                             int(blank), float(dropout_rate), f_proj.device.type == "cpu")


def joint_slabs_reference(f_proj, g_proj, head_w, head_b, labels_pad, seed, *,
                          blank: int, dropout_rate: float = 0.0):
    """``joint_slabs`` through the plain version (forward and hand-written
    backward), on any device: the reference the kernels are held to."""
    _check(f_proj, g_proj, head_w, head_b, labels_pad, blank, dropout_rate)
    return _JointSlabs.apply(f_proj, g_proj, head_w, head_b, labels_pad, int(seed),
                             int(blank), float(dropout_rate), True)


def joint_dropout_bits_kernel(seed: int, B: int, T: int, U1: int, H: int,
                              device) -> torch.Tensor:
    """The kernels' dropout bits [B, T, U1, H] (int64 holding uint32), drawn
    on the card by the hash the kernels use; for holding it against
    ``dropout_bits``."""
    bits = torch.empty((B, T, U1, H), dtype=torch.int32, device=device)
    lib = _build.load("joint_fused")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.joint_dropout_bits(ctypes.c_uint(seed & _M32), B, T, U1, H,
                                 _build.ptr(bits), ctypes.c_void_p(stream))
    _build.check(lib, err, "joint_dropout_bits")
    return bits.to(torch.int64) & _M32


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.joint_fused_fwd.argtypes = [vp] * 8 + [i] * 6 + [u, u, f, i, i, vp]
    lib.joint_fused_fwd.restype = i
    lib.joint_fused_bwd.argtypes = [vp] * 13 + [i] * 6 + [u, u, f, i, i, vp]
    lib.joint_fused_bwd.restype = i
    lib.joint_fused_bwd_scratch.argtypes = [i] * 6
    lib.joint_fused_bwd_scratch.restype = ctypes.c_longlong
    lib.joint_fused_smem.argtypes = [i, i, i, i]
    lib.joint_fused_smem.restype = i
    lib.joint_dropout_bits.argtypes = [u, i, i, i, i, vp, vp]
    lib.joint_dropout_bits.restype = i


_build.BINDERS["joint_fused"] = _bind


def work(B: int, T: int, U1: int, H: int, V1: int, itemsize: int = 2,
         backward: bool = False) -> tuple[int, int]:
    """(bytes, flops) one call must move and compute. Forward: f, g, the
    f32 head and bias and the labels read once, the two f32 slabs written
    once; one product of length H per (pair, column). Backward: the same
    inputs plus the two slab cotangents read, df, dg (operand dtype), dW,
    db (f32) written; three such products (the logits again, d_x, dW)."""
    pairs = B * T * U1
    inputs = (B * T * H + B * U1 * H) * itemsize + (B * H * V1 + B * V1 + B * U1) * 4
    if not backward:
        return inputs + 2 * pairs * 4, 2 * pairs * H * V1
    nbytes = inputs + 2 * pairs * 4 + (B * T * H + B * U1 * H) * itemsize
    nbytes += (B * H * V1 + B * V1) * 4
    return nbytes, 3 * 2 * pairs * H * V1
