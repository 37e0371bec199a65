"""Streaming (chunked) RNNT loss: the joint head fused into the loss.

Port of indic_cl_asr_tpu/ops/rnnt_loss_fused.py. With ``impl="xla"`` the
joint is evaluated in chunks of ``chunk_size`` frames along T; each
chunk's [B, Tc, U+1, V+1] logits are reduced at once to the blank and
target-label log-prob slabs and discarded, and the lattice
(ops/rnnt_loss.py, the CUDA alpha/beta kernels on the card) runs on the
slabs. Per chunk:

    inp = drop(relu(f_proj[:, t] + g_proj))           compute dtype
    logits = inp · head (f32 accumulation) + bias     f32
    lp_blank = logits[blank] - lse,  lp_label = logits[y_u] - lse

The head product keeps the JAX package's mixed-precision contract
(``_joint_dot``): the head is cast to the compute dtype, the product is
exact in f32, and in the backward the f32 cotangent is cast to the compute
dtype before both products. The port computes all V+1 columns in one
product: the JAX package splits off the blank column (``_joint_dot_split``)
only to fit the TPU's 128-lane tiles, and the values agree up to the order
of f32 sums.

``uniform_head`` (every row trains the same language) uses row 0's head
for the whole batch. ``remat``: ``"none"`` keeps each chunk's residuals
for the backward, unless their estimate B·T_pad·(U+1)·(H·itemsize +
4·(V+1)) exceeds ``RNNT_REMAT_NONE_LIMIT_GB`` (default 4): then it warns
and takes ``"full"``, as the JAX package does; ``"full"`` recomputes each
chunk in the backward (``torch.utils.checkpoint``), reusing the forward's
dropout mask, which is drawn once per chunk outside the checkpointed
function (the JAX package
saves ``joint_dropout_mask`` across its remat boundary); ``"save_logits"``
keeps each chunk's f32 logits and recomputes only the activated input in
the backward (``_JointLogits``). The three give the same numbers.

``impl="pallas"`` (relu only, as in the JAX package; another activation
takes the chunked path) runs the fused joint of ops/joint_fused.py over
the whole T, per-row heads (``uniform_head`` does not apply: the gradient
sums back through the caller's head gather), with a dropout seed drawn
from ``host_generator`` when dropout is on, else 0. ``remat`` does not
apply to it and warns, as in the JAX package.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.common import activate, dropout_keep_mask, fold_rank
from .joint_fused import joint_slabs
from .rnnt_loss import _reduce, rnnt_nll_from_logprobs

IMPLS = ("xla", "pallas")
REMATS = ("full", "save_logits", "none")


def _joint_dot_grads(inp, w, g):
    """(d_inp, d_w) of inp·w for the f32 cotangent ``g``: cast to inp's
    dtype first, exact products, f32 sums, rounded to inp's / w's dtype."""
    gc = g.to(inp.dtype).float()
    d_inp = torch.matmul(gc, w.float().transpose(-1, -2)).to(inp.dtype)
    x = inp.float()
    if w.dim() == 2:
        d_w = torch.matmul(x.reshape(-1, x.shape[-1]).t(), gc.reshape(-1, gc.shape[-1]))
    else:
        d_w = torch.matmul(x.transpose(1, 2), gc)
    return d_inp, d_w.to(w.dtype)


class _JointDot(torch.autograd.Function):
    """inp [B, N, H] · w ([B, H, V] or shared [H, V]) -> f32 [B, N, V],
    exact products with f32 accumulation; the backward casts the cotangent
    to inp's dtype first and rounds d_inp / d_w to inp's / w's dtype."""

    @staticmethod
    def forward(ctx, inp, w):
        ctx.save_for_backward(inp, w)
        return torch.matmul(inp.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        inp, w = ctx.saved_tensors
        return _joint_dot_grads(inp, w, g)


def _joint_input(f_chunk, g_proj, keep, activation, dropout_rate):
    inp = activate(f_chunk[:, :, None, :] + g_proj[:, None, :, :], activation)
    if keep is not None:
        inp = torch.where(keep, inp / (1.0 - dropout_rate), 0.0)
    return inp


class _JointLogits(torch.autograd.Function):
    """``remat="save_logits"``: the activated joint input · w -> f32
    [B, Tc·U1, V] as _JointDot computes it, keeping only the operands
    (f_chunk, g_proj, w, the dropout mask) for the backward, which forms
    the activated input again (the JAX package saves ``joint_logits`` and
    recomputes the elementwise input chain)."""

    @staticmethod
    def forward(ctx, f_chunk, g_proj, w, keep, activation, dropout_rate):
        B, Tc, H = f_chunk.shape
        inp = _joint_input(f_chunk, g_proj, keep, activation, dropout_rate)
        ctx.save_for_backward(f_chunk, g_proj, w, keep)
        ctx.args = (activation, dropout_rate)
        return torch.matmul(inp.reshape(B, -1, H).float(), w.float())

    @staticmethod
    def backward(ctx, gl):
        f_chunk, g_proj, w, keep = ctx.saved_tensors
        activation, dropout_rate = ctx.args
        B, Tc, H = f_chunk.shape
        with torch.enable_grad():
            leaves = [f_chunk.detach().requires_grad_(True), g_proj.detach().requires_grad_(True)]
            inp = _joint_input(*leaves, keep, activation, dropout_rate)
            d_inp, d_w = _joint_dot_grads(inp.detach().reshape(B, -1, H), w, gl)
            df, dg = torch.autograd.grad(inp, leaves, d_inp.view(inp.shape))
        return df, dg, d_w, None, None, None


def _chunk_slabs(f_chunk, g_proj, head_w, head_b, labels_pad, keep, blank: int,
                 dropout_rate: float, uniform_head: bool, activation: str,
                 save_logits: bool):
    """[B, Tc, H] -> (lp_blank, lp_label) [B, Tc, U+1] f32."""
    B, Tc, H = f_chunk.shape
    U1 = g_proj.shape[1]
    w = head_w.to(f_chunk.dtype)
    if uniform_head:
        w, bias = w[0], head_b[0][None]  # [H, V+1], [1, V+1]
    else:
        bias = head_b
    if save_logits:
        logits = _JointLogits.apply(f_chunk, g_proj, w, keep, activation, dropout_rate)
    else:
        inp = _joint_input(f_chunk, g_proj, keep, activation, dropout_rate)
        logits = _JointDot.apply(inp.reshape(B, Tc * U1, H), w)
    logits = logits.view(B, Tc, U1, -1) + bias[:, None, None, :].float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    lp_blank = logits[..., blank] - lse
    idx = labels_pad.long()[:, None, :, None].expand(B, Tc, U1, 1)
    lp_label = torch.gather(logits, 3, idx)[..., 0] - lse
    return lp_blank, lp_label


def rnnt_loss_fused(
    f_proj: torch.Tensor,      # [B, T, H] encoder-side joint projection
    g_proj: torch.Tensor,      # [B, U+1, H] prediction-side joint projection
    head_w: torch.Tensor,      # [B, H, V+1] per-sample language head
    head_b: torch.Tensor,      # [B, V+1] per-sample language head bias
    labels: torch.Tensor,      # [B, U] local token ids
    frame_lens: torch.Tensor,
    label_lens: torch.Tensor,
    *,
    blank: int,
    activation: str = "relu",
    reduction: str = "mean_batch",
    chunk_size: int = 64,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    host_generator: torch.Generator | None = None,
    impl: str = "xla",
    row_mask: torch.Tensor | None = None,  # bool [B]: real (non-repeat) rows
    uniform_head: bool = False,
    remat: str = "full",
    n_rows: int | None = None,
    seed_rank: int = 0,
):
    """Joint + RNNT loss; differentiable in f_proj, g_proj, head_w and
    head_b. ``impl="xla"``: the chunked joint, its dropout masks (8-bit,
    models/common.py) drawn from ``generator`` on the projections' device.
    ``impl="pallas"``: the fused joint kernels, their dropout seed drawn
    from the CPU ``host_generator`` and folded with the data rank
    ``seed_rank`` (models/common.py:fold_rank). ``n_rows`` is the real
    rows of the global batch when these rows are one data rank's share
    (ops/rnnt_loss.py:_reduce)."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: one of {IMPLS}")
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: one of {REMATS}")
    B, T, H = f_proj.shape
    U1 = g_proj.shape[1]
    labels_pad = torch.cat(
        [labels, torch.zeros((B, 1), dtype=labels.dtype, device=labels.device)], dim=1
    ).to(f_proj.device)
    dev = f_proj.device
    if impl == "pallas" and activation == "relu":
        if remat != "full":
            warnings.warn(
                f"rnnt_remat={remat!r} has no effect with the pallas joint impl: "
                "the fused kernels keep no logits and recompute them in the "
                "backward. A/B the remat knob with impl='xla'.", stacklevel=2)
        seed = 0
        if host_generator is not None and dropout_rate > 0.0:
            seed = fold_rank(int(torch.randint(0, 2**31 - 1, (1,), generator=host_generator)),
                             seed_rank, 31)
        lp_blank, lp_label = joint_slabs(f_proj, g_proj, head_w, head_b, labels_pad, seed,
                                         blank=blank, dropout_rate=dropout_rate)
        nll = rnnt_nll_from_logprobs(lp_blank, lp_label, frame_lens.to(dev, torch.int32),
                                     label_lens.to(dev, torch.int32))
        return _reduce(nll, label_lens, reduction, row_mask, n_rows)
    n_chunks = -(-T // chunk_size)
    T_pad = n_chunks * chunk_size
    if T_pad != T:
        f_proj = F.pad(f_proj, (0, 0, 0, T_pad - T))
    if remat == "none":
        # with no recompute the backward keeps the activated joint input
        # [B, T, U+1, H] and the f32 logits [B, T, U+1, V+1] of every chunk:
        # above the limit the chunked joint's bounded memory is kept instead
        V1 = head_b.shape[-1]
        resid_gb = B * T_pad * U1 * (H * f_proj.dtype.itemsize + V1 * 4) / 2**30
        limit_gb = float(os.environ.get("RNNT_REMAT_NONE_LIMIT_GB", "4"))
        if resid_gb > limit_gb:
            warnings.warn(
                f"rnnt_remat='none' would keep ~{resid_gb:.1f} GB of "
                f"joint residuals live (B={B}, T={T_pad}, U+1={U1}, "
                f"V+1={V1}) > {limit_gb:.0f} GB limit; falling back to "
                "'full' chunk remat. Raise RNNT_REMAT_NONE_LIMIT_GB to "
                "override.",
                stacklevel=2,
            )
            remat = "full"
    drop = dropout_rate > 0.0 and generator is not None
    kw = dict(blank=blank, dropout_rate=dropout_rate, uniform_head=uniform_head,
              activation=activation, save_logits=remat == "save_logits")
    pieces = []
    for i in range(n_chunks):
        f_chunk = f_proj[:, i * chunk_size:(i + 1) * chunk_size]
        keep = (dropout_keep_mask((B, chunk_size, U1, H), dropout_rate, generator,
                                  f_proj.device) if drop else None)
        args = (f_chunk, g_proj, head_w, head_b, labels_pad, keep)
        if remat == "full" and torch.is_grad_enabled():
            pieces.append(checkpoint(
                lambda *a: _chunk_slabs(*a, **kw), *args, use_reentrant=False))
        else:
            pieces.append(_chunk_slabs(*args, **kw))
    lp_blank = torch.cat([p[0] for p in pieces], dim=1)[:, :T]
    lp_label = torch.cat([p[1] for p in pieces], dim=1)[:, :T]
    nll = rnnt_nll_from_logprobs(
        lp_blank, lp_label, frame_lens.to(dev, torch.int32),
        label_lens.to(dev, torch.int32),
    )
    return _reduce(nll, label_lens, reduction, row_mask, n_rows)
