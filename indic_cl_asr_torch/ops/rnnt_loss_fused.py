"""Streaming (chunked) RNNT loss: the joint head fused into the loss.

Port of indic_cl_asr_tpu/ops/rnnt_loss_fused.py, its ``impl="xla"`` path.
The joint is evaluated in chunks of ``chunk_size`` frames along T; each
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
for the backward (the JAX package's fallback to "full" above 4 GB of them
is not ported: a flagship step keeps ~1.2 GB); ``"full"`` recomputes each
chunk in the backward (``torch.utils.checkpoint``), reusing the forward's dropout mask, which is
drawn once per chunk outside the checkpointed function (the JAX package
saves ``joint_dropout_mask`` across its remat boundary). ``"save_logits"``
and the fused joint kernels (``impl="pallas"``) arrive with the next slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.common import dropout_keep_mask
from .rnnt_loss import _reduce, rnnt_nll_from_logprobs


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
        gc = g.to(inp.dtype).float()
        d_inp = torch.matmul(gc, w.float().transpose(-1, -2)).to(inp.dtype)
        x = inp.float()
        if w.dim() == 2:
            d_w = torch.matmul(x.reshape(-1, x.shape[-1]).t(), gc.reshape(-1, gc.shape[-1]))
        else:
            d_w = torch.matmul(x.transpose(1, 2), gc)
        return d_inp, d_w.to(w.dtype)


def _chunk_slabs(f_chunk, g_proj, head_w, head_b, labels_pad, keep,
                 blank: int, dropout_rate: float, uniform_head: bool):
    """[B, Tc, H] -> (lp_blank, lp_label) [B, Tc, U+1] f32."""
    B, Tc, H = f_chunk.shape
    U1 = g_proj.shape[1]
    inp = torch.relu(f_chunk[:, :, None, :] + g_proj[:, None, :, :])
    if keep is not None:
        inp = torch.where(keep, inp / (1.0 - dropout_rate), 0.0)
    w = head_w.to(inp.dtype)
    if uniform_head:
        w, bias = w[0], head_b[0][None]  # [H, V+1], [1, V+1]
    else:
        bias = head_b
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
    reduction: str = "mean_batch",
    chunk_size: int = 64,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    impl: str = "xla",
    row_mask: torch.Tensor | None = None,  # bool [B]: real (non-repeat) rows
    uniform_head: bool = False,
    remat: str = "full",
):
    """Chunked relu joint + RNNT loss; differentiable in f_proj, g_proj,
    head_w and head_b. Joint dropout masks (8-bit, models/common.py) are
    drawn from ``generator`` on the projections' device."""
    if impl != "xla":
        raise NotImplementedError(
            f"impl={impl!r}: the fused joint kernels are not ported yet; use 'xla'")
    if remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={remat!r}: 'save_logits' is not ported yet; use 'none' or 'full'")
    B, T, H = f_proj.shape
    U1 = g_proj.shape[1]
    labels_pad = torch.cat(
        [labels, torch.zeros((B, 1), dtype=labels.dtype, device=labels.device)], dim=1
    ).to(f_proj.device)
    n_chunks = -(-T // chunk_size)
    T_pad = n_chunks * chunk_size
    if T_pad != T:
        f_proj = F.pad(f_proj, (0, 0, 0, T_pad - T))
    drop = dropout_rate > 0.0 and generator is not None
    kw = dict(blank=blank, dropout_rate=dropout_rate, uniform_head=uniform_head)
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
    dev = lp_blank.device
    nll = rnnt_nll_from_logprobs(
        lp_blank, lp_label, frame_lens.to(dev, torch.int32),
        label_lens.to(dev, torch.int32),
    )
    return _reduce(nll, label_lens, reduction, row_mask)
