"""Conformer encoder in PyTorch (eval and train mode).

Port of indic_cl_asr_tpu/models/conformer.py (the reference NeMo
ConformerEncoder with 'striding' ConvSubsampling, Transformer-XL rel-pos
MHSA and the conv module with BatchNorm):

  * ConvSubsampling: Conv2d(k3, s2, p1)+ReLU per round over (time, mel),
    then a Linear. The JAX package runs NHWC and flattens (F/4, C) in that
    order, so the port permutes NCHW to (T, F, C) before the flatten;
  * layer order ½FFN -> MHSA -> conv(GLU, depthwise k, BatchNorm, swish)
    -> ½FFN -> LayerNorm, residuals throughout; LayerNorm eps 1e-6 (Flax's
    default), BatchNorm eps 1e-5;
  * the input scaled by √d_model, a float32 sin/cos position table over
    [T-1 .. -(T-1)], and the (left, right) ``att_context_size`` band;
  * ``attn_impl="flash"`` runs the flash rel-pos kernels
    (ops/flash_mhsa.py); ``"xla"`` is the eager path with the JAX XLA
    path's rounding: content and position scores rounded to the compute
    dtype, an f32 softmax, -1e9 masking and zeroed masked probabilities.

Parameters are f32 and cast to ``cfg.dtype`` where they are used
(models/common.py). Train mode (``module.train()``) follows the JAX
package:

  * dropout after the pre-encoder, inside each FFN, on every residual
    branch, and on the attention probabilities; the flash path drops
    inside the kernel with a per-layer seed, the eager path with
    ``dropout`` (the 8-bit FastDropout);
  * BatchNorm with Flax's semantics: statistics over every B x T position,
    padding included, in f32, the biased variance E[x²] - E[x]² both to
    normalise and in the running average, ``ra = 0.9·ra + 0.1·batch``;
  * ``frozen_till = F``: pre_encode and layers [0, F) run under
    ``torch.no_grad()`` (the JAX package's stop_gradient cut), still in
    train mode: their dropout applies and their BatchNorm statistics are
    updated.

Layer parameters are one module per layer; both JAX layouts (scanned
``stack/layers`` [L, ...] and unrolled ``layers_i``) load into it through
models/convert.py. ``causal_conv``, Longformer ``global_tokens`` and the
other conv norms arrive with later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_mhsa import flash_relpos_mhsa
from .common import Conv1d, Conv2d, Dense, LayerNorm, Rngs, cast, dropout


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    feat_in: int = 80
    n_layers: int = 17
    d_model: int = 512
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 31
    subsampling_factor: int = 4
    dropout: float = 0.1
    dropout_pre_encoder: float = 0.1
    dropout_att: float = 0.1
    frozen_till: int = 0  # layers [0, frozen_till) carry no gradient
    # (left, right) attention context in frames; -1 = unlimited
    att_context_size: tuple[int, int] = (-1, -1)
    attn_impl: str = "xla"  # "xla" (eager) or "flash" (CUDA kernels)
    dtype: torch.dtype = torch.float32  # compute dtype

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def sampling_num(self) -> int:
        return int(math.log2(self.subsampling_factor))


def subsampled_length(lengths, cfg: ConformerConfig):
    """calc_length with kernel 3, stride 2, pad 1+1, floor — per round."""
    out = lengths
    for _ in range(cfg.sampling_num):
        out = (out + 2 - 3) // 2 + 1
    return out


def subsampled_feat_dim(cfg: ConformerConfig) -> int:
    f = cfg.feat_in
    for _ in range(cfg.sampling_num):
        f = (f + 2 - 3) // 2 + 1
    return f


def rel_positional_encoding(length: int, d_model: int, device=None) -> torch.Tensor:
    """[2L-1, d] float32 sin/cos over positions L-1 .. -(L-1), built like
    the JAX package's rel_positional_encoding_dev (f32 iotas)."""
    positions = (length - 1) - torch.arange(
        2 * length - 1, dtype=torch.float32, device=device
    )
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    ang = positions[:, None] * div_term[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        2 * length - 1, d_model
    )


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[t, j] = in[t, (T-1) + (j - t)]
    via the XL pad/reshape trick."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, p + 1, t)
    return x[:, :, 1:].reshape(b, h, t, p)[..., :t]


class ConvSubsampling(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        C = cfg.d_model
        self.convs = nn.ModuleList(
            Conv2d(1 if i == 0 else C, C, 3, stride=2, padding=1, dtype=cfg.dtype)
            for i in range(cfg.sampling_num)
        )
        self.out = Dense(C * subsampled_feat_dim(cfg), cfg.d_model, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, T, F] -> [B, T/4, d_model]
        h = x[:, None]  # [B, 1, T, F]
        for conv in self.convs:
            h = F.relu(conv(h))
        B, C, T4, F4 = h.shape
        h = h.permute(0, 2, 3, 1).reshape(B, T4, F4 * C)  # (F4, C) order
        return self.out(h)


class RelPosSelfAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.linear_q = Dense(d, d, dtype=cfg.dtype)
        self.linear_k = Dense(d, d, dtype=cfg.dtype)
        self.linear_v = Dense(d, d, dtype=cfg.dtype)
        self.linear_pos = Dense(d, d, bias=False, dtype=cfg.dtype)
        self.linear_out = Dense(d, d, dtype=cfg.dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, d // H))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, d // H))

    def forward(self, x, pos_emb, lens, att_mask, rngs: Rngs | None = None):
        cfg = self.cfg
        H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
        B, T, _ = x.shape
        q = self.linear_q(x)
        k = self.linear_k(x)
        v = self.linear_v(x)
        p = self.linear_pos(pos_emb)  # [2T-1, d]
        drop = cfg.dropout_att if self.training else 0.0
        left, right = cfg.att_context_size
        if cfg.attn_impl == "flash":
            seed = 0
            if drop > 0.0:
                if rngs is None:
                    raise ValueError("attention dropout in train mode needs rngs")
                seed = rngs.seed()
            out = flash_relpos_mhsa(
                q, k, v, p, self.pos_bias_u, self.pos_bias_v, lens,
                n_heads=H, left=left, right=right, dropout_rate=drop, seed=seed,
            )
            return self.linear_out(out)

        dt = q.dtype
        q = q.view(B, T, H, D)
        k = k.view(B, T, H, D)
        v = v.view(B, T, H, D)
        p = p.view(-1, H, D)
        # scores ride in the compute dtype, the softmax in f32
        ac = torch.einsum("bthd,bshd->bhts", q + cast(self.pos_bias_u, dt), k)
        bd = torch.einsum("bthd,phd->bhtp", q + cast(self.pos_bias_v, dt), p)
        scores = (ac + _rel_shift(bd)) / math.sqrt(D)
        mask = att_mask[:, None]
        scores = scores.masked_fill(~mask, -1e9)
        attn = torch.softmax(scores.float(), dim=-1)
        attn = torch.where(mask, attn, 0.0)
        attn = dropout(attn, drop, rngs.device if rngs else None, self.training).to(dt)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, cfg.d_model)
        return self.linear_out(out)


class BatchNorm(nn.Module):
    """BatchNorm over channels of [B, C, T], in f32, with Flax's
    semantics: eval mode normalises with the stored statistics; train mode
    with the batch's (over all B x T positions, biased variance
    E[x²] - E[x]² clipped at 0) and updates the stored ones in place,
    ``ra = momentum·ra + (1 - momentum)·batch``."""

    def __init__(self, C: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))
        self.register_buffer("running_mean", torch.zeros(C))
        self.register_buffer("running_var", torch.ones(C))

    def forward(self, x):  # [B, C, T]
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None]) * mul[:, None]
        return (y + self.bias.float()[:, None]).to(x.dtype)


class ConformerConvModule(nn.Module):
    """pointwise(2d) -> GLU -> mask -> depthwise(k) -> BatchNorm -> swish
    -> pointwise(d)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.pointwise_conv1 = Dense(d, 2 * d, dtype=cfg.dtype)
        self.depthwise_conv = Conv1d(
            d, d, cfg.conv_kernel_size, padding=cfg.conv_kernel_size // 2,
            groups=d, dtype=cfg.dtype,
        )
        self.batch_norm = BatchNorm(d)
        self.pointwise_conv2 = Dense(d, d, dtype=cfg.dtype)

    def forward(self, x, pad_mask):
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        h = torch.where(pad_mask[:, :, None], h, 0.0)
        h = self.depthwise_conv(h.transpose(1, 2))
        h = F.silu(self.batch_norm(h)).transpose(1, 2)
        return self.pointwise_conv2(h)


class FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.linear1 = Dense(cfg.d_model, cfg.d_ff, dtype=cfg.dtype)
        self.linear2 = Dense(cfg.d_ff, cfg.d_model, dtype=cfg.dtype)

    def forward(self, x, rngs: Rngs | None = None):
        h = F.silu(self.linear1(x))
        h = dropout(h, self.cfg.dropout, rngs.device if rngs else None, self.training)
        return self.linear2(h)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        norm = lambda: LayerNorm(d, eps=1e-6)  # noqa: E731 (Flax eps)
        self.norm_feed_forward1 = norm()
        self.feed_forward1 = FeedForward(cfg)
        self.norm_self_att = norm()
        self.self_attn = RelPosSelfAttention(cfg)
        self.norm_conv = norm()
        self.conv = ConformerConvModule(cfg)
        self.norm_feed_forward2 = norm()
        self.feed_forward2 = FeedForward(cfg)
        self.norm_out = norm()

    def forward(self, x, pos_emb, lens, att_mask, pad_mask, rngs: Rngs | None = None):
        gen = rngs.device if rngs else None

        def drop(h):
            return dropout(h, self.cfg.dropout, gen, self.training)

        h = self.feed_forward1(self.norm_feed_forward1(x), rngs)
        x = x + 0.5 * drop(h)
        h = self.self_attn(self.norm_self_att(x), pos_emb, lens, att_mask, rngs)
        x = x + drop(h)
        x = x + drop(self.conv(self.norm_conv(x), pad_mask))
        h = self.feed_forward2(self.norm_feed_forward2(x), rngs)
        x = x + 0.5 * drop(h)
        return self.norm_out(x)


class ConformerEncoder(nn.Module):
    """[B, F, T_mel] features + [B] mel lengths -> [B, T_enc, d], [B] lens."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.attn_impl not in ("xla", "flash"):
            raise ValueError(f"attn_impl={cfg.attn_impl!r}")
        self.cfg = cfg
        self.pre_encode = ConvSubsampling(cfg)
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.n_layers))

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                rngs: Rngs | None = None):
        cfg = self.cfg
        n_frozen = min(max(cfg.frozen_till, 0), cfg.n_layers)
        gen = rngs.device if rngs else None
        # the frozen prefix (pre_encode and layers [0, F)) builds no graph
        frozen = torch.no_grad() if n_frozen > 0 else contextlib.nullcontext()
        with frozen:
            x = self.pre_encode(feats.transpose(1, 2))
            out_lens = subsampled_length(feat_lens.to(torch.int64), cfg).to(torch.int32)
            B, T, _ = x.shape
            x = x * math.sqrt(cfg.d_model)
            x = dropout(x, cfg.dropout_pre_encoder, gen, self.training)
        pos_emb = rel_positional_encoding(T, cfg.d_model, x.device).to(x.dtype)
        idx = torch.arange(T, device=x.device)
        pad_mask = idx[None, :] < out_lens[:, None]
        att_mask = None
        if cfg.attn_impl == "xla":
            att_mask = pad_mask[:, :, None] & pad_mask[:, None, :]
            left, right = cfg.att_context_size
            rel = idx[None, :] - idx[:, None]
            if left >= 0:
                att_mask = att_mask & (rel >= -left)[None]
            if right >= 0:
                att_mask = att_mask & (rel <= right)[None]
        for i, layer in enumerate(self.layers):
            with frozen if i < n_frozen else contextlib.nullcontext():
                x = layer(x, pos_emb, out_lens, att_mask, pad_mask, rngs)
        x = torch.where(pad_mask[:, :, None], x, 0.0)
        return x, out_lens
