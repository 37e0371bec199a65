"""Conformer encoder in PyTorch (eval mode).

Port of indic_cl_asr_tpu/models/conformer.py (the reference NeMo
ConformerEncoder with 'striding' ConvSubsampling, Transformer-XL rel-pos
MHSA and the conv module with BatchNorm):

  * ConvSubsampling: Conv2d(k3, s2, p1)+ReLU per round over (time, mel),
    then a Linear. The JAX package runs NHWC and flattens (F/4, C) in that
    order, so the port permutes NCHW to (T, F, C) before the flatten;
  * layer order ½FFN -> MHSA -> conv(GLU, depthwise k, BatchNorm, swish)
    -> ½FFN -> LayerNorm, residuals throughout; LayerNorm eps 1e-6 (Flax's
    default), BatchNorm eps 1e-5 on the stored statistics;
  * the input scaled by √d_model, a float32 sin/cos position table over
    [T-1 .. -(T-1)], and the (left, right) ``att_context_size`` band;
  * ``attn_impl="flash"`` runs the flash rel-pos kernel
    (ops/flash_mhsa.py); ``"xla"`` is the eager path with the JAX XLA
    path's rounding: content and position scores rounded to the compute
    dtype, an f32 softmax, -1e9 masking and zeroed masked probabilities.

Layer parameters are one module per layer; both JAX layouts (scanned
``stack/layers`` [L, ...] and unrolled ``layers_i``) load into it through
models/convert.py. The config holds only what this eval-mode encoder
runs: dropout, SpecAugment, ``frozen_till``, ``causal_conv``, Longformer
``global_tokens`` and the other conv norms arrive with later slices, and
passing one of them raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_mhsa import flash_relpos_mhsa


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    feat_in: int = 80
    n_layers: int = 17
    d_model: int = 512
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 31
    subsampling_factor: int = 4
    # (left, right) attention context in frames; -1 = unlimited
    att_context_size: tuple[int, int] = (-1, -1)
    attn_impl: str = "xla"  # "xla" (eager) or "flash" (CUDA kernel)

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
            nn.Conv2d(1 if i == 0 else C, C, 3, stride=2, padding=1)
            for i in range(cfg.sampling_num)
        )
        self.out = nn.Linear(C * subsampled_feat_dim(cfg), cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, T, F] -> [B, T/4, d_model]
        h = x[:, None].to(self.out.weight.dtype)  # [B, 1, T, F]
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
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_pos = nn.Linear(d, d, bias=False)
        self.linear_out = nn.Linear(d, d)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, d // H))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, d // H))

    def forward(self, x, pos_emb, lens, att_mask):
        cfg = self.cfg
        H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
        B, T, _ = x.shape
        q = self.linear_q(x)
        k = self.linear_k(x)
        v = self.linear_v(x)
        p = self.linear_pos(pos_emb)  # [2T-1, d]
        left, right = cfg.att_context_size
        if cfg.attn_impl == "flash":
            out = flash_relpos_mhsa(
                q, k, v, p, self.pos_bias_u, self.pos_bias_v, lens,
                n_heads=H, left=left, right=right,
            )
            return self.linear_out(out)

        dt = q.dtype
        q = q.view(B, T, H, D)
        k = k.view(B, T, H, D)
        v = v.view(B, T, H, D)
        p = p.view(-1, H, D)
        # scores ride in the compute dtype, the softmax in f32
        ac = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u.to(dt), k)
        bd = torch.einsum("bthd,phd->bhtp", q + self.pos_bias_v.to(dt), p)
        scores = (ac + _rel_shift(bd)) / math.sqrt(D)
        mask = att_mask[:, None]
        scores = scores.masked_fill(~mask, -1e9)
        attn = torch.softmax(scores.float(), dim=-1)
        attn = torch.where(mask, attn, 0.0).to(dt)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, cfg.d_model)
        return self.linear_out(out)


class BatchNormEval(nn.Module):
    """BatchNorm over channels from stored statistics (eval mode), computed
    in f32: (x - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, C: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))
        self.register_buffer("running_mean", torch.zeros(C))
        self.register_buffer("running_var", torch.ones(C))

    def forward(self, x):  # [B, C, T]
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float()[:, None]) * mul[:, None]
        return (y + self.bias.float()[:, None]).to(x.dtype)


class ConformerConvModule(nn.Module):
    """pointwise(2d) -> GLU -> mask -> depthwise(k) -> BatchNorm -> swish
    -> pointwise(d)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.pointwise_conv1 = nn.Linear(d, 2 * d)
        self.depthwise_conv = nn.Conv1d(
            d, d, cfg.conv_kernel_size, padding=cfg.conv_kernel_size // 2,
            groups=d,
        )
        self.batch_norm = BatchNormEval(d)
        self.pointwise_conv2 = nn.Linear(d, d)

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
        self.linear1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.linear2 = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        return self.linear2(F.silu(self.linear1(x)))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        norm = lambda: nn.LayerNorm(d, eps=1e-6)  # noqa: E731 (Flax eps)
        self.norm_feed_forward1 = norm()
        self.feed_forward1 = FeedForward(cfg)
        self.norm_self_att = norm()
        self.self_attn = RelPosSelfAttention(cfg)
        self.norm_conv = norm()
        self.conv = ConformerConvModule(cfg)
        self.norm_feed_forward2 = norm()
        self.feed_forward2 = FeedForward(cfg)
        self.norm_out = norm()

    def forward(self, x, pos_emb, lens, att_mask, pad_mask):
        x = x + 0.5 * self.feed_forward1(self.norm_feed_forward1(x))
        x = x + self.self_attn(self.norm_self_att(x), pos_emb, lens, att_mask)
        x = x + self.conv(self.norm_conv(x), pad_mask)
        x = x + 0.5 * self.feed_forward2(self.norm_feed_forward2(x))
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

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        cfg = self.cfg
        x = self.pre_encode(feats.transpose(1, 2))
        out_lens = subsampled_length(feat_lens.to(torch.int64), cfg).to(torch.int32)
        B, T, _ = x.shape
        x = x * math.sqrt(cfg.d_model)
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
        for layer in self.layers:
            x = layer(x, pos_emb, out_lens, att_mask, pad_mask)
        x = torch.where(pad_mask[:, :, None], x, 0.0)
        return x, out_lens
