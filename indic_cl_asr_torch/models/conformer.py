"""Conformer encoder in PyTorch (eval and train mode).

Port of indic_cl_asr_tpu/models/conformer.py (the reference NeMo
ConformerEncoder with 'striding' ConvSubsampling, Transformer-XL rel-pos
MHSA and the conv module with BatchNorm):

  * ConvSubsampling: Conv2d(k3, s2, p1)+ReLU per round over (time, mel),
    then a Linear. The JAX package runs NHWC and flattens (F/4, C) in that
    order, so the port permutes NCHW to (T, F, C) before the flatten;
  * layer order ½FFN -> MHSA -> conv(GLU, depthwise k, norm, swish)
    -> ½FFN -> LayerNorm, residuals throughout; LayerNorm eps 1e-6 (Flax's
    default), BatchNorm eps 1e-5;
  * the conv module's norm (``conv_norm_type``): BatchNorm, or Flax's
    LayerNorm over the channels of each frame or GroupNorm (``group_norm<N>``,
    N groups, 1 when omitted) over every frame of the padded T and C/N
    channels, both eps 1e-6 with f32 statistics E[x²] - E[x]² and no
    running statistics; the module keeps the name ``batch_norm``;
  * ``subsampling_conv_channels`` channels in the subsampling convs (-1:
    d_model);
  * the input scaled by √d_model when ``xscale``, a float32 sin/cos
    position table over [T-1 .. -(T-1)], and the (left, right)
    ``att_context_size`` band;
  * ``attn_impl="flash"`` runs the flash rel-pos kernels
    (ops/flash_mhsa.py); ``"xla"`` is the eager path with the JAX XLA
    path's rounding: content and position scores rounded to the compute
    dtype, an f32 softmax, -1e9 masking and zeroed masked probabilities.
    ``attention_route`` resolves the route once from the config, as the
    JAX module routes T > 512 and global tokens to XLA: a flash config
    whose head dim exceeds the kernels' largest (128), or with Longformer
    global tokens, takes the eager path;
  * ``causal_conv``: the depthwise conv pads (k-1, 0) instead of
    (k//2, k//2), so a frame sees none of its future (the cache-aware
    streaming of models/streaming.py needs it);
  * Longformer ``global_tokens`` G > 0 (the reference's
    RelPositionMultiHeadAttentionLongformer): the static positions 0, s,
    2s, .. (G-1)s (s = ``global_tokens_spacing``) attend to and from every
    valid position with content-only scores, from the shared projections
    or from ``global_q/k/v`` when ``global_attn_separate``; every other
    pair keeps the band. The global rows' outputs are drawn from the
    global values. As in the JAX package, an in-band global key gives one
    (global) score column, where NeMo's concatenation counts it twice;

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

Split over a model axis (parallel/sharding.py:shard_model) each layer
runs Megatron's column/row pairs on its slices: attention over H/M local
heads (the flash kernels unchanged, the position biases and any
global-token projections sliced to those heads, linear_out row-parallel),
the FFN (linear1 column-, linear2 row-parallel) and the conv module
(pointwise_conv1's paired value and gate columns, so the GLU is local; the
depthwise conv and the norm on the local channels, BatchNorm's sums over
the data ranks only and its updated statistics gathered whole;
pointwise_conv2 row-parallel). Draws inside a split region (the attention
kernel's seed, the eager attention's and the FFN's dropout) fold the model
rank in (``Rngs.region``); the residual ones do not.

Layer parameters are one module per layer; both JAX layouts (scanned
``stack/layers`` [L, ...] and unrolled ``layers_i``) load into it through
models/convert.py. ``dropout_emb`` and ``pos_emb_max_len`` are accepted and read by
no module, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_mhsa import MAX_HEAD_DIM, flash_relpos_mhsa
from ..parallel.sharding import all_reduce_sum, copy_to_model, gather_from_model, region_mesh
from .common import Conv1d, Conv2d, Dense, LayerNorm, Rngs, cast, dropout, row_parallel


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    feat_in: int = 80
    n_layers: int = 17
    d_model: int = 512
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 31
    conv_norm_type: str = "batch_norm"  # or "layer_norm" / "group_norm<N>"
    subsampling_factor: int = 4
    subsampling_conv_channels: int = -1  # -1 -> d_model
    dropout: float = 0.1
    dropout_pre_encoder: float = 0.1
    dropout_emb: float = 0.0
    dropout_att: float = 0.1
    xscale: bool = True
    pos_emb_max_len: int = 5000
    frozen_till: int = 0  # layers [0, frozen_till) carry no gradient
    # (left, right) attention context in frames; -1 = unlimited
    att_context_size: tuple[int, int] = (-1, -1)
    causal_conv: bool = False  # depthwise conv padded (k-1, 0)
    # Longformer global tokens at 0, s, 2s, ..: G, s, separate projections
    global_tokens: int = 0
    global_tokens_spacing: int = 1
    global_attn_separate: bool = False
    attn_impl: str = "xla"  # "xla" (eager) or "flash" (CUDA kernels)
    dtype: torch.dtype = torch.float32  # compute dtype

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def conv_channels(self) -> int:
        return (self.d_model if self.subsampling_conv_channels == -1
                else self.subsampling_conv_channels)

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


def sinusoids(first: int, n: int, d_model: int, device=None) -> torch.Tensor:
    """[n, d] float32 sin/cos (interleaved) over the distances first,
    first - 1, .., first - n + 1, from f32 iotas as the JAX package builds
    them."""
    positions = first - torch.arange(n, dtype=torch.float32, device=device)
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    ang = positions[:, None] * div_term[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(n, d_model)


def rel_positional_encoding(length: int, d_model: int, device=None) -> torch.Tensor:
    """[2L-1, d] float32 sin/cos over positions L-1 .. -(L-1), the JAX
    package's rel_positional_encoding_dev."""
    return sinusoids(length - 1, 2 * length - 1, d_model, device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[t, j] = in[t, (T-1) + (j - t)]
    via the XL pad/reshape trick."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, p + 1, t)
    return x[:, :, 1:].reshape(b, h, t, p)[..., :t]


class ConvSubsampling(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        C = cfg.conv_channels
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


def attention_route(cfg: ConformerConfig) -> str:
    """The attention path of every layer of ``cfg``: "flash" (the CUDA
    kernels) for ``attn_impl="flash"`` at head dims the kernels take and
    without global tokens, else "xla" (the eager path). Above head dim 128
    the kernels would need tiles split along D; until they exist those
    configs run eager. Global tokens take the eager path as the JAX
    module sends them to XLA: the kernels compute the band alone."""
    if (cfg.attn_impl == "flash" and cfg.d_model // cfg.n_heads <= MAX_HEAD_DIM
            and cfg.global_tokens == 0):
        return "flash"
    return "xla"


def global_positions(cfg: ConformerConfig, T: int) -> torch.Tensor:
    """bool [T]: the static global-token positions 0, s, .. (G-1)s below T."""
    pos = torch.arange(cfg.global_tokens) * cfg.global_tokens_spacing
    is_g = torch.zeros(T, dtype=torch.bool)
    is_g[pos[pos < T]] = True
    return is_g


class RelPosSelfAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.route = attention_route(cfg)
        self.linear_q = Dense(d, d, dtype=cfg.dtype)
        self.linear_k = Dense(d, d, dtype=cfg.dtype)
        self.linear_v = Dense(d, d, dtype=cfg.dtype)
        self.linear_pos = Dense(d, d, bias=False, dtype=cfg.dtype)
        self.linear_out = Dense(d, d, dtype=cfg.dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, d // H))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, d // H))
        if cfg.global_tokens > 0 and cfg.global_attn_separate:
            self.global_q = Dense(d, d, dtype=cfg.dtype)
            self.global_k = Dense(d, d, dtype=cfg.dtype)
            self.global_v = Dense(d, d, dtype=cfg.dtype)

    def forward(self, x, pos_emb, lens, att_mask, rngs: Rngs | None = None):
        cfg = self.cfg
        H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
        mesh = region_mesh(self.linear_q.weight)
        heads = slice(0, H)
        if mesh is not None:  # this rank's H/M heads
            x = copy_to_model(x, mesh)
            H //= mesh.n_model
            heads = slice(mesh.model_rank * H, (mesh.model_rank + 1) * H)
        B, T, _ = x.shape
        q = self.linear_q(x)
        k = self.linear_k(x)
        v = self.linear_v(x)
        p = self.linear_pos(pos_emb)  # [2T-1, H*D]
        bias_u, bias_v = self.pos_bias_u, self.pos_bias_v
        if mesh is not None:
            bias_u, bias_v = bias_u[heads], bias_v[heads]
        drop = cfg.dropout_att if self.training else 0.0
        left, right = cfg.att_context_size
        if self.route == "flash":
            seed = 0
            if drop > 0.0:
                if rngs is None:
                    raise ValueError("attention dropout in train mode needs rngs")
                seed = rngs.seed()
            out = flash_relpos_mhsa(
                q, k, v, p, bias_u, bias_v, lens,
                n_heads=H, left=left, right=right, dropout_rate=drop, seed=seed,
            )
            return self._out(out, mesh)

        dt = q.dtype
        q = q.view(B, T, H, D)
        k = k.view(B, T, H, D)
        v = v.view(B, T, H, D)
        p = p.view(-1, H, D)
        # scores ride in the compute dtype, the softmax in f32
        ac = torch.einsum("bthd,bshd->bhts", q + cast(bias_u, dt), k)
        bd = torch.einsum("bthd,phd->bhtp", q + cast(bias_v, dt), p)
        scores = (ac + _rel_shift(bd)) / math.sqrt(D)
        mask = att_mask[:, None]
        if cfg.global_tokens > 0:
            is_g = global_positions(cfg, T).to(x.device)
            gq, gk, gv = q, k, v
            if cfg.global_attn_separate:
                rows = slice(heads.start * D, heads.stop * D)
                gq, gk, gv = (F.linear(x.to(dt), cast(lin.weight, dt)[rows],
                                       cast(lin.bias, dt)[rows]).view(B, T, H, D)
                              for lin in (self.global_q, self.global_k, self.global_v))
            # a link with a global end takes the content-only global score
            # and is open between any two valid positions
            gscore = torch.einsum("bthd,bshd->bhts", gq, gk) / math.sqrt(D)
            use_g = is_g[:, None] | is_g[None, :]
            scores = torch.where(use_g, gscore, scores)
            diag = att_mask.diagonal(dim1=1, dim2=2)  # the band holds distance 0
            valid_pair = diag[:, :, None] & diag[:, None, :]
            mask = (att_mask | (valid_pair & use_g))[:, None]
        scores = scores.masked_fill(~mask, -1e9)
        attn = torch.softmax(scores.float(), dim=-1)
        attn = torch.where(mask, attn, 0.0)
        attn = dropout(attn, drop, rngs.region if rngs else None, self.training).to(dt)
        out = torch.einsum("bhts,bshd->bthd", attn, v)
        if cfg.global_tokens > 0:  # the global rows draw on the global values
            out = torch.where(is_g[None, :, None, None],
                              torch.einsum("bhts,bshd->bthd", attn, gv), out)
        return self._out(out.reshape(B, T, H * D), mesh)

    def _out(self, out, mesh):
        return self.linear_out(out) if mesh is None else row_parallel(self.linear_out, out, mesh)


class BatchNorm(nn.Module):
    """BatchNorm over channels of [B, C, T], in f32, with Flax's
    semantics: eval mode normalises with the stored statistics; train mode
    with the batch's (over all B x T positions, biased variance
    E[x²] - E[x]² clipped at 0) and updates the stored ones in place,
    ``ra = momentum·ra + (1 - momentum)·batch``, unless ``update_stats`` is
    off (``batch_stats_frozen``): the JAX package's callers that discard
    the ``batch_stats`` a train-mode forward returns. ``sum_over_ranks``
    (set by train/step.py:data_parallel under a data mesh) maps this
    rank's Σx and Σx² to the global batch's, differentiably, and gives
    the number of ranks: the statistics are then the global batch's, the
    same on every rank. Given the ``mesh`` of a model-split conv module,
    x holds this model rank's channels: the norm reads its slice of the
    scale, bias and statistics, and gathers the updated statistics whole
    over the model ranks."""

    def __init__(self, C: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.sum_over_ranks = None
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))
        self.register_buffer("running_mean", torch.zeros(C))
        self.register_buffer("running_var", torch.ones(C))

    def forward(self, x, mesh=None):  # [B, C, T]
        xf = x.float()
        ch = _channels(x, mesh)
        if self.training:
            sums = torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))])
            n = xf.shape[0] * xf.shape[2]
            if self.sum_over_ranks is not None:
                sums, ranks = self.sum_over_ranks(sums)
                n *= ranks
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    new = torch.stack([m * self.running_mean[ch] + (1 - m) * mean,
                                       m * self.running_var[ch] + (1 - m) * var])
                    if mesh is not None:
                        new = gather_from_model(new, 1, mesh)
                    self.running_mean.copy_(new[0])
                    self.running_var.copy_(new[1])
        else:
            mean, var = self.running_mean[ch].float(), self.running_var[ch].float()
        mul = torch.rsqrt(var + self.eps) * self.weight[ch].float()
        y = (xf - mean[:, None]) * mul[:, None]
        return (y + self.bias[ch].float()[:, None]).to(x.dtype)


def _channels(x, mesh) -> slice:
    """The channels of [B, C, T] ``x`` among the whole norm's: this model
    rank's slice under ``mesh``, all of them without one."""
    if mesh is None:
        return slice(None)
    C = x.shape[1]
    return slice(mesh.model_rank * C, (mesh.model_rank + 1) * C)


class GroupNorm(nn.Module):
    """Flax's LayerNorm (``groups=None``: over the C channels of each frame)
    or GroupNorm (over every frame of the padded T and the C/groups
    channels of a group, so a row's result depends on its padding) of
    [B, C, T], in f32: statistics E[x] and E[x²] - E[x]² clipped at 0,
    eps 1e-6, ``(x - mean)·(rsqrt(var + eps)·scale) + bias``; no running
    statistics. Given a model-split conv module's ``mesh`` x holds this
    model rank's channels: a layer norm sums its statistics over the model
    ranks, a group norm keeps groups/M whole groups."""

    def __init__(self, C: int, groups: int | None, eps: float = 1e-6):
        super().__init__()
        if groups is not None and (groups <= 0 or C % groups):
            raise ValueError(f"{groups} groups do not divide {C} channels")
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))

    def forward(self, x, mesh=None):  # [B, C, T]
        xf = x.float()
        ch = _channels(x, mesh)
        if self.groups is None and mesh is not None:
            sums = torch.stack([xf.sum(dim=1, keepdim=True), (xf * xf).sum(dim=1, keepdim=True)])
            sums = all_reduce_sum(sums, mesh, "model") / self.weight.shape[0]
            mean, sq = sums[0], sums[1]
        elif self.groups is None:
            mean = xf.mean(dim=1, keepdim=True)
            sq = (xf * xf).mean(dim=1, keepdim=True)
        else:
            B, C, T = xf.shape
            groups = self.groups // (1 if mesh is None else mesh.n_model)
            g = xf.reshape(B, groups, C // groups * T)
            mean = g.mean(dim=2).repeat_interleave(C // groups, dim=1)[:, :, None]
            sq = (g * g).mean(dim=2).repeat_interleave(C // groups, dim=1)[:, :, None]
        var = torch.clamp(sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[ch].float()[:, None]
        return ((xf - mean) * mul + self.bias[ch].float()[:, None]).to(x.dtype)


def conv_norm(cfg: ConformerConfig) -> nn.Module:
    """The conv module's norm named by ``cfg.conv_norm_type``."""
    kind = cfg.conv_norm_type
    if kind == "batch_norm":
        return BatchNorm(cfg.d_model)
    if kind == "layer_norm":
        return GroupNorm(cfg.d_model, None)
    if kind.startswith("group_norm"):
        return GroupNorm(cfg.d_model, int(kind[len("group_norm"):] or 1))
    raise ValueError(f"conv_norm_type={kind!r}")


@contextlib.contextmanager
def batch_stats_frozen(module: nn.Module):
    """Inside, train-mode BatchNorm normalises with the batch's statistics
    but leaves the stored ones untouched (EWC's Fisher and MAS's
    importance batches, the LwF teacher's forward)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield module
    finally:
        for m, b in zip(norms, before):
            m.update_stats = b


class ConformerConvModule(nn.Module):
    """pointwise(2d) -> GLU -> mask -> depthwise(k) -> norm -> swish
    -> pointwise(d); the norm is ``conv_norm(cfg)``, named ``batch_norm``
    whatever its kind (the JAX package's and NeMo's name)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d, k = cfg.d_model, cfg.conv_kernel_size
        # a causal conv is padded (k-1, 0) in forward, else (k//2, k//2) here
        self.causal_pad = k - 1 if cfg.causal_conv else 0
        self.pointwise_conv1 = Dense(d, 2 * d, dtype=cfg.dtype)
        self.depthwise_conv = Conv1d(d, d, k, padding=0 if cfg.causal_conv else k // 2,
                                     groups=d, dtype=cfg.dtype)
        self.batch_norm = conv_norm(cfg)
        self.pointwise_conv2 = Dense(d, d, dtype=cfg.dtype)

    def forward(self, x, pad_mask):
        mesh = region_mesh(self.pointwise_conv1.weight)
        if mesh is None:
            a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        else:  # this rank's value and gate columns, and their biases
            x = copy_to_model(x, mesh)
            pw = self.pointwise_conv1
            dt = pw.dtype
            bias = torch.cat([half[self._local(mesh)] for half in cast(pw.bias, dt).chunk(2)])
            a, b = F.linear(x.to(dt), cast(pw.weight, dt), bias).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        h = torch.where(pad_mask[:, :, None], h, 0.0)
        h = h.transpose(1, 2)
        if self.causal_pad:
            h = F.pad(h, (self.causal_pad, 0))
        if mesh is None:
            h = self.depthwise_conv(h)
            h = F.silu(self.batch_norm(h)).transpose(1, 2)
            return self.pointwise_conv2(h)
        dw = self.depthwise_conv
        ch = self._local(mesh)
        h = F.conv1d(h.to(dw.dtype), cast(dw.weight, dw.dtype)[ch], cast(dw.bias, dw.dtype)[ch],
                     padding=dw.padding, groups=h.shape[1])
        h = F.silu(self.batch_norm(h, mesh)).transpose(1, 2)
        return row_parallel(self.pointwise_conv2, h, mesh)

    def _local(self, mesh) -> slice:
        """This model rank's channels of the d_model."""
        C = self.depthwise_conv.in_channels // mesh.n_model
        return slice(mesh.model_rank * C, (mesh.model_rank + 1) * C)


class FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.linear1 = Dense(cfg.d_model, cfg.d_ff, dtype=cfg.dtype)
        self.linear2 = Dense(cfg.d_ff, cfg.d_model, dtype=cfg.dtype)

    def forward(self, x, rngs: Rngs | None = None):
        mesh = region_mesh(self.linear1.weight)
        if mesh is not None:
            x = copy_to_model(x, mesh)
        h = F.silu(self.linear1(x))
        h = dropout(h, self.cfg.dropout, rngs.region if rngs else None, self.training)
        return self.linear2(h) if mesh is None else row_parallel(self.linear2, h, mesh)


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
        self.attention_route = attention_route(cfg)
        self.pre_encode = ConvSubsampling(cfg)
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.n_layers))

    def extra_repr(self) -> str:
        return f"attention_route={self.attention_route!r}"

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
            if cfg.xscale:
                x = x * math.sqrt(cfg.d_model)
            x = dropout(x, cfg.dropout_pre_encoder, gen, self.training)
        pos_emb = rel_positional_encoding(T, cfg.d_model, x.device).to(x.dtype)
        idx = torch.arange(T, device=x.device)
        pad_mask = idx[None, :] < out_lens[:, None]
        att_mask = None
        if self.attention_route == "xla":
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
