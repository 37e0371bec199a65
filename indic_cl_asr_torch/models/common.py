"""Shared pieces of the model family: modules whose f32 master parameters
are cast to the compute dtype where they are used, dropout, and the
randomness of a training step.

Port of indic_cl_asr_tpu/models/common.py and utils/rng.py:23-41. The JAX
package keeps every parameter in f32 and runs each Flax module in its
``dtype`` (bf16 at the flagship): Dense and Conv cast kernel and bias to
that dtype where they use them. The port does the same (``cast``), so
AdamW updates f32 weights; the values a bf16 model computes with equal
those of weights stored in bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import reduce_from_model


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``p`` in the compute dtype. Where no gradient flows to it
    (serving, and the frozen layers in training) the cast copy is kept on
    the parameter and reused until the parameter changes (its version
    counter or storage), which saves a cast kernel per use; where a
    gradient flows, the cast is part of the graph."""
    if p.dtype == dtype:
        return p
    if p.requires_grad and torch.is_grad_enabled():
        return p.to(dtype)
    key = (p._version, p.data_ptr(), p.device, dtype)
    hit = getattr(p, "_cast_cache", None)
    if hit is None or hit[0] != key:
        # a normal tensor even inside inference_mode, so a later forward
        # with autograd on may save it for the backward
        with torch.inference_mode(False):
            hit = (key, p.detach().to(dtype))
        p._cast_cache = hit
    return hit[1]


class Dense(nn.Linear):
    """``nn.Linear`` in a compute dtype: input, weight and bias are cast to
    ``dtype`` at use (Flax ``Dense(dtype=...)``)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else cast(self.bias, dt)
        return F.linear(x.to(dt), cast(self.weight, dt), b)


def row_parallel(dense: Dense, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel ``dense`` over ``mesh``'s model axis: this rank's
    input features times its slice of the weight's input dim, the partial
    products summed over the model ranks, then the (whole) bias once."""
    dt = dense.dtype
    y = reduce_from_model(F.linear(x.to(dt), cast(dense.weight, dt)), mesh)
    return y if dense.bias is None else y + cast(dense.bias, dt)


class _CastConv:
    """Convolution in a compute dtype: input, weight and bias are cast to
    ``dtype`` at use (Flax ``Conv(dtype=...)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else cast(self.bias, dt)
        return self._conv_forward(x.to(dt), cast(self.weight, dt), b)


class Conv1d(_CastConv, nn.Conv1d):
    pass


class Conv2d(_CastConv, nn.Conv2d):
    pass


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its scale and bias cast to the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, cast(self.weight, x.dtype),
                            cast(self.bias, x.dtype), self.eps)


JOINT_ACTIVATIONS = ("relu", "tanh", "sigmoid")


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """The joint's activation by name (the JAX package's ``_activate``)."""
    if activation == "relu":
        return torch.relu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"joint activation {activation!r}: one of {JOINT_ACTIVATIONS}")


def dropout_keep_mask(shape, rate: float, generator: torch.Generator,
                      device) -> torch.Tensor | None:
    """Bernoulli(1 - rate) keep mask drawn as 8-bit random bytes, the JAX
    package's ``dropout_keep_mask``: the keep probability is quantised to
    round((1-rate)·256)/256, so rate 0.1 keeps 230/256 (drops 0.10156).
    None when the threshold saturates (keep everything)."""
    t = int(round((1.0 - rate) * 256.0))
    if t >= 256:
        return None
    bits = torch.randint(0, 256, tuple(shape), generator=generator,
                         device=device, dtype=torch.uint8)
    return bits < t


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """FastDropout: ``where(keep, x / (1 - rate), 0)`` with the 8-bit keep
    mask, drawn from ``generator`` (on x's device)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = dropout_keep_mask(x.shape, rate, generator, x.device)
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


@dataclasses.dataclass
class Rngs:
    """The randomness of one training step, from generators passed in.

    ``host`` is a CPU generator for what must be the same on every device:
    the SpecAugment bands and the attention kernel's per-layer dropout
    seeds. ``device`` lives on the model's device and draws the large
    masks (dither, dropout). ``rank`` is the data rank folded into the
    device generator's seed and the joint kernel's (``fold_rank``): the
    whole model's draws are the same on every model rank of a data rank.
    Under a model axis of M > 1 (``model_rank``, ``n_model``) a split
    region draws from ``region``, a second device generator, and its
    attention kernel seeds (``seed``) fold in the global rank
    ``rank·M + model_rank``: each rank's heads and FFN slice get masks of
    their own. At M = 1 ``region`` is ``device`` and ``seed`` folds the
    data rank. JAX keys and torch generators give different numbers, so
    these draws match the JAX package in distribution, not in value; under
    more than one rank the device draws match the one-process run in
    distribution, not in value."""

    host: torch.Generator
    device: torch.Generator
    rank: int = 0
    model_rank: int = 0
    n_model: int = 1
    split: torch.Generator | None = None

    @classmethod
    def from_host(cls, host: torch.Generator, device, rank: int = 0, model_rank: int = 0,
                  n_model: int = 1) -> "Rngs":
        """A device generator seeded from one draw of ``host``, folded
        with the data rank ``rank``; under a model axis a second one for
        the split regions, folded with the global rank."""
        draw = int(torch.randint(0, 2**62, (1,), generator=host))
        dev = torch.Generator(device=torch.device(device))
        dev.manual_seed(fold_rank(draw, rank, 62))
        split = None
        if n_model > 1:
            split = torch.Generator(device=torch.device(device))
            split.manual_seed(fold_rank(draw ^ _SPLIT_SALT, rank * n_model + model_rank, 62))
        return cls(host=host, device=dev, rank=rank, model_rank=model_rank, n_model=n_model,
                   split=split)

    @property
    def region(self) -> torch.Generator:
        """The device generator of the model-parallel regions."""
        return self.device if self.split is None else self.split

    def fork(self) -> "Rngs":
        """Another step's Rngs from the same host generator and ranks."""
        return Rngs.from_host(self.host, self.device.device, self.rank, self.model_rank,
                              self.n_model)

    def seed(self) -> int:
        """A 31-bit seed from ``host`` (one per attention layer and step),
        folded with the global rank (the data rank at M = 1)."""
        return fold_rank(int(torch.randint(0, 2**31 - 1, (1,), generator=self.host)),
                         self.rank * self.n_model + self.model_rank, 31)


# keeps a split region's device stream apart from every rank's whole one
_SPLIT_SALT = 0x5DEECE66D


def fold_rank(seed: int, rank: int, bits: int) -> int:
    """``seed`` for rank ``rank`` (the data rank; in a model-split region
    the global rank): unchanged at rank 0, distinct for every rank. The
    host generator is the same on every rank (so are the SpecAugment
    bands, drawn for the global batch), but the kernels hash (seed, local
    row or head, ...) and the device generators draw local masks: without
    the fold, row i of every rank would get the same dropout."""
    return (seed ^ (rank * 0x9E3779B97F4A7C15)) & ((1 << bits) - 1)
