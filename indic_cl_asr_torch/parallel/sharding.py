"""The DP x TP mesh (PyTorch).

Port of indic_cl_asr_tpu/parallel/sharding.py (reference DDP + NCCL +
SyncBatchNorm + DistributedSampler, cl_baseline.py:33-48, 133-134;
SURVEY.md §2.3, §5.8). One process drives one device; the mesh lays the
process group's ranks out row-major as "data" x "model", as the JAX
``make_mesh`` reshapes its devices: global rank = data_rank x n_model +
model_rank. Each axis has its own process group.

Under the JAX package's GSPMD the collectives are implicit. Here they
are explicit, and each rank calls them in the same order.

The data axis:

  * every rank assembles the identical global batch and keeps the rows
    its data rank owns (``place_batch``): the leading axis is split over
    "data"; the scalars (``n_valid``) and the host lengths SpecAugment
    draws from stay global, and ``row0`` marks this rank's first global
    row. The model ranks of one data rank hold the same rows;
  * every mean over the batch sums this rank's valid rows and divides by
    the global count, so the sum over the data ranks is the global mean;
  * BatchNorm statistics are all-reduced sums over the data ranks
    (``all_reduce_sum``, differentiable), the global batch's;
  * the step's gradients and logged losses go through one flat
    all-reduce over the data group (``reduce_sum``).

The model axis (Megatron tensor parallelism):

  * ``PARAM_RULES``, the JAX package's regexes over its parameter paths,
    give each parameter the dim it is split along, or None (whole), with
    the JAX divisibility fallback (``split_dims``: each port name is
    mapped to its JAX path by models/convert.py:jax_path).
    ``shard_model`` keeps this rank's slice of each split parameter; an
    AdamW built after it keeps moments of the slices;
  * the encoder's products run on the slices: column-parallel
    linear_q/k/v/pos (H/M heads a rank), FFN linear1 and pointwise_conv1,
    row-parallel linear_out, linear2 and pointwise_conv2, between
    ``copy_to_model`` (identity; the backward sums the cotangent over the
    model ranks) and ``reduce_from_model`` (the partial products summed;
    identity backward). pointwise_conv1 keeps a rank's PAIRED columns, its
    slice of the GLU's value half and of its gate half, so the GLU stays
    local: a permutation of the JAX contiguous split, undone by
    ``gather_state``;
  * the prediction net and the heads keep their split storage and compute
    whole: ``whole`` gathers a split parameter at use
    (``gather_from_model``: all-gather; the backward keeps this rank's
    slice), and the joint's projections are column-parallel, their
    outputs gathered;
  * parameters whole in JAX that a split region reads a slice of (the
    position biases, the global-token projections, the pointwise_conv1
    bias, the depthwise conv, the conv norm's scale and bias, the joint
    projections' biases) get partial gradients on each rank:
    ``model_sum_partial`` sums them over the model ranks before the data
    all-reduce;
  * ``gather_state``/``gather_named`` and ``local_named`` convert between
    the shards and the whole state (checkpoints, the whole model eval
    decodes with).

``COUNTS`` counts each axis's collectives apart.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from .distributed import all_hosts_agree, initialized, process_count, process_index

# collectives issued, their bytes and the host seconds spent issuing them
# (the enqueue: no call waits for the device), since the last reset: the
# data axis as all_reduce*, the model axis as model_*  (each axis's cost a
# step: read around a step, reset by the caller)
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """"data" x "model" over the process group's ranks. ``data_rank`` and
    ``model_rank`` are this process's place on each axis; ``group`` is the
    data axis's process group and ``model_group`` the model axis's (None:
    no process group, or an axis of one, whose collectives are the
    identity)."""

    n_data: int
    n_model: int
    data_rank: int
    group: object | None
    model_rank: int = 0
    model_group: object | None = None


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). ``n_data=None`` means world size / ``n_model``. Raises
    ``ValueError`` when the mesh does not cover the ranks exactly (a
    process is one device), when the ranks ask for different meshes, or
    when a group's members disagree on their places. Every rank builds
    every group (``dist.new_group``) in the same order: the data groups
    by model rank, then the model groups by data rank."""
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than the {world} processes")
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves processes out of {world}: each "
                         "process is one device; launch as many processes as the mesh holds")
    if n_model == 1:
        return Mesh(n_data, 1, process_index(), dist.group.WORLD if initialized() else None)
    if not all_hosts_agree(np.array([n_data, n_model])):
        raise ValueError(f"this rank asks for a {n_data}x{n_model} mesh, another for another")
    data_rank, model_rank = divmod(process_index(), n_model)
    groups = {}
    for m in range(n_model):
        groups["data", m] = dist.new_group([d * n_model + m for d in range(n_data)])
    for d in range(n_data):
        groups["model", d] = dist.new_group([d * n_model + m for m in range(n_model)])
    mesh = Mesh(n_data, n_model, data_rank, groups["data", model_rank], model_rank,
                groups["model", data_rank])
    for group, size, place, other in ((mesh.group, n_data, model_rank, "model"),
                                      (mesh.model_group, n_model, data_rank, "data")):
        got = [None] * size
        dist.all_gather_object(got, place, group=group)
        if any(g != place for g in got):
            raise ValueError(f"a group of rank {process_index()} holds ranks of {other} "
                             f"places {got}, not all {place}")
    return mesh


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _axis(mesh: Mesh, axis: str):
    """(group, counter prefix) of ``axis`` ("data" or "model")."""
    return (mesh.group, "") if axis == "data" else (mesh.model_group, "model_")


def _all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """In-place sum of ``t`` over the ranks of ``axis``. A 16-bit tensor
    is summed in f32 and rounded once."""
    group, key = _axis(mesh, axis)
    t0 = time.perf_counter()
    if group is not None:
        if t.element_size() < 4:
            buf = t.float()
            dist.all_reduce(buf, group=group)
            t.copy_(buf)
        else:
            dist.all_reduce(t, group=group)
    COUNTS[f"{key}all_reduce"] += 1
    COUNTS[f"{key}all_reduce_bytes"] += t.numel() * t.element_size()
    COUNTS[f"{key}all_reduce_host_s" if not key else "model_host_s"] += time.perf_counter() - t0
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every model rank's ``t`` (equal shapes), in model-rank order."""
    t0 = time.perf_counter()
    t = t.contiguous()
    # gloo gathers no bfloat16: move a 16-bit tensor's bytes
    wire = t.view(torch.uint8) if t.element_size() == 2 else t
    out = [torch.empty_like(wire) for _ in range(mesh.n_model)]
    dist.all_gather(out, wire, group=mesh.model_group)
    COUNTS["model_all_gather"] += 1
    COUNTS["model_all_gather_bytes"] += t.numel() * t.element_size() * mesh.n_model
    COUNTS["model_host_s"] += time.perf_counter() - t0
    return [o.view(t.dtype) for o in out]


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x over one axis; the cotangent of each rank's x is
    Σ_ranks dy, since every rank's share of the loss reads y."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None, axis: str = "data") -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis``, differentiable (the identity
    without a mesh)."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh, axis)


class _CopyToModel(torch.autograd.Function):
    """Enter the model-parallel region: identity; each model rank's
    cotangent covers its slice's use of x only, so the backward sums it."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Leave the region by a sum of the ranks' partial products; the
    cotangent of the (whole) sum is every rank's."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_(x.clone(), mesh, "model")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    """Leave the region by concatenating the ranks' slices along ``dim``;
    the cotangent of this rank's slice is its slice of the (whole)
    cotangent."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], mesh.model_rank
        return torch.cat(_all_gather(x, mesh), dim=dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim % x.dim(), mesh)


def reduce_sum(mesh: Mesh, tensors, like, axis: str = "data") -> list[torch.Tensor]:
    """Sum each of ``tensors`` over the ranks of ``axis`` in ONE all-reduce
    of a flat f32 buffer; a None (an unused gradient) enters as zeros
    shaped as its ``like`` entry, so every rank's buffer has the same
    layout."""
    parts = [torch.zeros_like(l) if t is None else t for t, l in zip(tensors, like)]
    flat = torch.cat([p.detach().reshape(-1).float() for p in parts])
    _all_reduce_(flat, mesh, axis)
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].view(p.shape).to(p.dtype))
        i += p.numel()
    return out


# ---------------------------------------------------------------------------
# the rules and the shards
# ---------------------------------------------------------------------------

# (regex over the JAX package's '/'-joined parameter path) -> its
# PartitionSpec as a tuple, the JAX package's PARAM_RULES as it states
# them: column-parallel layers split the OUTPUT dim, the row-parallel
# layer after them the INPUT dim. First match wins.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"feed_forward\d/linear1/kernel$", (None, "model")),
    (r"feed_forward\d/linear2/kernel$", ("model", None)),
    (r"feed_forward\d/linear1/bias$", ("model",)),
    (r"self_attn/linear_[qkv]/kernel$", (None, "model")),
    (r"self_attn/linear_[qkv]/bias$", ("model",)),
    (r"self_attn/linear_pos/kernel$", (None, "model")),
    (r"self_attn/linear_out/kernel$", ("model", None)),
    (r"conv/pointwise_conv1/kernel$", (None, "model")),
    (r"conv/pointwise_conv2/kernel$", ("model", None)),
    (r"prediction/embedding$", ("model", None)),
    (r"lstm_\d/w_ih$", (None, "model")),
    (r"lstm_\d/w_hh$", (None, "model")),
    (r"lstm_\d/bias$", ("model",)),
    (r"joint/(enc|pred)/kernel$", (None, "model")),
    (r"joint/head_kernel$", (None, None, "model")),
    (r"joint/head_bias$", (None, "model")),
    (r"ctc_decoder/kernel$", (None, "model")),
    (r"ctc_decoder/bias$", ("model",)),
]

# the encoder parameters the port computes split: each must split (the
# port has no whole fallback inside a layer)
_ENCODER_SPLIT = re.compile(r"^encoder\.layers\.\d+\.(feed_forward\d\.linear[12]\.weight|"
                            r"feed_forward\d\.linear1\.bias|self_attn\.linear_(q|k|v|pos|out)"
                            r"\.weight|self_attn\.linear_[qkv]\.bias|"
                            r"conv\.pointwise_conv[12]\.weight)$")
# whole in the JAX rules, read a slice of by a split region (the encoder's
# always, the joint's where its projections split)
_PARTIAL = re.compile(r"^encoder\.layers\.\d+\.(self_attn\.pos_bias_[uv]|"
                      r"self_attn\.global_[qkv]\.(weight|bias)|conv\.pointwise_conv1\.bias|"
                      r"conv\.depthwise_conv\.(weight|bias)|conv\.batch_norm\.(weight|bias))$")
_PAIRED = re.compile(r"conv\.pointwise_conv1\.weight$")


def _spec_for_path(path: str) -> tuple:
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, path):
            return spec
    return ()


def split_dims(model: torch.nn.Module, n_model: int) -> dict[str, int | None]:
    """{parameter name: the dim (in the port's layout) split over a model
    axis of ``n_model``, or None}: the JAX rule of the parameter's JAX
    path, whole where the split dim does not divide by ``n_model`` (the
    JAX package's fallback) or the axis is 1."""
    from ..models.convert import jax_path

    out = {}
    for name, p in model.named_parameters():
        path, axes = jax_path(name, p.dim())
        spec = _spec_for_path(path)
        dim = None
        if n_model > 1 and "model" in spec and len(spec) <= p.dim():
            j = spec.index("model")
            port_dim = j if axes is None else axes.index(j)
            if p.shape[port_dim] % n_model == 0:
                dim = port_dim
        out[name] = dim
    return out


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter is split: along ``dim`` over ``mesh``'s model axis;
    ``paired``: each half of ``dim`` split on its own (pointwise_conv1's
    value and gate columns)."""

    dim: int
    mesh: Mesh
    paired: bool = False


def shard_tensor(t: torch.Tensor, split: Split, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of the whole ``t``."""
    M = split.mesh.n_model
    if split.paired:
        return torch.cat([h.chunk(M, split.dim)[rank] for h in t.chunk(2, split.dim)],
                         split.dim)
    return t.chunk(M, split.dim)[rank]


def unshard(pieces: list[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every model rank's slice."""
    if split.paired:
        halves = [p.chunk(2, split.dim) for p in pieces]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], split.dim)
    return torch.cat(pieces, split.dim)


def split_of(p: torch.Tensor) -> Split | None:
    """``p``'s Split, None for a whole parameter."""
    return getattr(p, "model_split", None)


def region_mesh(p: torch.Tensor) -> Mesh | None:
    """The mesh a split parameter's region runs over (None: whole)."""
    s = split_of(p)
    return None if s is None else s.mesh


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p`` whole: a split parameter gathered from the model ranks
    (differentiable), any other as it is."""
    s = split_of(p)
    if s is None:
        return p
    if s.paired:
        raise ValueError("a paired split is read as its slices")
    return gather_from_model(p, s.dim, s.mesh)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split ``model`` (whole, on this rank's device) over ``mesh``'s model
    axis in place: each parameter ``split_dims`` splits keeps this rank's
    slice and is tagged ``model_split``; the whole parameters a split
    region reads a slice of are tagged ``model_partial``; ``model.mesh``
    is set. Build the optimizer after this. Raises ``ValueError`` where
    the encoder cannot run split: heads, FFN width or channels that do
    not divide by the model axis, or a group norm whose groups do not.
    The identity for a model axis of one."""
    M, r = mesh.n_model, mesh.model_rank
    if M == 1:
        return model
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is split already")
    enc = model.cfg.encoder
    if enc.n_heads % M:
        raise ValueError(f"{enc.n_heads} attention heads do not split over a model axis of "
                         f"{M}: each rank runs whole heads (flash or eager); choose "
                         "--mesh.model to divide model.n_heads")
    norm = enc.conv_norm_type
    if norm.startswith("group_norm") and int(norm[len("group_norm"):] or 1) % M:
        raise ValueError(f"{norm}: its groups do not split over a model axis of {M}")
    dims = split_dims(model, M)
    whole_enc = [n for n, d in dims.items() if d is None and _ENCODER_SPLIT.match(n)]
    if whole_enc:
        raise ValueError(f"{whole_enc[0]} does not split over a model axis of {M} "
                         "(d_model and the FFN width must divide by it)")
    joint_split = dims.get("joint.enc.weight") is not None
    for name, p in model.named_parameters():
        dim = dims[name]
        if dim is not None:
            split = Split(dim, mesh, paired=bool(_PAIRED.search(name)))
            with torch.no_grad():
                p.data = shard_tensor(p.data, split, r).clone()
            p.model_split = split
        elif _PARTIAL.match(name) or (joint_split and name in ("joint.enc.bias",
                                                                "joint.pred.bias")):
            p.model_partial = mesh
    model.mesh = mesh
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    return getattr(model, "mesh", None) is not None


def _gather_many(tensors: list[torch.Tensor], splits: list[Split]) -> list[torch.Tensor]:
    """The whole tensors of split ``tensors``, one all-gather per dtype."""
    out: list[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: dict = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        pieces = _all_gather(flat, splits[idx[0]].mesh)
        off = 0
        for i in idx:
            n, shape = tensors[i].numel(), tensors[i].shape
            out[i] = unshard([p[off:off + n].view(shape) for p in pieces], splits[i])
            off += n
    return out


def _whole_list(tensors, splits) -> list[torch.Tensor]:
    idx = [i for i, s in enumerate(splits) if s is not None]
    out = [t.detach() for t in tensors]
    for i, w in zip(idx, _gather_many([tensors[i] for i in idx], [splits[i] for i in idx])):
        out[i] = w
    return out


def gather_named(model: torch.nn.Module, tensors: dict) -> dict:
    """{parameter name: tensor shaped as that parameter's shard} -> the
    same names with whole tensors (every model rank calls it; the
    identity on a model that is not split)."""
    params = dict(model.named_parameters())
    names = list(tensors)
    splits = [split_of(params[n]) if n in params else None for n in names]
    return dict(zip(names, _whole_list([tensors[n] for n in names], splits)))


def local_named(model: torch.nn.Module, tensors: dict) -> dict:
    """The inverse of ``gather_named``: this rank's slice of each whole
    tensor named after a split parameter; any other entry as it is (a
    whole state dict as ``model``'s shards:
    ``model.load_state_dict(local_named(model, whole))``)."""
    params = dict(model.named_parameters())
    out = {}
    for n, t in tensors.items():
        s = split_of(params[n]) if n in params else None
        out[n] = t if s is None else shard_tensor(t, s, s.mesh.model_rank)
    return out


def gather_state(model: torch.nn.Module, optimizer=None) -> dict:
    """The whole state of a split ``model`` on every model rank: ``model``,
    its state dict (parameters and BatchNorm statistics) whole; with
    ``optimizer`` (train/state.py:AdamW over its parameters) also ``mu``
    and ``nu``, whole, in the optimizer's order. A model that is not split
    gives its own tensors (detached)."""
    out = {"model": gather_named(model, model.state_dict())}
    if optimizer is not None:
        splits = [split_of(p) for p in optimizer.params]
        out["mu"] = _whole_list(optimizer.mu, splits)
        out["nu"] = _whole_list(optimizer.nu, splits)
    return out


def local_moments(optimizer, moments: list[torch.Tensor]) -> list[torch.Tensor]:
    """Whole AdamW moments (in the optimizer's order) as its shards."""
    return [m if split_of(p) is None else shard_tensor(m, split_of(p), split_of(p).mesh.model_rank)
            for p, m in zip(optimizer.params, moments)]


def model_sum_partial(mesh: Mesh | None, grads, params) -> list:
    """``grads`` with those of the ``model_partial`` parameters summed over
    the model ranks, in one flat all-reduce (None enters as zeros); the
    rest as given."""
    grads = list(grads)
    if mesh is None or mesh.n_model == 1:
        return grads
    idx = [i for i, p in enumerate(params) if getattr(p, "model_partial", None) is not None]
    if idx:
        summed = reduce_sum(mesh, [grads[i] for i in idx], [params[i] for i in idx], "model")
        for i, g in zip(idx, summed):
            grads[i] = g
    return grads


def model_total(values, params) -> torch.Tensor:
    """Σ of per-parameter scalars, each split parameter's a sum over its
    slice: the split ones summed over the model ranks (one all-reduce,
    identity backward), the whole ones counted once."""
    own = [v for v, p in zip(values, params) if split_of(p) is None]
    split = [(v, split_of(p).mesh) for v, p in zip(values, params) if split_of(p) is not None]
    total = sum(own) if own else 0.0
    if split:
        total = total + reduce_from_model(torch.stack([v for v, _ in split]).sum(), split[0][1])
    return total


def whole_numel(p: torch.Tensor) -> int:
    """Elements of the whole parameter ``p`` is a shard of."""
    s = split_of(p)
    return p.numel() * (1 if s is None else s.mesh.n_model)


# batch keys whose leading axis is NOT split: the global batch's host
# lengths (the SpecAugment bands are drawn for every row of it)
GLOBAL_KEYS = ("audio_len_host",)


def place_batch(batch: dict, mesh: Mesh, device) -> dict:
    """This rank's rows of a global batch dict (train/step.py's
    ``batch_to_device_dict`` layout) on ``device``: every tensor's leading
    axis split over "data", the scalars and ``GLOBAL_KEYS`` kept whole,
    ``n_valid`` (the global count of real rows; B when absent) and
    ``row0``, the first global row this rank holds. The model ranks of
    one data rank get the same rows. Raises ``ValueError`` when B is not
    divisible by the data axis."""
    B = batch["audio"].shape[0]
    if B % mesh.n_data:
        raise ValueError(f"a batch of {B} rows does not split over {mesh.n_data} data ranks")
    b = B // mesh.n_data
    row0 = mesh.data_rank * b
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v) and v.dim() >= 1 and k not in GLOBAL_KEYS:
            v = v[row0:row0 + b].to(device, non_blocking=True)
        out[k] = v
    out["n_valid"] = B if batch.get("n_valid") is None else int(batch["n_valid"])
    out["row0"] = row0
    return out
