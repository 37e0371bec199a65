"""The data axis of the DP x TP mesh (PyTorch).

Port of the data half of indic_cl_asr_tpu/parallel/sharding.py (reference
DDP + NCCL + SyncBatchNorm + DistributedSampler, cl_baseline.py:33-48,
133-134; SURVEY.md §2.3, §5.8). One process drives one device; the mesh
is the process group's ranks laid out as "data" x "model".

Under the JAX package's GSPMD the collectives are implicit. Here they
are explicit, and each rank calls them in the same order:

  * every rank assembles the identical global batch and keeps the rows
    it owns (``place_batch``): the leading axis is split over "data";
    the scalars (``n_valid``) and the host lengths SpecAugment draws from
    stay global, and ``row0`` marks this rank's first global row;
  * every mean over the batch sums this rank's valid rows and divides by
    the global count, so the sum over the ranks is the global mean;
  * BatchNorm statistics are all-reduced sums over the data ranks
    (``all_reduce_sum``, differentiable), the global batch's;
  * the step's gradients and logged losses go through one flat
    all-reduce (``reduce_sum``).

The model axis (tensor parallelism) is not ported: ``make_mesh`` raises
for ``n_model > 1`` (ROADMAP §1).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch
import torch.distributed as dist

from .distributed import initialized, process_count, process_index

# all-reduces issued, their bytes and the host seconds spent issuing them
# (the enqueue: no call waits for the device), since the last reset (the
# data axis's cost a step: read around a step, reset by the caller)
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """"data" x "model" over the process group's ranks; ``data_rank`` is
    this process's place on the data axis. ``group`` is the data axis's
    process group, None when no group is initialised (one process: the
    collectives are the identity)."""

    n_data: int
    n_model: int
    data_rank: int
    group: object | None


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). ``n_data=None`` means world size / ``n_model``. Raises
    ``ValueError`` when the mesh does not cover the ranks exactly (a
    process is one device) and ``NotImplementedError`` for a model axis."""
    if n_model > 1:
        raise NotImplementedError(
            f"a model axis of {n_model}: tensor-parallel training is not ported "
            "(ROADMAP §1, the model axis of parallel/sharding.py)")
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
    return Mesh(n_data, n_model, process_index(),
                dist.group.WORLD if initialized() else None)


def _all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place sum of ``t`` over the data ranks."""
    t0 = time.perf_counter()
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    COUNTS["all_reduce_host_s"] += time.perf_counter() - t0
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the cotangent of each rank's x is Σ_ranks dy, since
    every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Σ of ``x`` over the data ranks, differentiable (the identity
    without a mesh)."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def reduce_sum(mesh: Mesh, tensors, like) -> list[torch.Tensor]:
    """Sum each of ``tensors`` over the data ranks in ONE all-reduce of a
    flat f32 buffer; a None (an unused gradient) enters as zeros shaped
    as its ``like`` entry, so every rank's buffer has the same layout."""
    parts = [torch.zeros_like(l) if t is None else t for t, l in zip(tensors, like)]
    flat = torch.cat([p.detach().reshape(-1).float() for p in parts])
    _all_reduce_(flat, mesh)
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].view(p.shape).to(p.dtype))
        i += p.numel()
    return out


# batch keys whose leading axis is NOT split: the global batch's host
# lengths (the SpecAugment bands are drawn for every row of it)
GLOBAL_KEYS = ("audio_len_host",)


def place_batch(batch: dict, mesh: Mesh, device) -> dict:
    """This rank's rows of a global batch dict (train/step.py's
    ``batch_to_device_dict`` layout) on ``device``: every tensor's leading
    axis split over "data", the scalars and ``GLOBAL_KEYS`` kept whole,
    ``n_valid`` (the global count of real rows; B when absent) and
    ``row0``, the first global row this rank holds. Raises ``ValueError``
    when B is not divisible by the data axis."""
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
