"""Process-group bring-up and synchronisation (PyTorch).

Port of indic_cl_asr_tpu/parallel/distributed.py (reference
cl_baseline.py:33-48 ``setup_distributed``: NCCL init; the torchrun
rendezvous of sbatch.sh:50-59; ``dist.barrier()`` at
cl_baseline.py:120/142/178). One process drives one device. Without an
initialised process group ``barrier``, ``broadcast_from_main`` and
``all_hosts_agree`` are no-ops, as the JAX ones are at one process.

Each collective here runs on the group's own device kind: NCCL on the
current CUDA device; gloo on the CPU, and on CUDA tensors through the
gloo path where the caller asked for gloo on a card.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# the reference's NCCL timeout (cl_baseline.py:41): an importance epoch
# or an eval of every language may keep one rank away from a collective
TIMEOUT = datetime.timedelta(hours=5)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def setup_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    auto_init: bool = False,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> tuple[int, int]:
    """Initialise the default process group if needed; returns
    (process_index, process_count), (0, 1) without a group.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` rendezvous over ``tcp://``; ``auto_init`` reads
    torchrun's variables (``env://``: MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE). The backend is NCCL for a CUDA ``device`` and gloo for
    the CPU unless ``backend`` names one; a failed init raises. On a CUDA
    device without an index the process pins ``cuda:LOCAL_RANK`` (0 when
    unset) with ``torch.cuda.set_device``. Idempotent: a second call
    returns the live group's (rank, size)."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and not auto_init:
        return 0, 1
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
        if idx >= torch.cuda.device_count():
            raise ValueError(f"cuda:{idx} asked for, {torch.cuda.device_count()} cards visible "
                             "(LOCAL_RANK or the device index)")
        torch.cuda.set_device(idx)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    else:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                   if v not in os.environ]
        if missing:
            raise ValueError(f"auto_init reads torchrun's variables; {missing} not set "
                             "(or give a coordinator address)")
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Every process waits here for the others (``name`` documents the
    call site)."""
    if process_count() > 1:
        dist.barrier()


def _collective_device() -> torch.device:
    """Where the default group's collectives keep their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_main(tree):
    """Process 0's value on every process. A tensor, or a dict, list or
    tuple of tensors (every process holding the same structure, shapes
    and dtypes) goes leaf by leaf through ``dist.broadcast``, each leaf
    in place (staged through the group's device where it lies on another);
    any other object through ``broadcast_object_list``."""
    if process_count() == 1:
        return tree
    leaves = _tensor_leaves(tree)
    dev = _collective_device()
    if leaves is None:
        box = [tree]
        dist.broadcast_object_list(box, src=0, device=dev)
        return box[0]
    for t in leaves:
        staged = t.to(dev)
        dist.broadcast(staged, src=0)
        if staged is not t:
            t.copy_(staged)
    return tree


def _tensor_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        items = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        items = list(tree)
    else:
        return None
    out = []
    for item in items:
        sub = _tensor_leaves(item)
        if sub is None:
            return None
        out += sub
    return out


def all_hosts_agree(value) -> bool:
    """True iff every process passed an equal value (a number, string,
    array or tensor; trivially True at one process)."""
    if process_count() == 1:
        return True
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    got = [None] * process_count()
    dist.all_gather_object(got, value)
    return all(np.array_equal(np.asarray(g), np.asarray(got[0])) for g in got)
