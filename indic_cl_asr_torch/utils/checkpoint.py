"""Weight saves and the task-sequence checkpoint (PyTorch).

Port of indic_cl_asr_tpu/utils/checkpoint.py:

  * ``save_partial``: the trainable parameters only, as an ``.npz`` of
    {port parameter name: array} (the reference's ``model_<lang>.pth``
    partial state dicts, utils.py:265-271);
  * ``load_partial``: the non-strict restore of a partial ``.npz``
    (cl_baseline_lwf.py:223), the port's own or the JAX package's
    ``model_<lang>.npz`` in either encoder layout;
  * ``save_model`` / ``load_model``: the whole model for
    ``init_checkpoint``, the port's counterpart of the JAX package's orbax
    tree of the variables;
  * ``SequenceCheckpointer``: per completed task, the model's state dict
    (parameters and BatchNorm statistics), the optimizer's ``mu``/``nu``/
    ``count`` and the CL method's state, with ``torch.save``, plus a
    ``sequence.json`` manifest of the completed tasks and the val WER
    records, so a crashed language sequence resumes where it stopped.

Every file holds the whole model. Over a model split by
parallel/sharding.py:shard_model the writers gather the parameters,
statistics and AdamW moments over the model ranks (every rank calls them;
the main process writes), and the readers load each rank's shard, so a
file written by a split run loads into one process and the reverse.

Orbax trees and ``.nemo`` files are not read.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..models.convert import named_state_dict
from ..parallel.distributed import barrier, is_main_process
from ..parallel.sharding import gather_named, gather_state, local_moments, local_named


def save_partial(path: str, model: torch.nn.Module, names) -> None:
    """Save the parameters named in ``names`` (the trainable ones) as f32
    numpy arrays under their names, whole; every process calls it, the
    main process writes."""
    keep = set(names)
    arrays = gather_named(model, {n: p for n, p in model.named_parameters() if n in keep})
    if is_main_process():
        np.savez(path, **{n: t.float().cpu().numpy() for n, t in arrays.items()})


@torch.no_grad()
def load_partial(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Non-strict restore of an ``.npz`` of named arrays into ``model`` in
    place: the port's ``save_partial`` files (port state-dict names), or
    the JAX package's named leaves ('/'-joined paths: its
    ``model_<lang>.npz`` partial saves, or a whole tree with ``params/``
    and ``batch_stats/`` prefixes), in either encoder layout
    (``encoder/layers_<i>/...`` or the ``[L, ...]`` rows of
    ``encoder/stack/layers/...``), mapped through models/convert.py.
    Entries and layers the file lacks keep the model's values; a name that
    matches nothing in the model raises."""
    with np.load(path) as data:
        named = {k: data[k] for k in data.files}
    n_jax = sum("/" in k for k in named)
    if n_jax not in (0, len(named)):
        raise ValueError(f"{path} mixes JAX paths and port names")
    sd = local_named(model, {k: torch.from_numpy(np.asarray(v, dtype=np.float32))
                             for k, v in (named_state_dict(named) if n_jax else named).items()})
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"{path}: no such entry in the model: {unknown}")
    for name, arr in sd.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: {tuple(arr.shape)} != {tuple(own[name].shape)}")
        own[name].copy_(arr)
    return model


def save_model(path: str, model: torch.nn.Module) -> None:
    """The whole model (parameters and BatchNorm statistics) as a ``.pt``,
    in the layout ``SequenceCheckpointer.save_task`` writes its
    ``"model"`` entry; every process calls it, the main process writes."""
    state = gather_state(model)["model"]
    if is_main_process():
        torch.save({"model": {k: v.cpu() for k, v in state.items()}}, path)


@torch.no_grad()
def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """``init_checkpoint``: load a ``save_model`` file or a task checkpoint
    (``sequence/task_<i>_<lang>.pt``) strictly, or an ``.npz`` of named
    arrays through ``load_partial``. An orbax tree (a directory) is not
    read: save the JAX variables' named leaves as an ``.npz`` instead."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax tree?): the port reads a "
                         ".pt written by save_model or an .npz of named arrays")
    if path.endswith(".npz"):
        return load_partial(path, model)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(local_named(model, state["model"]))
    return model


class SequenceCheckpointer:
    """Per-task full training state + a manifest recording progress."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._manifest_path = os.path.join(self.root, "sequence.json")

    def manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {"completed_tasks": [], "val_performance": {}}

    def _path(self, task_idx: int, lang: str, suffix: str = "") -> str:
        return os.path.join(self.root, f"task_{task_idx}_{lang}{suffix}.pt")

    def save_task(self, task_idx: int, lang: str, model: torch.nn.Module, optimizer,
                  val_performance: dict, method_state: Any | None = None) -> None:
        """Checkpoint the model (parameters and BatchNorm statistics), the
        AdamW state and the CL method's state (whole: ``method_state`` as
        the method exports it), then record the task. Under a process group
        every process gathers the state (the same on every data rank), the
        main process writes, and every process waits for it at a
        barrier."""
        state = gather_state(model, optimizer)
        if is_main_process():
            self._write_task(task_idx, lang, state, optimizer, val_performance, method_state)
        barrier("save task")

    def _write_task(self, task_idx, lang, state, optimizer, val_performance, method_state):
        torch.save({
            "model": {k: v.cpu() for k, v in state["model"].items()},
            "optimizer": {
                "names": list(optimizer.names),
                "mu": [m.cpu() for m in state["mu"]],
                "nu": [n.cpu() for n in state["nu"]],
                "count": int(optimizer.count),
            },
        }, self._path(task_idx, lang))
        if method_state is not None:
            torch.save(method_state, self._path(task_idx, lang, "_method"))
        m = self.manifest()
        if lang not in m["completed_tasks"]:
            m["completed_tasks"].append(lang)
        m["val_performance"] = val_performance
        with open(self._manifest_path, "w") as f:
            json.dump(m, f)

    def load_task(self, task_idx: int, lang: str, model: torch.nn.Module, optimizer) -> None:
        """Restore ``save_task``'s state into ``model`` and ``optimizer`` in
        place (the same parameter names and trainable set; each rank of a
        split model takes its shards)."""
        state = torch.load(self._path(task_idx, lang), map_location="cpu", weights_only=True)
        opt = state["optimizer"]
        if list(opt["names"]) != list(optimizer.names):
            raise ValueError("checkpoint's trainable parameters differ from the optimizer's")
        model.load_state_dict(local_named(model, state["model"]))
        with torch.no_grad():
            for dst, src in zip(optimizer.mu, local_moments(optimizer, opt["mu"])):
                dst.copy_(src)
            for dst, src in zip(optimizer.nu, local_moments(optimizer, opt["nu"])):
                dst.copy_(src)
        optimizer.count = int(opt["count"])

    def load_method_state(self, task_idx: int, lang: str, device=None) -> Any | None:
        path = self._path(task_idx, lang, "_method")
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=device or "cpu", weights_only=True)

    def latest_task(self) -> tuple[int, str] | None:
        m = self.manifest()
        if not m["completed_tasks"]:
            return None
        return len(m["completed_tasks"]) - 1, m["completed_tasks"][-1]
