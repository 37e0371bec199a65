"""Partial weight saves and the task-sequence checkpoint (PyTorch).

Port of the same-layout part of indic_cl_asr_tpu/utils/checkpoint.py:

  * ``save_partial``: the trainable parameters only, as an ``.npz`` of
    {port parameter name: array} (the reference's ``model_<lang>.pth``
    partial state dicts, utils.py:265-271);
  * ``SequenceCheckpointer``: per completed task, the model's state dict
    (parameters and BatchNorm statistics), the optimizer's ``mu``/``nu``/
    ``count`` and the CL method's state, with ``torch.save``, plus a
    ``sequence.json`` manifest of the completed tasks and the val WER
    records, so a crashed language sequence resumes where it stopped.

Cross-layout conversion, ``load_partial``, orbax trees and ``.nemo``
files are not ported here.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def save_partial(path: str, model: torch.nn.Module, names) -> None:
    """Save the parameters named in ``names`` (the trainable ones) as f32
    numpy arrays under their names."""
    keep = set(names)
    arrays = {n: p.detach().float().cpu().numpy() for n, p in model.named_parameters()
              if n in keep}
    np.savez(path, **arrays)


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
        AdamW state and the CL method's state, then record the task."""
        torch.save({
            "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": {
                "names": list(optimizer.names),
                "mu": [m.detach().cpu() for m in optimizer.mu],
                "nu": [n.detach().cpu() for n in optimizer.nu],
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
        place (the same parameter layout and trainable set)."""
        state = torch.load(self._path(task_idx, lang), map_location="cpu", weights_only=True)
        opt = state["optimizer"]
        if list(opt["names"]) != list(optimizer.names):
            raise ValueError("checkpoint's trainable parameters differ from the optimizer's")
        model.load_state_dict(state["model"])
        with torch.no_grad():
            for dst, src in zip(optimizer.mu, opt["mu"]):
                dst.copy_(src)
            for dst, src in zip(optimizer.nu, opt["nu"]):
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
