"""Elastic Weight Consolidation over named parameters (PyTorch).

Port of indic_cl_asr_tpu/cl/ewc.py (reference cl_baseline_ewc.py):

  * while training task t > 0 the quadratic penalty enters as GRADIENTS
    added to the task gradients before the optimizer step (:228-231):
        g_penalty = 2 * e_lambda * F * (theta - theta*)        (:69-81)
  * after each task's training epochs, one extra pass over the data
    accumulates the Fisher diagonal (:245-269):
        fish += loss_value * grad(task_loss)^2    per batch
        fish /= total_utterances
    and merges it with decay into the running Fisher (:272-280):
        main_fish = e_gamma * main_fish + fish
  * theta* (checkpoint) is the post-task parameter clone (:282).

Every dict is keyed by the trainable parameters' names; frozen parameters
carry no Fisher, which equals the JAX package's masked zeros. Over a model
split by parallel/sharding.py each entry is the parameter's shard: the
penalty gradients are elementwise, and the monitor's mean over a split
tensor sums its shards over the model ranks and divides by the whole
tensor's size.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.sharding import model_total, split_of, whole_numel


@dataclasses.dataclass
class EWCConfig:
    e_lambda: float = 10.0
    e_gamma: float = 1.0


@dataclasses.dataclass
class EWCState:
    """main_fish/checkpoint: {name: tensor} (None before the first task)."""

    main_fish: dict | None = None
    checkpoint: dict | None = None


@torch.no_grad()
def penalty_grads(cfg: EWCConfig, main_fish: dict, params: dict, checkpoint: dict):
    """(grads by name, mean |penalty grad| monitor) — cl_baseline_ewc.py:69-81."""
    grads = {n: 2.0 * cfg.e_lambda * f * (params[n] - checkpoint[n])
             for n, f in main_fish.items()}
    ps = [params[n] for n in grads]
    monitor = model_total([g.abs().mean() if split_of(p) is None else g.abs().sum() / whole_numel(p)
                           for g, p in zip(grads.values(), ps)], ps) / max(len(grads), 1)
    return grads, monitor


@torch.no_grad()
def accumulate_fisher(fish: dict, grads: dict, loss_value) -> dict:
    """fish += loss * grad^2 (one batch) — cl_baseline_ewc.py:245-260;
    normalisation happens in finalize_fisher."""
    return {n: f + loss_value * grads[n] * grads[n] for n, f in fish.items()}


@torch.no_grad()
def finalize_fisher(fish: dict, total_utterances: int) -> dict:
    return {n: f / total_utterances for n, f in fish.items()}


@torch.no_grad()
def merge_fisher(cfg: EWCConfig, main_fish: dict | None, fish: dict) -> dict:
    if main_fish is None:
        return fish
    return {n: cfg.e_gamma * m + fish[n] for n, m in main_fish.items()}


@torch.no_grad()
def end_task(cfg: EWCConfig, state: EWCState, fish: dict, total_utterances: int,
             params: dict) -> EWCState:
    """Finalize a task: normalize + merge the Fisher, snapshot theta* of the
    trainable ``params`` ({name: parameter})."""
    fish = finalize_fisher(fish, total_utterances)
    return EWCState(
        main_fish=merge_fisher(cfg, state.main_fish, fish),
        checkpoint={n: p.detach().clone() for n, p in params.items()},
    )


def make_penalty_fn(cfg: EWCConfig, state: EWCState):
    """For train/step.py's penalty hook: (0 scalar, penalty grads) — EWC's
    penalty enters as gradients, not as a loss term."""
    if state.main_fish is None or state.checkpoint is None:
        return None

    def penalty_fn(params):
        grads, _ = penalty_grads(cfg, state.main_fish, params, state.checkpoint)
        return torch.zeros((), device=next(iter(grads.values())).device), grads

    return penalty_fn
