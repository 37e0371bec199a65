"""Memory Aware Synapses over named parameters (PyTorch).

Port of indic_cl_asr_tpu/cl/mas.py (reference cl_baseline_mas.py):

  * while training task t > 0 the penalty is a LOSS term (:231-234,
    :70-75): loss += mas_lambda * sum_k Omega_k * (theta_k - theta*_k)^2
  * after the task's training epochs, one extra pass accumulates
    importance from the surrogate "output energy" (:257-287):
        surrogate = (1 - mas_ctx) * mean_{B,T,U} ||joint_logits||^2
                  + mas_ctx * mean_{B,T} ||ctc_logits||^2
        Omega_k += |grad_k(surrogate)|   per batch;  Omega /= n_batches
    and OVERWRITES the stored importance; theta* is the post-task clone.

Over a model split by parallel/sharding.py Omega and theta* hold the
parameters' shards: the penalty's terms of split parameters are summed
over the model ranks (identity backward), the whole ones counted once.

The joint energy is computed chunked over T with ``torch.utils.checkpoint``
per chunk, so the B x T x U x V joint is never held whole. Its products
are plain ``torch.matmul`` (the JAX package computes them outside any
Pallas kernel): the head cast to the compute dtype, f32 sums.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.common import activate
from ..parallel.sharding import model_total
from ..ops.rnnt_loss import row_count


@dataclasses.dataclass
class MASConfig:
    mas_lambda: float = 1.0
    mas_ctx: float = 0.3


@dataclasses.dataclass
class MASState:
    importance: dict | None = None  # Omega by name
    checkpoint: dict | None = None  # theta* by name


def penalty(cfg: MASConfig, importance: dict, params: dict, checkpoint_: dict):
    """Scalar penalty loss (cl_baseline_mas.py:70-75), scaled by mas_lambda."""
    terms = [torch.sum(o * (params[n] - checkpoint_[n]) ** 2) for n, o in importance.items()]
    return cfg.mas_lambda * model_total(terms, [params[n] for n in importance])


def make_penalty_fn(cfg: MASConfig, state: MASState):
    """Hook for train/step.py: MAS is a loss term (grads via autograd)."""
    if state.importance is None or state.checkpoint is None:
        return None

    def penalty_fn(params):
        return penalty(cfg, state.importance, params, state.checkpoint), None

    return penalty_fn


def joint_logits(f_chunk, g_proj, head_w, head_b, activation: str, uniform_head: bool):
    """[B, Tc, H] x [B, U1, H] -> f32 joint logits [B, Tc, U1, V1]: the
    head cast to the compute dtype, exact products, f32 sums."""
    inp = activate(f_chunk[:, :, None, :] + g_proj[:, None, :, :], activation)
    B, Tc, U1, H = inp.shape
    x = inp.float().reshape(B, Tc * U1, H)
    if uniform_head:
        z = torch.matmul(x, head_w[0].to(inp.dtype).float()) + head_b[0]
    else:
        z = torch.matmul(x, head_w.to(inp.dtype).float()) + head_b[:, None, :]
    return z.view(B, Tc, U1, -1)


def _valid_frames(z, ci, chunk_size, T, row_mask):
    """[B, Tc] per-frame values with chunk-padding frames and repeat rows zeroed."""
    t_abs = ci * chunk_size + torch.arange(chunk_size, device=z.device)
    z = torch.where((t_abs < T)[None, :], z, 0.0)
    if row_mask is not None:
        z = torch.where(row_mask[:, None], z, 0.0)
    return z


def joint_energy_chunked(f_proj, g_proj, head_w, head_b, *, activation: str = "relu",
                         chunk_size: int = 64, row_mask=None, uniform_head: bool = False,
                         n_rows=None):
    """mean over (B, T, U) of sum_v joint_logits^2, chunked over T — the
    reference's rnn_logits surrogate (cl_baseline_mas.py:264-268). Frames
    added by chunk padding and the repeat rows of a final bucket batch
    (``row_mask``) are masked out; the in-bucket T/U padding stays in,
    like the reference's mean over its pad-to-max tensors. The divisor
    is rows·T·U1, the rows ``ops/rnnt_loss.py:row_count(row_mask,
    n_rows, B)``."""
    B, T, H = f_proj.shape
    n_chunks = -(-T // chunk_size)
    T_pad = n_chunks * chunk_size
    if T_pad != T:
        f_proj = F.pad(f_proj, (0, 0, 0, T_pad - T))

    def chunk_energy(f_chunk, g, w, b, ci):
        z = joint_logits(f_chunk, g, w, b, activation, uniform_head)
        sq = (z ** 2).sum(dim=(2, 3))
        return _valid_frames(sq, ci, chunk_size, T, row_mask).sum()

    total = 0.0
    for ci in range(n_chunks):
        f_chunk = f_proj[:, ci * chunk_size:(ci + 1) * chunk_size]
        total = total + checkpoint(chunk_energy, f_chunk, g_proj, head_w, head_b, ci,
                                   use_reentrant=False)
    return total / (row_count(row_mask, n_rows, B) * T * g_proj.shape[1])


def mas_surrogate(cfg: MASConfig, f_proj, g_proj, head_w, head_b, ctc_logits, *,
                  activation: str = "relu", chunk_size: int = 64, row_mask=None,
                  uniform_head: bool = False, n_rows=None):
    """(1-ctx) * joint energy + ctx * ctc energy (cl_baseline_mas.py:258-264);
    ``n_rows`` as in ``joint_energy_chunked``."""
    rnnt_energy = joint_energy_chunked(
        f_proj, g_proj, head_w, head_b, activation=activation, chunk_size=chunk_size,
        row_mask=row_mask, uniform_head=uniform_head, n_rows=n_rows)
    ctc_sq = (ctc_logits.float() ** 2).sum(-1)  # [B, T]
    if row_mask is not None:
        ctc_sq = torch.where(row_mask[:, None], ctc_sq, 0.0)
    B, T = ctc_sq.shape
    ctc_energy = ctc_sq.sum() / (row_count(row_mask, n_rows, B) * T)
    return (1.0 - cfg.mas_ctx) * rnnt_energy + cfg.mas_ctx * ctc_energy


@torch.no_grad()
def accumulate_importance(importance: dict, surrogate_grads: dict) -> dict:
    """Omega += |grad| per batch (cl_baseline_mas.py:272-276)."""
    return {n: o + surrogate_grads[n].abs() for n, o in importance.items()}


@torch.no_grad()
def end_task(state: MASState, importance: dict, n_batches: int, params: dict) -> MASState:
    """Normalize and OVERWRITE the importance (not merged — :287), snapshot
    theta* of the trainable ``params``."""
    return MASState(
        importance={n: o / n_batches for n, o in importance.items()},
        checkpoint={n: p.detach().clone() for n, p in params.items()},
    )
