"""CTC loss with the reference's conventions (PyTorch).

Port of indic_cl_asr_tpu/ops/ctc_loss.py: blank is the LAST column,
infeasible rows (fewer frames than labels plus adjacent repeats, each of
which needs a separating blank) contribute 0 (torch's ``zero_infinity``,
tested explicitly as the JAX package does), and the reductions are
ops/rnnt_loss.py's, with ``row_mask`` for the repeat rows that pad a
bucket's last batch. Two lattices, as in the JAX package:

  * ``impl="native"``: an f32 log-softmax of the inputs, then
    ``torch.nn.functional.ctc_loss`` (the JAX package's own scan);
  * ``impl="optax"``: ``optax.ctc_loss``'s forward recursion
    (``_optax_ctc_nll``), logits and frame/label paddings in, the
    log-softmax inside, log(0) as -1e5, differentiated by autograd.

The JAX package runs both lattices as ``lax.scan``s, not in a TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .rnnt_loss import _reduce

IMPLS = ("native", "optax")
_LOG_EPSILON = -1e5  # optax's log(0)


def _optax_ctc_nll(logits, logit_paddings, labels, label_paddings, blank_id):
    """Per-row NLL [B] of optax.ctc_loss_with_forward_probs, step for step:
    separate blank (phi) and label (emit) forward probabilities over the
    N labels, padded frames carrying the state through."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = F.pad(repeat, (0, 1))  # [B, N]
    lp_phi = logprobs[:, :, blank_id]  # [B, T]
    lp_emit = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(B, T, N))
    phi = torch.full((B, N + 1), _LOG_EPSILON, dtype=logits.dtype, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), _LOG_EPSILON, dtype=logits.dtype, device=logits.device)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)

    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + _LOG_EPSILON * repeat)
        e, p = lp_emit[:, t], lp_phi[:, t, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = update_phi(prev_phi + p, emit + p + _LOG_EPSILON * (1.0 - repeat))
        pad = logit_paddings[:, t, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def ctc_loss(
    log_probs: torch.Tensor,   # [B, T, V+1] log-probs (or logits), blank LAST
    frame_lens: torch.Tensor,  # [B]
    labels: torch.Tensor,      # [B, U] local token ids (no blanks)
    label_lens: torch.Tensor,  # [B]
    blank: int | None = None,
    reduction: str = "mean_batch",
    impl: str = "native",
    row_mask: torch.Tensor | None = None,  # bool [B]: real (non-repeat) rows
    n_rows: int | None = None,  # real rows of the global batch (ops/rnnt_loss.py:_reduce)
):
    B, T, V1 = log_probs.shape
    if blank is None:
        blank = V1 - 1
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: one of {IMPLS}")
    dev = log_probs.device
    frame_lens = frame_lens.to(dev, torch.int64)
    label_lens = label_lens.to(dev, torch.int64)
    labels = labels.to(dev, torch.int64)
    if impl == "native":
        lp = torch.log_softmax(log_probs.float(), dim=-1)
        nll = F.ctc_loss(
            lp.transpose(0, 1), labels, frame_lens, label_lens, blank=blank,
            reduction="none", zero_infinity=True,
        )
    else:
        t_iota = torch.arange(T, device=dev)[None, :]
        u_pos = torch.arange(labels.shape[1], device=dev)[None, :]
        nll = _optax_ctc_nll(
            log_probs.float(), (t_iota >= frame_lens[:, None]).float(), labels,
            (u_pos >= label_lens[:, None]).float(), blank,
        )
    u_iota = torch.arange(labels.shape[1], device=dev)[None, :]
    valid_lbl = (u_iota < label_lens[:, None])[:, 1:]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid_lbl).sum(dim=1)
    feasible = frame_lens >= label_lens + repeats
    nll = torch.where(feasible & torch.isfinite(nll), nll, 0.0)
    return _reduce(nll, label_lens, reduction, row_mask, n_rows)
