"""CTC loss with the reference's conventions (PyTorch).

Port of indic_cl_asr_tpu/ops/ctc_loss.py with ``impl="native"``: blank is
the LAST column, the inputs get an f32 log-softmax first, infeasible rows
(fewer frames than labels plus adjacent repeats, each of which needs a
separating blank) contribute 0 (torch's ``zero_infinity``, tested
explicitly as the JAX package does), and the reductions are
ops/rnnt_loss.py's, with ``row_mask`` for the repeat rows that pad a
bucket's last batch.

The JAX package runs this lattice as a ``lax.scan``, not in a TPU kernel,
so the port uses ``torch.nn.functional.ctc_loss``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .rnnt_loss import _reduce


def ctc_loss(
    log_probs: torch.Tensor,   # [B, T, V+1] log-probs (or logits), blank LAST
    frame_lens: torch.Tensor,  # [B]
    labels: torch.Tensor,      # [B, U] local token ids (no blanks)
    label_lens: torch.Tensor,  # [B]
    blank: int | None = None,
    reduction: str = "mean_batch",
    row_mask: torch.Tensor | None = None,  # bool [B]: real (non-repeat) rows
):
    B, T, V1 = log_probs.shape
    if blank is None:
        blank = V1 - 1
    dev = log_probs.device
    frame_lens = frame_lens.to(dev, torch.int64)
    label_lens = label_lens.to(dev, torch.int64)
    labels = labels.to(dev, torch.int64)
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    nll = F.ctc_loss(
        lp.transpose(0, 1), labels, frame_lens, label_lens, blank=blank,
        reduction="none", zero_infinity=True,
    )
    u_iota = torch.arange(labels.shape[1], device=dev)[None, :]
    valid_lbl = (u_iota < label_lens[:, None])[:, 1:]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid_lbl).sum(dim=1)
    feasible = frame_lens >= label_lens + repeats
    nll = torch.where(feasible & torch.isfinite(nll), nll, 0.0)
    return _reduce(nll, label_lens, reduction, row_mask)
