"""Multiblank and TDT (Token-and-Duration) transducer losses.

Port of indic_cl_asr_tpu/ops/rnnt_variants.py, the reference's multiblank
and TDT lattices (NeMo gpu_rnnt_kernel.py:411-660 and :889-1218) as
anti-diagonal wavefronts:

  * both losses generalize the standard RNNT lattice with longer time
    transitions (big blanks of duration d; TDT emissions that advance time
    by a predicted duration), so diagonal n depends on diagonals n-1 ..
    n-Dmax and the loop keeps the last Dmax alpha diagonals;
  * the duration-shifted log-prob inputs are laid out diagonal-major and
    delayed up front (``_rolled``), so each diagonal's step is elementwise
    work and a logsumexp over [B, U+1] rows;
  * gradients come from autograd through the diagonal loop, as the JAX
    package differentiates through its ``lax.scan``.

Both take the papers' logit under-normalization ``sigma``: each emission
contributes ``logp - sigma``. The JAX package has no Pallas kernel for
these losses, so this plain PyTorch version runs on either device; it
shares the standard loss's diagonal layout and reductions
(ops/rnnt_loss.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .rnnt_loss import NEG_INF, _from_diagonals, _reduce, _to_diagonals


def _shift_right_row(x: torch.Tensor) -> torch.Tensor:
    """[.., U1] -> the same with entries moved one label up (u-1 -> u)."""
    return F.pad(x[..., :-1], (1, 0), value=NEG_INF)


def _diag_major(x: torch.Tensor) -> torch.Tensor:
    """[B, T, U1] -> [D, B, U1] anti-diagonal-major."""
    return _to_diagonals(x, NEG_INF).transpose(0, 1)


def _rolled(xd: torch.Tensor, d: int) -> torch.Tensor:
    """Diagonal-major [D, ...] delayed by d: out[n] = xd[n - d]."""
    if d == 0:
        return xd
    return torch.cat([torch.full_like(xd[:d], NEG_INF), xd[:-d]], dim=0)


def _mask_time_labels(lp_list, lp_label, t_lens, u_lens):
    """NEG_INF out transitions from invalid frames / label rows."""
    B, T, U1 = lp_label.shape
    dev = lp_label.device
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    t_valid = t_idx < t_lens.to(dev)[:, None, None]
    lab_valid = t_valid & (u_idx < u_lens.to(dev)[:, None, None])
    out = [torch.where(t_valid, lp, NEG_INF) for lp in lp_list]
    return out, torch.where(lab_valid, lp_label, NEG_INF)


def _alpha_multiscan(blank_srcs, label_srcs, B, T, U1):
    """Shared wavefront: alpha over a lattice whose diagonal-n cell gets
    blank contributions (delay d) and label contributions (delay d, from
    row u-1 of diagonal n-d-1):

      blank_srcs [(d, lp_diag [D, B, U1])]: alpha(t, u) += alpha(t-d, u) + lp(t-d, u)
      label_srcs [(d, lp_diag)]:            alpha(t, u) += alpha(t-d, u-1) + lp(t-d, u-1)

    Returns alpha [B, T, U1]."""
    D = T + U1 - 1
    ref = blank_srcs[0][1]
    d_max = max([d for d, _ in blank_srcs] + [d + 1 for d, _ in label_srcs])
    # xs[n] holds, per source, the lp at that source's cell for every row
    # of diagonal n (rolled, so the loop never indexes back)
    xs_blank = torch.stack([_rolled(lp, d)[1:] for d, lp in blank_srcs])    # [nb, D-1, B, U1]
    xs_label = torch.stack([_rolled(lp, d + 1)[1:] for d, lp in label_srcs])  # [nl, D-1, B, U1]
    blank_delays = [d - 1 for d, _ in blank_srcs]
    label_delays = [d for d, _ in label_srcs]

    u_iota = torch.arange(U1, device=ref.device)
    alpha0 = torch.where(u_iota == 0, 0.0, NEG_INF).to(ref.dtype).expand(B, U1)
    # hist[j] is the alpha diagonal n-1-j
    hist = [alpha0] + [torch.full((B, U1), NEG_INF, dtype=ref.dtype, device=ref.device)
                       for _ in range(d_max - 1)]
    diags = [alpha0]
    for n in range(D - 1):
        blanks = torch.stack([hist[j] for j in blank_delays]) + xs_blank[:, n]
        labels = _shift_right_row(torch.stack([hist[j] for j in label_delays])
                                  + xs_label[:, n])
        alpha_n = torch.logsumexp(torch.cat([blanks, labels], dim=0), dim=0)
        hist = [alpha_n] + hist[:-1]
        diags.append(alpha_n)
    return _from_diagonals(torch.stack(diags, dim=1), T)


def _gather_tu(x: torch.Tensor, t_idx: torch.Tensor, u_idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, U1], per-row (t, u) -> [B] (t clipped into range)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, t_idx.clamp(0, x.shape[1] - 1).long(), u_idx.long()]


def _labels_logprob(log_probs, labels):
    """[B, T, U1, V1] -> log p(y_{u+1} | t, u) [B, T, U1] (column U: label 0)."""
    B = labels.shape[0]
    labels_pad = torch.cat([labels, torch.zeros((B, 1), dtype=labels.dtype,
                                                device=labels.device)], dim=1)
    idx = labels_pad.long().to(log_probs.device)[:, None, :, None]
    return torch.gather(log_probs, 3, idx.expand(*log_probs.shape[:3], 1))[..., 0]


def _exit_terms(alpha, srcs, frame_lens, label_lens):
    """log-probs of leaving the lattice with a final blank of duration d
    from frame t_len - d, for each (d, lp) of ``srcs``."""
    terms = []
    for d, lp in srcs:
        t_src = frame_lens.to(alpha.device) - d
        term = _gather_tu(alpha + lp, t_src, label_lens.to(alpha.device))
        terms.append(torch.where(t_src >= 0, term, NEG_INF))
    return torch.logsumexp(torch.stack(terms), dim=0)


def multiblank_rnnt_loss(
    log_probs: torch.Tensor,   # [B, T, U+1, V+1] log-softmaxed joint acts
    labels: torch.Tensor,      # [B, U]
    frame_lens: torch.Tensor,
    label_lens: torch.Tensor,
    *,
    blank: int,
    big_blank_durations: tuple[int, ...],
    sigma: float = 0.0,
    reduction: str = "mean_batch",
):
    """Multi-blank transducer NLL (arXiv:2211.03541; reference
    gpu_rnnt_kernel.py:411-520). Big blank i (duration
    ``big_blank_durations[i]`` > 1) lives at vocabulary index
    ``blank - 1 - i`` and advances time by its duration; the standard
    blank (index ``blank``) advances by 1."""
    B, T, U1, _ = log_probs.shape
    lp_blank = log_probs[..., blank] - sigma
    lp_big = [log_probs[..., blank - 1 - i] - sigma for i in range(len(big_blank_durations))]
    lp_label = _labels_logprob(log_probs, labels) - sigma
    (lp_blank, *lp_big), lp_label = _mask_time_labels(
        [lp_blank] + lp_big, lp_label, frame_lens, label_lens)

    blank_srcs = [(1, lp_blank)] + list(zip(big_blank_durations, lp_big))
    alpha = _alpha_multiscan([(d, _diag_major(lp)) for d, lp in blank_srcs],
                             [(0, _diag_major(lp_label))], B, T, U1)
    # exit: the last frame(s) emit a final (big) blank
    ll = _exit_terms(alpha, blank_srcs, frame_lens, label_lens)
    return _reduce(-ll, label_lens, reduction, None)


def tdt_loss(
    log_probs: torch.Tensor,           # [B, T, U+1, V+1] token log-probs
    duration_log_probs: torch.Tensor,  # [B, T, U+1, ND] duration log-probs
    labels: torch.Tensor,              # [B, U]
    frame_lens: torch.Tensor,
    label_lens: torch.Tensor,
    *,
    blank: int,
    durations: tuple[int, ...],        # ascending, e.g. (0, 1, 2, 3, 4)
    sigma: float = 0.0,
    reduction: str = "mean_batch",
):
    """Token-and-Duration Transducer NLL (arXiv:2304.06795; reference
    gpu_rnnt_kernel.py:889-1065). An emission at (t, u) jointly predicts a
    token (blank keeps u, a label advances it) and a duration d in
    ``durations`` that advances t by d; blanks need d >= 1."""
    B, T, U1, _ = log_probs.shape
    lp_blank = log_probs[..., blank] - sigma
    lp_label = _labels_logprob(log_probs, labels) - sigma
    blank_ds = [d for d in durations if d >= 1]
    blank_list = [lp_blank + duration_log_probs[..., i]
                  for i, d in enumerate(durations) if d >= 1]
    label_list = [lp_label + duration_log_probs[..., i] for i in range(len(durations))]
    masked, _ = _mask_time_labels(blank_list + label_list, lp_label, frame_lens, label_lens)
    blank_list, label_list = masked[:len(blank_list)], masked[len(blank_list):]
    # label transitions also need u < u_len
    u_idx = torch.arange(U1, device=log_probs.device)[None, None, :]
    lab_ok = u_idx < label_lens.to(log_probs.device)[:, None, None]
    label_list = [torch.where(lab_ok, lp, NEG_INF) for lp in label_list]

    blank_srcs = list(zip(blank_ds, blank_list))
    alpha = _alpha_multiscan([(d, _diag_major(lp)) for d, lp in blank_srcs],
                             [(d, _diag_major(lp)) for d, lp in zip(durations, label_list)],
                             B, T, U1)
    # exit: a final blank emission of duration d from frame t_len - d
    ll = _exit_terms(alpha, blank_srcs, frame_lens, label_lens)
    return _reduce(-ll, label_lens, reduction, None)
