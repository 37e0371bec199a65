"""Greedy CTC and batched frame-synchronous greedy RNNT decoding.

Port of indic_cl_asr_tpu/ops/decoding.py (``ctc_greedy_decode``,
``rnnt_greedy_decode``), itself the reference's GreedyCTCInfer and
GreedyBatchedRNNTInfer (`_greedy_decode_blank_as_pad_loop_frames`): a
per-frame inner symbol loop bounded by ``max_symbols``, a ``max_out``
cap, first-index argmax, emit-masked prediction-net state updates and
blank-padded outputs.

``rnnt_greedy_decode`` is the plain version of the fused decode kernel
(ops/decode_fused.py): a Python loop over frames whose inner loop stops
as soon as every row has emitted blank.
"""

from __future__ import annotations

from typing import Callable

import torch


def ctc_greedy_decode(
    log_probs: torch.Tensor,  # [B, T, V+1], blank LAST
    frame_lens: torch.Tensor,
    blank: int | None = None,
):
    """-> (ids [B, T] padded with blank, lens [B]) after collapse+deblank."""
    B, T, V1 = log_probs.shape
    if blank is None:
        blank = V1 - 1
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)
    t_iota = torch.arange(T, device=ids.device)[None, :]
    valid = t_iota < frame_lens.to(ids.device)[:, None]
    prev = torch.cat(
        [torch.full((B, 1), blank, dtype=ids.dtype, device=ids.device),
         ids[:, :-1]], dim=1,
    )
    keep = valid & (ids != blank) & (ids != prev)
    lens = keep.sum(dim=1).to(torch.int32)
    # stable compaction: the k-th kept token lands at output position k
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((B, T + 1), blank, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, torch.where(keep, pos, T), torch.where(keep, ids, blank))
    return out[:, :T], lens


def rnnt_greedy_decode(
    f_proj: torch.Tensor,      # [B, T, H] encoder-side joint projections
    frame_lens: torch.Tensor,  # [B]
    lang_ids: torch.Tensor,    # [B]
    pred_step: Callable,       # (last_label [B], state) -> (g [B, H], state)
    joint_step: Callable,      # (f_t [B, H], g_t [B, H], lang_ids) -> [B, V+1]
    init_state=None,
    *,
    blank: int,
    max_symbols: int = 10,
    max_out: int = 256,
):
    """Batched greedy transducer decode -> (ids [B, max_out], lens [B])."""
    B, T, _ = f_proj.shape
    dev = f_proj.device
    rows = torch.arange(B, device=dev)
    frame_lens = frame_lens.to(dev)
    out = torch.full((B, max_out), blank, dtype=torch.int32, device=dev)
    out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    last = torch.full((B,), blank, dtype=torch.int32, device=dev)
    # the prediction-net output for the current last label is cached and
    # only recomputed after an emission
    g, state = pred_step(last, init_state)
    n_frames = int(frame_lens.max()) if B else 0
    for t in range(min(T, n_frames)):
        f_t = f_proj[:, t]
        cont = t < frame_lens
        k = 0
        while k < max_symbols and bool(cont.any()):
            logits = joint_step(f_t, g, lang_ids)
            pred = torch.argmax(logits, dim=-1).to(torch.int32)
            emit = cont & (pred != blank) & (out_len < max_out)
            pos = out_len.clamp(0, max_out - 1).long()
            out[rows, pos] = torch.where(emit, pred, out[rows, pos])
            out_len = out_len + emit.to(torch.int32)
            last = torch.where(emit, pred, last)
            g_new, state_new = pred_step(last, state)
            g = torch.where(emit[:, None], g_new, g)
            state = tuple(
                tuple(
                    torch.where(emit.view((B,) + (1,) * (n.dim() - 1)), n, o)
                    for n, o in zip(new, old)
                )
                for new, old in zip(state_new, state)
            )
            cont = cont & emit
            k += 1
    return out, out_len
