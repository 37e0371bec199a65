"""Greedy CTC and batched greedy RNNT decoding (frame-sync and label-looping).

Port of indic_cl_asr_tpu/ops/decoding.py (``ctc_greedy_decode``,
``rnnt_greedy_decode``, ``rnnt_greedy_decode_labelsync``), itself the
reference's GreedyCTCInfer and GreedyBatchedRNNTInfer
(`_greedy_decode_blank_as_pad_loop_frames` and the loop-labels family): a
per-frame symbol budget of ``max_symbols``, a ``max_out`` cap,
first-index argmax, emit-masked prediction-net state updates and
blank-padded outputs.

``rnnt_greedy_decode`` is the plain version of the fused decode kernel
(ops/decode_fused.py): a Python loop over frames whose inner loop stops
as soon as every row has emitted blank. It also continues a decode across
the chunks of an encoder stream (``carry``, ``t_offset``), which the
streaming recognizer (models/streaming.py:StreamingASR) runs on either
device, as the JAX package runs it in XLA: the fused kernel, like its
Pallas counterpart, takes no carry. ``rnnt_greedy_decode_labelsync``
gives the same output with rounds that scale with the emitted tokens; it
runs in plain PyTorch on either device (the JAX package runs it in XLA,
with no Pallas kernel).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def tree_where(sel: torch.Tensor, new, old):
    """``torch.where(sel, new, old)`` over a nested tuple of tensors whose
    leading dimension is ``sel``'s."""
    if isinstance(new, torch.Tensor):
        return torch.where(sel.view(sel.shape + (1,) * (new.dim() - sel.dim())), new, old)
    return tuple(tree_where(sel, n, o) for n, o in zip(new, old))


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
    carry=None,
    t_offset: int = 0,
    return_carry: bool = False,
):
    """Batched greedy transducer decode -> (ids [B, max_out], lens [B]).

    Streaming continuation: ``carry`` is the value returned with
    ``return_carry=True`` (-> (ids, lens, carry)) by the previous chunk and
    ``t_offset`` the absolute frame index of ``f_proj[:, 0]``; the token
    buffer, last label and prediction-net state continue across chunks,
    and a frame takes part while ``t_offset + t < frame_lens``, so decoding
    an encoder stream chunk by chunk equals one decode of the whole."""
    B, T, _ = f_proj.shape
    dev = f_proj.device
    rows = torch.arange(B, device=dev)
    frame_lens = frame_lens.to(dev)
    if carry is None:
        out = torch.full((B, max_out), blank, dtype=torch.int32, device=dev)
        out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        last = torch.full((B,), blank, dtype=torch.int32, device=dev)
        # the prediction-net output for the current last label is cached
        # and only recomputed after an emission
        g, state = pred_step(last, init_state)
    else:
        out, out_len, last, g, state = carry
        out = out.clone()  # the ids returned with the carry stay as they were
    n_frames = int(frame_lens.max()) - t_offset if B else 0
    for t in range(min(T, n_frames)):
        f_t = f_proj[:, t]
        cont = t_offset + t < frame_lens
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
            state = tree_where(emit, state_new, state)
            cont = cont & emit
            k += 1
    if return_carry:
        return out, out_len, (out, out_len, last, g, state)
    return out, out_len


def rnnt_greedy_decode_labelsync(
    f_proj: torch.Tensor,      # [B, T, H]
    frame_lens: torch.Tensor,  # [B]
    lang_ids: torch.Tensor,    # [B]
    pred_step: Callable,
    joint_step: Callable,
    init_state=None,
    *,
    blank: int,
    max_symbols: int = 10,
    max_out: int = 256,
    window: int = 32,
):
    """Label-looping batched greedy decode -> (ids [B, max_out], lens [B]),
    the same output as ``rnnt_greedy_decode``.

    Each round joins a window of ``W = min(window, T)`` frames with the
    current prediction-net output in one batched joint call and jumps to
    the first non-blank frame; a prediction-net step follows only an
    emission. A per-frame symbol budget (``sym_count`` at ``last_t``) keeps
    frame-sync's ``max_symbols``; a frame whose budget or the ``max_out``
    cap is spent is left (``forced_adv``). At most ``T + max_out`` rounds."""
    B, T, H = f_proj.shape
    dev = f_proj.device
    W = min(window, T)
    frame_lens = frame_lens.to(dev).long()
    rows = torch.arange(B, device=dev)
    w_iota = torch.arange(W, device=dev)
    lang_win = lang_ids.to(dev).repeat_interleave(W)
    g, state = pred_step(torch.full((B,), blank, dtype=torch.int32, device=dev), init_state)
    f_pad = F.pad(f_proj, (0, 0, 0, W))
    t_ptr = torch.zeros((B,), dtype=torch.long, device=dev)
    out = torch.full((B, max_out), blank, dtype=torch.int32, device=dev)
    out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    last = torch.full((B,), blank, dtype=torch.int32, device=dev)
    sym_count = torch.zeros((B,), dtype=torch.int32, device=dev)
    last_t = torch.full((B,), -1, dtype=torch.long, device=dev)
    it = 0
    while it < T + max_out and bool((t_ptr < frame_lens).any()):
        idx = t_ptr[:, None] + w_iota[None]                        # [B, W]
        f_win = f_pad[rows[:, None], idx]                          # [B, W, H]
        logits = joint_step(
            f_win.reshape(B * W, H), g.repeat_interleave(W, dim=0), lang_win
        ).reshape(B, W, -1)
        pred = torch.argmax(logits, dim=-1).to(torch.int32)
        valid_w = idx < frame_lens[:, None]
        nonblank = (pred != blank) & valid_w
        has_nb = nonblank.any(dim=1)
        # first non-blank frame of the window (argmax of a bool: cast first)
        w_star = torch.argmax(nonblank.to(torch.int32), dim=1)
        n_valid = valid_w.sum(dim=1)

        active = t_ptr < frame_lens
        t_emit = t_ptr + w_star
        label = pred[rows, w_star]
        new_sym = torch.where(t_emit == last_t, sym_count + 1, 1).to(torch.int32)
        budget_ok = new_sym <= max_symbols
        cap_ok = out_len < max_out
        emit = active & has_nb & budget_ok & cap_ok
        forced_adv = active & has_nb & ~(budget_ok & cap_ok)

        pos = out_len.clamp(0, max_out - 1).long()
        out[rows, pos] = torch.where(emit, label, out[rows, pos])
        out_len = out_len + emit.to(torch.int32)
        last = torch.where(emit, label, last)
        g_new, state_new = pred_step(last, state)
        g = torch.where(emit[:, None], g_new, g)
        state = tree_where(emit, state_new, state)

        t_next = torch.where(
            emit, t_emit,
            torch.where(forced_adv, t_emit + 1, t_ptr + n_valid.clamp(min=1)),
        )
        t_ptr = torch.where(active, t_next, t_ptr)
        sym_count = torch.where(emit, new_sym, 0).to(torch.int32)
        last_t = torch.where(emit, t_emit, -1)
        it += 1
    return out, out_len
