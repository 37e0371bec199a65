"""Beam-search decoding: CTC prefix beam search and RNNT beams.

Port of indic_cl_asr_tpu/ops/beam_search.py (the reference's beam/maes
strategies, rnnt_decoding.py, and its CTC beam classes). Three decoders:

- ``ctc_prefix_beam_search``: prefix beam search (Hannun et al. 2014) over
  blank/non-blank prefix probabilities, on the host in numpy, one
  utterance at a time (the port's own copy).
- ``rnnt_beam_search``: the Graves 2012 beam with prefix merging, host
  control flow around the model's ``pred_step`` / ``joint_step`` on torch
  tensors, one utterance at a time. Exact but slow: the quality oracle.
- ``rnnt_beam_search_batched``: the frame-synchronous batched beam (the
  shape of NeMo's mAES): per frame up to ``max_expansions`` rounds in which
  every live hypothesis either takes blank or extends with one of its
  top-P non-blank symbols, a per-row top-K over the K·(P+1) candidates,
  force-finalisation with the blank score, and a logsumexp merge of equal
  label sequences inside the beam. It is the plain version of the fused
  beam kernel (ops/beam_fused.py).

Selection follows ``lax.top_k``: the lowest index wins among equal values.
``torch.topk`` does not promise that, and ties are certain here (dead
slots and blocked extensions all hold exactly ``NEG``, and ``NEG + lp``
rounds back to ``NEG``), so the batched beam selects with a stable
descending sort.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from .decoding import tree_where

NEG_INF = -float("inf")
NEG = -1e30  # the batched beam's dead score: finite, never -inf


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,  # [T, V+1], blank LAST, log-softmaxed
    frame_len: int,
    blank: int | None = None,
    beam_size: int = 8,
    prune_logp: float = -12.0,
) -> list[int]:
    """Best label prefix under CTC prefix beam search."""
    T, V1 = log_probs.shape
    if blank is None:
        blank = V1 - 1
    # prefix -> (log p ending in blank, log p ending in non-blank)
    beams: dict[tuple, tuple[float, float]] = {(): (0.0, NEG_INF)}
    for t in range(min(frame_len, T)):
        row = log_probs[t]
        keep = np.where(row > prune_logp)[0]
        if len(keep) == 0:
            keep = [int(np.argmax(row))]
        next_beams: dict[tuple, list[float]] = defaultdict(
            lambda: [NEG_INF, NEG_INF]
        )
        for prefix, (p_b, p_nb) in beams.items():
            p_tot = _logaddexp(p_b, p_nb)
            for v in keep:
                p = float(row[v])
                if v == blank:
                    nb = next_beams[prefix]
                    nb[0] = _logaddexp(nb[0], p_tot + p)
                    continue
                last = prefix[-1] if prefix else None
                if v == last:
                    # a repeat extends the same prefix, or makes a new one
                    # only through a preceding blank
                    nb = next_beams[prefix]
                    nb[1] = _logaddexp(nb[1], p_nb + p)
                    ext = next_beams[prefix + (v,)]
                    ext[1] = _logaddexp(ext[1], p_b + p)
                else:
                    ext = next_beams[prefix + (v,)]
                    ext[1] = _logaddexp(ext[1], p_tot + p)
        ranked = sorted(
            next_beams.items(),
            key=lambda kv: -_logaddexp(kv[1][0], kv[1][1]),
        )[:beam_size]
        beams = {k: (v[0], v[1]) for k, v in ranked}
    best = max(beams.items(), key=lambda kv: _logaddexp(*kv[1]))
    return list(best[0])


class _Hyp:
    __slots__ = ("score", "ys", "state", "g")

    def __init__(self, score, ys, state, g):
        self.score = score
        self.ys = ys
        self.state = state
        self.g = g


def rnnt_beam_search(
    f_proj,                    # [T, H] projected encoder frames (1 sample)
    frame_len: int,
    lang_id: int,
    pred_step: Callable,       # ([N] labels, state) -> (g [N, H], state)
    joint_step: Callable,      # (f_t [N, H], g [N, H], lang [N]) -> [N, V+1]
    *,
    blank: int,
    beam_size: int = 4,
    max_expansions: int = 10,
) -> list[int]:
    """Graves 2012 transducer beam search for one utterance. ``f_proj`` is
    a torch tensor on the model's device (or an array, moved to the CPU)."""
    f_proj = torch.as_tensor(f_proj)
    dev = f_proj.device
    lang = torch.tensor([lang_id], dtype=torch.int32, device=dev)

    def pred1(label, state):
        g, st = pred_step(torch.tensor([label], dtype=torch.int32, device=dev), state)
        return g[0], st

    def logits1(t, g):
        out = joint_step(f_proj[None, t], g[None], lang)
        x = out[0].float().cpu().numpy()
        x = x - x.max()
        return x - math.log(np.exp(x).sum())

    g0, st0 = pred1(blank, None)
    B = [_Hyp(0.0, (), st0, g0)]

    for t in range(min(frame_len, len(f_proj))):
        A = sorted(B, key=lambda h: -h.score)
        B = []
        merged: dict[tuple, float] = {}
        expansions = 0
        while A and expansions < max_expansions:
            best = A.pop(0)
            lp = logits1(t, best.g)
            # blank: the hypothesis moves on to the next frame
            b_score = best.score + float(lp[blank])
            if best.ys in merged:
                # prefix merge: logsumexp the scores of equal sequences;
                # merged[] keeps the TOTAL mass, so a copy that was cut from
                # B comes back with it instead of being dropped
                merged[best.ys] = _logaddexp(merged[best.ys], b_score)
                for h in B:
                    if h.ys == best.ys:
                        h.score = merged[best.ys]
                        break
                else:
                    B.append(_Hyp(merged[best.ys], best.ys, best.state, best.g))
            else:
                merged[best.ys] = b_score
                B.append(_Hyp(b_score, best.ys, best.state, best.g))
            # non-blank extensions stay in this frame
            order = np.argsort(-lp)
            for v in order[: beam_size + 1]:
                v = int(v)
                if v == blank:
                    continue
                g_new, st_new = pred1(v, best.state)
                A.append(_Hyp(best.score + float(lp[v]), best.ys + (v,), st_new, g_new))
            A = sorted(A, key=lambda h: -h.score)[:beam_size]
            expansions += 1
            # stop when the best unexpanded hypothesis cannot beat the worst kept
            if len(B) >= beam_size:
                B = sorted(B, key=lambda h: -h.score)[:beam_size]
                if not A or A[0].score < B[-1].score:
                    break
        if not B:
            B = A[:beam_size]
        B = sorted(B, key=lambda h: -h.score)[:beam_size]

    return list(max(B, key=lambda h: h.score).ys)


def rnnt_beam_search_batched(
    f_proj: torch.Tensor,      # [B, T, H] projected encoder frames
    frame_lens: torch.Tensor,  # [B]
    lang_ids: torch.Tensor,    # [B]
    pred_step: Callable,       # ([N] labels, state|None) -> (g [N, H], state)
    joint_step: Callable,      # (f [N, H], g [N, H], lang [N]) -> [N, V+1] logits
    init_state=None,
    *,
    blank: int,
    beam_size: int = 4,
    max_expansions: int = 6,
    max_out: int = 256,
    topk: int | None = None,
    trace: list | None = None,
):
    """Batched frame-synchronous transducer beam search.

    Returns (ids [B, max_out] int32 blank-padded, lens [B] int32, scores [B]
    f32) of each row's best hypothesis. With ``beam_size=1`` and
    ``max_expansions`` equal to greedy's ``max_symbols`` it is greedy
    decoding.

    Hypotheses live in [B, K, ...] tensors (the prediction-net state flat
    as [B*K, ...]); the joint and the prediction net run once a round for
    all B*K hypotheses. The expansion loop of a frame runs while any
    hypothesis of any row is live, at most ``max_expansions`` rounds.

    ``trace``, when a list, receives one [B] f32 tensor per selection: the
    smallest relative gap, row by row, between two candidates whose order
    decided the outcome (the K-th and (K+1)-th of the top-K, the P-th and
    (P+1)-th non-blank of each live hypothesis, the best and second-best
    hypothesis at the end). A decoder whose sums round otherwise can only
    disagree where such a gap is of the order of that rounding."""
    B, T, H = f_proj.shape
    dev = f_proj.device
    K = beam_size
    P = topk if topk is not None else beam_size
    frame_lens = frame_lens.to(dev)
    rows = torch.arange(B, device=dev)[:, None].expand(B, K)
    slots = torch.arange(K, device=dev)[None, :].expand(B, K)

    def flat(x):
        return x.reshape((B * K,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, K) + x.shape[1:])

    def gather_state(state, parent):
        fp = (rows * K + parent).reshape(-1)
        if isinstance(state, torch.Tensor):
            return state[fp]
        return tuple(gather_state(s, parent) for s in state)

    def rel_gap(a, b):
        return ((a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)).where(
            (a > NEG / 2) & (b > NEG / 2), torch.full_like(a, math.inf))

    # every slot primed with the blank/SOS step; only slot 0 is live at t=0
    # (the others would be duplicates of the same empty prefix)
    g0, state = pred_step(torch.full((B * K,), blank, dtype=torch.int32, device=dev),
                          init_state)
    g = unflat(g0)
    lang_flat = lang_ids.to(dev).repeat_interleave(K)
    tokens = torch.full((B, K, max_out), blank, dtype=torch.int32, device=dev)
    lens = torch.zeros((B, K), dtype=torch.int32, device=dev)
    scores = torch.where(slots == 0, 0.0, NEG).to(torch.float32)

    def logp_all(g, f_rep):
        # (x - m) - log(sum(exp(x - m))): jax.nn.log_softmax's order of
        # operations, which the scores accumulate
        x = joint_step(f_rep, flat(g), lang_flat).float()
        x = x - x.amax(dim=-1, keepdim=True)
        return unflat(x - torch.log(torch.exp(x).sum(dim=-1, keepdim=True)))

    n_frames = min(T, int(frame_lens.max())) if B else 0
    for t in range(n_frames):
        frame_active = t < frame_lens
        f_rep = f_proj[:, t].repeat_interleave(K, dim=0)
        c_tokens, c_lens, c_scores, c_g, c_state = tokens, lens, scores, g, state
        done = c_scores <= NEG / 2  # dead slots never expand
        e = 0
        while e < max_expansions and not bool(done.all()):
            lp = logp_all(c_g, f_rep)                              # [B, K, V1]
            can_extend = ~done & (c_lens < max_out)
            # candidate 0 of a parent: take blank (a done hypothesis stays as it is)
            stay = torch.where(done, c_scores, c_scores + lp[..., blank])
            # candidates 1..P: the top-P non-blank extensions
            lp_nb = lp.clone()
            lp_nb[..., blank] = NEG
            nb_sorted, nb_order = torch.sort(lp_nb, dim=-1, descending=True, stable=True)
            ext_lp, ext_ids = nb_sorted[..., :P], nb_order[..., :P]  # [B, K, P]
            ext = torch.where(can_extend[..., None], c_scores[..., None] + ext_lp, NEG)
            cand = torch.cat([stay[..., None], ext], dim=-1).reshape(B, K * (P + 1))
            sorted_c, order = torch.sort(cand, dim=-1, descending=True, stable=True)
            new_scores, sel = sorted_c[:, :K], order[:, :K]
            if trace is not None:
                gaps = [rel_gap(sorted_c[:, K - 1], sorted_c[:, K])]
                if P < lp.shape[-1]:
                    gp = rel_gap(c_scores + nb_sorted[..., P - 1], c_scores + nb_sorted[..., P])
                    gaps.append(torch.where(can_extend, gp, math.inf).amin(dim=1))
                trace.append(torch.stack(gaps).amin(dim=0).where(frame_active, math.inf))
            parent = sel // (P + 1)
            slot = sel % (P + 1)
            is_stay = slot == 0
            ext_tok = torch.gather(ext_ids[rows, parent], -1,
                                   (slot - 1).clamp(min=0)[..., None])[..., 0].to(torch.int32)
            p_tokens = c_tokens[rows, parent]
            p_lens = c_lens[rows, parent]
            wpos = p_lens.clamp(0, max_out - 1).long()
            cur = p_tokens[rows, slots, wpos]
            p_tokens[rows, slots, wpos] = torch.where(is_stay, cur, ext_tok)
            new_lens = p_lens + (~is_stay).to(torch.int32)
            new_done = done[rows, parent] | is_stay
            # the prediction net advances only on emission
            p_g = c_g[rows, parent]
            p_state = gather_state(c_state, parent)
            g_new, state_new = pred_step(flat(torch.where(is_stay, blank, ext_tok)), p_state)
            emit = ~is_stay
            c_g = torch.where(emit[..., None], unflat(g_new), p_g)
            c_state = tree_where(flat(emit), state_new, p_state)
            c_tokens, c_lens, c_scores, done = p_tokens, new_lens, new_scores, new_done
            e += 1
        # force-finalise the hypotheses that ran out of expansions
        lp = logp_all(c_g, f_rep)
        c_scores = torch.where(done | (c_scores <= NEG / 2), c_scores,
                               c_scores + lp[..., blank])
        # Graves prefix merge inside the beam: logsumexp equal label
        # sequences into the lower slot and kill the higher one, pair by
        # pair in (i, j), i < j order. A pair equal in no row now is
        # skipped: merging only kills slots, so it cannot become equal.
        fin = c_scores > NEG / 2
        eq = ((c_lens[:, :, None] == c_lens[:, None, :])
              & (c_tokens[:, :, None] == c_tokens[:, None, :]).all(dim=-1)
              & fin[:, :, None] & fin[:, None, :]).any(dim=0).tolist()
        for i in range(K):
            for j in range(i + 1, K):
                if not eq[i][j]:
                    continue
                same = (
                    (c_lens[:, i] == c_lens[:, j])
                    & (c_tokens[:, i] == c_tokens[:, j]).all(dim=-1)
                    & (c_scores[:, i] > NEG / 2)
                    & (c_scores[:, j] > NEG / 2)
                )
                merged = torch.logaddexp(c_scores[:, i], c_scores[:, j])
                c_scores = c_scores.clone()
                c_scores[:, i] = torch.where(same, merged, c_scores[:, i])
                c_scores[:, j] = torch.where(same, NEG, c_scores[:, j])
        # rows whose frames are exhausted carry through unchanged
        m = frame_active
        tokens = torch.where(m[:, None, None], c_tokens, tokens)
        lens = torch.where(m[:, None], c_lens, lens)
        scores = torch.where(m[:, None], c_scores, scores)
        g = torch.where(m[:, None, None], c_g, g)
        state = tree_where(m.repeat_interleave(K), c_state, state)
    best = torch.argmax(scores, dim=1)
    if trace is not None and K > 1:
        top2 = torch.sort(scores, dim=1, descending=True, stable=True)[0]
        trace.append(rel_gap(top2[:, 0], top2[:, 1]))
    r = torch.arange(B, device=dev)
    return tokens[r, best], lens[r, best], scores[r, best]
