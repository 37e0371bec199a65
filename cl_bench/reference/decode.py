"""Plain greedy decoders and the gap measures that judge decoded tokens.

A decoded token sequence is judged by the widest gap by which a choice it
implies lies below the reference's best at that point, minimised over the
alignments that give the sequence: 0 where the reference's own greedy
decode would give it, small where a rounding flipped a near tie, large
where the decode chose what the model does not say.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import Reference


def pred_state(ref: Reference, last, state):
    """One prediction-net step from local label ``last`` [B] (blank reads
    the zero row) -> (projected g [B, Hj], state)."""
    m = ref.m
    tok = torch.where(last == ref.V, m["vocab_size_total"], last)
    x = ref.embed(tok)
    new = []
    for n in range(m["pred_rnn_layers"]):
        h, c = state[n]
        h, c = ref.lstm_step(x, h, c, n)
        new.append((h, c))
        x = h
    return ref.linear(x, "joint.pred"), new


def greedy_rnnt(ref: Reference, f_proj, lens, lang_ids, max_symbols: int, max_out: int):
    """Frame-synchronous greedy transducer decode, up to ``max_symbols``
    emissions a frame and ``max_out`` a row -> token lists."""
    B, T, _ = f_proj.shape
    dev = f_proj.device
    Hp = ref.m["pred_hidden"]
    blank = ref.V
    W = ref.P["joint.head_kernel"][lang_ids]  # [B, Hj, V1]
    b = ref.P["joint.head_bias"][lang_ids]
    state = [(torch.zeros(B, Hp, device=dev), torch.zeros(B, Hp, device=dev))
             for _ in range(ref.m["pred_rnn_layers"])]
    last = torch.full((B,), blank, dtype=torch.long, device=dev)
    g, state = pred_state(ref, last, state)
    out_len = torch.zeros(B, dtype=torch.long, device=dev)
    out = torch.full((B, max_out), -1, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(int(lens.max())):
        cont = t < lens
        for _ in range(max_symbols):
            if not bool(cont.any()):
                break
            x = F.relu(f_proj[:, t] + g)
            logits = torch.einsum("bh,bhv->bv", ref.q(x), ref.q(W)) + b
            pred = logits.argmax(-1)
            emit = cont & (pred != blank) & (out_len < max_out)
            out[rows, out_len.clamp(max=max_out - 1)] = torch.where(
                emit, pred, out[rows, out_len.clamp(max=max_out - 1)])
            out_len = out_len + emit.long()
            g_new, s_new = pred_state(ref, torch.where(emit, pred, last), state)
            last = torch.where(emit, pred, last)
            g = torch.where(emit[:, None], g_new, g)
            state = [(torch.where(emit[:, None], h2, h1), torch.where(emit[:, None], c2, c1))
                     for (h1, c1), (h2, c2) in zip(state, s_new)]
            cont = cont & emit
    out = out.cpu().tolist()
    return [row[:n] for row, n in zip(out, out_len.cpu().tolist())]


def greedy_ctc(lp, lens):
    """Frame argmax, repeats merged, blanks (the last class) dropped."""
    blank = lp.shape[-1] - 1
    ids = lp.argmax(-1).cpu().numpy()
    out = []
    for r, n in enumerate(lens.tolist()):
        seq, prev = [], blank
        for k in ids[r, :n]:
            if k != blank and k != prev:
                seq.append(int(k))
            prev = k
        out.append(seq)
    return out


def teacher_forced(ref: Reference, seqs: list[list[int]], device):
    """The projected prediction-net output after each prefix of each
    sequence: [N, U_max + 1, Hj]."""
    U = max(1, max(len(s) for s in seqs))
    tok = torch.zeros((len(seqs), U), dtype=torch.long, device=device)
    for i, s in enumerate(seqs):
        if s:
            tok[i, :len(s)] = torch.tensor(s, device=device)
    return ref.linear(ref.predict(tok), "joint.pred")


def rnnt_gap(ref: Reference, f_proj, g_proj, lang: int, seq: list[int], truncated: bool,
             max_symbols: int) -> float:
    """The widest gap of the best greedy alignment of ``seq``: at (t, u) a
    blank costs max - logit(blank), an emission max - logit(y_u+1); at
    most ``max_symbols`` emissions a frame, after which the frame is left
    at no cost, as the greedy decoder leaves it. An alignment runs from
    (0, 0) past the last frame (or, for a row cut at ``max_out``, to its
    last token anywhere)."""
    T, U = f_proj.shape[0], len(seq)
    logits = ref.joint_logits(f_proj[None], g_proj[None, :U + 1], lang)[0]  # [T, U+1, V1]
    top = logits.amax(-1)
    gb = (top - logits[..., ref.V]).double().cpu().numpy()
    gl = np.zeros((T, 0))
    if U:
        y = torch.tensor(seq, device=logits.device)
        gl = (top[:, :U] - torch.gather(logits[:, :U], 2, y[None, :, None].expand(T, U, 1))[..., 0])
        gl = gl.double().cpu().numpy()
    inf = np.inf
    enter = np.full(U + 1, inf)  # best cost of entering frame t at each u
    enter[0] = 0.0
    best_end = inf
    for t in range(T):
        M = enter.copy()  # no emission yet in this frame
        R = np.full(U + 1, -inf)  # widest label gap of the last k emissions
        forced = np.full(U + 1, inf)
        for k in range(1, min(max_symbols, U) + 1):
            R_new = np.full(U + 1, -inf)
            R_new[k:] = np.maximum(R[k - 1:-1], gl[t, k - 1:])
            R = R_new
            cand = np.maximum(enter[:U + 1 - k], R[k:])
            M[k:] = np.minimum(M[k:], cand)
            if k == max_symbols:
                forced[k:] = cand
        best_end = min(best_end, M[U])
        enter = np.minimum(np.maximum(M, gb[t]), forced)
    return float(best_end if truncated else enter[U])


def ctc_gap(lp, seq: list[int]) -> float:
    """The widest gap of the best CTC alignment of ``seq`` over frames of
    log-probs ``lp`` [T, V+1] (blank last): each frame costs max - lp of the
    class the alignment puts there."""
    c = (lp.amax(-1, keepdim=True) - lp).double().cpu().numpy()
    T, V1 = c.shape
    blank = V1 - 1
    ext = [blank]
    for k in seq:
        ext += [k, blank]
    ext = np.asarray(ext)
    S = len(ext)
    skip = np.zeros(S, bool)
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    A = np.full(S, np.inf)
    A[0] = c[0, blank]
    if S > 1:
        A[1] = c[0, ext[1]]
    for t in range(1, T):
        best = A.copy()
        best[1:] = np.minimum(best[1:], A[:-1])
        best[2:] = np.where(skip[2:], np.minimum(best[2:], A[:-2]), best[2:])
        A = np.maximum(best, c[t, ext])
    return float(A[-1] if S == 1 else min(A[-1], A[-2]))
