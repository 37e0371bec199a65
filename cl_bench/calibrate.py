"""The eval cell's decode work, pinned: the blank biases that make the
greedy decodes emit the mix's tokens a second of audio, found by false
position with the plain reference decoders (float32) on the seed's own
serving weights. Each language's RNNT head gets its own blank bias, set on
every utterance of that language in the mix; the CTC head's blank column is
shared, and is set on all the mix's utterances at once."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .check import assemble
from .reference.decode import greedy_ctc, greedy_rnnt, pred_state
from .reference.model import Reference, frontend

STEPS = 6
TOLERANCE = 0.05  # of the target rate


def frames_per_s(cfg: dict) -> float:
    fc = cfg["frontend"]
    return fc["sample_rate"] / fc["hop_length"] / cfg["model"]["subsampling_factor"]


def solve(rate, target: float, guess: float) -> float:
    """The bias at which ``rate`` (falling as the bias rises) meets
    ``target``: a bracket around ``guess``, then false position (Illinois)."""
    lo, hi = guess - 4.0, guess + 4.0
    r_lo, r_hi = rate(lo) - target, rate(hi) - target
    for _ in range(8):
        if r_lo >= 0:
            break
        lo -= 8.0
        r_lo = rate(lo) - target
    for _ in range(8):
        if r_hi <= 0:
            break
        hi += 8.0
        r_hi = rate(hi) - target
    if r_lo < 0 or r_hi > 0:
        raise RuntimeError(f"no blank bias in [{lo}, {hi}] meets {target} tokens a frame")
    side = 0
    for _ in range(STEPS):
        mid = (lo * r_hi - hi * r_lo) / (r_hi - r_lo)
        r = rate(mid) - target
        if abs(r) <= TOLERANCE * target:
            return mid
        if r > 0:
            lo, r_lo = mid, r
            if side == 1:
                r_hi /= 2
            side = 1
        else:
            hi, r_hi = mid, r
            if side == -1:
                r_lo /= 2
            side = -1
    return mid


def greedy_start(ref, f_proj, lang):
    """[B, T] margin of the best token over blank (without its bias) at the
    start of decoding."""
    B, T, _ = f_proj.shape
    Hp = ref.m["pred_hidden"]
    state = [(torch.zeros(B, Hp, device=f_proj.device),) * 2
             for _ in range(ref.m["pred_rnn_layers"])]
    g, _ = pred_state(ref, torch.full((B,), ref.V, device=f_proj.device), state)
    W, b = ref.P["joint.head_kernel"][lang], ref.P["joint.head_bias"][lang]
    logits = torch.einsum("bth,bhv->btv", torch.relu(f_proj + g[:, None]), W) + b[:, None]
    return logits[..., :-1].amax(-1) - (logits[..., -1] - b[:, -1:])


def encode_all(ref, cfg: dict, mix: dict, utts, device):
    """(encoder output, frames) of ``utts``, encoded a bucket at a time and
    padded together to the longest."""
    fs, lens = [], []
    for b in sorted({u.bucket for u in utts}):
        batch = assemble([u for u in utts if u.bucket == b], mix, device)
        mel, n = frontend(batch["audio"], batch["audio_len"], cfg["frontend"])
        f, t = ref.encode(mel, n)
        fs.append(f)
        lens.append(t)
    T = max(f.shape[1] for f in fs)
    return torch.cat([F.pad(f, (0, 0, 0, T - f.shape[1])) for f in fs]), torch.cat(lens)


@torch.inference_mode()
def calibrate(cfg: dict, mix: dict, weights: dict, batches: dict, device) -> dict:
    """``batches`` {language: its utterances}. Sets ``joint.head_bias[l, -1]``
    for each language's head l and ``ctc_decoder.bias[-1]`` in ``weights``;
    returns {"rnnt": {language: bias}, "ctc": bias}."""
    from .cells import LANGUAGES

    m, dec = cfg["model"], cfg["decode"]
    target = mix["tokens_per_s"] / frames_per_s(cfg)
    ref = Reference(m, weights)
    V, Vt = ref.V, m["vocab_size_total"]
    weights["ctc_decoder.bias"][Vt] = 0.0
    out, margins, lps, all_lens = {"rnnt": {}}, [], [], []
    for lang, utts in batches.items():
        f, lens = encode_all(ref, cfg, mix, utts, device)
        frames = float(lens.sum())
        f_proj = ref.linear(f, "joint.enc")
        head = LANGUAGES.index(lang)
        ids = torch.full((len(utts),), head, dtype=torch.long, device=device)
        valid = torch.arange(f.shape[1], device=f.device)[None] < lens[:, None]
        # the guess: the bias at which the target share of frames prefers a
        # token at the start of decoding
        guess = float(torch.quantile(greedy_start(ref, f_proj, ids)[valid], 1.0 - target))

        def rnnt_rate(bias):
            weights["joint.head_bias"][head, -1] = bias
            seqs = greedy_rnnt(ref, f_proj, lens, ids, dec["max_symbols"], dec["max_out"])
            return sum(len(s) for s in seqs) / frames

        out["rnnt"][lang] = solve(rnnt_rate, target, guess)
        weights["joint.head_bias"][head, -1] = out["rnnt"][lang]
        lp = ref.ctc_logprobs(f, ids)  # bias 0 on blank: a shift moves only its log-prob
        margins.append((lp[..., :V].amax(-1) - lp[..., V])[valid])
        lps.append(lp)
        all_lens.append(lens)
    frames = float(sum(float(x.sum()) for x in all_lens))

    def ctc_rate(bias):
        n = 0
        for lp, lens in zip(lps, all_lens):
            shifted = lp.clone()
            shifted[..., V] += bias
            n += sum(len(s) for s in greedy_ctc(shifted, lens))
        return n / frames

    guess = float(torch.quantile(torch.cat(margins).float(), 1.0 - target))
    out["ctc"] = solve(ctc_rate, target, guess)
    weights["ctc_decoder.bias"][Vt] = out["ctc"]
    return out
