"""What decides ``correct``: the plain reference recomputes what the timed
path produced, from the inputs the benchmark made, and each number
compared has its limit in ``limits/<workload>.json``.

Training cells: the reference follows the program's first epoch, one step
a bucket (the same rows, step generators and weights), and the numbers are
the worst relative gap of a step's loss, the worst and the median leaf's
gap between the norms of the first gradient (the program's read from
AdamW's first moment after one step), the worst leaf's gap between the
norms of the parameters' change after the epoch, and the median leaf's
after its first three steps; a leaf's gap is measured against the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
rounding alone and are left out of the change.

The eval cell: every utterance of the last pass must have one answer a
decoder; a sample drawn from the seed (eight rows a bucket and the longest
utterance, per decoder) is judged by the widest gap of its tokens under the
reference (reference/decode.py).
"""

from __future__ import annotations

import gc
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from . import traffic
from .reference.decode import (ctc_gap, greedy_ctc, greedy_rnnt, rnnt_gap,
                               teacher_forced)
from .reference.layout import is_trainable, make_weights
from .reference.model import AdamW, Draws, Precision, Reference, frontend, step_loss

HERE = Path(__file__).resolve().parent
SAMPLE_PER_BUCKET = 8
MEDIAN_STEPS = 3  # the change that update_gap_median reads: after this many steps


def load_limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def assemble(utts, mix: dict, device, lang_index=None) -> dict:
    """A batch of ``utts`` padded to the largest of their buckets' shapes,
    read from their WAVs with the benchmark's own reader."""
    from .cells import LANGUAGES

    lang_index = lang_index or {l: i for i, l in enumerate(LANGUAGES)}
    b = max(u.bucket for u in utts)
    S = int(mix["bucket_boundaries_s"][b] * traffic.SAMPLE_RATE)
    U = mix["bucket_max_tokens"][b]
    audio = np.zeros((len(utts), S), np.float32)
    tokens = np.zeros((len(utts), U), np.int64)
    for i, u in enumerate(utts):
        x = traffic.read_wav(u.path)
        audio[i, :len(x)] = x
        tokens[i, :len(u.ids)] = u.ids
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"audio": t(audio), "audio_len": t(np.array([u.samples for u in utts])),
            "tokens": t(tokens), "token_len": t(np.array([len(u.ids) for u in utts])),
            "lang_ids": t(np.array([lang_index[u.lang] for u in utts]))}


def gap(prog: float, ref: float, floor: float) -> float:
    return abs(prog - ref) / max(abs(ref), floor)


# ---- training

def train_reference(cfg: dict, mix: dict, seed: int, steps: list, by_samples: dict, device,
                    prec: str = "f32", rows: int | None = None) -> dict:
    """The reference's readings over the program's check steps: the same
    weights (from ``seed``), rows (found by their sample counts) and step
    generators. ``rows`` keeps only a batch's first rows (a planted fault)."""
    m, tr = cfg["model"], cfg["train"]
    weights = make_weights(m, seed, device)
    F_ = tr["freeze_encoder_till"]
    names = [k for k in weights if is_trainable(k, F_)]
    p0 = {k: weights[k].clone() for k in names}
    for k in names:
        weights[k].requires_grad_(True)
    ref = Reference(m, weights, Precision(prec))
    opt = AdamW({k: weights[k] for k in names}, tr["lr"], tr["weight_decay"])
    losses, g1, delta3 = [], None, None

    def change():
        return {k: float((weights[k].detach() - p0[k]).double().norm()) for k in names}

    for i, st in enumerate(steps, 1):
        utts = [by_samples[n] for n in st["samples"]][:rows]
        batch = assemble(utts, mix, device)
        host = torch.Generator().manual_seed(st["seed"])
        loss = step_loss(ref, batch, cfg, Draws(host, device))
        grads = torch.autograd.grad(loss, [weights[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(weights[k]) if g is None else g.detach()
                 for k, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = {k: float(g.double().norm()) for k, g in grads.items()}
        opt.step(grads)
        del loss, grads
        if i == MEDIAN_STEPS:
            delta3 = change()
    delta = change()
    del weights, p0, opt, ref
    gc.collect()
    return {"losses": losses, "g1": g1, "delta3": delta3 or delta, "delta": delta}


def train_numbers(prog: dict, ref: dict, worst: bool = False) -> dict:
    """The numbers: the worst step's loss gap, the worst and the median
    leaf's gradient gap, the worst leaf's change gap after the epoch and the
    median leaf's after ``MEDIAN_STEPS``; with ``worst`` also the worst
    leaves' names (for setting limits)."""
    loss_gap = max(gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["g1"].values())
    grads = {k: gap(prog["g1"][k], v, g_med) for k, v in ref["g1"].items()}
    moved = [k for k, v in ref["g1"].items() if v >= 1e-3 * g_med]

    def change_gaps(key):
        d_med = statistics.median(ref[key][k] for k in moved)
        return {k: gap(prog[key][k], ref[key][k], d_med) for k in moved}

    updates = change_gaps("delta")
    out = {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
           "grad_gap_median": statistics.median(grads.values()),
           "update_gap": max(updates.values()),
           "update_gap_median": statistics.median(change_gaps("delta3").values())}
    if worst:
        out.update(grad_worst=max(grads, key=grads.get), update_worst=max(updates, key=updates.get))
    return out


# ---- eval

def sample(utts, seed: int) -> list:
    """Eight utterances a bucket and the longest, drawn from the seed."""
    rng = np.random.default_rng(seed + 1)
    by_bucket = {}
    for u in utts:
        by_bucket.setdefault(u.bucket, []).append(u)
    picked = {max(utts, key=lambda u: u.samples).samples}
    for b in sorted(by_bucket):
        group = by_bucket[b]
        for i in rng.choice(len(group), size=min(SAMPLE_PER_BUCKET, len(group)), replace=False):
            picked.add(group[i].samples)
    return sorted(picked)


@torch.inference_mode()
def eval_reference(cfg: dict, mix: dict, seed: int, biases, picked: list, by_samples: dict,
                   device, prec: str = "f32"):
    """(f_proj, ctc log-probs, frames) of each picked utterance, by the
    reference in ``prec``, in blocks of one bucket."""
    m = cfg["model"]
    from .cells import LANGUAGES

    weights = make_weights(m, seed, device, serving=True)
    for lang, bias in biases["rnnt"].items():
        weights["joint.head_bias"][LANGUAGES.index(lang), -1] = bias
    weights["ctc_decoder.bias"][m["vocab_size_total"]] = biases["ctc"]
    ref = Reference(m, weights, Precision(prec))
    out = {}
    for b in sorted({by_samples[n].bucket for n in picked}):
        utts = [by_samples[n] for n in picked if by_samples[n].bucket == b]
        batch = assemble(utts, mix, device)
        mel, n = frontend(batch["audio"], batch["audio_len"], cfg["frontend"])
        f, lens = ref.encode(mel, n)
        f_proj = ref.linear(f, "joint.enc")
        lp = ref.ctc_logprobs(f, batch["lang_ids"])
        for i, u in enumerate(utts):
            out[u.samples] = (f_proj[i, :lens[i]], lp[i, :lens[i]], int(batch["lang_ids"][i]))
    return ref, out


@torch.inference_mode()
def eval_numbers(ref, out: dict, seqs: dict, dec: dict, device) -> dict:
    """The widest RNNT and CTC gaps of ``seqs`` {(decoder, samples): ids}."""
    rnnt_keys = sorted(n for d, n in seqs if d == "rnnt")
    g = teacher_forced(ref, [seqs[("rnnt", n)] for n in rnnt_keys], device)
    gaps = {"rnnt": [], "ctc": []}
    for i, n in enumerate(rnnt_keys):
        f_proj, _, lang = out[n]
        s = seqs[("rnnt", n)]
        gaps["rnnt"].append(rnnt_gap(ref, f_proj, g[i], lang, s, len(s) >= dec["max_out"],
                                     dec["max_symbols"]))
    for d, n in seqs:
        if d == "ctc":
            gaps["ctc"].append(ctc_gap(out[n][1], seqs[(d, n)]))
    return {"rnnt_gap": max(gaps["rnnt"]), "ctc_gap": max(gaps["ctc"]),
            "rnnt_gap_mean": float(np.mean(gaps["rnnt"])),
            "ctc_gap_mean": float(np.mean(gaps["ctc"]))}


@torch.inference_mode()
def control_seqs(ref8, out8: dict, picked: list, dec: dict) -> dict:
    """The control's own tokens: the float8 reference decodes the picked
    utterances greedily, together."""
    rows = [out8[n] for n in picked]
    dev = rows[0][0].device
    lens = torch.tensor([r[0].shape[0] for r in rows], device=dev)
    pad = lambda xs: torch.nn.utils.rnn.pad_sequence(xs, batch_first=True)  # noqa: E731
    langs = torch.tensor([r[2] for r in rows], device=dev)
    rnnt = greedy_rnnt(ref8, pad([r[0] for r in rows]), lens, langs, dec["max_symbols"],
                       dec["max_out"])
    ctc = greedy_ctc(pad([r[1] for r in rows]), lens)
    seqs = {}
    for n, r, c in zip(picked, rnnt, ctc):
        seqs[("rnnt", n)], seqs[("ctc", n)] = r, c
    return seqs


def eval_answers(answers: dict, utts) -> int:
    """Utterance-decoder pairs of the last pass without exactly one answer."""
    return sum(len(answers.get((d, u.samples), [])) != 1 for u in utts for d in ("rnnt", "ctc"))


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): every limited number at or under
    its limit. A number the limits file does not list is shown beside no
    limit and not compared; a cell without limits is not correct."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = bool(limits) and all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim
                              for k, lim in limits.items())
    return ok, rows
