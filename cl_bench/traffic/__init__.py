"""The general traffic generator: a mix file (``traffic/<mix>.json``) in,
WAVs, transcripts and token ids out.

A mix fixes the amount of work; the seed picks only the content. Each
bucket ``[lo, hi, n]`` holds ``n`` utterances per (language, set) whose
durations are spread evenly over (lo, hi], interleaved between the groups
so that every utterance has a sample count of its own (the check finds a
decoded row's utterance by it). Transcript lengths follow the durations at
``tokens_per_s``. The seed draws the samples, the token ids and, in the
program, the order and the dropout and SpecAugment draws. So the number of
batches, the padded shapes, the real audio seconds and the token counts are
the same for every seed.

Transcripts are words of a character vocabulary (the port's
``CharTokenizer`` convention: a word is the boundary piece ``▁`` and its
characters), with no piece twice in a row, so every CTC target fits its
frames.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import wave
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SAMPLE_RATE = 16000
WORD_BOUNDARY = "▁"
UNK = "<unk>"
# 256 pieces a language: <unk>, the word boundary, 254 characters
CHARS = [chr(0x0900 + i) for i in range(254)]
VOCAB = [UNK, WORD_BOUNDARY] + CHARS


def load_mix(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Utterance:
    lang: str
    set: str
    bucket: int
    samples: int
    ids: np.ndarray  # int32 local piece ids
    text: str
    path: str = ""

    @property
    def seconds(self) -> float:
        return self.samples / SAMPLE_RATE


def bucket_of(duration: float, boundaries) -> int:
    for i, b in enumerate(boundaries):
        if duration <= b:
            return i
    return len(boundaries) - 1


def plan(mix: dict) -> list[tuple[str, str, int, int]]:
    """(lang, set, bucket, samples) of every utterance: the mix's fixed
    multiset, the same for every seed."""
    groups = [(lang, s) for lang in mix["languages"] for s in mix["sets"]]
    G = len(groups)
    out = []
    for b, (lo, hi, n) in enumerate(mix["buckets"]):
        if n % mix["batch_size"]:
            raise ValueError(f"bucket {b}: {n} utterances is no whole number of batches")
        for g, (lang, s) in enumerate(groups):
            for i in range(n):
                d = lo + (hi - lo) * (i * G + g + 0.5) / (n * G)
                samples = int(round(d * SAMPLE_RATE))
                if bucket_of(samples / SAMPLE_RATE, mix["bucket_boundaries_s"]) != b:
                    raise ValueError(f"duration {d} falls outside bucket {b}")
                out.append((lang, s, b, samples))
    return out


def token_count(samples: int, mix: dict) -> int:
    return max(2, int(round(mix["tokens_per_s"] * samples / SAMPLE_RATE)))


def transcript(n_tokens: int, rng: np.random.Generator) -> tuple[np.ndarray, str]:
    """``n_tokens`` piece ids forming words (▁ then 1+ characters), no id
    twice in a row; and the text the port's CharTokenizer reads back to
    them."""
    n_words = max(1, n_tokens // 5)
    chars = n_tokens - n_words
    # every word gets one character, the rest spread at random
    per_word = 1 + np.bincount(rng.integers(0, n_words, chars - n_words), minlength=n_words)
    ids, words = [], []
    prev = -1
    for k in per_word:
        ids.append(1)
        prev = 1
        word = []
        for _ in range(int(k)):
            if prev >= 2:  # any character but the previous one
                c = int(rng.integers(2, len(VOCAB) - 1))
                c += c >= prev
            else:
                c = int(rng.integers(2, len(VOCAB)))
            ids.append(c)
            word.append(VOCAB[c])
            prev = c
        words.append("".join(word))
    return np.asarray(ids, np.int32), " ".join(words)


def signals(lengths: list[int], seed: int, device, snr_db: float | None) -> list[np.ndarray]:
    """Speech-like signals (three modulated partials over a little noise),
    one per length, drawn on ``device`` from ``seed`` in a few large calls;
    with ``snr_db`` white noise at that SNR is added."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, L = len(lengths), max(lengths)
    t = torch.arange(L, device=device, dtype=torch.float32) / SAMPLE_RATE
    par = torch.rand((n, 10), generator=gen, device=device)
    f = 100.0 + 1400.0 * par[:, :3]
    phase = 2 * math.pi * par[:, 3:6]
    amp = 0.2 + 0.8 * par[:, 6:9]
    rate = 2.0 + 4.0 * par[:, 9:10]
    x = torch.zeros((n, L), device=device)
    for k in range(3):
        x += amp[:, k:k + 1] * torch.sin(2 * math.pi * f[:, k:k + 1] * t + phase[:, k:k + 1])
    x *= 0.5 + 0.5 * torch.sin(2 * math.pi * rate * t)
    x += 0.05 * torch.randn((n, L), generator=gen, device=device)
    x *= 0.3 / x.abs().amax(dim=1, keepdim=True)
    if snr_db is not None:
        noise = torch.randn((n, L), generator=gen, device=device)
        rms = x.pow(2).mean(dim=1, keepdim=True).sqrt()
        x += noise * rms / 10 ** (snr_db / 20)
    x = (x.clamp(-1, 1) * 32767).round().to(torch.int16).cpu().numpy()
    return [x[i, :m] for i, m in enumerate(lengths)]


def write_wav(path: str, pcm16: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm16.astype("<i2").tobytes())


def generate(mix: dict, seed: int, root: str, device) -> list[Utterance]:
    """Every utterance of ``mix`` for ``seed``, its WAV written under
    ``root``. Lengths and token counts come from the mix alone."""
    rng = np.random.default_rng(seed)
    utts = []
    for lang, s, b, samples in plan(mix):
        ids, text = transcript(token_count(samples, mix), rng)
        utts.append(Utterance(lang, s, b, samples, ids, text))
    snr = mix.get("snr_db")
    os.makedirs(root, exist_ok=True)
    for group_set in sorted({u.set for u in utts}):
        group = [u for u in utts if u.set == group_set]
        noisy = snr if group_set.endswith("noisy") else None
        sub = seed * 7919 + len(group_set)
        for k in range(0, len(group), 256):  # bounded device memory a call
            chunk = group[k:k + 256]
            for u, pcm in zip(chunk, signals([u.samples for u in chunk], sub + k, device, noisy)):
                u.path = os.path.join(root, f"{u.lang}_{u.set}_{u.samples}.wav")
                write_wav(u.path, pcm)
    return utts


def read_wav(path: str) -> np.ndarray:
    """The benchmark's own reader: PCM16 mono -> float32 in [-1, 1)."""
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def work_summary(utts: list[Utterance], mix: dict) -> dict:
    """What a pass over the set costs, from the mix alone: batches and
    padded shapes per bucket, real audio seconds, token counts."""
    B = mix["batch_size"]
    per_bucket = {}
    for u in utts:
        d = per_bucket.setdefault(u.bucket, {"utterances": 0, "tokens": 0, "samples": 0})
        d["utterances"] += 1
        d["tokens"] += len(u.ids)
        d["samples"] += u.samples
    groups = len(mix["languages"]) * len(mix["sets"])
    return {
        "batches": {b: d["utterances"] // B for b, d in sorted(per_bucket.items())},
        "batches_per_group": {b: d["utterances"] // B // groups for b, d in sorted(per_bucket.items())},
        "padded_shapes": {b: (B, int(mix["bucket_boundaries_s"][b] * SAMPLE_RATE),
                              mix["bucket_max_tokens"][b]) for b in sorted(per_bucket)},
        "audio_s": sum(u.samples for u in utts) / SAMPLE_RATE,
        "tokens": sum(len(u.ids) for u in utts),
        "lengths": sorted(u.samples for u in utts),
        "token_lengths": sorted(len(u.ids) for u in utts),
    }
