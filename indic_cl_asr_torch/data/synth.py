"""Synthetic data: tiny WAVs, manifests and tokenizers standing in for
IndicSUPERB (own copy of the JAX package's tests/synth.py; a seed writes
the same WAV bytes). ``--synthetic true`` runs of the command line
(scripts/_common.py:build_synthetic_data) train on it."""

import os
import zlib

import numpy as np

from ..audio.io import write_wav
from .manifest import ManifestEntry, write_manifest
from .tokenizer import (
    BPETokenizer,
    CharTokenizer,
    MultilingualTokenizer,
)

WORDS = {
    "hindi": ["namaste", "dhanyavad", "pani", "ghar", "samay"],
    "bengali": ["nomoshkar", "dhonnobad", "jol", "bari", "somoy"],
    "tamil": ["vanakkam", "nandri", "thanni", "veedu", "neram"],
}


def make_texts(
    lang: str, n: int, seed: int = 0, max_words: int = 5
) -> list[str]:
    # stable per-language offset: Python's hash() is salted per PROCESS,
    # which would hand two multihost workers DIFFERENT synthetic data for
    # the same (lang, seed) — crc32 is process-invariant
    rng = np.random.default_rng(seed + zlib.crc32(lang.encode()) % 1000)
    words = WORDS.get(lang, WORDS["hindi"])
    return [
        " ".join(rng.choice(words, size=rng.integers(2, max_words + 1)))
        for _ in range(n)
    ]


def make_tokenizer(langs, kind="char", vocab_size=64):
    toks = {}
    for lang in langs:
        corpus = make_texts(lang, 50)
        if kind == "bpe":
            toks[lang] = BPETokenizer.train(corpus, vocab_size)
        else:
            toks[lang] = CharTokenizer.train(corpus)
    return MultilingualTokenizer(toks)


def make_wav_dataset(
    root, langs, n_per_lang=6, sr=16000, seed=0,
    min_dur=0.3, max_dur=1.2, max_words=5,
):
    """Writes wavs + per-lang manifest entries; returns {lang: [entries]}.

    Note: CTC needs encoder frames >= tokens; with char tokenizers that
    means roughly dur_sec * 25 >= len(text). Pass min_dur/max_words
    accordingly for CTC-trainability tests."""
    rng = np.random.default_rng(seed)
    out = {}
    os.makedirs(root, exist_ok=True)
    for lang in langs:
        entries = []
        texts = make_texts(lang, n_per_lang, seed, max_words=max_words)
        for i, text in enumerate(texts):
            dur = float(rng.uniform(min_dur, max_dur))
            n = int(dur * sr)
            wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
            path = os.path.join(root, f"{lang}_{i}.wav")
            write_wav(path, wav, sr)
            entries.append(
                ManifestEntry(
                    audio_filepath=path, duration=dur, text=text, lang=lang
                )
            )
        write_manifest(os.path.join(root, f"{lang}.jsonl"), entries)
        out[lang] = entries
    return out
