"""Duration buckets and static-shape batch assembly (serving subset).

Utterances are grouped into duration buckets; each bucket has a fixed
(audio_samples, token_len) padded shape, and the final partial batch of a
bucket is padded by repeating its last entry (``n_real`` marks the real
rows). The training-side prefetching ``BatchPipeline`` arrives with the
training slice.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Callable

import numpy as np

from .manifest import ManifestEntry


@dataclasses.dataclass
class Batch:
    """Host-side batch: (signal, sig_len, tokens, tok_len) plus language
    routing ids."""

    audio: np.ndarray       # [B, S] float32
    audio_len: np.ndarray   # [B] int32, valid samples
    tokens: np.ndarray      # [B, U] int32, padded with pad_id
    token_len: np.ndarray   # [B] int32
    lang_ids: np.ndarray    # [B] int32 index into the language list
    texts: list[str]        # reference transcripts (for WER on host)
    langs: list[str]
    n_real: int = -1        # rows < n_real are real; the rest are repeats

    def __post_init__(self):
        if self.n_real < 0:
            self.n_real = len(self.texts)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shapes: audio second boundaries and token caps per bucket."""

    boundaries_sec: tuple[float, ...] = (4.0, 8.0, 12.0, 16.7)
    max_tokens: tuple[int, ...] = (64, 128, 192, 256)
    sample_rate: int = 16000

    def bucket_of(self, duration: float) -> int:
        for i, b in enumerate(self.boundaries_sec):
            if duration <= b:
                return i
        return len(self.boundaries_sec) - 1

    def shapes(self, bucket: int) -> tuple[int, int]:
        return (
            int(self.boundaries_sec[bucket] * self.sample_rate),
            self.max_tokens[bucket],
        )


def _assemble(
    entries: list[ManifestEntry],
    n_real: int,
    bucket: int,
    spec: BucketSpec,
    tokenizer,
    lang_index: dict[str, int],
    pad_id: int,
    loader: Callable[[str], np.ndarray],
    io_pool: cf.Executor | None,
) -> Batch:
    S, U = spec.shapes(bucket)
    B = len(entries)
    audio = np.zeros((B, S), np.float32)
    audio_len = np.zeros((B,), np.int32)
    tokens = np.full((B, U), pad_id, np.int32)
    token_len = np.zeros((B,), np.int32)
    lang_ids = np.zeros((B,), np.int32)

    paths = [e.audio_filepath for e in entries]
    if io_pool is not None:
        wavs = list(io_pool.map(loader, paths))
    else:
        wavs = [loader(p) for p in paths]

    for i, (e, wav) in enumerate(zip(entries, wavs)):
        n = min(len(wav), S)
        audio[i, :n] = wav[:n]
        audio_len[i] = n
        ids = tokenizer.text_to_ids(e.text, e.lang) if e.text else []
        ids = ids[:U]
        tokens[i, : len(ids)] = ids
        token_len[i] = len(ids)
        lang_ids[i] = lang_index[e.lang]
    return Batch(
        audio=audio,
        audio_len=audio_len,
        tokens=tokens,
        token_len=token_len,
        lang_ids=lang_ids,
        texts=[e.text for e in entries],
        langs=[e.lang for e in entries],
        n_real=n_real,
    )
