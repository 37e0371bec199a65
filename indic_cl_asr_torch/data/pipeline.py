"""Duration buckets, static-shape batch assembly and the training pipeline.

Port of indic_cl_asr_tpu/data/pipeline.py. Utterances are grouped into
duration buckets; each bucket has a fixed (audio_samples, token_len)
padded shape, and the final partial batch of a bucket is padded by
repeating its last entry (``n_real`` marks the real rows).
``BatchPipeline`` plans an epoch exactly as the JAX package does (the same
numpy shuffles for the same seed), assembles batches in a producer thread
with a pool of audio readers, and keeps ``prefetch`` batches ready. A
batch of WAV files read by ``load_audio`` is decoded in one threaded call
of the native host library (``utils/native.py``), as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np

from ..audio.io import load_audio
from ..utils.native import load_wav_batch_native
from ..utils.profiling import span
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


def shard_for_host(entries: Sequence[ManifestEntry], process_index: int,
                   process_count: int) -> list[ManifestEntry]:
    """Process ``process_index``'s strided share of ``entries``."""
    return list(entries[process_index::process_count])


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
    wavs = None
    if loader is load_audio and all(p.lower().endswith(".wav") for p in paths):
        # the whole batch in one threaded C++ call, straight into its buffer;
        # a file that call cannot read (length -1) sends the batch to the
        # Python reader, which reads more formats or says what is wrong
        native, native_lens = load_wav_batch_native(paths, S)
        if (native_lens >= 0).all():
            audio, audio_len[:] = native, native_lens
        else:
            wavs = [loader(p) for p in paths]
    elif io_pool is not None:
        wavs = list(io_pool.map(loader, paths))
    else:
        wavs = [loader(p) for p in paths]

    for i, e in enumerate(entries):
        if wavs is not None:
            n = min(len(wavs[i]), S)
            audio[i, :n] = wavs[i][:n]
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


class BatchPipeline:
    """Iterates fixed-shape batches over manifest entries.

    Within an epoch: entries are (optionally shuffled, with
    ``np.random.default_rng(seed + epoch)``) grouped by bucket; each bucket
    yields full ``batch_size`` batches, its final partial batch padded by
    repeating its last entry (``n_real`` real rows) unless ``drop_last``;
    the batch plan is then shuffled with ``seed + epoch + 10_000``."""

    def __init__(
        self,
        entries: Sequence[ManifestEntry],
        tokenizer,
        languages: Sequence[str],
        batch_size: int,
        spec: BucketSpec | None = None,
        pad_id: int = 0,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        loader: Callable[[str], np.ndarray] | None = None,
        num_io_threads: int = 8,
        prefetch: int = 2,
    ):
        self.entries = list(entries)
        self.tokenizer = tokenizer
        self.lang_index = {l: i for i, l in enumerate(languages)}
        self.batch_size = batch_size
        self.spec = spec or BucketSpec()
        self.pad_id = pad_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.loader = loader or load_audio
        self.num_io_threads = num_io_threads
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        buckets: dict[int, int] = {}
        for e in self.entries:
            b = self.spec.bucket_of(e.duration)
            buckets[b] = buckets.get(b, 0) + 1
        if self.drop_last:
            return sum(n // self.batch_size for n in buckets.values())
        return sum(-(-n // self.batch_size) for n in buckets.values())

    def _plan(self) -> list[tuple[int, int, list[ManifestEntry]]]:
        """[(bucket, n_real, entries)] for the current epoch."""
        order = list(self.entries)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        by_bucket: dict[int, list[ManifestEntry]] = {}
        for e in order:
            by_bucket.setdefault(self.spec.bucket_of(e.duration), []).append(e)
        plan = []
        for b, items in by_bucket.items():
            for i in range(0, len(items), self.batch_size):
                chunk = items[i:i + self.batch_size]
                n_real = len(chunk)
                if n_real < self.batch_size:
                    if self.drop_last:
                        continue
                    chunk = chunk + [chunk[-1]] * (self.batch_size - n_real)
                plan.append((b, n_real, chunk))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch + 10_000).shuffle(plan)
        return plan

    def __iter__(self) -> Iterator[Batch]:
        plan = self._plan()
        self._epoch += 1
        io_pool = cf.ThreadPoolExecutor(self.num_io_threads)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for b, n_real, chunk in plan:
                    with span("asr.data.assemble",
                              lambda: "B=%d S=%d U=%d" % (len(chunk), *self.spec.shapes(b))):
                        batch = _assemble(chunk, n_real, b, self.spec, self.tokenizer,
                                          self.lang_index, self.pad_id, self.loader,
                                          io_pool)
                    if not put(batch):
                        return
            except Exception as e:  # surfaced on the consumer's side
                put(e)
            finally:
                put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early must not leave the producer blocked
            stop.set()
            thread.join()
            io_pool.shutdown(wait=True)
