"""Transcription + evaluation harness (PyTorch port of train/eval.py).

  wav batch -> log-mel (eval, no dither) -> Conformer encode
  -> greedy RNNT (the fused kernel, frame-sync or label-looping), greedy
     CTC, or a beam (batched RNNT beam, host Graves beam, CTC prefix beam)
  -> host detokenization -> aggregate WER

Metric names match the reference
(``{val|test}/perf_{lang}_{rnnt|ctc}_{wer|noisy_wer|avg_wer}``).

``greedy_impl``: ``"auto"`` picks the fused kernel on a CUDA model with a
single-layer LSTM, the relu joint and widths the kernel takes
(``ops/decode_fused.fits``), label-looping on any other CUDA model (a
deeper prediction net, a tanh or sigmoid joint, widths that are not whole
16-byte groups), and frame-sync on the CPU (``resolve_decoders``);
``"fused"`` forces the kernel wrapper (on the CPU it runs its plain
version); ``"framesync"`` that plain version, a batched Python-loop
decoder, on any device; ``"labelsync"`` the label-looping decoder
(``labelsync_window`` frames a round), plain PyTorch on any device. The
kernel picks each row's own language head, so a mixed-language batch
takes it too.

``beam_impl`` (decoder ``"rnnt_beam"``): ``"auto"`` picks the fused beam
kernel on a CUDA model where the greedy kernel's conditions hold and the
kernel takes the beam size (``ops/beam_fused.fits``: 1-8), and the
batched beam otherwise (``"xla"``, the JAX package's name for it);
``"fused"`` forces the kernel wrapper. Both take ``max_symbols`` as their
expansion rounds per frame. An explicit ``"fused"`` that its kernel would
refuse (a deeper prediction net, another joint activation, such widths
or beam size) raises at construction. ``"rnnt_beam_host"`` (the per-utterance Graves beam
on the encoder's projections) and ``"ctc_beam"`` (prefix beam search on
the CTC log-probs) run on the host, one real row at a time.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import wave
from typing import Sequence

import torch

from ..audio.features import FrontendConfig, log_mel_spectrogram
from ..audio.io import load_audio
from ..data.manifest import ManifestEntry
from ..data.pipeline import BucketSpec, _assemble
from ..ops import beam_fused, decode_fused
from ..ops.beam_fused import rnnt_beam_search_fused, rnnt_beam_search_fused_reference
from ..ops.beam_search import ctc_prefix_beam_search, rnnt_beam_search
from ..ops.decode_fused import (
    rnnt_greedy_decode_fused,
    rnnt_greedy_decode_fused_reference,
)
from ..ops.decoding import ctc_greedy_decode, rnnt_greedy_decode_labelsync
from ..utils.profiling import span
from .metrics import wer

DECODERS = ("rnnt", "ctc", "rnnt_beam", "rnnt_beam_host", "ctc_beam")


def resolve_decoders(greedy_impl: str, beam_impl: str, device: torch.device,
                     pred_rnn_layers: int, joint_activation: str = "relu", *,
                     beam_size: int = 4, topk: int | None = None,
                     dtype: torch.dtype = torch.float32, pred_hidden: int = 640,
                     joint_hidden: int = 640, n_classes: int = 257) -> tuple[str, str]:
    """``"auto"`` greedy and beam choices from the device, the model's
    config and the search, as the JAX package makes them: on a CUDA model
    each fused kernel where it takes the model and the search (a
    single-layer LSTM, the relu joint, and what ``ops/decode_fused.fits``
    and ``ops/beam_fused.fits`` allow: the widths in ``dtype``, the beam
    size and top-K against ``n_classes`` = V+1), label-looping greedy and
    the batched ("xla") beam wherever it does not; frame-sync greedy and
    the batched beam on the CPU. Other values pass through, and an
    explicit ``"fused"`` the kernel would refuse raises ``ValueError``."""
    cuda = device.type == "cuda"
    greedy_fits = decode_fused.fits(pred_hidden, joint_hidden, dtype)
    beam_fits = beam_fused.fits(beam_size, topk, n_classes, pred_hidden, joint_hidden, dtype)
    model_fits = pred_rnn_layers == 1 and joint_activation == "relu"
    if greedy_impl == "auto":
        greedy_impl = ("fused" if model_fits and greedy_fits else "labelsync") if cuda else "framesync"
    if beam_impl == "auto":
        beam_impl = "fused" if cuda and model_fits and beam_fits else "xla"
    for what, impl, fits, other in (("greedy", greedy_impl, greedy_fits, "labelsync"),
                                    ("beam", beam_impl, beam_fits, "xla")):
        if impl != "fused":
            continue
        if pred_rnn_layers != 1:
            raise ValueError(
                f"the fused {what} takes a single-layer LSTM, the model has "
                f"{pred_rnn_layers}: use {what}_impl=\"{other}\""
            )
        if joint_activation != "relu":
            raise ValueError(
                f"the fused {what} takes the relu joint, the model's is "
                f"{joint_activation!r}: use {what}_impl=\"{other}\""
            )
        if not fits:
            raise ValueError(
                f"the fused {what} refuses widths {pred_hidden}, {joint_hidden} in {dtype} "
                f"(beam_size {beam_size}, topk {topk}, {n_classes} classes): "
                f"use {what}_impl=\"{other}\""
            )
    return greedy_impl, beam_impl


@dataclasses.dataclass
class Transcriber:
    """Batched transcription with a HybridRNNTCTC on its own device."""

    model: torch.nn.Module
    tokenizer: object
    languages: Sequence[str]
    frontend: FrontendConfig = FrontendConfig()
    batch_size: int = 16
    bucket_spec: BucketSpec | None = None
    max_symbols: int = 10
    max_out: int = 256
    beam_size: int = 4
    greedy_impl: str = "auto"  # "auto" | "fused" | "framesync" | "labelsync"
    beam_impl: str = "auto"    # "auto" | "fused" | "xla"
    labelsync_window: int = 32

    def __post_init__(self):
        cfg = self.model.cfg
        self.device = self.model.device
        self.greedy_impl, self.beam_impl = resolve_decoders(
            self.greedy_impl, self.beam_impl, self.device, cfg.pred_rnn_layers,
            cfg.joint_activation, beam_size=self.beam_size, dtype=cfg.dtype,
            pred_hidden=cfg.pred_hidden, joint_hidden=cfg.joint_hidden,
            n_classes=cfg.vocab_per_lang + 1,
        )
        if self.greedy_impl not in ("fused", "framesync", "labelsync"):
            raise ValueError(f"greedy_impl={self.greedy_impl!r}")
        if self.beam_impl not in ("fused", "xla"):
            raise ValueError(f"beam_impl={self.beam_impl!r}")
        if self.frontend.n_mels != cfg.encoder.feat_in:
            raise ValueError("front-end mel bins must match encoder feat_in")
        # batches encoded, and batches run per decoder
        self.counts: collections.Counter = collections.Counter()

    @torch.inference_mode()
    def _encode(self, audio, audio_len, n_real: int):
        """Log-mel and encoder of a batch whose first ``n_real`` rows are
        real (the span's ``real``; the rest repeat a row to fill it)."""
        with span("asr.eval.encode",
                  lambda: f"B={audio.shape[0]} real={n_real} S={audio.shape[1]}"):
            self.model.eval()  # a training step leaves the model in train mode
            mel, mel_lens = log_mel_spectrogram(audio, audio_len, self.frontend)
            self.counts["encoder_batches"] += 1
            return self.model.encode(mel, mel_lens)

    @torch.inference_mode()
    def decode_batch(self, audio, audio_len, lang_ids, decoder: str, n_real: int | None = None):
        """Device tensors of one batch -> the token ids of its first
        ``n_real`` rows (every row by default), one list per row."""
        model = self.model
        blank = model.cfg.blank_local
        n_real = len(lang_ids) if n_real is None else n_real
        f, enc_lens = self._encode(audio, audio_len, n_real)
        self.counts[f"{decoder}_batches"] += 1
        if decoder == "ctc_beam":
            lp = model.ctc_logprobs(f, lang_ids).float().cpu().numpy()
            n = enc_lens.cpu().tolist()
            return [ctc_prefix_beam_search(lp[r], n[r], blank, beam_size=self.beam_size)
                    for r in range(n_real)]
        if decoder == "ctc":
            ids, lens = ctc_greedy_decode(model.ctc_logprobs(f, lang_ids), enc_lens, blank)
        else:
            f_proj = model.joint_project_enc(f)
            if decoder == "rnnt_beam_host":
                n, langs = enc_lens.cpu().tolist(), lang_ids.cpu().tolist()
                return [rnnt_beam_search(f_proj[r], n[r], langs[r], model.pred_step,
                                         model.joint_step, blank=blank,
                                         beam_size=self.beam_size,
                                         max_expansions=self.max_symbols)
                        for r in range(n_real)]
            if decoder == "rnnt_beam":
                beam = (rnnt_beam_search_fused if self.beam_impl == "fused"
                        else rnnt_beam_search_fused_reference)
                ids, lens, _ = beam(f_proj, enc_lens, lang_ids, model,
                                    beam_size=self.beam_size,
                                    max_expansions=self.max_symbols, max_out=self.max_out)
            elif self.greedy_impl == "labelsync":
                ids, lens = rnnt_greedy_decode_labelsync(
                    f_proj, enc_lens, lang_ids, model.pred_step, model.joint_step, None,
                    blank=blank, max_symbols=self.max_symbols, max_out=self.max_out,
                    window=self.labelsync_window,
                )
            else:
                greedy = (rnnt_greedy_decode_fused if self.greedy_impl == "fused"
                          else rnnt_greedy_decode_fused_reference)
                ids, lens = greedy(f_proj, enc_lens, lang_ids, model,
                                   max_symbols=self.max_symbols, max_out=self.max_out)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        return [ids[r, : lens[r]].tolist() for r in range(n_real)]

    def transcribe(
        self, entries: Sequence[ManifestEntry], decoder: str = "rnnt"
    ) -> list[str]:
        """Entries -> hypothesis strings (original entry order)."""
        if decoder not in DECODERS:
            raise ValueError(f"decoder={decoder!r}: one of {DECODERS}")
        spec = self.bucket_spec or BucketSpec()
        lang_index = {l: i for i, l in enumerate(self.languages)}
        by_bucket: dict[int, list[int]] = {}
        for i, e in enumerate(entries):
            by_bucket.setdefault(spec.bucket_of(e.duration), []).append(i)

        hyps: list[str] = [""] * len(entries)
        dev = self.device
        with cf.ThreadPoolExecutor(8) as io_pool:
            for bucket, idxs in by_bucket.items():
                for i0 in range(0, len(idxs), self.batch_size):
                    chunk_idx = idxs[i0 : i0 + self.batch_size]
                    n_real = len(chunk_idx)
                    padded = chunk_idx + [chunk_idx[-1]] * (self.batch_size - n_real)
                    with span("asr.eval.assemble",
                              lambda: "B=%d S=%d" % (len(padded), spec.shapes(bucket)[0])):
                        batch = _assemble(
                            [entries[j] for j in padded], n_real, bucket, spec,
                            self.tokenizer, lang_index, 0, load_audio, io_pool,
                        )
                        audio = torch.from_numpy(batch.audio).to(dev)
                        audio_len = torch.from_numpy(batch.audio_len).to(dev)
                        lang_ids = torch.from_numpy(batch.lang_ids).to(dev)
                    rows = self.decode_batch(audio, audio_len, lang_ids, decoder, n_real)
                    del audio, audio_len, lang_ids  # off the card before the next batch's copies
                    with span("asr.eval.detokenize"):
                        for row in range(n_real):
                            hyps[chunk_idx[row]] = self.tokenizer.ids_to_text(
                                rows[row], batch.langs[row]
                            )
        return hyps

    def transcribe_files(
        self, audio_paths: Sequence[str], language: str, decoder: str = "rnnt"
    ) -> list[str]:
        """Path-level API (the reference's ``model.transcribe(audio,
        batch_size, language_id)``); durations come from the WAV headers."""
        entries = []
        for p in audio_paths:
            try:
                with wave.open(p, "rb") as w:
                    dur = w.getnframes() / w.getframerate()
            except (wave.Error, EOFError, OSError):
                dur = 0.0  # not a WAV: decoded by ffmpeg, first bucket
            entries.append(
                ManifestEntry(audio_filepath=p, duration=dur, text="", lang=language)
            )
        return self.transcribe(entries, decoder)

    def compute_wer(
        self, entries: Sequence[ManifestEntry], decoder: str = "rnnt"
    ) -> float:
        hyps = self.transcribe(entries, decoder)
        with span("asr.eval.wer"):
            return wer([e.text for e in entries], hyps)


def run_eval(
    logger,
    type_: str,
    transcriber: Transcriber,
    clean_entries: Sequence[ManifestEntry],
    noisy_entries: Sequence[ManifestEntry],
    epoch: int,
    curr_lang_idx: int,
    lang: str,
) -> dict:
    """Per-(split, lang) eval over both greedy decoders — reference
    utils.py:151-174 ``run_eval``, identical metric keys."""
    perf = {}
    log_dict = {}
    for mode in ("rnnt", "ctc"):
        val = transcriber.compute_wer(clean_entries, mode)
        noisy = transcriber.compute_wer(noisy_entries, mode)
        perf[f"{mode}_wer"] = val
        perf[f"{mode}_noisy_wer"] = noisy
        perf[f"{mode}_avg_wer"] = (val + noisy) / 2
        log_dict[f"{type_}/perf_{lang}_{mode}_wer"] = val
        log_dict[f"{type_}/perf_{lang}_{mode}_noisy_wer"] = noisy
        log_dict[f"{type_}/perf_{lang}_{mode}_avg_wer"] = perf[f"{mode}_avg_wer"]
    log_dict["epoch"] = epoch
    log_dict["lang"] = curr_lang_idx
    if logger is not None:
        logger.log(log_dict)
    return perf
