"""Decode throughput of the flagship model, one JSON line a decoder (the
port's scripts/bench_eval.py).

Transcribes a batch of seeded noise with a seeded random flagship model
(bf16, flash attention) through the front end, the encoder and one RNNT
decoder, as the JAX script's timed function does:
  * labelsync  — label-looping greedy (ops/decoding.py)
  * framesync  — frame-synchronous greedy (ops/decoding.py)
  * fused      — the fused greedy kernel (ops/decode_fused.py)
  * beam       — the batched beam (ops/beam_search.py)
  * beam_fused — the fused beam kernel (ops/beam_fused.py)
A decoder named here runs that implementation (a kernel wrapper runs its
plain version on CPU tensors) or raises; nothing is re-routed. Each batch
is timed with ``utils/profiling.py:StepTimer.time_fn``, which waits for
the card after every batch; the kernels are built before.

Usage: python -m indic_cl_asr_torch.scripts.bench_eval [--batch 16]
       [--secs 8] [--iters 20] [--decoders labelsync,framesync,beam]
       [--beam_size 4] [--max_expansions 6] [--tiny] [--device cuda|cpu]
Prints one JSON line per decoder:
  {"metric": "eval_utts_per_sec", "decoder", "value", "batch_ms", "device"}
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..audio.features import FrontendConfig, log_mel_spectrogram
from ..device import resolve_device
from ..models.hybrid import HybridRNNTCTC, flagship_config, init_weights_, tiny_config
from ..ops import _build
from ..ops.beam_fused import rnnt_beam_search_fused
from ..ops.beam_search import rnnt_beam_search_batched
from ..ops.decode_fused import rnnt_greedy_decode_fused
from ..ops.decoding import rnnt_greedy_decode, rnnt_greedy_decode_labelsync
from ..utils.profiling import StepTimer

DECODERS = ("labelsync", "framesync", "fused", "beam", "beam_fused")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--secs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--decoders", default="labelsync,framesync,fused,beam,beam_fused",
        help="comma list of labelsync|framesync|fused|beam|beam_fused",
    )
    ap.add_argument("--beam_size", type=int, default=4)
    ap.add_argument("--max_expansions", type=int, default=6)
    ap.add_argument(
        "--tiny", action="store_true",
        help="tiny model (CPU smoke); default is the flagship",
    )
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    decoders = args.decoders.split(",")
    for d in decoders:
        if d not in DECODERS:
            raise ValueError(f"decoder {d!r}: one of {DECODERS}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _build.build()

    cfg = tiny_config() if args.tiny else flagship_config(attn_impl="flash")
    fe = FrontendConfig(n_mels=cfg.encoder.feat_in)
    model = init_weights_(HybridRNNTCTC(cfg, device=dev), torch.Generator().manual_seed(0))
    model.eval()
    B, S = args.batch, 16000 * args.secs
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((0.1 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    lang = torch.zeros((B,), dtype=torch.int32, device=dev)
    blank = cfg.blank_local

    def decode(decoder, f_proj, enc_lens):
        steps = (f_proj, enc_lens, lang, model.pred_step, model.joint_step, None)
        if decoder == "labelsync":
            return rnnt_greedy_decode_labelsync(*steps, blank=blank)
        if decoder == "framesync":
            return rnnt_greedy_decode(*steps, blank=blank)
        if decoder == "beam":
            return rnnt_beam_search_batched(*steps, blank=blank, beam_size=args.beam_size,
                                            max_expansions=args.max_expansions)[:2]
        if decoder == "fused":
            return rnnt_greedy_decode_fused(f_proj, enc_lens, lang, model)
        return rnnt_beam_search_fused(f_proj, enc_lens, lang, model, beam_size=args.beam_size,
                                      max_expansions=args.max_expansions)[:2]

    @torch.inference_mode()
    def transcribe(decoder):
        mel, mel_lens = log_mel_spectrogram(audio, lens, fe)
        f, enc_lens = model.encode(mel, mel_lens)
        return decode(decoder, model.joint_project_enc(f), enc_lens)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    for decoder in decoders:
        timing = StepTimer(warmup=1).time_fn(transcribe, decoder, iters=args.iters)
        dt = timing["mean_s"]
        rec = {"metric": "eval_utts_per_sec", "decoder": decoder, "value": round(B / dt, 2),
               "batch_ms": round(dt * 1000, 1), "device": name}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
