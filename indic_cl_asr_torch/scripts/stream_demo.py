"""Simulated-live streaming transcription of a WAV file.

Feeds a recording chunk by chunk through the cache-aware streaming stack
(models/streaming.py ``StreamingASR``: per-layer encoder caches and the
continuation of the batched greedy RNNT decode) and prints the incremental
hypothesis after every chunk, then one JSON line with the final text. The
port's counterpart of the JAX package's scripts/stream_demo.py:

    python -m indic_cl_asr_torch.scripts.stream_demo --run outputs/<run_id> \\
        --lang hindi utt.wav [--chunk_mel 64] [--device cpu]

The run must be a causal one (``--model.causal_conv true`` and
``--model.att_context_left A --model.att_context_right 0``), for which the
streamed tokens equal the offline greedy decode of the same mel. The mel
front-end is the offline one applied to the whole file (per-utterance
normalization); a live microphone needs a causal normalization.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..audio.features import FrontendConfig, log_mel_spectrogram
from ..audio.io import load_audio
from ..models.streaming import StreamingASR
from .transcribe import load_task_variables, restore_run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("wav", help="WAV file to stream")
    p.add_argument("--run", required=True, help="run dir (see transcribe.py)")
    p.add_argument("--task", default=None, help="idx:lang checkpoint pick")
    p.add_argument("--lang", default=None)
    p.add_argument("--chunk_mel", type=int, default=64,
                   help="mel frames per streaming chunk")
    p.add_argument("--quiet", action="store_true", help="print only the final line")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = p.parse_args(argv)

    model, model_cfg, tokenizer, languages, cfg, ckpt = restore_run(ns.run, ns.device)
    load_task_variables(ns.run, model, ns.task, ckpt)
    lang = ns.lang or languages[0]
    if lang not in languages:
        raise ValueError(f"--lang must be one of {languages}")
    dev = model.device
    lang_ids = torch.tensor([languages.index(lang)], dtype=torch.int32, device=dev)

    fe = FrontendConfig(n_mels=model_cfg.encoder.feat_in)
    audio = load_audio(ns.wav)
    with torch.inference_mode():
        mel, mel_lens = log_mel_spectrogram(
            torch.from_numpy(audio[None]).to(dev),
            torch.tensor([audio.shape[0]], dtype=torch.int32, device=dev), fe)
    T = int(mel_lens[0])
    C = ns.chunk_mel

    asr = StreamingASR(model, chunk_mel=C)
    state = asr.init(batch_size=1)
    text = ""
    n_chunks = -(-T // C)
    for i in range(n_chunks):
        lo = i * C
        chunk = mel[:, :, lo:lo + C]
        valid = min(C, T - lo)
        if chunk.shape[2] < C:  # final partial chunk: zero-pad
            chunk = torch.nn.functional.pad(chunk, (0, C - chunk.shape[2]))
        (tokens, lens), state = asr.step(
            state, chunk, lang_ids,
            valid_mel=torch.tensor([valid], dtype=torch.int32, device=dev))
        ids = tokens[0, : int(lens[0])].tolist()
        text = tokenizer.ids_to_text(ids, lang)
        if not ns.quiet:
            secs = (lo + valid) * fe.hop_length / fe.sample_rate
            print(f"[{secs:6.2f}s] {text}", flush=True)
    print(json.dumps({"audio_filepath": ns.wav, "lang": lang, "text": text,
                      "chunks": n_chunks}, ensure_ascii=False))
    return text


if __name__ == "__main__":
    main()
