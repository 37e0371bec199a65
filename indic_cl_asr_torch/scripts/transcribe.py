"""Transcribe WAV files or a manifest with a trained run or a ``.nemo``.

The user-facing CLI over ``train/eval.py:Transcriber``, the port's
counterpart of the JAX package's scripts/transcribe.py (the reference's
``model.transcribe(audio, batch_size, language_id)``,
hybrid_rnnt_ctc_models.py:262-346). Runs are self-contained: every driver
writes config.json, tokenizer/ and sequence/task_<i>_<lang>.pt into its
run directory (scripts/_common.py:build_all), so this needs only that:

    # latest task checkpoint of a CL run, greedy RNNT, on the card
    python -m indic_cl_asr_torch.scripts.transcribe --run outputs/<run_id> \\
        --lang hindi utt1.wav utt2.wav

    # a specific task checkpoint, CTC decoder, manifest input + WER, CPU
    python -m indic_cl_asr_torch.scripts.transcribe --run outputs/<run_id> \\
        --task 0:hindi --decoder ctc --manifest test.jsonl --wer --device cpu

    # a pretrained NeMo artifact instead of a run (its languages are the
    # checkpoint's tokenizer keys: hi, bn, ...)
    python -m indic_cl_asr_torch.scripts.transcribe --nemo model.nemo \\
        --lang hi utt.wav

Prints one JSON line per utterance: {"audio_filepath", "lang", "text"}
(+ "ref" when the manifest carries transcripts), then a summary line
with the WER when --wer is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import wave

from ..audio.features import FrontendConfig
from ..data.manifest import ManifestEntry, read_manifest
from ..data.pipeline import BucketSpec
from ..data.tokenizer import MultilingualTokenizer
from ..device import resolve_device
from ..models.hybrid import HybridRNNTCTC
from ..models.nemo_ingest import restore_pretrained
from ..train.eval import DECODERS, Transcriber
from ..train.metrics import wer
from ..utils.checkpoint import SequenceCheckpointer, load_model
from ..utils.config import ConfigDict
from ._common import build_languages, build_model_cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("wavs", nargs="*", help="WAV files to transcribe")
    p.add_argument("--run", help="run directory written by a driver")
    p.add_argument("--nemo", help="pretrained .nemo artifact instead")
    p.add_argument(
        "--task", default=None,
        help="which sequence checkpoint, as idx:lang (default: latest)",
    )
    p.add_argument("--lang", default=None, help="language id for routing")
    p.add_argument("--manifest", help="manifest JSONL instead of WAV args")
    p.add_argument("--decoder", default="rnnt", choices=list(DECODERS))
    p.add_argument("--beam_size", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--wer", action="store_true",
                   help="score against manifest transcripts")
    p.add_argument("--out", default=None, help="also write JSONL here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def restore_run(run_dir: str, device=None):
    """Rebuild (model, model_cfg, tokenizer, languages, cfg, checkpointer)
    from a self-contained run directory; the model's weights come from
    ``load_task_variables``."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = ConfigDict(json.load(f))
    tokenizer = MultilingualTokenizer.load(os.path.join(run_dir, "tokenizer"))
    languages = build_languages(cfg)
    model_cfg = build_model_cfg(cfg, tokenizer, languages)
    model = HybridRNNTCTC(model_cfg, device=resolve_device(device))
    ckpt = SequenceCheckpointer(os.path.join(run_dir, "sequence"))
    return model, model_cfg, tokenizer, languages, cfg, ckpt


def load_task_variables(run_dir, model, task: str | None, ckpt):
    """Load the parameters and BatchNorm statistics of task ``idx:lang``
    (the latest completed task by default) into ``model``."""
    if task:
        idx_s, lang = task.split(":", 1)
        idx = int(idx_s)
    else:
        latest = ckpt.latest_task()
        assert latest is not None, (
            f"no completed tasks in {run_dir}/sequence — pass --task or train first"
        )
        idx, lang = latest
    load_model(os.path.join(run_dir, "sequence", f"task_{idx}_{lang}.pt"), model)
    print(f"# restored task {idx} ({lang})", file=sys.stderr)
    return model


def main(argv=None):
    ns = parse_args(argv)
    assert ns.run or ns.nemo, "--run <dir> or --nemo <path> required"
    assert ns.wavs or ns.manifest, "give WAV files or --manifest"

    if ns.run:
        model, model_cfg, tokenizer, languages, cfg, ckpt = restore_run(ns.run, ns.device)
        load_task_variables(ns.run, model, ns.task, ckpt)
    else:
        work = tempfile.mkdtemp(prefix="nemo_tok_")
        model, model_cfg, tokenizer = restore_pretrained(ns.nemo, work, device=ns.device)
        languages = list(tokenizer.langs)

    if ns.manifest:
        entries = read_manifest(ns.manifest)
        if ns.lang:
            entries = [e for e in entries if e.lang == ns.lang] or entries
    else:
        lang = ns.lang or languages[0]
        assert lang in languages, f"--lang must be one of {languages}"
        entries = []
        for p in ns.wavs:
            try:
                with wave.open(p, "rb") as w:
                    dur = w.getnframes() / w.getframerate()
            except (wave.Error, EOFError, OSError):
                dur = 0.0
            entries.append(ManifestEntry(audio_filepath=p, duration=dur, text="", lang=lang))

    tr = Transcriber(
        model=model, tokenizer=tokenizer, languages=languages,
        frontend=FrontendConfig(n_mels=model_cfg.encoder.feat_in),
        batch_size=ns.batch_size, bucket_spec=BucketSpec(), beam_size=ns.beam_size,
    )
    hyps = tr.transcribe(entries, ns.decoder)

    sink = open(ns.out, "w") if ns.out else None
    for e, h in zip(entries, hyps):
        rec = {"audio_filepath": e.audio_filepath, "lang": e.lang, "text": h}
        if e.text:
            rec["ref"] = e.text
        line = json.dumps(rec, ensure_ascii=False)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
    if sink:
        sink.close()

    if ns.wer:
        w = wer([e.text for e in entries], hyps)
        print(json.dumps({"wer": round(float(w), 4), "n": len(entries),
                          "decoder": ns.decoder}))
    return hyps


if __name__ == "__main__":
    main()
