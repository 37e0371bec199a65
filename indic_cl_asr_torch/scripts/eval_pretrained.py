"""Evaluate a pretrained ``.nemo`` checkpoint: RNNT and CTC WER.

The port's counterpart of the JAX package's scripts/eval_pretrained.py,
the one-command check against the reference's pretrained
``ai4bharat/indicconformer_stt_hi_hybrid_rnnt_large`` (cl_baseline.py:122
from_pretrained -> utils.py:120-174 compute_wer/run_eval):

    # a .nemo on disk, on the card
    python -m indic_cl_asr_torch.scripts.eval_pretrained --nemo model.nemo \\
        --dataset.manifest_dir manifests/ --n_langs 1 --split test

    # on the CPU
    python -m indic_cl_asr_torch.scripts.eval_pretrained --nemo model.nemo \\
        --dataset.manifest_dir manifests/ --n_langs 1 --device cpu

``--nemo`` (or ``NEMO_PATH``) names the artifact; ``--hf <repo_id>``
downloads it (needs ``huggingface_hub`` and the network). The languages
and manifests come from the config as in the CL drivers
(``{lang}_{split}.jsonl`` for the first ``n_langs`` of the config's
languages); each row takes the head of its language's position in that
list, and its text is decoded by the tokenizer under the manifest's
language key. ``--local_tokenizer`` (a ``MultilingualTokenizer.save``
directory) replaces the checkpoint's SentencePiece models.

Prints one JSON line per (lang, decoder): {"lang", "decoder", "split",
"wer", "n"}, then a summary line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from ..audio.features import FrontendConfig
from ..data.pipeline import BucketSpec
from ..data.tokenizer import MultilingualTokenizer
from ..models.nemo_ingest import download_from_hf, restore_pretrained
from ..train.eval import Transcriber
from ._common import build_data, build_languages, setup


def main(argv=None):
    cfg, ns = setup(
        argv,
        notes_default="eval_pretrained",
        extra_args={
            "nemo": {"type": str, "default": None},
            "hf": {"type": str, "default": None},
            "split": {"type": str, "default": "test"},
            "decoder": {"type": str, "default": None},
            "beam_size": {"type": int, "default": 4},
            "spm_out_dir": {"type": str, "default": None},
            "local_tokenizer": {"type": str, "default": None},
        },
    )
    nemo_path = ns.nemo or os.environ.get("NEMO_PATH")
    if not nemo_path and ns.hf:
        nemo_path = download_from_hf(ns.hf)
    if not nemo_path:
        raise SystemExit("--nemo <path> or --hf <repo_id> required")

    work_dir = ns.spm_out_dir or tempfile.mkdtemp(prefix="nemo_tok_")
    local_tok = ns.local_tokenizer
    model, model_cfg, tokenizer = restore_pretrained(
        nemo_path, work_dir, with_tokenizer=not local_tok, device=ns.device)
    if local_tok:
        tokenizer = MultilingualTokenizer.load(local_tok)
    print(f"# restored {nemo_path}: {model_cfg.encoder.n_layers} layers, d_model "
          f"{model_cfg.encoder.d_model}, vocab {model_cfg.vocab_size_total} x "
          f"{model_cfg.n_langs} langs", file=sys.stderr)

    languages = build_languages(cfg)
    data = build_data(cfg, languages)
    split = ns.split
    decoders = [ns.decoder] if ns.decoder else ["rnnt", "ctc"]
    tr = Transcriber(
        model=model, tokenizer=tokenizer, languages=languages,
        frontend=FrontendConfig(n_mels=model_cfg.encoder.feat_in),
        batch_size=cfg.get("batch_size", 16), bucket_spec=BucketSpec(),
        beam_size=ns.beam_size,
    )

    results = []
    for lang in languages:
        td = data[lang]
        entries = {"val": td.val_clean, "test": td.test_clean,
                   "noisy_val": td.val_noisy, "noisy_test": td.test_noisy}[split]
        for dec in decoders:
            w = tr.compute_wer(entries, dec)
            rec = {"lang": lang, "decoder": dec, "split": split,
                   "wer": round(float(w), 4), "n": len(entries)}
            results.append(rec)
            print(json.dumps(rec), flush=True)
    if results:
        avg = sum(r["wer"] for r in results) / len(results)
        print(json.dumps({"summary_avg_wer": round(avg, 4), "n_evals": len(results)}))
    return results


if __name__ == "__main__":
    main()
