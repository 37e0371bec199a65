"""Build the IndicSUPERB annotation dict + manifests from the raw tree.

Script equivalent of the reference's dataset_gen.ipynb: walks the
kb_data_clean_m4a / kb_data_noisy_m4a layout and produces, per language
(dataset_gen.ipynb cell 2 split sizes):

  train      = first 6200 clean train utts  + first 1000 noisy test utts
  val        = clean train utts 6200:6400   (clean val dir is empty)
  noisy_val  = noisy test utts 1200:1400
  test       = first 200 clean test utts
  noisy_test = noisy test utts 1000:1200

Outputs both the pickled annotation dict consumed by
--dataset.annotation_path and per-language JSONL manifests
({lang}_{split}.jsonl) for --dataset.manifest_dir.

Usage:
  python -m indic_cl_asr_torch.scripts.dataset_gen --root /data/indicsuperb \
      --out dataset.pkl --manifest_dir manifests

Expected raw layout (paths relative to --root, reference notebook cell 0):
  train_audio/kb_data_clean_m4a/<lang>/train/audio/*.m4a
  testkn_audio/kb_data_clean_m4a/<lang>/test_known/audio/*.m4a
  transcripts_n2w/kb_data_clean_m4a/<lang>/<split>/transcription_n2w.txt
  noisy/testkn_audio/kb_data_noisy_m4a/<lang>/test_known/audio/*.m4a
  noisy/kb_data_noisy_m4a/<lang>/test_known/transcription_n2w.txt
"""

import argparse
import glob
import os
import pickle

from ..data.manifest import ManifestEntry, write_manifest
from ..train.driver import LANGUAGES


def read_transcripts(path: str) -> dict[str, str]:
    """transcription_n2w.txt lines: `<basename><tab or space><text>`."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t") if "\t" in line else line.split(" ", 1)
            if len(parts) == 2:
                out[os.path.basename(parts[0])] = parts[1].strip()
    return out


def list_audio(d: str) -> list[str]:
    return sorted(
        glob.glob(os.path.join(d, "*.m4a"))
        + glob.glob(os.path.join(d, "*.wav"))
    )


def build(root: str, languages: list[str]) -> dict:
    ann = {
        s: {} for s in ("train", "val", "test", "noisy_val", "noisy_test")
    }
    for lang in languages:
        clean_train = list_audio(
            os.path.join(root, "train_audio/kb_data_clean_m4a", lang,
                         "train/audio")
        )
        clean_test = list_audio(
            os.path.join(root, "testkn_audio/kb_data_clean_m4a", lang,
                         "test_known/audio")
        )
        noisy_test = list_audio(
            os.path.join(root, "noisy/testkn_audio/kb_data_noisy_m4a", lang,
                         "test_known/audio")
        )
        tr_train = read_transcripts(
            os.path.join(root, "transcripts_n2w/kb_data_clean_m4a", lang,
                         "train/transcription_n2w.txt")
        )
        tr_test = read_transcripts(
            os.path.join(root, "transcripts_n2w/kb_data_clean_m4a", lang,
                         "test_known/transcription_n2w.txt")
        )
        tr_noisy = read_transcripts(
            os.path.join(root, "noisy/kb_data_noisy_m4a", lang,
                         "test_known/transcription_n2w.txt")
        )

        def slc(split, audio, transcripts):
            ann[split][lang] = {
                "audio": [os.path.relpath(a, root) for a in audio],
                "transcript": {
                    os.path.basename(a): transcripts.get(
                        os.path.basename(a), ""
                    )
                    for a in audio
                },
                "duration": {},
            }

        # reference split sizes (dataset_gen.ipynb cell 2)
        slc("train", clean_train[:6200] + noisy_test[:1000],
            {**tr_train, **tr_noisy})
        slc("val", clean_train[6200:6400], tr_train)
        slc("noisy_val", noisy_test[1200:1400], tr_noisy)
        slc("test", clean_test[:200], tr_test)
        slc("noisy_test", noisy_test[1000:1200], tr_noisy)
    return ann


def write_manifests(ann: dict, root: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for split, langs in ann.items():
        for lang, slc in langs.items():
            entries = [
                ManifestEntry(
                    audio_filepath=os.path.join(root, rel),
                    duration=0.0,
                    text=slc["transcript"].get(os.path.basename(rel), ""),
                    lang=lang,
                )
                for rel in slc["audio"]
            ]
            write_manifest(
                os.path.join(out_dir, f"{lang}_{split}.jsonl"), entries
            )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default="dataset.pkl")
    ap.add_argument("--manifest_dir", default=None)
    ap.add_argument("--languages", nargs="*", default=LANGUAGES)
    args = ap.parse_args(argv)
    ann = build(args.root, args.languages)
    with open(args.out, "wb") as f:
        pickle.dump(ann, f)
    if args.manifest_dir:
        write_manifests(ann, args.root, args.manifest_dir)
    for split in ann:
        sizes = {l: len(v["audio"]) for l, v in ann[split].items()}
        print(split, sizes)
    return ann


if __name__ == "__main__":
    main()
