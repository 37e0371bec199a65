"""Manifest + annotation-dict handling.

The reference flows data as JSONL manifests with
``{audio_filepath, duration, text, lang}`` rows (written on the fly by
hybrid_rnnt_ctc_models.py:398-451 `_transcribe_input_manifest_processing`)
built from a pickled annotation dict shaped
``{split: {lang: {"audio": [...], "transcript": {basename: text},
"duration": {basename: sec}}}}`` (dataset_gen.ipynb). We keep both forms:
manifests are the interchange format; the annotation dict is a convenience
loader for IndicSUPERB-style trees.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Iterable, Iterator


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    audio_filepath: str
    duration: float
    text: str
    lang: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), ensure_ascii=False)


def write_manifest(path: str, entries: Iterable[ManifestEntry]) -> None:
    with open(path, "w") as f:
        for e in entries:
            f.write(e.to_json() + "\n")


def read_manifest(path: str) -> list[ManifestEntry]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(
                ManifestEntry(
                    audio_filepath=d["audio_filepath"],
                    duration=float(d.get("duration", 0.0)),
                    text=d.get("text", ""),
                    lang=d.get("lang", ""),
                )
            )
    return out


def entries_from_annotation(
    annotation: dict,
    split: str,
    lang: str,
    data_root: str = "",
    limit: int | None = None,
) -> list[ManifestEntry]:
    """Convert one (split, lang) slice of the annotation dict to entries.

    ``limit`` reproduces the reference's ``dataset.train_size`` subsetting
    (config.yaml:22 — e.g. 3000 train utterances per language per task).
    """
    slc = annotation[split][lang]
    audio = slc["audio"]
    transcripts = slc["transcript"]
    durations = slc.get("duration", {})
    out = []
    for path in audio[: limit if limit else None]:
        base = os.path.basename(path)
        out.append(
            ManifestEntry(
                audio_filepath=os.path.join(data_root, path),
                duration=float(
                    durations.get(base, 0.0)
                    if isinstance(durations, dict)
                    else 0.0
                ),
                text=transcripts[base],
                lang=lang,
            )
        )
    return out


def load_annotation(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def iter_manifest(path: str) -> Iterator[ManifestEntry]:
    yield from read_manifest(path)
