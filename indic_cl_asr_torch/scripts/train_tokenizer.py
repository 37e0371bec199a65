"""Train per-language BPE tokenizers from manifests into an aggregate
MultilingualTokenizer directory (stands in for the reference checkpoint's
embedded SentencePiece models when training from scratch).

Usage:
  python -m indic_cl_asr_torch.scripts.train_tokenizer --manifest_dir manifests \
      --out tokenizers --vocab_size 256 --kind bpe
"""

import argparse
import os

from ..data.manifest import read_manifest
from ..data.tokenizer import (
    BPETokenizer,
    CharTokenizer,
    MultilingualTokenizer,
)
from ..train.driver import LANGUAGES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab_size", type=int, default=256)
    ap.add_argument("--kind", choices=["bpe", "char"], default="bpe")
    ap.add_argument("--languages", nargs="*", default=LANGUAGES)
    args = ap.parse_args(argv)

    toks = {}
    for lang in args.languages:
        path = os.path.join(args.manifest_dir, f"{lang}_train.jsonl")
        corpus = [e.text for e in read_manifest(path) if e.text]
        if args.kind == "bpe":
            tok = BPETokenizer.train(corpus, args.vocab_size)
        else:
            tok = CharTokenizer.train(corpus)
        # pad to the exact vocab_size so every language slice is equal
        # (the multisoftmax heads require V_total = L * V_local)
        while tok.vocab_size < args.vocab_size:
            tok.vocab.append(f"<pad{tok.vocab_size}>")
        tok._piece_to_id = {p: i for i, p in enumerate(tok.vocab)}
        toks[lang] = tok
        print(f"{lang}: vocab {tok.vocab_size} from {len(corpus)} lines")
    agg = MultilingualTokenizer(toks)
    agg.save(args.out)
    print(f"aggregate vocab {agg.vocab_size} -> {args.out}/")
    return agg


if __name__ == "__main__":
    main()
