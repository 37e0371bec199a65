"""Tokenizers: trainable BPE / char subword models + multilingual aggregate.

The reference routes text through per-language SentencePiece models wrapped in
an aggregate tokenizer (reference: NeMo common/tokenizers/
multilingual_tokenizer.py:26-219 and parts/mixins/mixins.py:183-240). Its
observable contract, which we preserve exactly:

  * ``text_to_ids(text, lang)`` returns **local per-language ids** (the global
    offset add is disabled upstream, multilingual_tokenizer.py:104);
  * ``ids_to_text(ids, lang)`` decodes with the language's own tokenizer,
    joining pieces and mapping the SentencePiece word-boundary marker
    ``▁`` to a space;
  * the aggregate bookkeeping (``token_id_offset``, ``vocab_size`` = sum of
    per-language vocab sizes, ``langs_by_token_id``) still exists because the
    model's aggregate CTC/joint output dimensions are derived from it.

Because sentencepiece is not available here, per-language tokenizers are our
own implementations: a byte-of-character-level trainable BPE with the ``▁``
convention, and a char tokenizer. A SentencePiece adapter loads real models
when the library exists (gated import) so converted .nemo checkpoints keep
their original vocab.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterable

UNK = "<unk>"
WORD_BOUNDARY = "▁"  # ▁


def _words_with_boundary(text: str) -> list[str]:
    return [WORD_BOUNDARY + w for w in text.strip().split()]


class BPETokenizer:
    """SentencePiece-style BPE over characters with ▁ word markers.

    vocab[0] == <unk>; remaining entries are single characters then merged
    pieces, ordered by merge rank (deterministic given the corpus).
    """

    def __init__(self, vocab: list[str], merges: list[tuple[str, str]]):
        assert vocab and vocab[0] == UNK
        self.vocab = list(vocab)
        self.merges = [tuple(m) for m in merges]
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._piece_to_id = {p: i for i, p in enumerate(self.vocab)}

    # ---- training ----

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int) -> "BPETokenizer":
        word_freq: collections.Counter = collections.Counter()
        for line in corpus:
            for w in _words_with_boundary(line):
                word_freq[w] += 1

        # initial symbol inventory: single characters (incl. ▁-prefixed char
        # splitting: '▁word' -> ['▁', 'w', 'o', 'r', 'd'])
        words = {w: tuple(w) for w in word_freq}
        charset = sorted({c for w in words.values() for c in w})
        vocab = [UNK] + charset
        merges: list[tuple[str, str]] = []

        while len(vocab) < vocab_size:
            pair_freq: collections.Counter = collections.Counter()
            for w, sym in words.items():
                f = word_freq[w]
                for a, b in zip(sym, sym[1:]):
                    pair_freq[(a, b)] += f
            if not pair_freq:
                break
            # deterministic tie-break: frequency desc, then lexicographic
            (a, b), freq = max(
                pair_freq.items(), key=lambda kv: (kv[1], kv[0])
            )
            if freq < 2:
                break
            merges.append((a, b))
            vocab.append(a + b)
            merged = a + b
            new_words = {}
            for w, sym in words.items():
                out = []
                i = 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                new_words[w] = tuple(out)
            words = new_words
        return cls(vocab, merges)

    # ---- encode / decode ----

    def _encode_word(self, word: str) -> list[str]:
        sym = [c if c in self._piece_to_id else UNK for c in word]
        if len(sym) < 2:
            return sym
        while True:
            best_rank, best_i = None, None
            for i, pair in enumerate(zip(sym, sym[1:])):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                return sym
            sym[best_i : best_i + 2] = [sym[best_i] + sym[best_i + 1]]
            if len(sym) < 2:
                return sym

    def text_to_tokens(self, text: str) -> list[str]:
        toks: list[str] = []
        for w in _words_with_boundary(text):
            toks.extend(self._encode_word(w))
        return toks

    def text_to_ids(self, text: str) -> list[int]:
        return [
            self._piece_to_id.get(t, 0) for t in self.text_to_tokens(text)
        ]

    def ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.vocab[i] if 0 <= i < len(self.vocab) else UNK for i in ids]

    def ids_to_text(self, ids: Iterable[int]) -> str:
        return (
            "".join(self.ids_to_tokens(ids))
            .replace(WORD_BOUNDARY, " ")
            .strip()
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---- persistence ----

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"type": "bpe", "vocab": self.vocab, "merges": self.merges}, f,
                ensure_ascii=False,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(d["vocab"], [tuple(m) for m in d["merges"]])


class CharTokenizer:
    """Char-level tokenizer with the same piece conventions (▁ for space)."""

    def __init__(self, vocab: list[str]):
        assert vocab and vocab[0] == UNK
        self.vocab = list(vocab)
        self._piece_to_id = {p: i for i, p in enumerate(self.vocab)}

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 0) -> "CharTokenizer":
        chars = sorted(
            {c for line in corpus for w in _words_with_boundary(line) for c in w}
        )
        if vocab_size:
            chars = chars[: max(0, vocab_size - 1)]
        return cls([UNK] + chars)

    def text_to_tokens(self, text: str) -> list[str]:
        return [
            c if c in self._piece_to_id else UNK
            for w in _words_with_boundary(text)
            for c in w
        ]

    def text_to_ids(self, text: str) -> list[int]:
        return [self._piece_to_id.get(t, 0) for t in self.text_to_tokens(text)]

    def ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.vocab[i] if 0 <= i < len(self.vocab) else UNK for i in ids]

    def ids_to_text(self, ids: Iterable[int]) -> str:
        return (
            "".join(self.ids_to_tokens(ids))
            .replace(WORD_BOUNDARY, " ")
            .strip()
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "char", "vocab": self.vocab}, f,
                      ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(d["vocab"])


def load_tokenizer(path: str):
    with open(path) as f:
        d = json.load(f)
    if d["type"] == "bpe":
        return BPETokenizer(d["vocab"], [tuple(m) for m in d["merges"]])
    if d["type"] == "char":
        return CharTokenizer(d["vocab"])
    raise ValueError(f"unknown tokenizer type {d['type']!r}")


class SentencePieceTokenizer:
    """Adapter over a real SentencePiece ``.model`` file (for converted
    checkpoints). Backed by the pure-Python ModelProto reader in
    data/spm_model.py — no sentencepiece library dependency. Set
    backend="library" to use the sentencepiece package when it IS
    installed (useful for cross-checking the pure parser)."""

    def __init__(self, model_path: str, backend: str = "pure"):
        if backend == "library":
            import sentencepiece as spm

            self._sp = spm.SentencePieceProcessor(model_file=model_path)
            self.vocab = [
                self._sp.id_to_piece(i)
                for i in range(self._sp.get_piece_size())
            ]
            self._pure = None
        else:
            from .spm_model import SpmModel

            self._pure = SpmModel.load(model_path)
            self._sp = None
            self.vocab = list(self._pure.pieces)

    def text_to_ids(self, text: str) -> list[int]:
        if self._pure is not None:
            return self._pure.encode_ids(text)
        return self._sp.encode(text, out_type=int)

    def text_to_tokens(self, text: str) -> list[str]:
        if self._pure is not None:
            return self._pure.encode_pieces(text)
        return self._sp.encode(text, out_type=str)

    def ids_to_tokens(self, ids) -> list[str]:
        return [self.vocab[int(i)] for i in ids]

    def ids_to_text(self, ids) -> str:
        if self._pure is not None:
            return self._pure.decode_ids(ids)
        return self._sp.decode([int(i) for i in ids])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class MultilingualTokenizer:
    """Aggregate of ordered per-language tokenizers.

    Contract preserved from the reference (multilingual_tokenizer.py):
    local-id encode, per-language decode, offset bookkeeping for the
    aggregate vocab the model heads are sized from.
    """

    def __init__(self, tokenizers: dict[str, object]):
        self.tokenizers_dict = dict(tokenizers)
        self.token_id_offset: dict[str, int] = {}
        self.vocabulary: list[str] = []
        offset = 0
        for lang, tok in self.tokenizers_dict.items():
            self.token_id_offset[lang] = offset
            offset += tok.vocab_size
            self.vocabulary.extend(tok.vocab)
        self.vocab_size = len(self.vocabulary)
        self.langs_by_token_id = {}
        for lang in self.tokenizers_dict:
            lo = self.token_id_offset[lang]
            hi = lo + self.tokenizers_dict[lang].vocab_size
            for i in range(lo, hi):
                self.langs_by_token_id[i] = lang

    @property
    def langs(self) -> list[str]:
        return list(self.tokenizers_dict.keys())

    @property
    def vocab(self) -> list[str]:
        return self.vocabulary

    def text_to_ids(self, text: str, lang: str) -> list[int]:
        # local per-language ids — reference behavior (offset add disabled,
        # multilingual_tokenizer.py:104)
        return self.tokenizers_dict[lang].text_to_ids(text)

    def text_to_tokens(self, text: str, lang: str) -> list[str]:
        return self.tokenizers_dict[lang].text_to_tokens(text)

    def ids_to_text(self, ids, lang: str) -> str:
        return self.tokenizers_dict[lang].ids_to_text(list(ids))

    def ids_to_tokens(self, ids, lang: str) -> list[str]:
        return self.tokenizers_dict[lang].ids_to_tokens(list(ids))

    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        index = {"langs": self.langs}
        for lang, tok in self.tokenizers_dict.items():
            tok.save(os.path.join(dirpath, f"{lang}.json"))
        with open(os.path.join(dirpath, "index.json"), "w") as f:
            json.dump(index, f)

    @classmethod
    def load(cls, dirpath: str) -> "MultilingualTokenizer":
        with open(os.path.join(dirpath, "index.json")) as f:
            index = json.load(f)
        toks = {
            lang: load_tokenizer(os.path.join(dirpath, f"{lang}.json"))
            for lang in index["langs"]
        }
        return cls(toks)
