"""Pure-Python SentencePiece inference (encode/decode from a
``tokenizer.model`` ModelProto): the port's own copy of anyref_tpu/sp.py.

The reference's LLaVA-Lightning checkpoint layout ships only the
SentencePiece ``tokenizer.model`` (reference train.py:58-62). Loading it
through HF's slow tokenizer needs the ``sentencepiece`` package, which the
port does not depend on, so this module implements the inference side:

  * ModelProto wire-format parsing (pieces + scores + types, trainer_spec
    model_type / byte_fallback / unk_id, normalizer_spec add_dummy_prefix /
    remove_extra_whitespaces / escape_whitespaces);
  * unigram encoding via Viterbi segmentation (max sum of piece scores);
  * BPE encoding via best-scoring adjacent-pair merges (LLaMA's
    ``tokenizer.model`` is a SentencePiece BPE model);
  * byte fallback (``<0xXX>`` pieces) for out-of-vocab characters;
  * decoding with byte-piece reassembly and whitespace unescaping.

Training-side features (normalization charsmaps beyond whitespace
escaping, sampling/nbest segmentation) are out of scope: LLaMA's
normalizer is the identity charsmap, and inference here is deterministic
Viterbi/greedy exactly like ``sentencepiece``'s default ``encode``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

_WS = "▁"  # ▁ (LOWER ONE EIGHTH BLOCK), SentencePiece's space escape

# SentencePiece.Type enum (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
_UNIGRAM, _BPE = 1, 2


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class SentencePieceModel:
    """Inference-only SentencePiece model. Matches the ``base`` interface
    ``AnyRefTokenizer`` expects (``encode(text, add_special_tokens=False)``
    returning base-vocab ids, ``decode(ids)``)."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 model_type: int = _BPE, byte_fallback: bool = False,
                 unk_id: int = 0, add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = True,
                 escape_whitespaces: bool = True):
        self.pieces = pieces
        self.model_type = model_type
        self.byte_fallback = byte_fallback
        self.unk_id = unk_id
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        # piece -> (id, score); CONTROL/UNUSED pieces are never produced by
        # text matching (sentencepiece treats them as meta pieces)
        self.vocab: Dict[str, Tuple[int, float]] = {}
        self.byte_ids: Dict[int, int] = {}
        for i, (p, score, typ) in enumerate(pieces):
            if typ == _BYTE:
                self.byte_ids[int(p[1:-1], 16)] = i  # "<0xAB>"
            if typ in (_NORMAL, _USER_DEFINED, _BYTE):
                self.vocab[p] = (i, score)
        self.max_piece_len = max((len(p) for p in self.vocab), default=1)
        self.min_score = min((s for _, s, t in pieces if t == _NORMAL),
                             default=0.0)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        return cls.from_bytes(open(path, "rb").read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: List[Tuple[str, float, int]] = []
        kw = {}
        for field, wire, val in _fields(data):
            if field == 1 and wire == 2:        # repeated SentencePiece
                piece, score, typ = "", 0.0, _NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        typ = v2
                pieces.append((piece, score, typ))
            elif field == 2 and wire == 2:      # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:                 # model_type
                        kw["model_type"] = v2
                    elif f2 == 35:              # byte_fallback
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40:              # unk_id
                        kw["unk_id"] = v2
            elif field == 3 and wire == 2:      # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 4:
                        kw["remove_extra_whitespaces"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_whitespaces"] = bool(v2)
        kw.setdefault("model_type", _UNIGRAM)   # proto default
        return cls(pieces, **kw)

    # -- encoding -------------------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s).strip()
        if self.add_dummy_prefix:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    def _fallback(self, ch: str) -> List[int]:
        """Out-of-vocab character -> byte pieces (byte_fallback) or unk."""
        if self.byte_fallback and self.byte_ids:
            return [self.byte_ids[b] for b in ch.encode("utf-8")]
        return [self.unk_id]

    def _encode_unigram(self, text: str) -> List[int]:
        # Viterbi over char positions maximizing the total piece score; an
        # unknown single char scores min_score - 10 like sentencepiece's
        # unk penalty, keeping known pieces always preferred.
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_score = self.min_score - 10.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self.max_piece_len)
            matched_single = False
            for j in range(i + 1, hi + 1):
                got = self.vocab.get(text[i:j])
                if got is None:
                    continue
                pid, score = got
                if j == i + 1:
                    matched_single = True
                if best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = (i, pid)
            if not matched_single and best[i] + unk_score > best[i + 1]:
                best[i + 1] = best[i] + unk_score
                back[i + 1] = (i, -1)           # -1: fallback marker
        ids: List[int] = []
        j = n
        prev_was_unk = False
        while j > 0:
            i, pid = back[j]
            if pid < 0:
                # sentencepiece merges CONSECUTIVE unknown chars into ONE
                # unk token when byte_fallback is off (unigram_model.cc
                # aggregates the unk span); with byte_fallback each char
                # still expands to its own byte pieces. The backtrace walks
                # right-to-left, so adjacent fallback spans are adjacent
                # iterations — skip the extra unk ids.
                if not (prev_was_unk and not (self.byte_fallback
                                              and self.byte_ids)):
                    ids[:0] = self._fallback(text[i:j])
                prev_was_unk = True
            else:
                ids.insert(0, pid)
                prev_was_unk = False
            j = i
        return ids

    def _encode_bpe(self, text: str) -> List[int]:
        # sentencepiece bpe_model.cc: start from characters; repeatedly
        # merge the adjacent pair whose concatenation is a vocab piece with
        # the highest score (leftmost wins ties); unmergeable leftover
        # symbols not in the vocab fall back to bytes/unk.
        syms = list(text)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                got = self.vocab.get(syms[i] + syms[i + 1])
                if got is not None and (best_score is None
                                        or got[1] > best_score):
                    best_score, best_i = got[1], i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids: List[int] = []
        for s in syms:
            got = self.vocab.get(s)
            if got is not None:
                ids.append(got[0])
            else:
                for ch in s:                    # unmerged multi-char can't
                    ids.extend(self._fallback(ch))  # happen; chars can
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        text = self._normalize(text)
        if not text:
            return []
        if self.model_type == _BPE:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    # -- decoding -------------------------------------------------------------
    def decode(self, ids: List[int]) -> str:
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue                   # ids past the SP vocab (e.g. a
            piece, _, typ = self.pieces[i]  # model head wider than the
            # tokenizer, or framework specials) have no surface form
            if typ == _BYTE:
                byte_buf.append(int(piece[1:-1], 16))
                continue
            flush()
            if typ in (_CONTROL, _UNUSED):
                continue
            if typ == _UNKNOWN:
                parts.append(" ⁇ ")        # sp's default unk surface
                continue
            parts.append(piece)
        flush()
        text = "".join(parts)
        if self.escape_whitespaces:
            text = text.replace(_WS, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text
