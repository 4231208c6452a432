"""Tokenizer + llava_v1 conversation layer: the port's own copy of
anyref_tpu/tokenizer.py.

``AnyRefTokenizer`` is special-token-aware. It wraps a base tokenizer
(any object with ``encode``/``decode``) or, by default, a deterministic
byte-level fallback with the same special-token geometry as the reference
layout. ``AnyRefTokenizer.from_pretrained`` loads the real LLaMA tokenizer
of a checkpoint directory: ``tokenizer.json`` through the ``tokenizers``
package, else the SentencePiece ``tokenizer.model`` through the port's own
reader (``sp.py``). Conversation building follows the llava_v1 / vicuna v1
template.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .config import IGNORE_INDEX, LLAMA_BASE_VOCAB, SpecialTokens

# token ids shared with LLaMA
PAD_ID = 0   # unk used as pad (reference train.py:64 tokenizer.pad_token = unk)
BOS_ID = 1
EOS_ID = 2

# vicuna v1 conversation template (llava_v1; reference conv_templates["llava_v1"])
SYSTEM_PROMPT = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions.")
ROLES = ("USER", "ASSISTANT")
SEP = " "
SEP2 = "</s>"

SPECIAL_STRINGS = {
    "[SEG]": "seg",
    "<im_start>": "im_start",
    "<im_end>": "im_end",
    "<audio_ref_start>": "audio_ref_start",
    "<audio_ref_end>": "audio_ref_end",
    "<img_ref_start>": "img_ref_start",
    "<img_ref_end>": "img_ref_end",
    "<image>": "image",
    "<img_ref>": "img_ref",
    "<audio_ref>": "audio_ref",
}


class _HFBase:
    """A ``tokenizers.Tokenizer`` behind the base interface."""

    def __init__(self, tk):
        self.tk = tk

    def encode(self, text, add_special_tokens=False):
        return self.tk.encode(text, add_special_tokens=False).ids

    def decode(self, ids):
        return self.tk.decode(ids)


class AnyRefTokenizer:
    """Special-token-aware tokenizer.

    ``base`` is the checkpoint's tokenizer (``from_pretrained``);
    otherwise a byte-level fallback encodes UTF-8 bytes as ids 3..258
    (deterministic, reversible).
    """

    @classmethod
    def from_pretrained(cls, path: str,
                        tokens: SpecialTokens = SpecialTokens()):
        """The real LLaMA tokenizer of an HF directory, in the reference's
        order: ``tokenizer.json`` through ``tokenizers`` (an ImportError
        that names it where the package is missing: the other file is not
        taken instead), else ``tokenizer.model`` (the LLaVA-Lightning
        layout, reference train.py:58-62) through the port's SentencePiece
        reader. Base-vocab piece ids are kept; the added specials take this
        layout's fixed ids."""
        fast = os.path.join(path, "tokenizer.json")
        if os.path.exists(fast):
            try:
                from tokenizers import Tokenizer
            except ImportError as e:
                raise ImportError(
                    f"{fast} needs the 'tokenizers' package, which is not "
                    "installed; install it, or load a directory that has "
                    "only tokenizer.model") from e
            return cls(_HFBase(Tokenizer.from_file(fast)), tokens)
        sp_path = os.path.join(path, "tokenizer.model")
        if os.path.exists(sp_path):
            from .sp import SentencePieceModel
            return cls(SentencePieceModel.from_file(sp_path), tokens)
        raise FileNotFoundError(
            f"no tokenizer.json or tokenizer.model under {path}")

    def __init__(self, base=None, tokens: SpecialTokens = SpecialTokens()):
        self.base = base
        self.tokens = tokens
        self._special_to_id = {
            s: getattr(tokens, attr) for s, attr in SPECIAL_STRINGS.items()
        }
        for i in range(tokens.num_loc):
            self._special_to_id[f"[LOC{i}]"] = tokens.loc0 + i
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        # longest-first so "<im_start>" wins over prefixes
        self._specials_sorted = sorted(self._special_to_id, key=len, reverse=True)

    @property
    def vocab_size(self) -> int:
        return LLAMA_BASE_VOCAB + self.tokens.num_added

    # -- plain text --------------------------------------------------------
    def _encode_text(self, text: str) -> List[int]:
        if self.base is not None:
            return self.base.encode(text, add_special_tokens=False)
        return [3 + b for b in text.encode("utf-8")]

    def _decode_text(self, ids: Sequence[int]) -> str:
        if self.base is not None:
            return self.base.decode(list(ids))
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode(
            "utf-8", errors="replace")

    # -- with specials ------------------------------------------------------
    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        out: List[int] = [BOS_ID] if add_bos else []
        i = 0
        buf = ""
        while i < len(text):
            matched = None
            if text[i] in "<[":
                for s in self._specials_sorted:
                    if text.startswith(s, i):
                        matched = s
                        break
            if text.startswith(SEP2, i):
                if buf:
                    out.extend(self._encode_text(buf))
                    buf = ""
                out.append(EOS_ID)
                i += len(SEP2)
            elif matched is not None:
                if buf:
                    out.extend(self._encode_text(buf))
                    buf = ""
                out.append(self._special_to_id[matched])
                i += len(matched)
            else:
                buf += text[i]
                i += 1
        if buf:
            out.extend(self._encode_text(buf))
        return out

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        parts: List[str] = []
        buf: List[int] = []
        for t in ids:
            t = int(t)
            if t in self._id_to_special or t in (BOS_ID, EOS_ID, PAD_ID):
                if buf:
                    parts.append(self._decode_text(buf))
                    buf = []
                if t in self._id_to_special and not skip_special:
                    parts.append(self._id_to_special[t])
                elif t == EOS_ID and not skip_special:
                    parts.append(SEP2)
            else:
                buf.append(t)
        if buf:
            parts.append(self._decode_text(buf))
        return "".join(parts)


# ---------------------------------------------------------------------------
# Conversation building
# ---------------------------------------------------------------------------
def build_conversation(question: str, answer: Optional[str] = None) -> str:
    """vicuna-v1 single-round prompt. With answer=None returns the
    generation prompt ending at "ASSISTANT:" (the reference's left_pad
    truncation at the 2nd ':' token, utils/coco_instance.py:121-126,
    reproduced by construction)."""
    prompt = f"{SYSTEM_PROMPT}{SEP}{ROLES[0]}: {question}{SEP}{ROLES[1]}:"
    if answer is None:
        return prompt
    return f"{prompt} {answer}{SEP2}"


def wrap_image_token(conversation: str) -> str:
    """use_mm_start_end wrap (reference utils/coco_instance.py:99-107)."""
    return conversation.replace("<image>", "<im_start><image><im_end>")


@dataclass
class TokenizedConversation:
    input_ids: np.ndarray   # [T] int32
    labels: np.ndarray      # [T] int32, IGNORE_INDEX outside the answer span
    prompt_len: int         # tokens before the answer starts


def tokenize_conversation(tokenizer: AnyRefTokenizer, question: str,
                          answer: str,
                          use_mm_start_end: bool = True
                          ) -> TokenizedConversation:
    """Tokenize one round and build its labels: everything through
    "ASSISTANT:" is IGNORE_INDEX, the answer tokens (with the trailing </s>)
    are supervised. The boundary is exact by construction: the prompt is
    tokenized on its own."""
    conv = build_conversation(question, answer)
    prompt = build_conversation(question, None)
    if use_mm_start_end:
        conv = wrap_image_token(conv)
        prompt = wrap_image_token(prompt)
    ids = np.asarray(tokenizer.encode(conv), np.int32)
    prompt_len = len(tokenizer.encode(prompt))
    labels = ids.copy()
    labels[:prompt_len] = IGNORE_INDEX
    return TokenizedConversation(ids, labels, prompt_len)


def tokenize_prompt(tokenizer: AnyRefTokenizer, question: str,
                    use_mm_start_end: bool = True) -> np.ndarray:
    prompt = build_conversation(question, None)
    if use_mm_start_end:
        prompt = wrap_image_token(prompt)
    return np.asarray(tokenizer.encode(prompt), np.int32)


# ---------------------------------------------------------------------------
# Prompt templates (reference dataset prompt strings)
# ---------------------------------------------------------------------------
def seg_question(class_text: str) -> str:
    """reference utils/refer_seg.py:403"""
    return f"<image>\nCan you segment {class_text} in this image?"


def seg_answer(class_text: str, itisseg: bool = False) -> str:
    """reference utils/refer_seg.py:405-407"""
    if itisseg:
        return "it is [SEG]."
    return f"{class_text}[SEG]."
