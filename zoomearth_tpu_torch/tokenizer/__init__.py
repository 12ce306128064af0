"""Tokenizer layer: HF tokenizer wrapper for real checkpoints + a deterministic fake
tokenizer for weight-free tests.

Both expose the same minimal surface the runtime needs: encode/decode, the special-token
ids (taken from the model config, never hardcoded — cf. SURVEY.md §2.6 on the
reference's hardcoded 151643), and chat-template helpers live in agent.prompts.
"""

from __future__ import annotations

from typing import List, Sequence

from ..config import SpecialTokens


class HFTokenizer:
    """Wraps a HF fast tokenizer loaded from a local checkpoint directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, use_fast=True)

    def encode(self, text: str) -> List[int]:
        return self.tk.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_id(self, token: str) -> int:
        return self.tk.convert_tokens_to_ids(token)


class FakeTokenizer:
    """Byte-level tokenizer over a small vocab for tests (no downloaded assets).

    Plain bytes map to ids 32..287 (id = 32 + byte); special tokens use the ids reserved
    by config.SpecialTokens for the tiny config. Vocab must be >= 304. A token set with
    its own `strings()` (config.KimiTokens) gives its special strings itself.
    """

    SPECIAL = {
        "<|image_pad|>": "image_pad",
        "<|video_pad|>": "video_pad",
        "<|vision_start|>": "vision_start",
        "<|vision_end|>": "vision_end",
        "<|im_start|>": "im_start",
        "<|im_end|>": "im_end",
        "<|endoftext|>": "endoftext",
        # InternVL family (config.InternVLTokens)
        "<IMG_CONTEXT>": "image_context",
        "<img>": "img_start",
        "</img>": "img_end",
    }

    def __init__(self, tokens: SpecialTokens):
        self.tokens = tokens
        if hasattr(tokens, "strings"):
            self._special_to_id = tokens.strings()
        else:
            self._special_to_id = {
                s: getattr(tokens, attr) for s, attr in self.SPECIAL.items() if hasattr(tokens, attr)
            }
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}

    def encode(self, text: str) -> List[int]:
        import re

        pattern = "(" + "|".join(re.escape(s) for s in self._special_to_id) + ")"
        out: List[int] = []
        for part in re.split(pattern, text):
            if not part:
                continue
            if part in self._special_to_id:
                out.append(self._special_to_id[part])
            else:
                out.extend(32 + b for b in part.encode("utf-8"))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        chunks: List[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                if buf:
                    chunks.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    chunks.append(self._id_to_special[i])
            elif 32 <= i < 32 + 256:
                buf.append(i - 32)
        if buf:
            chunks.append(buf.decode("utf-8", errors="replace"))
        return "".join(chunks)

    def token_id(self, token: str) -> int:
        return self._special_to_id[token]
