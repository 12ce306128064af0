"""The prompts and the byte-level tokenizer, as the reference works them out.

Plain Python: ids 32 + byte for text, the special tokens at the ids the configuration
gives. The templates are the ZoomEarth prompts (the reference repository's
demo.py / infer.py strings), written out here.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

VISION_TOKENS = "<|vision_start|><|image_pad|><|vision_end|>"
ZOOM_PREFIX = "\n<|im_start|>system\nYou are a helpful assistant. <|im_end|>\n<|im_start|>user\n" + VISION_TOKENS


class ByteTokenizer:
    def __init__(self, specials: Dict[str, int]):
        self.specials = dict(specials)
        self.by_id = {v: k for k, v in self.specials.items()}
        self._split = re.compile("(" + "|".join(re.escape(s) for s in self.specials) + ")")

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for part in self._split.split(text):
            if not part:
                continue
            if part in self.specials:
                out.append(self.specials[part])
            else:
                out.extend(32 + b for b in part.encode("utf-8"))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        chunks: List[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in self.by_id:
                if buf:
                    chunks.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    chunks.append(self.by_id[i])
            elif 32 <= i < 32 + 256:
                buf.append(i - 32)
        if buf:
            chunks.append(buf.decode("utf-8", errors="replace"))
        return "".join(chunks)


def qwen_specials(cfg: dict) -> Dict[str, int]:
    sp = cfg["special_token_ids"]
    return {"<|image_pad|>": cfg["image_token_id"], "<|video_pad|>": cfg["video_token_id"],
            "<|vision_start|>": cfg["vision_start_token_id"], "<|vision_end|>": cfg["vision_end_token_id"],
            "<|im_start|>": sp["im_start"], "<|im_end|>": sp["im_end"], "<|endoftext|>": sp["endoftext"]}


def kept_tokens(tok: ByteTokenizer, completion: List[int], pre_answer_text: str):
    """The longest prefix of the generated tokens whose text is a prefix of the text
    before <answer>, and the rest of that text (the stage-2 continuation keeps the
    generated ids where their text survives)."""
    lo, hi = 0, len(completion)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pre_answer_text.startswith(tok.decode(completion[:mid], skip_special_tokens=False)):
            lo = mid
        else:
            hi = mid - 1
    kept = completion[:lo]
    return kept, pre_answer_text[len(tok.decode(kept, skip_special_tokens=False)):]
