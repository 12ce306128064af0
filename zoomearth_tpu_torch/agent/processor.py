"""Processor: text + images -> token ids with expanded image pads (+ SFT label masking).

Equivalent of the reference's custom Qwen2VLProcessor (open_r1/model/
processing_qwen2_vl.py): each `<|image_pad|>` placeholder in the text is expanded to
grid_t*grid_h*grid_w/merge² pad tokens (processing_qwen2_vl.py:156-171), and the
`text_pair` label convention — labels are −100 for the prompt and all image tokens,
real token ids only over the target suffix (processing_qwen2_vl.py:197-205) — is
provided by `encode_with_labels`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import VLMConfig
from ..image.preprocess import num_vision_tokens, preprocess_image_u8
from ..utils.profiling import tracer

IGNORE_INDEX = -100


class Processor:
    """Tokenizer + image pipeline front-end for the generation/training runtimes."""

    def __init__(self, tokenizer, cfg: VLMConfig, min_pixels: Optional[int] = None, max_pixels: Optional[int] = None,
                 compact_patches: bool = False):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        # compact_patches: emit single-frame uint8 patches (half the host->device
        # bytes; vit_forward folds the patch-embed kernel — see preprocess_image_u8).
        # Still images only; leave False for video inputs.
        self.compact_patches = compact_patches

    def preprocess_images(self, images: Sequence) -> List[Tuple[np.ndarray, Tuple[int, int, int]]]:
        kw = {}
        if self.min_pixels is not None:
            kw["min_pixels"] = self.min_pixels
        if self.max_pixels is not None:
            kw["max_pixels"] = self.max_pixels
        v = self.cfg.vision
        with tracer.span("processor.preprocess"):
            return [
                preprocess_image_u8(
                    img,
                    patch_size=v.patch_size,
                    temporal_patch_size=v.temporal_patch_size,
                    merge_size=v.spatial_merge_size,
                    compact=self.compact_patches,
                    **kw,
                )
                for img in images
            ]

    def expand_image_pads(self, ids: List[int], grids: Sequence[Sequence[int]]) -> List[int]:
        """Replace each single image_pad token with the per-image token count."""
        pad = self.cfg.tokens.image_pad
        merge = self.cfg.vision.spatial_merge_size
        out: List[int] = []
        img_i = 0
        for t in ids:
            if t == pad:
                n = num_vision_tokens(grids[img_i], merge)
                out.extend([pad] * n)
                img_i += 1
            else:
                out.append(t)
        if img_i != len(grids):
            raise ValueError(f"text has {img_i} image placeholders but {len(grids)} images given")
        return out

    def encode(self, text: str, images: Sequence = ()) -> Tuple[List[int], List[Tuple[np.ndarray, Tuple[int, int, int]]]]:
        """Prompt text (one <|image_pad|> per image) -> (expanded ids, [(pv, grid)...])."""
        prepped = self.preprocess_images(images)
        with tracer.span("text.tokenize"):
            ids = self.tokenizer.encode(text)
            ids = self.expand_image_pads(ids, [g for _, g in prepped])
        return ids, prepped

    def encode_with_labels(
        self, prompt: str, target: str, images: Sequence = ()
    ) -> Tuple[List[int], List[int], List[Tuple[np.ndarray, Tuple[int, int, int]]]]:
        """SFT sample -> (input_ids, labels, images) with the text_pair masking.

        Images may appear in the prompt AND in the target (stage-2 cut samples embed the
        cropped image inside the assistant turn, SFT.py:148-168). Label = −100 over the
        whole prompt and over every image token, token id elsewhere in the target.
        """
        prepped = self.preprocess_images(images)
        grids = [g for _, g in prepped]
        prompt_ids = self.tokenizer.encode(prompt)
        target_ids = self.tokenizer.encode(target)
        n_prompt_imgs = prompt_ids.count(self.cfg.tokens.image_pad)
        prompt_ids = self.expand_image_pads(prompt_ids, grids[:n_prompt_imgs])
        target_ids = self.expand_image_pads(target_ids, grids[n_prompt_imgs:])
        input_ids = prompt_ids + target_ids
        pad = self.cfg.tokens.image_pad
        labels = [IGNORE_INDEX] * len(prompt_ids) + [
            IGNORE_INDEX if t == pad else t for t in target_ids
        ]
        return input_ids, labels, prepped
