"""What the runtime's stages take from a model family, picked from the model config by
one rule (`family`), so that the packing, the Generator and the episode host call each
hook in one place and a new family adds one entry here.

- Qwen2.5-VL (every VLMConfig, InternVL's included): M-RoPE positions over the image
  grids, the Qwen ViT's window metadata, the KVCache, and the Qwen chat template.
- Kimi-VL (KimiVLConfig): plain sequential positions, image tokens included (the three
  position planes are equal), MoonViT's segment and position-grid metadata, the
  LatentCache (models/mla.py), and Kimi-VL's chat template.
- MiMo-V2.5 (MiMoV2Config): Kimi-VL's sequential positions, the Qwen ViT's window
  metadata, the HybridCache (models/hybrid.py: each layer's own KV heads and widths), and
  the Qwen chat template (ChatML's markers).

The model code keeps its own rule for its layers: models/vlm.py runs MoonViT for a
KimiVLConfig; models/decoder.py asks the text config for each layer's attention
(`layer_attention(i)`) and MLP (`is_moe_layer(i)`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..agent import prompts as PT
from ..config import KimiVLConfig, MiMoV2Config
from ..models import moonvit, vit
from ..models.decoder import KVCache
from ..models.hybrid import HybridCache
from ..models.mla import LatentCache
from ..models.rope import mrope_chunk_position_ids, mrope_position_ids_batch


@dataclasses.dataclass(frozen=True)
class Family:
    # (cfg, ids (B, S), grids per row, lengths (B,)) -> (positions (3, B, S), next positions (B,))
    positions: Callable
    # (cfg, a row's chunk tokens, its grids, its start position) -> (positions (3, n), next position)
    chunk_positions: Callable
    # (cfg, grids of the packed images, rows P) -> host vision metadata
    vision_meta: Callable
    # (host vision metadata, device) -> the tower's device metadata
    meta_to_device: Callable
    # the cache kind: .create(text cfg, batch, max_len, dtype, device)
    cache: type
    # () -> (stage-1 prompt function, a continuation image's vision tokens), looked up when called
    prompts: Callable


def _mrope_positions(cfg, ids, grids_per_seq, lengths):
    S = ids.shape[1]
    return mrope_position_ids_batch(
        ids, grids_per_seq, image_pad_id=cfg.tokens.image_pad, merge_size=cfg.vision.spatial_merge_size,
        attention_mask=(ids != cfg.tokens.pad).astype(np.int32) if bool((lengths != S).any()) else None)


def _mrope_chunk_positions(cfg, toks, grids, start):
    return mrope_chunk_position_ids(np.asarray(toks), grids, start, image_pad_id=cfg.tokens.image_pad,
                                    merge_size=cfg.vision.spatial_merge_size)


def meta_dict(meta) -> dict:
    """The Qwen ViT's VisionMetadata -> host metadata dict (numpy arrays, uploaded by the
    Generator through vit.meta_to_device). win_mode is a plain int."""
    d = {"perm": meta.perm, "inv_perm_merged": meta.inv_perm_merged, "seg_window": meta.seg_window,
         "seg_full": meta.seg_full, "pos_ids": meta.pos_ids, "win_mode": meta.win_mode}
    if meta.win_gidx is not None:
        d.update(win_gidx=meta.win_gidx, win_valid=meta.win_valid, win_sidx=meta.win_sidx)
    return d


def _qwen_meta(cfg, grids, P):
    return meta_dict(vit.vision_metadata(grids, cfg.vision, pad_to=P))


def _sequential_positions(cfg, ids, grids_per_seq, lengths):
    B, S = ids.shape
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy(), lengths.copy()


def _sequential_chunk_positions(cfg, toks, grids, start):
    return start + np.arange(len(toks), dtype=np.int32)[None].repeat(3, 0), start + len(toks)


QWEN_VL = Family(_mrope_positions, _mrope_chunk_positions, _qwen_meta, vit.meta_to_device, KVCache,
                 lambda: (PT.stage1_prompt, PT.VISION_TOKENS))
KIMI_VL = Family(_sequential_positions, _sequential_chunk_positions,
                 lambda cfg, grids, P: moonvit.moonvit_metadata(grids, pad_to=P), moonvit.meta_to_device,
                 LatentCache, lambda: (PT.kimi_stage1_prompt, PT.KIMI_VISION_TOKENS))


MIMO_V2 = Family(_sequential_positions, _sequential_chunk_positions, _qwen_meta, vit.meta_to_device, HybridCache,
                 lambda: (PT.stage1_prompt, PT.VISION_TOKENS))
FAMILIES = {KimiVLConfig: KIMI_VL, MiMoV2Config: MIMO_V2}


def family(cfg) -> Family:
    """The family of a model config: Kimi-VL's or MiMo-V2.5's by its config class, Qwen's
    for every other (a VLMConfig, InternVLVLMConfig)."""
    return FAMILIES.get(type(cfg), QWEN_VL)
