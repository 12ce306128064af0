"""Combined VLM: ViT embeddings merged into the token stream + decoder forward
(port of models/vlm.py).

The merge is a cumsum-gather, as in the reference, so shapes never depend on the
data: image-pad slot j (in flattened batch order) reads vision embedding row j.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import VLMConfig, is_kimi
from ..utils.profiling import tracer
from .decoder import KVCache, decoder_forward, logits_from_hidden
from .moonvit import moonvit_forward
from .vit import vit_forward


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["text"]["embed"]["weight"][input_ids.long()]


def merge_vision_embeddings(
    token_embeds: torch.Tensor,  # (B, S, E)
    vision_embeds: torch.Tensor,  # (N_img_tokens, E) in image order
    is_image: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    """Replace image-pad token embeddings with vision embeddings (order-preserving)."""
    B, S, E = token_embeds.shape
    flat_img = is_image.reshape(-1)
    img_idx = torch.cumsum(flat_img.to(torch.int64), dim=0) - 1
    img_idx = img_idx.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds.index_select(0, img_idx).to(token_embeds.dtype)
    out = torch.where(flat_img[:, None], gathered, token_embeds.reshape(-1, E))
    return out.reshape(B, S, E)


def _win_plan(vision_meta: dict):
    if "win_gidx" in vision_meta:
        return (vision_meta["win_gidx"], vision_meta["win_valid"], vision_meta["win_sidx"])
    return None


def compute_vision_embeds(params, cfg: VLMConfig, pixel_values, vision_meta, win_mode: int = 0, tp=None):
    """Run just the vision tower: packed patches -> (N_merged, E) merged embeddings in
    image order. vision_meta holds device tensors (vit.meta_to_device). tp: the
    TensorParallel view of the whole tree on a tensor mesh (parallel/collectives.py),
    None elsewhere. Kimi-VL's configs run MoonViT (models/moonvit.py) over its own
    metadata (moonvit.meta_to_device). Traced as the device span `vision`."""
    with tracer.span("vision", device=True):
        if is_kimi(cfg):
            if tp is not None:
                raise NotImplementedError("vision: no tensor-parallel forward through MoonViT")
            return moonvit_forward(params["vision"], cfg.vision, pixel_values, vision_meta)
        return vit_forward(
            params["vision"], cfg.vision, pixel_values,
            vision_meta["perm"], vision_meta["inv_perm_merged"],
            vision_meta["seg_window"], vision_meta["seg_full"], vision_meta["pos_ids"],
            win_mode=win_mode, win_plan=_win_plan(vision_meta), tp=None if tp is None else tp.at("vision"),
        )


def vlm_forward(
    params,
    cfg: VLMConfig,
    input_ids: torch.Tensor,  # (B, S)
    position_ids: torch.Tensor,  # (3, B, S)
    pixel_values: Optional[torch.Tensor] = None,  # (N_patches, patch_dim) packed
    vision_meta: Optional[dict] = None,  # device tensors from vit.meta_to_device
    attn_positions: Optional[torch.Tensor] = None,
    attn_valid: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    update_cache_len: bool = True,
    logit_index: Optional[torch.Tensor] = None,
    write_pos: Optional[torch.Tensor] = None,
    win_mode: int = 0,
    attend_len: Optional[int] = None,
    vision_embeds: Optional[torch.Tensor] = None,  # (N_merged, E) from compute_vision_embeds
    write_index=None,  # decoder.write_index(write_pos, T), where the caller has it
    tp=None,  # TensorParallel view of the whole tree on a tensor mesh (no-cache training forward)
):
    """Full forward -> (logits fp32, cache).

    Vision input: either raw `pixel_values` (+ vision_meta), and the ViT runs here, or
    precomputed `vision_embeds` from compute_vision_embeds (a caller that runs the
    tower once per image and reuses its output); either way the embeddings replace
    the image-pad tokens. logits is (B, S, V), or (B, V) when logit_index (B,) is
    given: then only that position's hidden state is projected."""
    x = embed_tokens(params, input_ids)
    if pixel_values is not None and vision_embeds is None:
        vision_embeds = compute_vision_embeds(params, cfg, pixel_values, vision_meta, win_mode, tp)
    if vision_embeds is not None:
        x = merge_vision_embeddings(x, vision_embeds, input_ids == cfg.tokens.image_pad)
    hidden, cache = decoder_forward(
        params["text"], cfg.text, x, position_ids,
        attn_positions=attn_positions, attn_valid=attn_valid, cache=cache,
        update_cache_len=update_cache_len, write_pos=write_pos, attend_len=attend_len,
        index=write_index, tp=None if tp is None else tp.at("text"),
    )
    if logit_index is not None:
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), logit_index.long()]
    return logits_from_hidden(params["text"], cfg.text, hidden), cache


def masked_ce_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                   count: Optional[torch.Tensor] = None):
    """Next-token cross entropy with -100 masking (port of the reference's
    masked_ce_loss): logits[:, :-1] predict labels[:, 1:]; the loss is the mean over
    the valid tokens (at least one in the divisor). logits (B, S, V) fp32, labels
    (B, S). Returns (mean loss, number of valid tokens). `count`, where given, is the
    divisor instead of the valid tokens here (a data rank's rows divided by the whole
    batch's count: the sum over the ranks is then the whole batch's mean)."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != ignore_index
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    tok_logp = logp.gather(-1, safe_labels[..., None])[..., 0]
    n = valid.sum()
    return -(tok_logp * valid).sum() / (n if count is None else count).clamp(min=1), n
