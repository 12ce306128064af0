"""Plain attention ops with segment-id / causal masking (port of ops/attention.py).

These are the numerically authoritative torch versions of the reference's XLA paths.
The ViT's windowed blocks run `window_block_attention` / `gather_window_attention` on
every device (the reference computes them outside any Pallas kernel). The masked
dense `segment_attention`, `causal_attention` and `decode_attention` are the plain
versions behind the hand-written kernels in `flash_attention`, `flash_causal` and
`flash_decode`: on a CUDA tensor the model calls the kernel, never these.

Softmax always runs in float32 and masking uses NEG_INF = -1e30 instead of -inf, so a
fully masked row gives a uniform average instead of NaN (reference attention.py:13-22).
GQA never repeats kv heads: the G query heads of a kv head are folded into one
batched product (reference `_gqa_sdpa`, attention.py:126-144).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
LOCAL_BLOCK = 64  # ViT window span in patches (112px window / 14px patch = 8x8)


def _sdpa(q, k, v, mask, scale):
    """q (..., S, H, D), k/v (..., T, H, D), mask broadcastable to (..., H, S, T)."""
    logits = torch.einsum("...shd,...thd->...hst", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hst,...thd->...shd", probs.to(v.dtype), v)


def segment_attention(q, k, v, segment_ids, scale=None):
    """Packed varlen self-attention: q/k/v (S, H, D), segment_ids (S,) — tokens attend
    only within their segment. Pad rows (their own segment) produce garbage that the
    caller drops."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = (segment_ids[:, None] == segment_ids[None, :])[None]  # (1, S, T)
    return _sdpa(q, k, v, mask, scale)


def window_block_attention(q, k, v, scale=None):
    """ViT windowed attention when every aligned LOCAL_BLOCK-row block is exactly one
    window (VisionMetadata.win_mode 2): block-diagonal by construction, no mask."""
    S, H, D = q.shape
    nb = S // LOCAL_BLOCK
    if scale is None:
        scale = D**-0.5
    qb = q.reshape(nb, LOCAL_BLOCK, H, D)
    kb = k.reshape(nb, LOCAL_BLOCK, H, D)
    vb = v.reshape(nb, LOCAL_BLOCK, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vb)
    return out.reshape(S, H, D)


def gather_window_attention(q, k, v, gidx, valid, sidx, scale=None):
    """ViT windowed attention via the host gather plan (VisionMetadata win_gidx /
    win_valid / win_sidx, win_mode 1): gather rows into a (NW, L) per-window layout,
    attend dense block-diagonal with invalid keys masked, scatter back.

    gidx (NW*L,) int64 source rows; valid (NW, L) bool; sidx (S,) int64 slot per row."""
    S, H, D = q.shape
    NW, L = valid.shape
    if scale is None:
        scale = D**-0.5
    qg = q.index_select(0, gidx).reshape(NW, L, H, D)
    kg = k.index_select(0, gidx).reshape(NW, L, H, D)
    vg = v.index_select(0, gidx).reshape(NW, L, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", qg, kg).float() * scale
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vg)
    return out.reshape(NW * L, H, D).index_select(0, sidx)


def _gqa_sdpa(q, k, v, mask, scale):
    """q (B, S, H, D); k/v (B, Hkv, T, D) kv-head-major; mask broadcastable to
    (B, Hkv, G, S, T). The G query heads of each kv head share one product: the
    kv heads are never repeated."""
    B, S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def causal_attention(q, k, v, *, positions=None, kv_positions=None, valid=None, scale=None):
    """Batched causal GQA attention: q (B, S, H, D), k/v (B, Hkv, T, D).

    positions (B, S) query positions and kv_positions (B, T) key positions (default
    iota); a query sees keys at kv_position <= position. valid (B, T) masks kv slots."""
    B, S, H, D = q.shape
    T = k.shape[2]
    if scale is None:
        scale = D**-0.5
    if positions is None:
        positions = torch.arange(S, device=q.device)[None].expand(B, S)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device)[None].expand(B, T)
    mask = kv_positions[:, None, :] <= positions[:, :, None]  # (B, S, T)
    if valid is not None:
        mask = mask & valid[:, None, :]
    return _gqa_sdpa(q, k, v, mask[:, None, None], scale)


def decode_attention(q, k_cache, v_cache, *, kv_len, scale=None):
    """Single-step decode: q (B, 1, H, D) against cache (B, Hkv, T, D); kv_len (B,)
    valid entries per row (new token included)."""
    D = q.shape[-1]
    T = k_cache.shape[2]
    if scale is None:
        scale = D**-0.5
    valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]  # (B, T)
    return _gqa_sdpa(q, k_cache, v_cache, valid[:, None, None, None], scale)
