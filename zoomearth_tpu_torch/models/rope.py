"""Rotary position embeddings: vision 2D RoPE and decoder M-RoPE (port of models/rope.py).

The position-id builders are host-side numpy. They are copied verbatim from the
reference module (which imports JAX) and held equal to it by exact-equality tests.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D) fp32, broadcast over heads. The product
    runs in fp32 and is cast back to x.dtype."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return (x * cos + rotate_half(x) * sin).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies on `device`, made once per (dim, theta, device): a
    decode step captured into a CUDA graph may copy nothing from the host. Read-only,
    and a normal tensor even when first asked for under inference mode (training
    reads it too)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    with torch.inference_mode(False):
        return torch.from_numpy(inv.astype(np.float32)).to(device)


def vision_rope_cos_sin(pos_ids: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """pos_ids (S, 2) int (h, w) patch coordinates -> cos/sin (S, head_dim) fp32."""
    dim = head_dim // 2
    freqs = pos_ids[..., None].float() * _inv_freq(dim, theta, pos_ids.device)  # (S, 2, dim//2)
    freqs = freqs.reshape(pos_ids.shape[0], -1)  # (S, dim)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, mrope_section: Sequence[int],
                  theta: float = 1000000.0):
    """position_ids (3, B, S) -> cos/sin (B, S, head_dim) fp32: sections [t, h, w] of
    the half-dim take their frequencies from planes 0/1/2."""
    half = head_dim // 2
    freqs = position_ids[..., None].float() * _inv_freq(head_dim, theta, position_ids.device)
    parts = []
    off = 0
    for i, sec in enumerate(mrope_section):
        parts.append(freqs[i, ..., off : off + sec])
        off += sec
    assert off == half, f"mrope_section must sum to head_dim//2 ({half}), got {off}"
    f = torch.cat(parts, dim=-1)
    emb = torch.cat([f, f], dim=-1)
    return torch.cos(emb), torch.sin(emb)


# ---------------------------------------------------------------------------
# Host-side position ids (numpy copies of zoomearth_tpu/models/rope.py:51-202)
# ---------------------------------------------------------------------------

def vision_pos_ids(grid_thw: Sequence[Sequence[int]], merge_size: int = 2) -> np.ndarray:
    """(h, w) rotary coordinates per patch, in the patchify emission order
    (merge-block-major), concatenated over images. Host-side numpy."""
    out = []
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = (
            hpos.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = (
            wpos.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )
        pos = np.stack([hpos, wpos], axis=-1)  # (h*w, 2)
        out.append(np.tile(pos, (t, 1)))
    return np.concatenate(out, axis=0).astype(np.int32)


def mrope_position_ids(
    input_ids: np.ndarray,
    grid_thws: Sequence[Sequence[int]],
    *,
    image_pad_id: int,
    merge_size: int = 2,
    attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Compute (3, S) M-RoPE position ids for ONE sequence (host numpy).

    Text tokens advance all three planes together; each image's tokens get (t, h, w)
    grid coordinates offset after the preceding text; text after an image resumes at
    max(position)+1. Returns (position_ids, next_pos): next_pos is the scalar
    position of the first generated token."""
    ids = np.asarray(input_ids)
    if attention_mask is not None:
        valid_idx = np.nonzero(np.asarray(attention_mask) != 0)[0]
        valid_ids = ids[valid_idx]
    else:
        valid_idx = np.arange(len(ids))
        valid_ids = ids

    pos_chunks = []
    st = 0
    img_i = 0
    image_positions = np.nonzero(valid_ids == image_pad_id)[0]
    # Find starts of contiguous image_pad runs
    run_starts = [int(p) for j, p in enumerate(image_positions) if j == 0 or image_positions[j] != image_positions[j - 1] + 1]
    next_start = 0
    for run_st in run_starts:
        t, h, w = grid_thws[img_i]
        llm_h, llm_w = h // merge_size, w // merge_size
        n_img = t * llm_h * llm_w
        text_len = run_st - st
        st_idx = next_start
        if text_len > 0:
            text_pos = np.arange(text_len) + st_idx
            pos_chunks.append(np.stack([text_pos] * 3))
            st_idx = st_idx + text_len
        t_idx = np.repeat(np.arange(t), llm_h * llm_w)
        h_idx = np.tile(np.repeat(np.arange(llm_h), llm_w), t)
        w_idx = np.tile(np.arange(llm_w), t * llm_h)
        pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
        next_start = st_idx + max(t, llm_h, llm_w)
        st = run_st + n_img
        img_i += 1
    if st < len(valid_ids):
        text_len = len(valid_ids) - st
        text_pos = np.arange(text_len) + next_start
        pos_chunks.append(np.stack([text_pos] * 3))
        next_start = next_start + text_len
    packed = np.concatenate(pos_chunks, axis=1) if pos_chunks else np.zeros((3, 0), dtype=np.int64)

    full = np.ones((3, len(ids)), dtype=np.int64)
    full[:, valid_idx] = packed
    return full.astype(np.int32), int(next_start)


def mrope_chunk_position_ids(
    chunk_ids: np.ndarray,
    grid_thws: Sequence[Sequence[int]],
    start_pos: int,
    *,
    image_pad_id: int,
    merge_size: int = 2,
) -> Tuple[np.ndarray, int]:
    """M-RoPE positions for a CONTINUATION chunk starting at scalar position start_pos
    (all three planes aligned there). Returns ((3, S) positions, next_pos)."""
    pos, nxt = mrope_position_ids(
        np.asarray(chunk_ids), grid_thws, image_pad_id=image_pad_id, merge_size=merge_size
    )
    return pos + start_pos, nxt + start_pos


def mrope_position_ids_batch(
    input_ids: np.ndarray,
    grid_thws_per_seq: Sequence[Sequence[Sequence[int]]],
    *,
    image_pad_id: int,
    merge_size: int = 2,
    attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch wrapper: input_ids (B, S) -> (3, B, S) position ids + (B,) next positions."""
    B = input_ids.shape[0]
    outs, nexts = [], []
    for b in range(B):
        am = attention_mask[b] if attention_mask is not None else None
        pos, nxt = mrope_position_ids(
            input_ids[b], grid_thws_per_seq[b], image_pad_id=image_pad_id, merge_size=merge_size, attention_mask=am
        )
        outs.append(pos)
        nexts.append(nxt)
    return np.stack(outs, axis=1), np.asarray(nexts, dtype=np.int32)
