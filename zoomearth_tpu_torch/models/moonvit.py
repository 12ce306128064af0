"""MoonViT: Kimi-VL's native-resolution vision tower and its projector.

An image of gh x gw patches (14 x 14 x 3 pixels each, one frame) becomes gh/2 x gw/2
decoder embeddings. With x the patch features, row y and column x_ of a patch:

- patch embedding: x = P W_pe + b_pe, P the patch's 588 values (channel, row, column)
  normalized to (P / 255 - mean) / std; W_pe is (588, 1152);
- position embedding: x += G[y, x_], G the learned 64 x 64 x 1152 grid resized
  bicubically (align_corners=False) to gh x gw where the image's grid differs;
- 27 blocks: x += Attn(LN0(x)); x += W_1 GELU_tanh(W_0 LN1(x) + b_0) + b_1, where Attn
  is [q | k | v] = h W_qkv + b_qkv over 16 heads of 72, full attention within the
  image (K1's segments), out = concat_h(softmax(q_h k_h^T / sqrt(72)) v_h) W_o + b_o;
- 2D RoPE on q and k: each head's 72 dims are 36 adjacent pairs (2i, 2i + 1), each
  turned as a complex number, pair 2j by x_ w_j and pair 2j + 1 by y w_j, with
  w_j = 10000^(-4 j / 72), j = 0 .. 17;
- a final LayerNorm, then the projector: LayerNorm per patch, the 2 x 2 neighbours
  of each merge block concatenated (4 x 1152 = 4608), GELU(z W_1 + b_1) W_2 + b_2 with
  W_1 (4608, 4608) and W_2 (4608, 2048). LayerNorm eps 1e-5 throughout.

Patches arrive in the processor's patchify order, merge-block-major ((block row,
block column, row in block, column in block), image after image), so the four patches
of a merge block are consecutive and the merge is a reshape; the host metadata
(`moonvit_metadata`) gives each patch its (row, column) for the RoPE and its row of the
resized position grids.

K1 at head width 72: the tower zero-pads q, k and v to 80 (the next width K1 runs, on
its tensor-core path) and slices the output back to 72. The kernel's scale is
1/sqrt(80), so q is multiplied by sqrt(80 / 72) in fp32 with the rotary, before its
one rounding: the logits are q.k / sqrt(72) as the tower has them. The padding costs
8/72 = 11 % more attention work and bytes, and a copy of q, k and v per block.

Params: patch_embed.{w, b}; pos_emb (64, 64, 1152); blocks[i].{norm0, norm1}.{scale,
bias}, .{wqkv, bqkv, wo, bo, w0, b0, w1, b1}; final_ln.{scale, bias};
projector.{ln.{scale, bias}, w1, b1, w2, b2}. Matrices are (in, out).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MoonViTConfig
from ..ops.flash_attention import PAD_SEG, flash_segment_attention
from .vit import layer_norm


def kernel_head_dim(D: int) -> int:
    """The head width K1 runs a D-wide head at: the next multiple of 16."""
    return -(-D // 16) * 16


def moonvit_metadata(grids: Sequence[Sequence[int]], pad_to: int = 0) -> dict:
    """Host metadata of a packed batch of images (grids (1, gh, gw) in order), padded to
    `pad_to` rows: `seg` (P,) int32 segment ids (one per image, ascending; pad rows
    PAD_SEG), `pos` (P, 2) int32 (row, column) of each patch in merge-block-major order,
    `pos_idx` (P,) int64 each patch's row in the concatenated resized position grids
    (the tables of `tables`, in order, then one zero row for the pad rows), `tables` the
    distinct (gh, gw) grids, and `win_mode` 0 (no windowed attention)."""
    tables, offs = [], {}
    seg, pos, idx = [], [], []
    total = 0
    for i, (_, gh, gw) in enumerate(grids):
        if (gh, gw) not in offs:
            offs[(gh, gw)] = total
            tables.append((gh, gw))
            total += gh * gw
        rows, cols = _block_major(gh, gw)
        seg.append(np.full(gh * gw, i, np.int32))
        pos.append(np.stack([rows, cols], -1))
        idx.append(offs[(gh, gw)] + rows * gw + cols)
    n = sum(len(s) for s in seg)
    P = max(pad_to, n)
    seg = np.concatenate(seg + [np.full(P - n, PAD_SEG, np.int32)])
    pos = np.concatenate(pos + [np.zeros((P - n, 2), np.int64)]).astype(np.int32)
    idx = np.concatenate(idx + [np.full(P - n, total, np.int64)]).astype(np.int64)
    return {"seg": seg, "pos": pos, "pos_idx": idx, "tables": tuple(tables), "win_mode": 0}


@functools.lru_cache(maxsize=64)
def _block_major(gh: int, gw: int, merge: int = 2):
    """(rows, columns) of a gh x gw grid's patches in merge-block-major order."""
    r = np.arange(gh).reshape(gh // merge, merge, 1, 1)
    c = np.arange(gw).reshape(1, 1, gw // merge, merge)
    rows = np.broadcast_to(r, (gh // merge, merge, gw // merge, merge)).transpose(0, 2, 1, 3).reshape(-1)
    cols = np.broadcast_to(c, (gh // merge, merge, gw // merge, merge)).transpose(0, 2, 1, 3).reshape(-1)
    return rows, cols


def meta_to_device(meta: dict, device) -> dict:
    return {"seg": torch.as_tensor(meta["seg"], dtype=torch.int32, device=device),
            "pos": torch.as_tensor(meta["pos"], dtype=torch.int32, device=device),
            "pos_idx": torch.as_tensor(meta["pos_idx"], dtype=torch.int64, device=device),
            "tables": tuple(meta["tables"])}


def resized_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The (H0, W0, C) position grid at gh x gw: itself, or resized bicubically
    (align_corners=False) in fp32, as (gh * gw, C) rows in row-major order."""
    H0, W0, C = grid.shape
    if (gh, gw) == (H0, W0):
        return grid.reshape(gh * gw, C)
    g = F.interpolate(grid.permute(2, 0, 1)[None].float(), size=(gh, gw), mode="bicubic", align_corners=False)
    return g[0].permute(1, 2, 0).reshape(gh * gw, C).to(grid.dtype)


def rope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """pos (P, 2) (row, column) -> cos, sin (P, head_dim / 2) fp32: pair 2j turns by
    column * w_j, pair 2j + 1 by row * w_j, w_j = theta^(-4 j / head_dim)."""
    w = theta ** (-torch.arange(0, head_dim, 4, device=pos.device, dtype=torch.float32)[: head_dim // 4] / head_dim)
    ang = torch.stack([pos[:, 1, None].float() * w, pos[:, 0, None].float() * w], dim=-1).reshape(pos.shape[0], -1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_2d(x: torch.Tensor, cos, sin, scale: float = 1.0) -> torch.Tensor:
    """x (P, H, D) with its adjacent pairs turned as complex numbers by cos/sin
    (P, D / 2), times `scale`, in fp32, rounded once to x.dtype."""
    P, H, D = x.shape
    xf = x.float().reshape(P, H, D // 2, 2)
    c, s = cos[:, None], sin[:, None]
    a, b = xf[..., 0], xf[..., 1]
    out = torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(P, H, D)
    return (out * scale if scale != 1.0 else out).to(x.dtype)


def _block(p, cfg: MoonViTConfig, x, seg, cos, sin):
    P, C = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    Dk = kernel_head_dim(D)
    h = layer_norm(x, p["norm0"]["scale"], p["norm0"]["bias"], cfg.layer_norm_eps)
    qkv = (h @ p["wqkv"] + p["bqkv"]).reshape(P, 3, H, D)
    q = apply_rope_2d(qkv[:, 0], cos, sin, math.sqrt(Dk / D))
    k = apply_rope_2d(qkv[:, 1], cos, sin)
    v = qkv[:, 2]
    if Dk != D:
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    a = flash_segment_attention(q, k, v, seg)[..., :D].reshape(P, C)
    x = x + a @ p["wo"] + p["bo"]
    h = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], cfg.layer_norm_eps)
    return x + F.gelu(h @ p["w0"] + p["b0"], approximate="tanh") @ p["w1"] + p["b1"]


def moonvit_forward(params, cfg: MoonViTConfig, pixel_values: torch.Tensor, meta: dict) -> torch.Tensor:
    """Packed patches (P, 588), float or uint8, in the processor's order, with device
    metadata (meta_to_device) -> (P / 4, out_hidden_size) decoder embeddings, each
    image's merge blocks in order, the pad rows' at the tail."""
    w = params["patch_embed"]["w"]
    if pixel_values.dtype == torch.uint8:
        pixel_values = (pixel_values.float() / 255.0 - cfg.image_mean) / cfg.image_std
    x = pixel_values.to(w.dtype) @ w + params["patch_embed"]["b"]
    grid = params["pos_emb"]
    tables = [resized_grid(grid, gh, gw) for gh, gw in meta["tables"]] + [grid.new_zeros((1, grid.shape[-1]))]
    x = x + torch.cat(tables).index_select(0, meta["pos_idx"])
    cos, sin = rope_cos_sin(meta["pos"], cfg.head_dim, cfg.rope_theta)
    for blk in params["blocks"]:
        x = _block(blk, cfg, x, meta["seg"], cos, sin)
    x = layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps)
    pj = params["projector"]
    x = layer_norm(x, pj["ln"]["scale"], pj["ln"]["bias"], cfg.layer_norm_eps).reshape(-1, cfg.merge_unit * x.shape[-1])
    x = F.gelu(x @ pj["w1"] + pj["b1"], approximate="none")
    return x @ pj["w2"] + pj["b2"]
