"""Qwen2.5-VL vision tower (port of models/vit.py).

The host metadata (`VisionMetadata`, `window_index`, `vision_metadata`,
`_window_gather_plan`) is a verbatim numpy copy of the reference's, held equal to it
by exact-equality tests. The forward takes that metadata as device tensors:

- full-attention blocks (and windowed blocks when win_mode == 0) run K1,
  `flash_segment_attention`;
- windowed blocks with win_mode 2 / 1 run the plain reshape / gather-plan paths,
  which the reference also computes outside any kernel.

Params are the reference's tree of (in, out) matrices (see params.init_vision_params).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VisionConfig
from ..image.preprocess import IMAGE_MEAN, IMAGE_STD
from ..ops.attention import LOCAL_BLOCK, gather_window_attention, window_block_attention
from ..ops.flash_attention import PAD_SEG, flash_segment_attention
from .rope import apply_rotary, vision_pos_ids, vision_rope_cos_sin


@dataclasses.dataclass(frozen=True)
class VisionMetadata:
    """Host-computed, shape-static ViT forward metadata for one packed image batch."""

    perm: np.ndarray  # (S,) int32: patch permutation into window order
    inv_perm_merged: np.ndarray  # (S/m²,) int32: merged-token perm back to image order (pads map to the identity tail)
    seg_window: np.ndarray  # (S,) int32 window id per patch (window order); pad = PAD_SEG
    seg_full: np.ndarray  # (S,) int32 image id per patch (window order); pad = PAD_SEG
    pos_ids: np.ndarray  # (S, 2) int32 rotary (h, w) ids per patch (window order)
    num_patches: int  # real (unpadded) patch count
    # windowed-attention dispatch: 2 = every aligned 64-row block is one window
    # (window_block_attention); 1 = windows straddle block edges, use the gather
    # plan below (gather_window_attention); 0 = the segment kernel.
    win_mode: int = 0
    win_gidx: np.ndarray | None = None  # (NW*64,) int32
    win_valid: np.ndarray | None = None  # (NW, 64) bool
    win_sidx: np.ndarray | None = None  # (S,) int32


def window_index(grid_thw: Sequence[Sequence[int]], cfg: VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per merged-token window permutation + window id, concatenated over images.

    Returns (index, window_ids) both of length sum(t*h*w)/merge_unit. `index` lists
    merged-token indices in window-major order; `window_ids` is the window id of each
    listed token (globally unique across images).
    """
    vit_ws = cfg.window_size // cfg.spatial_merge_size // cfg.patch_size  # merged tokens per window side
    index_out, wid_out = [], []
    base = 0
    wid_base = 0
    for t, h, w in grid_thw:
        llm_h, llm_w = h // cfg.spatial_merge_size, w // cfg.spatial_merge_size
        idx = np.arange(t * llm_h * llm_w).reshape(t, llm_h, llm_w)
        pad_h = (-llm_h) % vit_ws
        pad_w = (-llm_w) % vit_ws
        nwh, nww = (llm_h + pad_h) // vit_ws, (llm_w + pad_w) // vit_ws
        padded = np.full((t, llm_h + pad_h, llm_w + pad_w), -100, dtype=np.int64)
        padded[:, :llm_h, :llm_w] = idx
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t * nwh * nww, vit_ws * vit_ws)
        wids = np.broadcast_to(np.arange(padded.shape[0])[:, None], padded.shape)
        keep = padded != -100
        index_out.append(padded[keep] + base)
        wid_out.append(wids[keep] + wid_base)
        base += t * llm_h * llm_w
        wid_base += padded.shape[0]
    return np.concatenate(index_out), np.concatenate(wid_out)


def vision_metadata(
    grid_thw: Sequence[Sequence[int]], cfg: VisionConfig, pad_to: int = 0
) -> VisionMetadata:
    """Compute all host-side metadata for a packed batch of image grids.

    pad_to: optionally pad the patch dimension to this bucket size (multiple of
    merge_unit); pad patches get segment id PAD_SEG (sorts last, keeping ids ascending
    for the segment kernel) so attention isolates them. Memoized on (grids, cfg,
    pad_to); treat results as read-only.
    """
    key = (tuple(tuple(int(v) for v in g) for g in grid_thw), cfg, int(pad_to))
    return _vision_metadata_cached(key)


@functools.lru_cache(maxsize=256)
def _vision_metadata_cached(key) -> VisionMetadata:
    grid_thw, cfg, pad_to = key
    m2 = cfg.merge_unit
    n_patches = sum(t * h * w for t, h, w in grid_thw)
    if len(cfg.fullatt_block_indexes) >= cfg.depth:
        # Window-free family (Qwen2-VL): no reorder; every "window" is the image.
        n_merged = n_patches // m2
        midx = np.arange(n_merged)
        wids = np.concatenate(
            [np.full(t * h * w // m2, i) for i, (t, h, w) in enumerate(grid_thw)]
        )
    else:
        midx, wids = window_index(grid_thw, cfg)  # merged-token level
    # Expand merged-token permutation to patch level: merged token j covers patches
    # [j*m2, (j+1)*m2) in emission order.
    perm = (midx[:, None] * m2 + np.arange(m2)[None, :]).reshape(-1)
    seg_window = np.repeat(wids, m2)
    # image id per merged token (in image order), then permuted to window order
    img_ids_merged = np.concatenate(
        [np.full(t * h * w // m2, i) for i, (t, h, w) in enumerate(grid_thw)]
    )
    seg_full = np.repeat(img_ids_merged[midx], m2)
    pos = vision_pos_ids(grid_thw, cfg.spatial_merge_size)[perm]  # window order
    inv_perm_merged = np.argsort(midx)

    if pad_to and pad_to > n_patches:
        pad_n = pad_to - n_patches
        assert pad_n % m2 == 0, "bucket size must be a multiple of merge_unit"
        perm = np.concatenate([perm, np.arange(n_patches, pad_to)])
        seg_window = np.concatenate([seg_window, np.full(pad_n, PAD_SEG)])
        seg_full = np.concatenate([seg_full, np.full(pad_n, PAD_SEG)])
        pos = np.concatenate([pos, np.zeros((pad_n, 2), dtype=pos.dtype)])
        # identity tail: the ViT output row count stays pad_to/m2, a function of the
        # bucket and not of the real image mix
        n_merged = n_patches // m2
        inv_perm_merged = np.concatenate(
            [inv_perm_merged, np.arange(n_merged, pad_to // m2)]
        )

    # windowed-attention mode: window_index emits each window as a contiguous
    # ascending run, so a segment's span equals its patch count; the pad tail is one
    # long PAD_SEG run whose output rows are dropped downstream.
    win_mode = 0
    win_gidx = win_valid = win_sidx = None
    S_total = len(seg_window)

    if S_total % LOCAL_BLOCK == 0 and S_total > 0:
        blocks = seg_window.reshape(-1, LOCAL_BLOCK)
        first = blocks[:, 0]
        # uniform: each aligned block holds exactly one segment AND no segment spans
        # two blocks (adjacent equal ids are only allowed for the PAD tail)
        uniform = bool(np.all(blocks == blocks[:, :1])) and bool(
            np.all((first[1:] != first[:-1]) | (first[1:] == PAD_SEG))
        )
        if uniform:
            win_mode = 2
        else:
            real = seg_window[seg_window != PAD_SEG]
            if real.size and np.bincount(real - real.min()).max() <= LOCAL_BLOCK:
                plan = _window_gather_plan(seg_window, LOCAL_BLOCK)
                if plan is not None:
                    win_mode = 1
                    win_gidx, win_valid, win_sidx = plan

    return VisionMetadata(
        perm=perm.astype(np.int32),
        inv_perm_merged=inv_perm_merged.astype(np.int32),
        seg_window=seg_window.astype(np.int32),
        seg_full=seg_full.astype(np.int32),
        pos_ids=pos.astype(np.int32),
        num_patches=n_patches,
        win_mode=win_mode,
        win_gidx=win_gidx,
        win_valid=win_valid,
        win_sidx=win_sidx,
    )


def _window_gather_plan(seg: np.ndarray, lmax: int):
    """Gather plan for gather_window_attention: split the contiguous ascending runs of
    `seg` into pseudo-windows of <= lmax rows (only the PAD tail run can exceed lmax),
    then emit (gidx, valid, sidx). Returns None when the padded layout would more than
    double the row count."""
    S = len(seg)
    bounds = np.flatnonzero(np.diff(seg)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [S]])
    pieces = []
    for st, en in zip(starts, ends):
        for off in range(int(st), int(en), lmax):
            pieces.append((off, min(lmax, int(en) - off)))
    nw = len(pieces)
    if nw * lmax > 2 * S:
        return None
    gidx = np.zeros((nw, lmax), np.int32)
    valid = np.zeros((nw, lmax), bool)
    sidx = np.zeros((S,), np.int32)
    for w, (st, ln) in enumerate(pieces):
        gidx[w, :ln] = np.arange(st, st + ln)
        valid[w, :ln] = True
        sidx[st : st + ln] = w * lmax + np.arange(ln)
    return gidx.reshape(-1), valid, sidx


def meta_to_device(meta: dict, device) -> dict:
    """Host metadata dict (PreparedBatch.vision_meta) -> device tensors for
    vit_forward. Index arrays become int64, segment ids stay int32 (K1 reads int32)."""
    get = meta.get
    out = {
        "perm": torch.as_tensor(get("perm"), dtype=torch.int64, device=device),
        "inv_perm_merged": torch.as_tensor(get("inv_perm_merged"), dtype=torch.int64, device=device),
        "seg_window": torch.as_tensor(get("seg_window"), dtype=torch.int32, device=device),
        "seg_full": torch.as_tensor(get("seg_full"), dtype=torch.int32, device=device),
        "pos_ids": torch.as_tensor(get("pos_ids"), dtype=torch.int32, device=device),
    }
    if get("win_gidx") is not None:
        out["win_gidx"] = torch.as_tensor(get("win_gidx"), dtype=torch.int64, device=device)
        out["win_valid"] = torch.as_tensor(get("win_valid"), dtype=torch.bool, device=device)
        out["win_sidx"] = torch.as_tensor(get("win_sidx"), dtype=torch.int64, device=device)
    return out


def rms_norm(x, scale, eps):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * scale


def layer_norm(x, scale, bias, eps):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps)).to(dtype) * scale + bias


def _vit_norm(p, cfg: VisionConfig, x):
    if cfg.norm_type == "layer":
        return layer_norm(x, p["scale"], p["bias"], 1e-6)
    return rms_norm(x, p["scale"], cfg.rms_norm_eps)


def _vit_mlp(p, cfg: VisionConfig, h, tp=None):
    """The block's MLP; with `tp` on this rank's slice of the width where the rules
    split its matrices (the replicated column biases sliced, the row bias added after
    the all-reduce)."""
    if tp is not None:
        p, split = tp.block(p, cols=("wg", "wu", "w1"), rows=("wd", "w2"), col_biases=("bg", "bu", "b1"))
        if split:
            h = tp.f(h)
            if cfg.mlp_type == "gelu_fc":
                z = h @ p["w1"] + p["b1"]
                z = z * torch.sigmoid(1.702 * z) if cfg.hidden_act == "quick_gelu" else F.gelu(z, approximate="none")
                return tp.g(z @ p["w2"]) + p["b2"]
            return tp.g((F.silu(h @ p["wg"] + p["bg"]) * (h @ p["wu"] + p["bu"])) @ p["wd"]) + p["bd"]
    if cfg.mlp_type == "gelu_fc":
        z = h @ p["w1"] + p["b1"]
        if cfg.hidden_act == "quick_gelu":
            z = z * torch.sigmoid(1.702 * z)
        else:
            z = F.gelu(z, approximate="none")
        return z @ p["w2"] + p["b2"]
    g = F.silu(h @ p["wg"] + p["bg"])
    u = h @ p["wu"] + p["bu"]
    return (g * u) @ p["wd"] + p["bd"]


def _vit_block(params, cfg: VisionConfig, x, seg, cos, sin, attn_fn=flash_segment_attention, tp=None):
    """One ViT block: norm -> segment attention (2D RoPE) -> norm -> MLP. With `tp` the
    attention runs on this rank's heads where the rules split wqkv and wo (the
    head-aligned pieces of parallel/mesh.py), the output bias added after the
    all-reduce."""
    S = x.shape[0]
    h = _vit_norm(params["norm1"], cfg, x)
    p, split = params["attn"], False
    if tp is not None:
        p, split = tp.at("attn").block(p, cols=("wqkv",), rows=("wo",))
        if split:
            h = tp.f(h)
    qkv = h @ p["wqkv"] + p["bqkv"]
    qkv = qkv.reshape(S, 3, -1, cfg.head_dim)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    attn = attn_fn(q, k, v, seg)
    if split:
        attn = tp.g(attn.reshape(S, -1) @ p["wo"]) + p["bo"]
    else:
        attn = attn.reshape(S, cfg.hidden_size) @ p["wo"] + p["bo"]
    x = x + attn
    h = _vit_norm(params["norm2"], cfg, x)
    return x + _vit_mlp(params["mlp"], cfg, h, None if tp is None else tp.at("mlp"))


def vit_forward(
    params,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # (S, patch_dim) conv-patch layout, float or uint8
    perm: torch.Tensor,  # (S,) int64 (meta_to_device)
    inv_perm_merged: torch.Tensor,  # (S/m²,) int64
    seg_window: torch.Tensor,  # (S,) int32
    seg_full: torch.Tensor,  # (S,) int32
    pos_ids: torch.Tensor,  # (S, 2)
    win_mode: int = 0,
    win_plan=None,  # (win_gidx, win_valid, win_sidx); required iff win_mode == 1
    tp=None,  # parallel.collectives.TensorParallel at params (a tensor mesh's training forward)
) -> torch.Tensor:
    """Packed ViT forward -> (S/m², out_hidden_size) merged vision embeddings in image
    order: real merged tokens first, bucket pad rows at the tail.

    uint8 pixel_values are CLIP-normalized here, in the numpy op order. Compact
    single-frame patches fold the patch-embed kernel's temporal row-slices."""
    if pixel_values.dtype == torch.uint8:
        reps = pixel_values.shape[-1] // cfg.in_channels
        mean_col = torch.from_numpy(np.repeat(IMAGE_MEAN, reps)).to(pixel_values.device)
        std_col = torch.from_numpy(np.repeat(IMAGE_STD, reps)).to(pixel_values.device)
        pixel_values = (pixel_values.float() / 255.0 - mean_col) / std_col
    kernel = params["patch_embed"]["kernel"]
    if pixel_values.shape[-1] != kernel.shape[0]:
        # compact patches: x_dup @ K == x_compact @ (sum of K's temporal row-slices)
        t_rep = kernel.shape[0] // pixel_values.shape[-1]
        per_ch = pixel_values.shape[-1] // cfg.in_channels
        folded = kernel.float().reshape(cfg.in_channels, t_rep, per_ch, -1)
        kernel = folded.sum(dim=1).reshape(cfg.in_channels * per_ch, -1).to(kernel.dtype)
    x = pixel_values.to(kernel.dtype) @ kernel
    x = x.index_select(0, perm)  # into window order
    cos, sin = vision_rope_cos_sin(pos_ids, cfg.head_dim)
    if win_mode == 2:
        win_attn = lambda q, k, v, seg: window_block_attention(q, k, v)  # noqa: E731
    elif win_mode == 1:
        gp, vp, sp = win_plan
        win_attn = lambda q, k, v, seg: gather_window_attention(q, k, v, gp, vp, sp)  # noqa: E731
    else:
        win_attn = flash_segment_attention
    for i in range(cfg.depth):
        if i in cfg.fullatt_block_indexes:
            seg, attn_fn = seg_full, flash_segment_attention
        else:
            seg, attn_fn = seg_window, win_attn
        x = _vit_block(params["blocks"][i], cfg, x, seg, cos, sin, attn_fn, None if tp is None else tp.at("blocks", i))
    # Patch merger: norm, merge each group of merge_unit consecutive patches (window
    # order), 2-layer MLP (w0 column-split and w1 row-split over a tensor mesh).
    m = params["merger"]
    x = _vit_norm(m["ln_q"], cfg, x)
    x = x.reshape(-1, cfg.merge_unit * cfg.hidden_size)
    if tp is not None:
        m, split = tp.at("merger").block(m, cols=("w0",), rows=("w1",), col_biases=("b0",))
        if split:
            x = F.gelu(tp.f(x) @ m["w0"] + m["b0"], approximate="none")
            return (tp.g(x @ m["w1"]) + m["b1"]).index_select(0, inv_perm_merged)
    x = F.gelu(x @ m["w0"] + m["b0"], approximate="none")
    x = x @ m["w1"] + m["b1"]
    return x.index_select(0, inv_perm_merged)
