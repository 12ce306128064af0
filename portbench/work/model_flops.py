"""Frozen model-FLOP counts of the live work (tokens and patches, no bucket padding),
the numerators of the `mfu.*` metrics. Products only (2 per multiply-add), attention
as 4 D H per (query, key) pair it needs, the language head per logits row made.
Configurations are the benchmark's JSON files (HF keys).
"""

from __future__ import annotations

from typing import Sequence


def _text(cfg: dict):
    Hd, It = cfg["hidden_size"], cfg["intermediate_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim", Hd // H)
    per_layer = Hd * H * D * 2 + 2 * Hd * Hkv * D + 3 * Hd * It
    return per_layer, cfg["num_hidden_layers"], H, D, Hd, cfg["vocab_size"]


def decoder_pass(cfg: dict, n_new: int, ctx0: int, logits_rows: int) -> int:
    """n_new tokens appended after ctx0 cached ones, each attending causally."""
    per_layer, L, H, D, Hd, V = _text(cfg)
    pairs = n_new * ctx0 + n_new * (n_new + 1) // 2
    return 2 * per_layer * L * n_new + 4 * D * H * L * pairs + 2 * Hd * V * logits_rows


def decode_steps(cfg: dict, n_steps: int, ctx0: int) -> int:
    """n_steps one-token steps after ctx0 cached tokens, each making a logits row."""
    return decoder_pass(cfg, n_steps, ctx0, n_steps)


def qwen_vit(cfg: dict, grid: Sequence[int]) -> int:
    """One image through the Qwen2.5-VL vision tower (windowed and full blocks, merger)."""
    v = cfg["vision_config"]
    E, I, nh, m = v["hidden_size"], v["intermediate_size"], v["num_heads"], v["spatial_merge_size"]
    hd = E // nh
    patch_dim = v["in_chans"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    _, gh, gw = grid
    N = gh * gw
    ws = v["window_size"] // v["patch_size"] // m
    bh, bw = gh // m, gw // m
    win_pairs = sum((min(ws, bh - r) * min(ws, bw - c) * m * m) ** 2
                    for r in range(0, bh, ws) for c in range(0, bw, ws))
    n_full = len(v["fullatt_block_indexes"])
    attn = 4 * hd * nh * (n_full * N * N + (v["depth"] - n_full) * win_pairs)
    blocks = 2 * N * v["depth"] * (4 * E * E + 3 * E * I)
    merger = 2 * (N // (m * m)) * ((m * m * E) ** 2 + m * m * E * v["out_hidden_size"])
    return 2 * N * patch_dim * E + blocks + attn + merger


def eval_question(cfg: dict, len1: int, out1: int, kept: int, chunk: int, out2: int,
                  grid1: Sequence[int], grid2: Sequence[int]) -> int:
    """A two-stage ZoomEarth episode with KV reuse: the stage-1 image and prompt, its
    decode, the crop and the stage-2 chunk over the kept cache, its decode."""
    f = qwen_vit(cfg, grid1) + decoder_pass(cfg, len1, 0, 1) + decode_steps(cfg, max(out1 - 1, 0), len1)
    if out2 or chunk:
        ctx = len1 + kept
        f += qwen_vit(cfg, grid2) + decoder_pass(cfg, chunk, ctx, 1) + decode_steps(cfg, max(out2 - 1, 0), ctx + chunk)
    return f

