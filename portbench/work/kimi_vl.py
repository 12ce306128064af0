"""Kimi-VL's counts, frozen here: the model FLOPs of a question's live work (the
numerator of `mfu.eval` in its cell) and the least work of each kernel launch the
`*_roofline` metrics read (K5, K2 at key width 192 and value width 128, the grouped
expert products). Products only (2 per multiply-add). Configurations are the
benchmark's JSON files (HF keys; the text keys at the top level).

Model FLOPs count the published, expanded form of latent attention: per token the q,
kv_a, kv_b and o products; 2 H (192 + 128) per (query, key) pair the two attention
products need; the dense SwiGLU in the first layer; in every other layer the router,
the 6 chosen experts' three products and the shared experts'; the head per logits row.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _layers(cfg: dict):
    """(per-token product FLOPs of the attention, of a dense layer's MLP, of a routed
    layer's MLP; number of dense layers, of routed layers)."""
    E, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    attn = 2 * (E * H * (dn + dr) + E * (r + dr) + r * H * (dn + dv) + H * dv * E)
    dense = 2 * 3 * E * cfg["intermediate_size"]
    F_ = cfg["moe_intermediate_size"]
    routed = 2 * (E * cfg["n_routed_experts"] + 3 * E * F_ * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    L = cfg["num_hidden_layers"]
    n_dense = sum(1 for i in range(L) if i < cfg["first_k_dense_replace"] or i % cfg["moe_layer_freq"] != 0)
    return attn, dense, routed, n_dense, L - n_dense


def decoder_pass(cfg: dict, n_new: int, ctx0: int, logits_rows: int) -> int:
    """n_new tokens appended after ctx0 cached ones, each attending causally."""
    attn, dense, routed, n_dense, n_routed = _layers(cfg)
    H = cfg["num_attention_heads"]
    pairs = n_new * ctx0 + n_new * (n_new + 1) // 2
    per_pair = 2 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    L = n_dense + n_routed
    return (n_new * (L * attn + n_dense * dense + n_routed * routed) + L * per_pair * pairs
            + 2 * cfg["hidden_size"] * cfg["vocab_size"] * logits_rows)


def decode_steps(cfg: dict, n_steps: int, ctx0: int) -> int:
    return decoder_pass(cfg, n_steps, ctx0, n_steps)


def moonvit(cfg: dict, grid: Sequence[int]) -> int:
    """One image through MoonViT and the projector."""
    v = cfg["vision_config"]
    C, I, nh = v["hidden_size"], v["intermediate_size"], v["num_attention_heads"]
    _, gh, gw = grid
    N = gh * gw
    patch_dim = 3 * v["patch_size"] ** 2
    blocks = v["num_hidden_layers"] * (2 * N * (4 * C * C + 2 * C * I) + 4 * (C // nh) * nh * N * N)
    m = 4 * C
    projector = 2 * (N // 4) * (m * m + m * cfg["hidden_size"])
    return 2 * N * patch_dim * C + blocks + projector


def eval_question(cfg: dict, len1: int, out1: int, kept: int, chunk: int, out2: int,
                  grid1: Sequence[int], grid2: Sequence[int]) -> int:
    """A two-stage episode with KV reuse: the stage-1 image and prompt, its decode, the
    crop and the stage-2 chunk over the kept cache, its decode."""
    f = moonvit(cfg, grid1) + decoder_pass(cfg, len1, 0, 1) + decode_steps(cfg, max(out1 - 1, 0), len1)
    if out2 or chunk:
        ctx = len1 + kept
        f += moonvit(cfg, grid2) + decoder_pass(cfg, chunk, ctx, 1) + decode_steps(cfg, max(out2 - 1, 0), ctx + chunk)
    return f


def mla_decode_work(kv_len: torch.Tensor, T: int, H: int, Dk: int, Dv: int) -> tuple[int, int]:
    """K5: both products over each row's live slots (2 H (Dk + Dv) a slot: 16 x 1088 x 2
    at Kimi-VL's widths), the live latent rows read once (Dk x 2 bytes each), q read and
    out written once (bf16)."""
    live = int(kv_len.to(torch.int64).clamp(0, T).sum())
    return 2 * H * (Dk + Dv) * live, 2 * live * Dk + 2 * kv_len.shape[0] * H * (Dk + Dv)


def mla_prefill_work(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, DV: int,
                     T: int, rope: int) -> tuple[int, int]:
    """K2 at key width D and value width DV: both products over each query's live keys
    (2 H (D + DV) a pair), q read and out written once, and of each k / v row any query
    of the row sees, the per-head parts read once and the `rope` dims of k that every
    head shares (latent attention's k_r) once for all heads (bf16)."""
    klen = kv_len.long().clamp(0, T)[:, None]
    live = torch.minimum(positions.long().clamp(-1, T - 1) + 1, klen)
    rows = int(live.amax(1).sum())
    n = positions.numel() * H
    return 2 * H * (D + DV) * int(live.sum()), 2 * (n * (D + DV) + rows * (Hkv * (D - rope + DV) + rope))


def grouped_work(offs: torch.Tensor, K: int, N: int) -> tuple[int, int]:
    """One grouped product over the sorted rows: 2 M K N flops for its M rows, the
    weights of the experts that got a row read once, the rows read and written once
    (bf16)."""
    ends = offs.long()
    sizes = torch.diff(ends, prepend=ends.new_zeros(1))
    M, touched = int(ends[-1]), int((sizes > 0).sum())
    return 2 * M * K * N, 2 * (touched * K * N + M * (K + N))
