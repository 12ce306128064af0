"""MiMo-V2.5's counts, frozen here: the model FLOPs of a question's live work (the
numerator of `mfu.eval` in its cell) and the least work of each attention launch the
`*_roofline` metrics read (K2 at key width 192 and value width 128 with and without the
band, K6 in the window and the global layers; the held experts' grouped products are
counted as Kimi-VL's, portbench/work/kimi_vl.py::grouped_work).
Products only (2 per multiply-add). Configurations are the benchmark's JSON files (the
decoder's HF keys at the top level, `n_routed_experts` the experts held on this chip,
`expert_parallel` the chips that share a routed layer).

Model FLOPs count what this chip computes of the cut model: per token the fused q | k |
v and the o products of every layer; 2 H (192 + 128) per (query, key) pair the two
attention products need, a window layer's pairs only within its window; the dense SwiGLU
in the first layer; in every routed layer the router over all experts and the held
share of the 8 picks, k x held / router width (1 expert a token here, as the deployment
spreads them); the head per logits row. The vision tower is the Qwen2.5-VL tower's
count (portbench/work/model_flops.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .model_flops import qwen_vit


def _kind(cfg: dict, i: int):
    """(H, Hkv, dq, dv, window) of layer i."""
    if cfg["hybrid_layer_pattern"][i] == 1:
        return (cfg["swa_num_attention_heads"], cfg["swa_num_key_value_heads"], cfg["swa_head_dim"],
                cfg["swa_v_head_dim"], cfg["sliding_window"])
    return cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"], cfg["v_head_dim"], 0


def _pairs(n_new: int, ctx0: int, window: int) -> int:
    """(query, key) pairs of n_new tokens appended after ctx0, causal, within window keys (0: all)."""
    if not window:
        return n_new * ctx0 + n_new * (n_new + 1) // 2
    return sum(min(p + 1, window) for p in range(ctx0, ctx0 + n_new))


def decoder_pass(cfg: dict, n_new: int, ctx0: int, logits_rows: int) -> int:
    """n_new tokens appended after ctx0 cached ones, each attending causally (window layers within their window)."""
    E = cfg["hidden_size"]
    width = cfg["n_routed_experts"] * cfg.get("expert_parallel", {"size": 1})["size"]
    held_share = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / width
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        H, Hkv, dq, dv, window = _kind(cfg, i)
        per_token = E * (H * dq + Hkv * (dq + dv)) + H * dv * E
        if cfg["moe_layer_freq"][i]:
            per_token += E * width + held_share * 3 * E * cfg["moe_intermediate_size"]
        else:
            per_token += 3 * E * cfg["intermediate_size"]
        total += 2 * per_token * n_new + 2 * H * (dq + dv) * _pairs(n_new, ctx0, window)
    return int(total) + 2 * E * cfg["vocab_size"] * logits_rows


def decode_steps(cfg: dict, n_steps: int, ctx0: int) -> int:
    return decoder_pass(cfg, n_steps, ctx0, n_steps)


def eval_question(cfg: dict, len1: int, out1: int, kept: int, chunk: int, out2: int,
                  grid1: Sequence[int], grid2: Sequence[int]) -> int:
    """A two-stage episode with KV reuse: the stage-1 image and prompt, its decode, the
    crop and the stage-2 chunk over the kept cache, its decode."""
    f = qwen_vit(cfg, grid1) + decoder_pass(cfg, len1, 0, 1) + decode_steps(cfg, max(out1 - 1, 0), len1)
    if out2 or chunk:
        ctx = len1 + kept
        f += qwen_vit(cfg, grid2) + decoder_pass(cfg, chunk, ctx, 1) + decode_steps(cfg, max(out2 - 1, 0), ctx + chunk)
    return f


def attention_work(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, DV: int, T: int,
                   window: int = 0) -> tuple[int, int]:
    """K2 at key width D and value width DV, with a band of `window` keys (0: causal): both
    products over each query's live keys (2 H (D + DV) a pair), q read and out written
    once, and each row's k and v rows that any of its queries sees read once (bf16)."""
    klen = kv_len.long().clamp(0, T)
    pos = positions.long().clamp(-1, T - 1)
    hi = torch.minimum(pos + 1, klen[:, None])
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    live = (hi - lo).clamp(min=0)
    rows = (torch.minimum(pos.amax(1) + 1, klen) - lo.amin(1)).clamp(min=0)
    return (2 * H * (D + DV) * int(live.sum()),
            2 * (positions.numel() * H * (D + DV) + int(rows.sum()) * Hkv * (D + DV)))


def decode_work(kv_len: torch.Tensor, T: int, H: int, Hkv: int, D: int, DV: int, window: int = 0) -> tuple[int, int]:
    """K6: both products over each row's attended slots (the last min(kv_len, window), all
    kv_len at window 0), each such slot's k and v rows of every KV head read once, q read
    and out written once (bf16)."""
    klen = kv_len.to(torch.int64).clamp(0, T)
    live = int((klen.clamp(max=window) if window else klen).sum())
    B = kv_len.shape[0]
    return 2 * H * (D + DV) * live, 2 * (live * Hkv * (D + DV) + B * H * (D + DV))
