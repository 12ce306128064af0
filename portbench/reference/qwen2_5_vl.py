"""Plain PyTorch reference of Qwen2.5-VL, written from the published architecture
(the model card and HF transformers' description of Qwen2.5-VL): no kernels, no
cache, no batching, float32 with TF32 off.

Vision: the 14 px patches of an image (2 frames of a still image) embedded by one
product; 2D rotary positions (the patch's row in the first half of each head's
rotary angles, its column in the second); blocks of RMSNorm, attention with bias
over qkv and out, and a SwiGLU MLP with bias; attention within windows of 4 x 4
merged units (8 x 8 patches) except in the full-attention blocks, which see the
whole image; then RMSNorm and the 2 x 2 merger MLP (GELU). Decoder: Qwen2.5 layers,
RMSNorm, GQA attention with q/k/v bias, M-RoPE (rotary angle sections from the
temporal, height and width position planes), SwiGLU, tied embeddings.

Weights are read by name from the benchmark's dict (HF names, Linear weights stored
(in, out)). `linear` is the one place where a product happens, so the control can
put a lower precision there.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Precision:
    """fp32: the reference. fp8: the control, each product's weight and input rounded
    to float8 e4m3 with a per-tensor (weight) and per-row (input) scale."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(name)
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        w = w.float()
        if self.name == "fp8":
            w = fp8_round(w, None)
            x = fp8_round(x, -1)
        y = x @ w
        return y if b is None else y + b.float()


def fp8_round(t: torch.Tensor, dim) -> torch.Tensor:
    """t rounded to float8 e4m3 at its scale; a gradient passes through unrounded."""
    with torch.no_grad():
        amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
        scale = (amax / 448.0).clamp(min=1e-12)
        rounded = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t).detach() if t.requires_grad else rounded


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def attention(q, k, v, mask):
    """q (S, H, D), k/v (T, H, D), mask (S, T) bool or None -> (S, H * D)."""
    logits = torch.einsum("shd,thd->hst", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("hst,thd->shd", logits.softmax(-1), v).reshape(q.shape[0], -1)


def run_block(fn, *args):
    return fn(*args)


def vision_forward(W: Dict, cfg: dict, patches: np.ndarray, grid: Sequence[int], prec: Precision,
                   block=run_block) -> torch.Tensor:
    """One image's patches (N, patch_dim), in the processor's order -> (N / 4, out)
    merged embeddings. block(fn, x) runs each block (training checkpoints it)."""
    v = cfg["vision_config"]
    dev = W["visual.patch_embed.proj.weight"].device
    E, nh, m = v["hidden_size"], v["num_heads"], v["spatial_merge_size"]
    hd = E // nh
    _, gh, gw = grid
    N = gh * gw
    x = prec.linear(torch.as_tensor(patches, device=dev).float(), W["visual.patch_embed.proj.weight"])
    idx = torch.arange(N, device=dev)
    bw = gw // m
    wi, hi = idx % m, (idx // m) % m
    bcol, brow = (idx // (m * m)) % bw, idx // (m * m * bw)
    hpos, wpos = brow * m + hi, bcol * m + wi
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd // 2, 2, device=dev).float() / (hd // 2)))
    freqs = torch.cat([hpos[:, None] * inv, wpos[:, None] * inv], -1)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    ws = v["window_size"] // v["patch_size"] // m  # merged units per window side
    win = (brow // ws) * (-(-bw // ws)) + bcol // ws
    win_mask = win[:, None] == win[None, :]
    full = set(v["fullatt_block_indexes"])

    def one_block(i, x):
        b = f"visual.blocks.{i}."
        h = rms(x, W[b + "norm1.weight"], 1e-6)
        qkv = prec.linear(h, W[b + "attn.qkv.weight"], W[b + "attn.qkv.bias"]).reshape(N, 3, nh, hd)
        q, k, vv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        a = attention(q, k, vv, None if i in full else win_mask)
        x = x + prec.linear(a, W[b + "attn.proj.weight"], W[b + "attn.proj.bias"])
        h = rms(x, W[b + "norm2.weight"], 1e-6)
        g = prec.linear(h, W[b + "mlp.gate_proj.weight"], W[b + "mlp.gate_proj.bias"])
        u = prec.linear(h, W[b + "mlp.up_proj.weight"], W[b + "mlp.up_proj.bias"])
        return x + prec.linear(F.silu(g) * u, W[b + "mlp.down_proj.weight"], W[b + "mlp.down_proj.bias"])

    for i in range(v["depth"]):
        x = block(functools.partial(one_block, i), x)
    x = rms(x, W["visual.merger.ln_q.weight"], 1e-6).reshape(N // (m * m), -1)
    x = F.gelu(prec.linear(x, W["visual.merger.mlp.0.weight"], W["visual.merger.mlp.0.bias"]))
    return prec.linear(x, W["visual.merger.mlp.2.weight"], W["visual.merger.mlp.2.bias"])


def rope_index(ids: Sequence[int], grids: Sequence[Sequence[int]], image_token: int, merge: int) -> np.ndarray:
    """M-RoPE positions (3, S) of a sequence: text tokens step all three planes by one;
    an image's tokens sit at (start, start + row, start + col) of its merged grid, and
    the text after it starts one past the largest of them."""
    pos = np.zeros((3, len(ids)), np.int64)
    nxt, i, g = 0, 0, 0
    while i < len(ids):
        if ids[i] == image_token:
            _, gh, gw = grids[g]
            h, w = gh // merge, gw // merge
            rows, cols = np.divmod(np.arange(h * w), w)
            pos[0, i:i + h * w] = nxt
            pos[1, i:i + h * w] = nxt + rows
            pos[2, i:i + h * w] = nxt + cols
            nxt += max(h, w)
            i += h * w
            g += 1
        else:
            pos[:, i] = nxt
            nxt += 1
            i += 1
    return pos


def decoder_logits(W: Dict, cfg: dict, x: torch.Tensor, pos: np.ndarray, at: Sequence[int], prec: Precision,
                   prefix: str = "model.", head: str = "lm_head.weight", layer=run_block) -> torch.Tensor:
    """Causal decoder over embeddings x (S, hidden) at positions pos (3, S) -> fp32
    logits (len(at), vocab) of the rows `at`. layer(fn, x) runs each layer."""
    dev = x.device
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim", cfg["hidden_size"] // H)
    eps = cfg["rms_norm_eps"]
    S = x.shape[0]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, D, 2, device=dev).float() / D))
    planes = torch.as_tensor(pos, device=dev).float()[:, :, None] * inv  # (3, S, D/2)
    sections = cfg["rope_scaling"]["mrope_section"] if "rope_scaling" in cfg else [D // 2]
    parts, off = [], 0
    for j, sec in enumerate(sections):
        parts.append(planes[j % planes.shape[0], :, off:off + sec])
        off += sec
    freqs = torch.cat(parts, -1)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    x = x.float()

    def one_layer(i, x):
        p = f"{prefix}layers.{i}."
        h = rms(x, W[p + "input_layernorm.weight"], eps)
        q = prec.linear(h, W[p + "self_attn.q_proj.weight"], W[p + "self_attn.q_proj.bias"]).reshape(S, H, D)
        k = prec.linear(h, W[p + "self_attn.k_proj.weight"], W[p + "self_attn.k_proj.bias"]).reshape(S, Hkv, D)
        v = prec.linear(h, W[p + "self_attn.v_proj.weight"], W[p + "self_attn.v_proj.bias"]).reshape(S, Hkv, D)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
        x = x + prec.linear(attention(q, k, v, causal), W[p + "self_attn.o_proj.weight"])
        h = rms(x, W[p + "post_attention_layernorm.weight"], eps)
        g = prec.linear(h, W[p + "mlp.gate_proj.weight"])
        u = prec.linear(h, W[p + "mlp.up_proj.weight"])
        return x + prec.linear(F.silu(g) * u, W[p + "mlp.down_proj.weight"])

    for i in range(cfg["num_hidden_layers"]):
        x = layer(functools.partial(one_layer, i), x)
    x = rms(x[list(at)], W[prefix + "norm.weight"], eps)
    return prec.linear(x, W[head] if head in W else W[prefix + "embed_tokens.weight"].t())


def embed(W: Dict, ids: Sequence[int], images: List[torch.Tensor], image_token: int, prefix: str = "model.") -> torch.Tensor:
    """Token embeddings with each image's merged embeddings in place of its image tokens, in order."""
    table = W[prefix + "embed_tokens.weight"]
    ids_t = torch.as_tensor(list(ids), device=table.device)
    x = table[ids_t].float()
    if images:
        x[ids_t == image_token] = torch.cat(images).float()
    return x


def logit_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best (0 for the argmax)."""
    t = torch.as_tensor(list(tokens), device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]


def set_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
