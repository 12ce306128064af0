"""Plain PyTorch reference of Kimi-VL-A3B-Instruct, written from the published
architecture (its config.json, modeling_kimi_vl.py and DeepSeek-V3's modeling, as the
model card describes them): no kernels, no cache, no batching, float32 with TF32 off.
It imports torch and numpy, and nothing of the program.

Vision (MoonViT): 14 px patches of one frame (3 x 14 x 14 values, channel-major) in
row-major order, embedded by one product with bias; the learned 64 x 64 position grid
resized bicubically (align_corners=False) to the image's patch grid and added; blocks of
LayerNorm, attention with bias over qkv and out, full over the image, with 2D rotary
positions (each head's dims as complex pairs, pair 2j turned by column x w_j and pair
2j + 1 by row x w_j, w_j = 10000^(-4 j / head_dim)), LayerNorm and a GELU (tanh) MLP;
a final LayerNorm; then the projector: LayerNorm per patch, the 2 x 2 neighbours of
each merge block concatenated, linear, GELU, linear.

Decoder (DeepSeek-V3 style): RMSNorm; latent attention in the expanded form (q from one
product, [c | k_r] from another, c RMS-normed and expanded to each head's 128 key dims
and 128 value dims, the 64 rotary dims de-interleaved then turned by rotate-half over
sequential positions, theta 800000, logits over sqrt(192)); the first layer's dense
SwiGLU; then routed experts by a loop over the experts the tokens chose: sigmoid scores
in fp32, the top 6 of scores plus the correction bias, weights the chosen scores over
their sum times 2.446, plus the shared experts' SwiGLU; an untied head.

Departures from the published description, each forced by the benchmark: random
weights by name from the benchmark's dict (HF names, Linear weights (in, out), the
patch convolution as a (588, 1152) matrix); a byte-level tokenizer; images sized by the
Qwen2-VL processor's arithmetic (sides rounded to multiples of 28 within its pixel
budget) where Kimi-VL's processor pads, so both models see a 504 px image as 36 x 36
patches. `Precision.linear` (portbench/reference/qwen2_5_vl.py) is the one place a
product happens, the router's included, so the fp8 control can stand in the program's
place; each product upcasts its own weight, so no more than one layer's weights are in
fp32 at a time and the reference runs beside the bf16 weights on the card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .qwen2_5_vl import Precision, logit_gaps, set_fp32  # noqa: F401 (re-exported for the episode)

VISION = "vision_tower."
PROJ = "multi_modal_projector."
TEXT = "language_model.model."
HEAD = "language_model.lm_head.weight"

VISION_TOKENS = "<|media_start|>image<|media_content|><|media_pad|><|media_end|>"
PREFIX = ("<|im_system|>system<|im_middle|>You are a helpful assistant<|im_end|>"
          "<|im_user|>user<|im_middle|>" + VISION_TOKENS)
SPECIAL_STRINGS = {"media_pad": "<|media_pad|>", "media_start": "<|media_start|>",
                   "media_content": "<|media_content|>", "media_end": "<|media_end|>", "im_user": "<|im_user|>",
                   "im_assistant": "<|im_assistant|>", "im_system": "<|im_system|>", "im_middle": "<|im_middle|>",
                   "im_end": "<|im_end|>", "bos": "[BOS]", "endoftext": "[EOS]", "pad": "[PAD]"}


def specials(cfg: dict) -> Dict[str, int]:
    """The byte-level tokenizer's special strings and their ids, from the configuration."""
    return {SPECIAL_STRINGS[k]: int(v) for k, v in cfg["special_token_ids"].items()}


def patches(image, patch: int = 14, factor: int = 28, mean: float = 0.5, std: float = 0.5):
    """(patches (N, 3 * patch^2) float32 in row-major order, grid (1, gh, gw)): the image
    resized (bicubic) to its grid and normalized."""
    from PIL import Image

    from .image import qwen_grid_size

    arr = np.asarray(image.convert("RGB"))
    h, w = arr.shape[:2]
    hb, wb = qwen_grid_size(h, w, factor)
    if (hb, wb) != (h, w):
        arr = np.asarray(Image.fromarray(arr).resize((wb, hb), Image.BICUBIC))
    x = (arr.astype(np.float32) / 255.0 - mean) / std
    gh, gw = hb // patch, wb // patch
    x = x.reshape(gh, patch, gw, patch, 3).transpose(0, 2, 4, 1, 3)  # (row, col, channel, y, x)
    return np.ascontiguousarray(x.reshape(gh * gw, 3 * patch * patch)), (1, gh, gw)


def _ln(x, W, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], W[prefix + "weight"].float(), W[prefix + "bias"].float(), eps)


def vision_forward(W: Dict, cfg: dict, pixels: np.ndarray, grid: Sequence[int], prec: Precision) -> torch.Tensor:
    """One image's row-major patches -> (N / 4, hidden) decoder embeddings, merge blocks
    in row-major order."""
    v = cfg["vision_config"]
    dev = W[VISION + "patch_embed.proj.weight"].device
    C, nh, eps = v["hidden_size"], v["num_attention_heads"], v["layer_norm_eps"]
    hd = C // nh
    _, gh, gw = grid
    N = gh * gw
    x = prec.linear(torch.as_tensor(pixels, device=dev).float(), W[VISION + "patch_embed.proj.weight"],
                    W[VISION + "patch_embed.proj.bias"])
    pos = W[VISION + "patch_embed.pos_emb.weight"].float()  # (H0, W0, C)
    if tuple(pos.shape[:2]) != (gh, gw):
        pos = F.interpolate(pos.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic", align_corners=False)[0]
        pos = pos.permute(1, 2, 0)
    x = x + pos.reshape(N, C)
    idx = torch.arange(N, device=dev)
    row, col = (idx // gw).float(), (idx % gw).float()
    w = 10000.0 ** (-torch.arange(0, hd, 4, device=dev).float()[: hd // 4] / hd)
    angles = torch.stack([col[:, None] * w, row[:, None] * w], dim=-1).reshape(N, hd // 2)
    turn = torch.polar(torch.ones_like(angles), angles)[:, None]  # (N, 1, hd / 2) complex

    def rot(t):  # (N, nh, hd)
        return torch.view_as_real(torch.view_as_complex(t.reshape(N, nh, hd // 2, 2).contiguous()) * turn).reshape(N, nh, hd)

    for i in range(v["num_hidden_layers"]):
        b = f"{VISION}encoder.blocks.{i}."
        h = _ln(x, W, b + "norm0.", eps)
        qkv = prec.linear(h, W[b + "wqkv.weight"], W[b + "wqkv.bias"]).reshape(N, 3, nh, hd)
        q, k, vv = rot(qkv[:, 0]), rot(qkv[:, 1]), qkv[:, 2]
        a = torch.einsum("hst,thd->shd", torch.einsum("shd,thd->hst", q, k).mul(hd ** -0.5).softmax(-1), vv)
        x = x + prec.linear(a.reshape(N, C), W[b + "wo.weight"], W[b + "wo.bias"])
        h = _ln(x, W, b + "norm1.", eps)
        x = x + prec.linear(F.gelu(prec.linear(h, W[b + "mlp.fc0.weight"], W[b + "mlp.fc0.bias"]), approximate="tanh"),
                            W[b + "mlp.fc1.weight"], W[b + "mlp.fc1.bias"])
    x = _ln(x, W, VISION + "encoder.final_layernorm.", eps)
    x = _ln(x, W, PROJ + "pre_norm.", eps)
    x = x.reshape(gh // 2, 2, gw // 2, 2, C).permute(0, 2, 1, 3, 4).reshape(N // 4, 4 * C)
    x = F.gelu(prec.linear(x, W[PROJ + "linear_1.weight"], W[PROJ + "linear_1.bias"]))
    return prec.linear(x, W[PROJ + "linear_2.weight"], W[PROJ + "linear_2.bias"])


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, cos, sin):
    """DeepSeek-V3's rotary: the pairs (2i, 2i + 1) de-interleaved to (i, i + d/2), then rotate-half."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin


def _swiglu(h, W, prefix, prec):
    g = prec.linear(h, W[prefix + "gate_proj.weight"])
    u = prec.linear(h, W[prefix + "up_proj.weight"])
    return prec.linear(F.silu(g) * u, W[prefix + "down_proj.weight"])


def moe(W: Dict, cfg: dict, h: torch.Tensor, prefix: str, prec: Precision) -> torch.Tensor:
    """The routed layer over tokens h (S, hidden): a loop over the chosen experts."""
    s = torch.sigmoid(prec.linear(h, W[prefix + "gate.weight"]))
    chosen = torch.topk(s + W[prefix + "gate.e_score_correction_bias"].float(), cfg["num_experts_per_tok"],
                        dim=-1).indices
    w = s.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(h)
    for e in torch.unique(chosen).tolist():
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        y[tok] += w[tok, slot, None] * _swiglu(h[tok], W, f"{prefix}experts.{e}.", prec)
    return y + _swiglu(h, W, prefix + "shared_experts.", prec)


def decoder_logits(W: Dict, cfg: dict, x: torch.Tensor, at: Sequence[int], prec: Precision) -> torch.Tensor:
    """Causal decoder over embeddings x (S, hidden) at positions 0 .. S - 1 -> fp32
    logits (len(at), vocab) of the rows `at`."""
    dev = x.device
    H, dn, dr, dv, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                        cfg["v_head_dim"], cfg["kv_lora_rank"])
    eps = cfg["rms_norm_eps"]
    S = x.shape[0]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, dr, 2, device=dev).float() / dr))
    f = torch.arange(S, device=dev).float()[:, None] * inv
    emb = torch.cat([f, f], -1)
    cos, sin = emb.cos(), emb.sin()
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    x = x.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"{TEXT}layers.{i}."
        h = _rms(x, W[p + "input_layernorm.weight"], eps)
        q = prec.linear(h, W[p + "self_attn.q_proj.weight"]).reshape(S, H, dn + dr)
        kva = prec.linear(h, W[p + "self_attn.kv_a_proj_with_mqa.weight"])
        c = _rms(kva[:, :r], W[p + "self_attn.kv_a_layernorm.weight"], eps)
        k_r = _rope(kva[:, r:], cos, sin)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos[:, None], sin[:, None])], -1)
        kv = prec.linear(c, W[p + "self_attn.kv_b_proj.weight"]).reshape(S, H, dn + dv)
        k = torch.cat([kv[..., :dn], k_r[:, None].expand(S, H, dr)], -1)
        logits = torch.einsum("shd,thd->hst", q, k) * (dn + dr) ** -0.5
        a = torch.einsum("hst,thd->shd", logits.masked_fill(~causal, float("-inf")).softmax(-1), kv[..., dn:])
        x = x + prec.linear(a.reshape(S, H * dv), W[p + "self_attn.o_proj.weight"])
        h = _rms(x, W[p + "post_attention_layernorm.weight"], eps)
        dense = i < cfg["first_k_dense_replace"] or i % cfg["moe_layer_freq"] != 0
        x = x + (_swiglu(h, W, p + "mlp.", prec) if dense else moe(W, cfg, h, p + "mlp.", prec))
    x = _rms(x[list(at)], W[TEXT + "norm.weight"], eps)
    return prec.linear(x, W[HEAD] if HEAD in W else W[TEXT + "embed_tokens.weight"].t())


def embed(W: Dict, ids: Sequence[int], images: List[torch.Tensor], image_token: int) -> torch.Tensor:
    """Token embeddings with each image's embeddings in place of its image tokens, in order."""
    table = W[TEXT + "embed_tokens.weight"]
    ids_t = torch.as_tensor(list(ids), device=table.device)
    x = table[ids_t].float()
    if images:
        x[ids_t == image_token] = torch.cat(images).float()
    return x
