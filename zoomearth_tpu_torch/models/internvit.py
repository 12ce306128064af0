"""InternViT vision tower + projector (port of models/internvit.py; the second VLM
family).

The InternVL vision stack (reference family: vlm_modules/internvl_module.py:17-341,
architecture as transformers' modeling_internvl.py), eagerly on the params' device:

- conv patch embed as a plain matmul over pre-flattened patches,
- CLS token + learned absolute position embeddings (no interpolation: anyres tiles are
  always image_size x image_size),
- pre-LN blocks with layer-scale (ls1/ls2), optional QK RMSNorm over the full embed
  dim, full (unwindowed) softmax attention,
- pixel-shuffle 2x spatial downsample + LayerNorm/MLP projector into the LLM width.

The attention is plain torch ops, as the reference computes it outside any Pallas
kernel: the logits product in the params' dtype, THEN cast to fp32 for the softmax,
the probabilities back in v's dtype for the second product (internvit.py:119-121;
logits computed in fp32 from the start are another bf16 result).

The LLM side is the Qwen2.5 decoder (models/decoder.py) with sequential positions
(every rotary plane carries arange, which is 1D RoPE under any mrope_section) and
embeds-input generation: vision embeddings replace the <IMG_CONTEXT> positions in
models.vlm.vlm_forward.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import InternVitConfig, InternVLVLMConfig
from .params import _Init, init_text_params, text_params_from_hf, torch_dtype
from .vit import layer_norm, rms_norm


def patchify_tiles(tiles_chw: np.ndarray, patch_size: int = 14) -> np.ndarray:
    """(T, C, H, W) float32 tiles -> (T, n_patches, C*p*p) conv-patch layout
    (row-major patches; per-patch flatten order (c, ph, pw) matching conv2d)."""
    T, C, H, W = tiles_chw.shape
    gh, gw = H // patch_size, W // patch_size
    x = tiles_chw.reshape(T, C, gh, patch_size, gw, patch_size)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # (T, gh, gw, C, p, p)
    return x.reshape(T, gh * gw, C * patch_size * patch_size)


def init_internvit_params(init: _Init, cfg: InternVitConfig, text_hidden: int) -> Dict:
    """Random InternViT + projector tree with the JAX package's keys and shapes
    (internvit.py:42-88): dense weights N(0, 0.02), zero biases and CLS token, unit
    norm scales, layer-scale at cfg.layer_scale_init."""
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.patch_dim
    n_pos = cfg.patches_per_side**2 + 1

    def dense(i, o):
        return init.normal((i, o), 0.02)

    blocks = []
    for _ in range(cfg.depth):
        blk = {
            "ln1": {"scale": init.ones(H), "bias": init.zeros(H)},
            "ln2": {"scale": init.ones(H), "bias": init.zeros(H)},
            "attn": {"wq": dense(H, H), "wk": dense(H, H), "wv": dense(H, H), "wo": dense(H, H),
                     "bo": init.zeros(H)},
            "mlp": {"w1": dense(H, I), "b1": init.zeros(I), "w2": dense(I, H), "b2": init.zeros(H)},
            "ls1": init.ones(H).mul_(cfg.layer_scale_init),
            "ls2": init.ones(H).mul_(cfg.layer_scale_init),
        }
        if cfg.attention_bias:
            blk["attn"].update(bq=init.zeros(H), bk=init.zeros(H), bv=init.zeros(H))
        if cfg.use_qk_norm:
            blk["attn"].update(q_norm=init.ones(H), k_norm=init.ones(H))
        blocks.append(blk)

    c2 = int(cfg.hidden_size * int(1 / cfg.downsample_ratio) ** 2)
    return {
        "patch_embed": {"kernel": dense(D, H), "bias": init.zeros(H)},
        "cls_token": init.zeros((1, 1, H)),
        "pos_embed": init.normal((1, n_pos, H), 0.02),
        "blocks": blocks,
        "projector": {
            "ln": {"scale": init.ones(c2), "bias": init.zeros(c2)},
            "w1": dense(c2, text_hidden), "b1": init.zeros(text_hidden),
            "w2": dense(text_hidden, text_hidden), "b2": init.zeros(text_hidden),
        },
    }


def init_internvl_params(cfg: InternVLVLMConfig, generator: Optional[torch.Generator] = None,
                         device="cpu", dtype=None) -> Dict:
    """Full random InternVL tree {"vision": InternViT+projector, "text": Qwen2}, drawn
    directly on `device` from `generator` (a torch.Generator on that device; a fresh
    seed-0 one when omitted)."""
    dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init = _Init(generator, device, dtype)
    return {"vision": init_internvit_params(init, cfg.vision, cfg.text.hidden_size),
            "text": init_text_params(init, cfg.text)}


def _act(name: str, x):
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


def _norm(cfg: InternVitConfig, p, x):
    if cfg.norm_type == "layer_norm":
        return layer_norm(x, p["scale"], p["bias"], cfg.layer_norm_eps)
    return rms_norm(x, p["scale"], cfg.layer_norm_eps)


def _block(p, cfg: InternVitConfig, x):
    T, S, H = x.shape
    nh, d = cfg.num_heads, cfg.head_dim
    a = p["attn"]
    h = _norm(cfg, p["ln1"], x)
    q, k, v = h @ a["wq"], h @ a["wk"], h @ a["wv"]
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    if cfg.use_qk_norm:
        # RMSNorm over the FULL embed dim before the head split (HF InternVLVisionAttention)
        q = rms_norm(q, a["q_norm"], cfg.layer_norm_eps)
        k = rms_norm(k, a["k_norm"], cfg.layer_norm_eps)
    q = q.reshape(T, S, nh, d)
    k = k.reshape(T, S, nh, d)
    v = v.reshape(T, S, nh, d)
    logits = torch.einsum("tshd,tzhd->thsz", q, k).float() * (d**-0.5)
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("thsz,tzhd->tshd", probs.to(v.dtype), v).reshape(T, S, H)
    attn = attn @ a["wo"] + a["bo"]
    x = x + p["ls1"] * attn
    h = _norm(cfg, p["ln2"], x)
    h = _act(cfg.hidden_act, h @ p["mlp"]["w1"] + p["mlp"]["b1"]) @ p["mlp"]["w2"] + p["mlp"]["b2"]
    return x + p["ls2"] * h


def pixel_shuffle(feats: torch.Tensor, scale_factor: float = 0.5) -> torch.Tensor:
    """(T, W, H, C) -> (T, W*sf, H*sf, C/sf^2) — exact HF op order (modeling_internvl
    pixel_shuffle: view/permute/view/permute)."""
    T, W, H, C = feats.shape
    x = feats.reshape(T, W, int(H * scale_factor), int(C / scale_factor))
    x = x.transpose(1, 2)
    x = x.reshape(T, int(H * scale_factor), int(W * scale_factor), int(C / (scale_factor**2)))
    return x.transpose(1, 2)


def internvit_embeds(params, cfg: InternVitConfig, patches: torch.Tensor) -> torch.Tensor:
    """Packed tiles -> merged LLM-space vision embeddings.

    patches: (T, n_patches, patch_dim) from patchify_tiles (all tiles are the native
    image_size, so position embeddings apply without interpolation), on the params'
    device. Returns (T * num_image_token, text_hidden) in tile order."""
    T = patches.shape[0]
    kernel = params["patch_embed"]["kernel"]
    x = patches.to(kernel.dtype) @ kernel + params["patch_embed"]["bias"]
    cls = params["cls_token"].expand(T, 1, x.shape[-1])
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    for blk in params["blocks"]:
        x = _block(blk, cfg, x)
    feats = x[:, 1:, :]  # drop CLS (vision_feature_select_strategy="default")
    side = cfg.patches_per_side
    feats = feats.reshape(T, side, side, -1)
    feats = pixel_shuffle(feats, cfg.downsample_ratio)
    feats = feats.reshape(T, -1, feats.shape[-1])
    p = params["projector"]
    h = layer_norm(feats, p["ln"]["scale"], p["ln"]["bias"], 1e-5)
    h = _act("gelu", h @ p["w1"] + p["b1"])
    h = h @ p["w2"] + p["b2"]
    return h.reshape(T * h.shape[1], -1)


# ---------------------------------------------------------------------------
# HF weight import (mirrors zoomearth_tpu/models/internvit.py's HF import)
# ---------------------------------------------------------------------------

def _state(hf_model_or_state) -> Dict[str, torch.Tensor]:
    if hasattr(hf_model_or_state, "state_dict"):
        hf_model_or_state = hf_model_or_state.state_dict()
    return {k: torch.as_tensor(v).detach() for k, v in hf_model_or_state.items()}


def internvit_params_from_hf(hf_model_or_state, cfg: InternVitConfig, device="cpu", dtype=torch.float32):
    """Map a transformers InternVLForConditionalGeneration's (or its state dict's)
    vision tower + projector into the port's tree on `device`."""
    sd = _state(hf_model_or_state)
    dtype = torch_dtype(dtype)

    def g(name):
        return sd[name].to(device=device, dtype=dtype)

    def lin(name):  # torch Linear weight (out, in) -> (in, out)
        return sd[name].t().contiguous().to(device=device, dtype=dtype)

    pfx = "model.vision_tower."
    conv_w = sd[pfx + "embeddings.patch_embeddings.projection.weight"]  # (H, C, p, p)
    kernel = conv_w.reshape(conv_w.shape[0], -1).t().contiguous().to(device=device, dtype=dtype)
    blocks = []
    for i in range(cfg.depth):
        b = f"{pfx}encoder.layer.{i}."
        blk = {
            "ln1": {"scale": g(b + "layernorm_before.weight"), "bias": g(b + "layernorm_before.bias")},
            "ln2": {"scale": g(b + "layernorm_after.weight"), "bias": g(b + "layernorm_after.bias")},
            "attn": {
                "wq": lin(b + "attention.q_proj.weight"),
                "wk": lin(b + "attention.k_proj.weight"),
                "wv": lin(b + "attention.v_proj.weight"),
                "wo": lin(b + "attention.projection_layer.weight"),
                "bo": g(b + "attention.projection_layer.bias"),
            },
            "mlp": {
                "w1": lin(b + "mlp.fc1.weight"), "b1": g(b + "mlp.fc1.bias"),
                "w2": lin(b + "mlp.fc2.weight"), "b2": g(b + "mlp.fc2.bias"),
            },
            "ls1": g(b + "lambda_1"),
            "ls2": g(b + "lambda_2"),
        }
        if cfg.attention_bias:
            blk["attn"].update(bq=g(b + "attention.q_proj.bias"), bk=g(b + "attention.k_proj.bias"),
                               bv=g(b + "attention.v_proj.bias"))
        if cfg.use_qk_norm:
            blk["attn"].update(q_norm=g(b + "attention.q_norm.weight"), k_norm=g(b + "attention.k_norm.weight"))
        blocks.append(blk)
    proj = "model.multi_modal_projector."
    return {
        "patch_embed": {"kernel": kernel, "bias": g(pfx + "embeddings.patch_embeddings.projection.bias")},
        "cls_token": g(pfx + "embeddings.cls_token"),
        "pos_embed": g(pfx + "embeddings.position_embeddings"),
        "blocks": blocks,
        "projector": {
            "ln": {"scale": g(proj + "layer_norm.weight"), "bias": g(proj + "layer_norm.bias")},
            "w1": lin(proj + "linear_1.weight"), "b1": g(proj + "linear_1.bias"),
            "w2": lin(proj + "linear_2.weight"), "b2": g(proj + "linear_2.bias"),
        },
    }


def internvl_params_from_hf(hf_model_or_state, cfg: InternVLVLMConfig, device="cpu", dtype=torch.float32):
    """Full-tree import: InternViT+projector plus the Qwen2 language model."""
    sd = _state(hf_model_or_state)
    dtype = torch_dtype(dtype)

    def g(name):
        return sd[name].to(device=device, dtype=dtype)

    def lin(name):
        return sd[name].t().contiguous().to(device=device, dtype=dtype)

    text = text_params_from_hf(g, lin, cfg.text, "model.language_model.", "lm_head.weight" in sd)
    return {"vision": internvit_params_from_hf(sd, cfg.vision, device, dtype), "text": text}
