"""Parameter trees: random init, conversion from the JAX package, HF checkpoints
(port of models/params.py).

A parameter tree is the reference's nested dict / list layout with torch tensors as
leaves; every matrix keeps the reference's (in, out) layout, so `x @ w` is the
projection. Three ways to build one:

- `init_vlm_params(cfg, generator, device, dtype)` draws random weights on the device;
- `params_from_numpy(tree, device, dtype)` converts the JAX package's tree (numpy
  leaves) so both packages compute the same function in tests;
- `load_hf_checkpoint(path, cfg, device, dtype)` reads HF safetensors shards.

`export_hf_state_dict` / `save_hf_checkpoint` write a tree back out in the HF layout
(what training's checkpoints are exported as).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import TextConfig, VisionConfig, VLMConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or a name ("bfloat16", "float32"; "int8" for a KV cache)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree, device="cpu", dtype=None) -> Dict:
    """The JAX package's parameter tree (leaves as numpy arrays or anything
    np.asarray accepts, (in, out) layout) -> the port's tree on `device`, structure
    for structure: a LoRA leaf {"w", "a", "b", "s"} (train/lora.py; s 0-d) and an int8
    leaf {"q", "s"} (ops/quant.py) come across as dicts of tensors that ops.quant.qdot
    takes as they are. Float leaves take `dtype` (float32 when omitted); integer
    leaves (the int8 values) keep their own dtype."""
    def conv(leaf):
        a = np.asarray(leaf)
        if a.dtype.kind in "iu":
            return torch.from_numpy(np.array(a)).to(device=device)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=torch_dtype(dtype) if dtype is not None else torch.float32)

    return map_tree(conv, tree)


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Random init (same shapes and scales as the reference; different numbers)
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def dense(self, in_dim, out_dim):
        scale = (2.0 / (in_dim + out_dim)) ** 0.5
        w = torch.randn((in_dim, out_dim), generator=self.g, device=self.device, dtype=self.dtype)
        return w.mul_(scale)

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.g, device=self.device, dtype=self.dtype).mul_(scale)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def init_vision_params(init: _Init, cfg: VisionConfig) -> Dict:
    E, I = cfg.hidden_size, cfg.intermediate_size

    def norm_p():
        p = {"scale": init.ones(E)}
        if cfg.norm_type == "layer":
            p["bias"] = init.zeros(E)
        return p

    blocks = []
    for _ in range(cfg.depth):
        attn = {
            "wqkv": init.dense(E, 3 * E), "bqkv": init.zeros(3 * E),
            "wo": init.dense(E, E), "bo": init.zeros(E),
        }
        if cfg.mlp_type == "gelu_fc":
            mlp = {"w1": init.dense(E, I), "b1": init.zeros(I),
                   "w2": init.dense(I, E), "b2": init.zeros(E)}
        else:
            mlp = {"wg": init.dense(E, I), "bg": init.zeros(I),
                   "wu": init.dense(E, I), "bu": init.zeros(I),
                   "wd": init.dense(I, E), "bd": init.zeros(E)}
        blocks.append({"norm1": norm_p(), "norm2": norm_p(), "attn": attn, "mlp": mlp})
    m = cfg.merge_unit * E
    return {
        "patch_embed": {"kernel": init.dense(cfg.patch_dim, E)},
        "blocks": blocks,
        "merger": {
            "ln_q": norm_p(),
            "w0": init.dense(m, m), "b0": init.zeros(m),
            "w1": init.dense(m, cfg.out_hidden_size), "b1": init.zeros(cfg.out_hidden_size),
        },
    }


def init_text_params(init: _Init, cfg: TextConfig) -> Dict:
    E, I = cfg.hidden_size, cfg.intermediate_size
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "input_ln": {"scale": init.ones(E)},
            "post_ln": {"scale": init.ones(E)},
            "attn": {
                "wq": init.dense(E, H * D), "bq": init.zeros(H * D),
                "wk": init.dense(E, Hkv * D), "bk": init.zeros(Hkv * D),
                "wv": init.dense(E, Hkv * D), "bv": init.zeros(Hkv * D),
                "wo": init.dense(H * D, E),
            },
            "mlp": {"wg": init.dense(E, I), "wu": init.dense(E, I), "wd": init.dense(I, E)},
        })
    params = {
        "embed": {"weight": init.normal((cfg.vocab_size, E), 0.02)},
        "layers": layers,
        "final_ln": {"scale": init.ones(E)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": init.dense(E, cfg.vocab_size)}
    return params


def init_vlm_params(cfg: VLMConfig, generator: Optional[torch.Generator] = None,
                    device="cpu", dtype=None) -> Dict:
    """Random weights drawn directly on `device` from `generator` (a torch.Generator
    on that device; a fresh seed-0 one when omitted)."""
    dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init = _Init(generator, device, dtype)
    return {"vision": init_vision_params(init, cfg.vision), "text": init_text_params(init, cfg.text)}


# ---------------------------------------------------------------------------
# HF -> port conversion (mirrors zoomearth_tpu/models/params.py:149-273)
# ---------------------------------------------------------------------------

def _strip_prefix(key: str) -> str:
    for p in ("model.", "language_model.model.", ""):
        if key.startswith(p):
            key = key[len(p):]
            break
    return key


def text_params_from_hf(get, lin, tcfg: TextConfig, prefix: str, has_lm_head: bool) -> Dict:
    """The Qwen2 text tree from HF keys under `prefix`: get(name) reads a tensor as it
    is, lin(name) a torch Linear weight transposed to (in, out). The untied lm_head is
    read where the config does not tie it and the state holds it."""
    text = {
        "embed": {"weight": get(prefix + "embed_tokens.weight")},
        "layers": [],
        "final_ln": {"scale": get(prefix + "norm.weight")},
    }
    for i in range(tcfg.num_hidden_layers):
        p = f"{prefix}layers.{i}."
        text["layers"].append({
            "input_ln": {"scale": get(p + "input_layernorm.weight")},
            "post_ln": {"scale": get(p + "post_attention_layernorm.weight")},
            "attn": {
                "wq": lin(p + "self_attn.q_proj.weight"), "bq": get(p + "self_attn.q_proj.bias"),
                "wk": lin(p + "self_attn.k_proj.weight"), "bk": get(p + "self_attn.k_proj.bias"),
                "wv": lin(p + "self_attn.v_proj.weight"), "bv": get(p + "self_attn.v_proj.bias"),
                "wo": lin(p + "self_attn.o_proj.weight"),
            },
            "mlp": {"wg": lin(p + "mlp.gate_proj.weight"), "wu": lin(p + "mlp.up_proj.weight"),
                    "wd": lin(p + "mlp.down_proj.weight")},
        })
    if not tcfg.tie_word_embeddings and has_lm_head:
        text["lm_head"] = {"weight": lin("lm_head.weight")}
    return text


def convert_hf_state_dict(state: Dict, cfg: VLMConfig, device="cpu", dtype=None) -> Dict:
    """HF Qwen2.5-VL (or Qwen2-VL) state_dict (torch tensors or numpy arrays) -> the
    port's tree. Accepts transformers>=4.52 keys (model.visual.*, model.language_model.*,
    lm_head.*) and the older layout (visual.*, model.layers.*)."""
    dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
    flat = {_strip_prefix(k): v for k, v in state.items()}

    def raw(name):
        return torch.as_tensor(flat[name])

    def get(name):
        return raw(name).to(device=device, dtype=dtype)

    def lin(name):  # torch Linear weight (out, in) -> (in, out)
        return raw(name).t().contiguous().to(device=device, dtype=dtype)

    vcfg, tcfg = cfg.vision, cfg.text
    vp = "visual." if "visual.patch_embed.proj.weight" in flat else "vision_tower."
    pe = raw(vp + "patch_embed.proj.weight")  # (E, C, T, P, P)

    def norm_p(name):
        p = {"scale": get(name + ".weight")}
        if vcfg.norm_type == "layer":
            p["bias"] = get(name + ".bias")
        return p

    vision = {
        "patch_embed": {"kernel": pe.reshape(vcfg.hidden_size, -1).t().contiguous().to(device=device, dtype=dtype)},
        "blocks": [],
        "merger": {
            "ln_q": norm_p(vp + "merger.ln_q"),
            "w0": lin(vp + "merger.mlp.0.weight"), "b0": get(vp + "merger.mlp.0.bias"),
            "w1": lin(vp + "merger.mlp.2.weight"), "b1": get(vp + "merger.mlp.2.bias"),
        },
    }
    for i in range(vcfg.depth):
        b = f"{vp}blocks.{i}."
        if vcfg.mlp_type == "gelu_fc":
            mlp = {"w1": lin(b + "mlp.fc1.weight"), "b1": get(b + "mlp.fc1.bias"),
                   "w2": lin(b + "mlp.fc2.weight"), "b2": get(b + "mlp.fc2.bias")}
        else:
            mlp = {"wg": lin(b + "mlp.gate_proj.weight"), "bg": get(b + "mlp.gate_proj.bias"),
                   "wu": lin(b + "mlp.up_proj.weight"), "bu": get(b + "mlp.up_proj.bias"),
                   "wd": lin(b + "mlp.down_proj.weight"), "bd": get(b + "mlp.down_proj.bias")}
        vision["blocks"].append({
            "norm1": norm_p(b + "norm1"),
            "norm2": norm_p(b + "norm2"),
            "attn": {"wqkv": lin(b + "attn.qkv.weight"), "bqkv": get(b + "attn.qkv.bias"),
                     "wo": lin(b + "attn.proj.weight"), "bo": get(b + "attn.proj.bias")},
            "mlp": mlp,
        })

    lp = "language_model." if "language_model.embed_tokens.weight" in flat else ""
    text = text_params_from_hf(get, lin, tcfg, lp, "lm_head.weight" in flat)
    return {"vision": vision, "text": text}


def load_hf_checkpoint(path: str, cfg: Optional[VLMConfig] = None, device="cpu", dtype=None) -> Dict:
    """Load an HF safetensors checkpoint directory into the port's tree."""
    try:
        from safetensors import safe_open
    except ImportError as e:  # pragma: no cover - depends on the installation
        raise ImportError(
            "load_hf_checkpoint needs the `safetensors` package to read HF checkpoints; "
            "it is not installed"
        ) from e

    if cfg is None:
        cfg = VLMConfig.from_hf_dir(path)
    index_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    state = {}
    for shard in shards:
        with safe_open(os.path.join(path, shard), framework="pt") as f:
            for k in f.keys():
                state[k] = f.get_tensor(k)
    return convert_hf_state_dict(state, cfg, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# port -> HF export (mirrors zoomearth_tpu/models/params.py:285-379; checkpoint
# interchange, the local analog of the reference's hub push, utils/callbacks.py:43-77)
# ---------------------------------------------------------------------------

def export_hf_state_dict(params, cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """The port's tree -> an HF Qwen2.5-VL state_dict (transformers>=4.52 keys), CPU
    tensors in each leaf's own dtype (the reference writes fp32; bf16 weights stay
    bf16 here, half the bytes). load_hf_checkpoint reads it back."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        t = t.detach().to("cpu")
        out[name] = t.t().contiguous() if transpose else t.contiguous()

    v, t = params["vision"], params["text"]
    vcfg = cfg.vision
    pe = v["patch_embed"]["kernel"].detach().to("cpu").t()  # (E, patch_dim)
    out["model.visual.patch_embed.proj.weight"] = pe.reshape(
        vcfg.hidden_size, vcfg.in_channels, vcfg.temporal_patch_size, vcfg.patch_size, vcfg.patch_size
    ).contiguous()
    for i, b in enumerate(v["blocks"]):
        p = f"model.visual.blocks.{i}."
        put(p + "norm1.weight", b["norm1"]["scale"])
        put(p + "norm2.weight", b["norm2"]["scale"])
        put(p + "attn.qkv.weight", b["attn"]["wqkv"], transpose=True)
        put(p + "attn.qkv.bias", b["attn"]["bqkv"])
        put(p + "attn.proj.weight", b["attn"]["wo"], transpose=True)
        put(p + "attn.proj.bias", b["attn"]["bo"])
        put(p + "mlp.gate_proj.weight", b["mlp"]["wg"], transpose=True)
        put(p + "mlp.gate_proj.bias", b["mlp"]["bg"])
        put(p + "mlp.up_proj.weight", b["mlp"]["wu"], transpose=True)
        put(p + "mlp.up_proj.bias", b["mlp"]["bu"])
        put(p + "mlp.down_proj.weight", b["mlp"]["wd"], transpose=True)
        put(p + "mlp.down_proj.bias", b["mlp"]["bd"])
    put("model.visual.merger.ln_q.weight", v["merger"]["ln_q"]["scale"])
    put("model.visual.merger.mlp.0.weight", v["merger"]["w0"], transpose=True)
    put("model.visual.merger.mlp.0.bias", v["merger"]["b0"])
    put("model.visual.merger.mlp.2.weight", v["merger"]["w1"], transpose=True)
    put("model.visual.merger.mlp.2.bias", v["merger"]["b1"])

    put("model.language_model.embed_tokens.weight", t["embed"]["weight"])
    for i, layer in enumerate(t["layers"]):
        p = f"model.language_model.layers.{i}."
        put(p + "input_layernorm.weight", layer["input_ln"]["scale"])
        put(p + "post_attention_layernorm.weight", layer["post_ln"]["scale"])
        put(p + "self_attn.q_proj.weight", layer["attn"]["wq"], transpose=True)
        put(p + "self_attn.q_proj.bias", layer["attn"]["bq"])
        put(p + "self_attn.k_proj.weight", layer["attn"]["wk"], transpose=True)
        put(p + "self_attn.k_proj.bias", layer["attn"]["bk"])
        put(p + "self_attn.v_proj.weight", layer["attn"]["wv"], transpose=True)
        put(p + "self_attn.v_proj.bias", layer["attn"]["bv"])
        put(p + "self_attn.o_proj.weight", layer["attn"]["wo"], transpose=True)
        put(p + "mlp.gate_proj.weight", layer["mlp"]["wg"], transpose=True)
        put(p + "mlp.up_proj.weight", layer["mlp"]["wu"], transpose=True)
        put(p + "mlp.down_proj.weight", layer["mlp"]["wd"], transpose=True)
    put("model.language_model.norm.weight", t["final_ln"]["scale"])
    if not cfg.text.tie_word_embeddings and "lm_head" in t:
        put("lm_head.weight", t["lm_head"]["weight"], transpose=True)
    return out


def hf_config_dict(cfg: VLMConfig) -> Dict:
    """The config.json save_hf_checkpoint writes (VLMConfig.from_hf_dir reads it back)."""
    v, t, tok = cfg.vision, cfg.text, cfg.tokens
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "head_dim": t.head_dim, "rope_theta": t.rope_theta,
        "rms_norm_eps": t.rms_norm_eps,
        "tie_word_embeddings": t.tie_word_embeddings,
        "max_position_embeddings": t.max_position_embeddings,
        "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
        "image_token_id": tok.image_pad, "video_token_id": tok.video_pad,
        "vision_start_token_id": tok.vision_start,
        "vision_end_token_id": tok.vision_end,
        "eos_token_id": tok.eos, "pad_token_id": tok.pad,
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "out_hidden_size": v.out_hidden_size, "hidden_act": v.hidden_act,
        },
    }


def save_hf_checkpoint(params, cfg: VLMConfig, path: str) -> str:
    """Write an HF-format checkpoint dir (model.safetensors; config.json if absent)."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file(export_hf_state_dict(params, cfg), os.path.join(path, "model.safetensors"))
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        with open(cfg_path, "w") as f:
            json.dump(hf_config_dict(cfg), f, indent=2)
    return path
