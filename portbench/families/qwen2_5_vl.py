"""Qwen2.5-VL: the leaves the benchmark draws, and the program's config and parameter
tree built from a configuration file (HF `config.json` keys).

The benchmark's layout is HF's names with every Linear weight stored (in, out), the
transpose of torch's: the program's tree is built over these same tensors, and the
plain reference (portbench/reference/qwen2_5_vl.py) reads them by name.
"""

from __future__ import annotations

from typing import Dict, List

from ..harness.weights import Leaf


def dtype_name(cfg: dict) -> str:
    return cfg.get("torch_dtype", "bfloat16")


def leaves(cfg: dict) -> List[Leaf]:
    v = cfg["vision_config"]
    E, I, out = v["hidden_size"], v["intermediate_size"], v["out_hidden_size"]
    patch_dim = v["in_chans"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    m = v["spatial_merge_size"] ** 2 * E
    Hd, It, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim", Hd // H)
    out_leaves: List[Leaf] = [("visual.patch_embed.proj.weight", (patch_dim, E), "dense")]
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}."
        out_leaves += [
            (b + "norm1.weight", (E,), "norm"), (b + "norm2.weight", (E,), "norm"),
            (b + "attn.qkv.weight", (E, 3 * E), "dense"), (b + "attn.qkv.bias", (3 * E,), "bias"),
            (b + "attn.proj.weight", (E, E), "dense"), (b + "attn.proj.bias", (E,), "bias"),
            (b + "mlp.gate_proj.weight", (E, I), "dense"), (b + "mlp.gate_proj.bias", (I,), "bias"),
            (b + "mlp.up_proj.weight", (E, I), "dense"), (b + "mlp.up_proj.bias", (I,), "bias"),
            (b + "mlp.down_proj.weight", (I, E), "dense"), (b + "mlp.down_proj.bias", (E,), "bias"),
        ]
    out_leaves += [
        ("visual.merger.ln_q.weight", (E,), "norm"),
        ("visual.merger.mlp.0.weight", (m, m), "dense"), ("visual.merger.mlp.0.bias", (m,), "bias"),
        ("visual.merger.mlp.2.weight", (m, out), "dense"), ("visual.merger.mlp.2.bias", (out,), "bias"),
        ("model.embed_tokens.weight", (V, Hd), "embed"),
    ]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out_leaves += [
            (p + "input_layernorm.weight", (Hd,), "norm"), (p + "post_attention_layernorm.weight", (Hd,), "norm"),
            (p + "self_attn.q_proj.weight", (Hd, H * D), "dense"), (p + "self_attn.q_proj.bias", (H * D,), "bias"),
            (p + "self_attn.k_proj.weight", (Hd, Hkv * D), "dense"), (p + "self_attn.k_proj.bias", (Hkv * D,), "bias"),
            (p + "self_attn.v_proj.weight", (Hd, Hkv * D), "dense"), (p + "self_attn.v_proj.bias", (Hkv * D,), "bias"),
            (p + "self_attn.o_proj.weight", (H * D, Hd), "dense"),
            (p + "mlp.gate_proj.weight", (Hd, It), "dense"), (p + "mlp.up_proj.weight", (Hd, It), "dense"),
            (p + "mlp.down_proj.weight", (It, Hd), "dense"),
        ]
    out_leaves.append(("model.norm.weight", (Hd,), "norm"))
    if not cfg.get("tie_word_embeddings", True):
        out_leaves.append(("lm_head.weight", (Hd, V), "dense"))
    return out_leaves


def program_config(cfg: dict):
    """The port's VLMConfig with the file's numbers."""
    from zoomearth_tpu_torch.config import SpecialTokens, TextConfig, VisionConfig, VLMConfig

    v = cfg["vision_config"]
    vision = VisionConfig(
        depth=v["depth"], hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_heads=v["num_heads"], in_channels=v["in_chans"], patch_size=v["patch_size"],
        temporal_patch_size=v["temporal_patch_size"], spatial_merge_size=v["spatial_merge_size"],
        window_size=v["window_size"], fullatt_block_indexes=tuple(v["fullatt_block_indexes"]),
        out_hidden_size=v["out_hidden_size"], hidden_act=v["hidden_act"],
    )
    text = TextConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"]),
        rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
        tie_word_embeddings=cfg["tie_word_embeddings"], max_position_embeddings=cfg["max_position_embeddings"],
        mrope_section=tuple(cfg["rope_scaling"]["mrope_section"]),
    )
    sp = cfg["special_token_ids"]
    tokens = SpecialTokens(
        image_pad=cfg["image_token_id"], video_pad=cfg["video_token_id"],
        vision_start=cfg["vision_start_token_id"], vision_end=cfg["vision_end_token_id"],
        im_start=sp["im_start"], im_end=sp["im_end"], endoftext=sp["endoftext"], eos=cfg["eos_token_id"],
    )
    return VLMConfig(vision=vision, text=text, tokens=tokens, dtype=dtype_name(cfg))


def program_tree(W: Dict, cfg: dict) -> Dict:
    """The port's parameter tree over the benchmark's tensors (no copy)."""
    v = cfg["vision_config"]
    blocks = []
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}."
        blocks.append({
            "norm1": {"scale": W[b + "norm1.weight"]}, "norm2": {"scale": W[b + "norm2.weight"]},
            "attn": {"wqkv": W[b + "attn.qkv.weight"], "bqkv": W[b + "attn.qkv.bias"],
                     "wo": W[b + "attn.proj.weight"], "bo": W[b + "attn.proj.bias"]},
            "mlp": {"wg": W[b + "mlp.gate_proj.weight"], "bg": W[b + "mlp.gate_proj.bias"],
                    "wu": W[b + "mlp.up_proj.weight"], "bu": W[b + "mlp.up_proj.bias"],
                    "wd": W[b + "mlp.down_proj.weight"], "bd": W[b + "mlp.down_proj.bias"]},
        })
    vision = {
        "patch_embed": {"kernel": W["visual.patch_embed.proj.weight"]},
        "blocks": blocks,
        "merger": {"ln_q": {"scale": W["visual.merger.ln_q.weight"]},
                   "w0": W["visual.merger.mlp.0.weight"], "b0": W["visual.merger.mlp.0.bias"],
                   "w1": W["visual.merger.mlp.2.weight"], "b1": W["visual.merger.mlp.2.bias"]},
    }
    return {"vision": vision, "text": text_tree(W, cfg, "model.")}


def text_tree(W: Dict, cfg: dict, prefix: str, head: str = "lm_head.weight") -> Dict:
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        layers.append({
            "input_ln": {"scale": W[p + "input_layernorm.weight"]},
            "post_ln": {"scale": W[p + "post_attention_layernorm.weight"]},
            "attn": {"wq": W[p + "self_attn.q_proj.weight"], "bq": W[p + "self_attn.q_proj.bias"],
                     "wk": W[p + "self_attn.k_proj.weight"], "bk": W[p + "self_attn.k_proj.bias"],
                     "wv": W[p + "self_attn.v_proj.weight"], "bv": W[p + "self_attn.v_proj.bias"],
                     "wo": W[p + "self_attn.o_proj.weight"]},
            "mlp": {"wg": W[p + "mlp.gate_proj.weight"], "wu": W[p + "mlp.up_proj.weight"],
                    "wd": W[p + "mlp.down_proj.weight"]},
        })
    text = {"embed": {"weight": W[prefix + "embed_tokens.weight"]}, "layers": layers,
            "final_ln": {"scale": W[prefix + "norm.weight"]}}
    if head in W:
        text["lm_head"] = {"weight": W[head]}
    return text
