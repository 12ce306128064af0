"""MiMo-V2.5's parameter tree from tensor names.

`hf_leaves(cfg)` lists every tensor the port reads, by name, with each Linear weight
stored (in, out) (the transpose of torch's), with the kind of values it holds (a dense
matrix, an embedding, a bias, a norm scale, a sink logit): the vision tower under
Qwen2.5-VL's names ("visual."), and the decoder under "model." with one fused q | k | v
product a layer (`attention_projection_layout` "fused_qkv"), a sink logit per head in the
window layers, and of each routed layer the router over all n_routed_experts and the
experts this device holds (`experts_held`), by their global numbers, expert after expert
within each of their three products, so that tensors laid out in that order stack
without a copy. `params_from_hf(W, cfg)` builds the program's tree (models/vit.py,
models/hybrid.py, models/moe.py) over those tensors; the sinks become fp32 copies (what
the kernels read).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..config import MiMoV2Config
from .kimi_vl import stacked

TEXT = "model."
HEAD = "lm_head.weight"
SINK = "self_attn.attention_sink_bias"


def vision_leaves(cfg: MiMoV2Config) -> List[Tuple[str, Sequence[int], str]]:
    """The Qwen2.5-VL vision tower's tensors under their published names."""
    v = cfg.vision
    E, I, out = v.hidden_size, v.intermediate_size, v.out_hidden_size
    m = v.merge_unit * E
    leaves: List[Tuple[str, Sequence[int], str]] = [("visual.patch_embed.proj.weight", (v.patch_dim, E), "dense")]
    for i in range(v.depth):
        b = f"visual.blocks.{i}."
        leaves += [
            (b + "norm1.weight", (E,), "norm"), (b + "norm2.weight", (E,), "norm"),
            (b + "attn.qkv.weight", (E, 3 * E), "dense"), (b + "attn.qkv.bias", (3 * E,), "bias"),
            (b + "attn.proj.weight", (E, E), "dense"), (b + "attn.proj.bias", (E,), "bias"),
            (b + "mlp.gate_proj.weight", (E, I), "dense"), (b + "mlp.gate_proj.bias", (I,), "bias"),
            (b + "mlp.up_proj.weight", (E, I), "dense"), (b + "mlp.up_proj.bias", (I,), "bias"),
            (b + "mlp.down_proj.weight", (I, E), "dense"), (b + "mlp.down_proj.bias", (E,), "bias"),
        ]
    return leaves + [
        ("visual.merger.ln_q.weight", (E,), "norm"),
        ("visual.merger.mlp.0.weight", (m, m), "dense"), ("visual.merger.mlp.0.bias", (m,), "bias"),
        ("visual.merger.mlp.2.weight", (m, out), "dense"), ("visual.merger.mlp.2.bias", (out,), "bias"),
    ]


def hf_leaves(cfg: MiMoV2Config) -> List[Tuple[str, Sequence[int], str]]:
    """(name, shape, kind) of every tensor; a window layer's sink logits are drawn as "norm:3",
    about 3 (portbench/harness/weights.py's kinds): at random weights that takes ~10 % of a
    row's softmax, so the sink does work."""
    t = cfg.text
    E = t.hidden_size
    out = vision_leaves(cfg) + [(TEXT + "embed_tokens.weight", (t.vocab_size, E), "embed")]
    e0, e1 = t.held
    for i in range(t.num_hidden_layers):
        a = t.layer_attention(i)
        p = f"{TEXT}layers.{i}."
        H, Hkv = a.num_attention_heads, a.num_key_value_heads
        out += [
            (p + "input_layernorm.weight", (E,), "norm"), (p + "post_attention_layernorm.weight", (E,), "norm"),
            (p + "self_attn.qkv_proj.weight", (E, H * a.qk_head_dim + Hkv * (a.qk_head_dim + a.v_head_dim)), "dense"),
            (p + "self_attn.o_proj.weight", (H * a.v_head_dim, E), "dense"),
        ]
        if a.sink:
            out.append((p + SINK, (H,), "norm:3"))
        if not t.is_moe_layer(i):
            F_ = t.intermediate_size
            out += [(p + "mlp.gate_proj.weight", (E, F_), "dense"), (p + "mlp.up_proj.weight", (E, F_), "dense"),
                    (p + "mlp.down_proj.weight", (F_, E), "dense")]
            continue
        F_ = t.moe_intermediate_size
        out += [(p + "mlp.gate.weight", (E, t.n_routed_experts), "dense"),
                (p + "mlp.gate.e_score_correction_bias", (t.n_routed_experts,), "bias")]
        for proj, shape in (("gate_proj", (E, F_)), ("up_proj", (E, F_)), ("down_proj", (F_, E))):
            out += [(f"{p}mlp.experts.{e}.{proj}.weight", shape, "dense") for e in range(e0, e1)]
    out.append((TEXT + "norm.weight", (E,), "norm"))
    if not t.tie_word_embeddings:
        out.append((HEAD, (E, t.vocab_size), "dense"))
    return out


def vision_tree(W: Dict) -> Dict:
    blocks = []
    i = 0
    while f"visual.blocks.{i}.norm1.weight" in W:
        b = f"visual.blocks.{i}."
        blocks.append({
            "norm1": {"scale": W[b + "norm1.weight"]}, "norm2": {"scale": W[b + "norm2.weight"]},
            "attn": {"wqkv": W[b + "attn.qkv.weight"], "bqkv": W[b + "attn.qkv.bias"],
                     "wo": W[b + "attn.proj.weight"], "bo": W[b + "attn.proj.bias"]},
            "mlp": {"wg": W[b + "mlp.gate_proj.weight"], "bg": W[b + "mlp.gate_proj.bias"],
                    "wu": W[b + "mlp.up_proj.weight"], "bu": W[b + "mlp.up_proj.bias"],
                    "wd": W[b + "mlp.down_proj.weight"], "bd": W[b + "mlp.down_proj.bias"]},
        })
        i += 1
    return {"patch_embed": {"kernel": W["visual.patch_embed.proj.weight"]}, "blocks": blocks,
            "merger": {"ln_q": {"scale": W["visual.merger.ln_q.weight"]},
                       "w0": W["visual.merger.mlp.0.weight"], "b0": W["visual.merger.mlp.0.bias"],
                       "w1": W["visual.merger.mlp.2.weight"], "b1": W["visual.merger.mlp.2.bias"]}}


def params_from_hf(W: Dict, cfg: MiMoV2Config) -> Dict:
    """The program's tree over the tensors of W (views; the held experts stacked by
    `stacked`; the sinks fp32 copies)."""
    t = cfg.text
    e0, e1 = t.held
    layers = []
    for i in range(t.num_hidden_layers):
        p = f"{TEXT}layers.{i}."
        attn = {"wqkv": W[p + "self_attn.qkv_proj.weight"], "wo": W[p + "self_attn.o_proj.weight"]}
        if p + SINK in W:
            attn["sink"] = W[p + SINK].float().contiguous()
        if t.is_moe_layer(i):
            mlp = {"gate": W[p + "mlp.gate.weight"], "bias": W[p + "mlp.gate.e_score_correction_bias"],
                   **{key: stacked(W, [f"{p}mlp.experts.{e}.{proj}.weight" for e in range(e0, e1)])
                      for key, proj in (("wg", "gate_proj"), ("wu", "up_proj"), ("wd", "down_proj"))}}
        else:
            mlp = {"wg": W[p + "mlp.gate_proj.weight"], "wu": W[p + "mlp.up_proj.weight"],
                   "wd": W[p + "mlp.down_proj.weight"]}
        layers.append({"input_ln": {"scale": W[p + "input_layernorm.weight"]},
                       "post_ln": {"scale": W[p + "post_attention_layernorm.weight"]}, "attn": attn, "mlp": mlp})
    text = {"embed": {"weight": W[TEXT + "embed_tokens.weight"]}, "layers": layers,
            "final_ln": {"scale": W[TEXT + "norm.weight"]}}
    if HEAD in W:
        text["lm_head"] = {"weight": W[HEAD]}
    return {"vision": vision_tree(W), "text": text}
