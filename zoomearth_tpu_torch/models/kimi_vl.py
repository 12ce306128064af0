"""Kimi-VL's parameter tree from its checkpoint's tensor names.

`hf_leaves(cfg)` lists every tensor of Kimi-VL-A3B-Instruct's checkpoint that the
port reads, by its published name, with each Linear weight stored (in, out) (the
transpose of torch's) and the patch embedding's convolution as a (588, 1152) matrix
over (channel, row, column), with the kind of values it holds (a dense matrix, an
embedding, a bias, a norm scale). The routed experts of a layer are listed
expert after expert within each of their three products, so that tensors laid out in
that order stack without a copy. `params_from_hf(W, cfg)` builds the program's tree
(models/moonvit.py, models/mla.py, models/moe.py) over those tensors.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..config import KimiVLConfig

VISION = "vision_tower."
PROJ = "multi_modal_projector."
TEXT = "language_model.model."
HEAD = "language_model.lm_head.weight"


def hf_leaves(cfg: KimiVLConfig) -> List[Tuple[str, Sequence[int], str]]:
    """(name, shape, kind) of every tensor, kind one of "dense", "embed", "bias", "norm"."""
    v, t = cfg.vision, cfg.text
    C, I = v.hidden_size, v.intermediate_size
    out: List[Tuple[str, Sequence[int], str]] = [
        (VISION + "patch_embed.proj.weight", (v.patch_dim, C), "dense"),
        (VISION + "patch_embed.proj.bias", (C,), "bias"),
        (VISION + "patch_embed.pos_emb.weight", (v.init_pos_emb_height, v.init_pos_emb_width, C), "embed"),
    ]
    for i in range(v.depth):
        b = f"{VISION}encoder.blocks.{i}."
        out += [
            (b + "norm0.weight", (C,), "norm"), (b + "norm0.bias", (C,), "bias"),
            (b + "wqkv.weight", (C, 3 * C), "dense"), (b + "wqkv.bias", (3 * C,), "bias"),
            (b + "wo.weight", (C, C), "dense"), (b + "wo.bias", (C,), "bias"),
            (b + "norm1.weight", (C,), "norm"), (b + "norm1.bias", (C,), "bias"),
            (b + "mlp.fc0.weight", (C, I), "dense"), (b + "mlp.fc0.bias", (I,), "bias"),
            (b + "mlp.fc1.weight", (I, C), "dense"), (b + "mlp.fc1.bias", (C,), "bias"),
        ]
    m = v.merge_unit * C
    out += [
        (VISION + "encoder.final_layernorm.weight", (C,), "norm"), (VISION + "encoder.final_layernorm.bias", (C,), "bias"),
        (PROJ + "pre_norm.weight", (C,), "norm"), (PROJ + "pre_norm.bias", (C,), "bias"),
        (PROJ + "linear_1.weight", (m, m), "dense"), (PROJ + "linear_1.bias", (m,), "bias"),
        (PROJ + "linear_2.weight", (m, t.hidden_size), "dense"), (PROJ + "linear_2.bias", (t.hidden_size,), "bias"),
        (TEXT + "embed_tokens.weight", (t.vocab_size, t.hidden_size), "embed"),
    ]
    E, H, r, dr = t.hidden_size, t.num_attention_heads, t.kv_lora_rank, t.qk_rope_head_dim
    for i in range(t.num_hidden_layers):
        p = f"{TEXT}layers.{i}."
        out += [
            (p + "input_layernorm.weight", (E,), "norm"), (p + "post_attention_layernorm.weight", (E,), "norm"),
            (p + "self_attn.q_proj.weight", (E, H * t.q_head_dim), "dense"),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (E, r + dr), "dense"),
            (p + "self_attn.kv_a_layernorm.weight", (r,), "norm"),
            (p + "self_attn.kv_b_proj.weight", (r, H * (t.qk_nope_head_dim + t.v_head_dim)), "dense"),
            (p + "self_attn.o_proj.weight", (H * t.v_head_dim, E), "dense"),
        ]
        if not t.is_moe_layer(i):
            F_ = t.intermediate_size
            out += [(p + "mlp.gate_proj.weight", (E, F_), "dense"), (p + "mlp.up_proj.weight", (E, F_), "dense"),
                    (p + "mlp.down_proj.weight", (F_, E), "dense")]
            continue
        F_, S_ = t.moe_intermediate_size, t.moe_intermediate_size * t.n_shared_experts
        out += [(p + "mlp.gate.weight", (E, t.n_routed_experts), "dense"),
                (p + "mlp.gate.e_score_correction_bias", (t.n_routed_experts,), "bias")]
        for proj, shape in (("gate_proj", (E, F_)), ("up_proj", (E, F_)), ("down_proj", (F_, E))):
            out += [(f"{p}mlp.experts.{e}.{proj}.weight", shape, "dense") for e in range(t.n_routed_experts)]
        out += [(p + "mlp.shared_experts.gate_proj.weight", (E, S_), "dense"),
                (p + "mlp.shared_experts.up_proj.weight", (E, S_), "dense"),
                (p + "mlp.shared_experts.down_proj.weight", (S_, E), "dense")]
    out.append((TEXT + "norm.weight", (E,), "norm"))
    if not t.tie_word_embeddings:
        out.append((HEAD, (E, t.vocab_size), "dense"))
    return out


def stacked(W: Dict, names: Sequence[str]) -> torch.Tensor:
    """The tensors `names` as one (n, ...) tensor: a view where they lie one after the
    other in one buffer (no copy), else a stacked copy."""
    first = W[names[0]]
    n = first.numel()
    base = first.storage_offset()
    ptr = first.untyped_storage().data_ptr()
    if all(W[nm].is_contiguous() and W[nm].shape == first.shape and W[nm].untyped_storage().data_ptr() == ptr
           and W[nm].storage_offset() == base + i * n for i, nm in enumerate(names)):
        return first.as_strided((len(names),) + tuple(first.shape), (n,) + tuple(first.stride()), base)
    return torch.stack([W[nm] for nm in names])


def params_from_hf(W: Dict, cfg: KimiVLConfig) -> Dict:
    """The program's tree over the tensors of W (views; the experts stacked by `stacked`)."""
    v, t = cfg.vision, cfg.text

    def ln(prefix):
        return {"scale": W[prefix + "weight"], "bias": W[prefix + "bias"]}

    blocks = []
    for i in range(v.depth):
        b = f"{VISION}encoder.blocks.{i}."
        blocks.append({"norm0": ln(b + "norm0."), "norm1": ln(b + "norm1."),
                       "wqkv": W[b + "wqkv.weight"], "bqkv": W[b + "wqkv.bias"],
                       "wo": W[b + "wo.weight"], "bo": W[b + "wo.bias"],
                       "w0": W[b + "mlp.fc0.weight"], "b0": W[b + "mlp.fc0.bias"],
                       "w1": W[b + "mlp.fc1.weight"], "b1": W[b + "mlp.fc1.bias"]})
    vision = {
        "patch_embed": {"w": W[VISION + "patch_embed.proj.weight"], "b": W[VISION + "patch_embed.proj.bias"]},
        "pos_emb": W[VISION + "patch_embed.pos_emb.weight"],
        "blocks": blocks,
        "final_ln": ln(VISION + "encoder.final_layernorm."),
        "projector": {"ln": ln(PROJ + "pre_norm."), "w1": W[PROJ + "linear_1.weight"], "b1": W[PROJ + "linear_1.bias"],
                      "w2": W[PROJ + "linear_2.weight"], "b2": W[PROJ + "linear_2.bias"]},
    }
    layers = []
    for i in range(t.num_hidden_layers):
        p = f"{TEXT}layers.{i}."
        attn = {"wq": W[p + "self_attn.q_proj.weight"], "wkva": W[p + "self_attn.kv_a_proj_with_mqa.weight"],
                "kv_norm": {"scale": W[p + "self_attn.kv_a_layernorm.weight"]},
                "wkvb": W[p + "self_attn.kv_b_proj.weight"], "wo": W[p + "self_attn.o_proj.weight"]}
        if t.is_moe_layer(i):
            experts = range(t.n_routed_experts)
            mlp = {"gate": W[p + "mlp.gate.weight"], "bias": W[p + "mlp.gate.e_score_correction_bias"],
                   **{key: stacked(W, [f"{p}mlp.experts.{e}.{proj}.weight" for e in experts])
                      for key, proj in (("wg", "gate_proj"), ("wu", "up_proj"), ("wd", "down_proj"))},
                   "shared": {key: W[f"{p}mlp.shared_experts.{proj}.weight"]
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
    return {"vision": vision, "text": text}
