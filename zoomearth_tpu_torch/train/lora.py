"""LoRA adapters for the text decoder (port of train/lora.py; the reference's PEFT
path, grpo_trainer.py:293-305 + peft get_peft_model).

A LoRA-wrapped weight is a dict leaf {"w": base, "a": (in, r), "b": (r, out), "s":
alpha / r as a 0-d tensor} that ops.quant.qdot dispatches on, so every decoder matmul
(decode, prefill, training) picks it up with no change to the model code. The base
stays frozen because the optimizer never steps it (`frozen_leaves`); the KL
reference model is the ADAPTER-DISABLED policy (`strip_lora`: PEFT disables the
adapters instead of keeping a second copy), a tree that shares the base tensors.

b starts at zero (standard LoRA), so at step 0 the adapted policy equals the base
model exactly. a is drawn from an explicit torch.Generator: the JAX package draws it
with jax.random, so the two packages' adapters differ in value (the tests carry the
JAX package's adapters across with params_from_numpy instead).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def is_lora(w) -> bool:
    return isinstance(w, dict) and "a" in w and "b" in w and "w" in w


def apply_lora(params, generator: torch.Generator, *, r: int = 8, alpha: float = 16.0,
               targets: Sequence[str] = DEFAULT_TARGETS):
    """Wrap the text-decoder matmuls of a param tree with LoRA adapters (a new tree
    sharing every other leaf, the base weights included). a ~ N(0, 1) / r, drawn on
    the base weight's device from `generator` (a torch.Generator on that device), in
    the base's dtype; b = 0; s = alpha / r. A leaf that is already a dict (LoRA or
    int8) is left as it is."""
    out = {"vision": params["vision"], "text": dict(params["text"])}
    layers = []
    for layer in params["text"]["layers"]:
        nl = {"input_ln": layer["input_ln"], "post_ln": layer["post_ln"]}
        for group in ("attn", "mlp"):
            g = dict(layer[group])
            for name in targets:
                if name in g and not isinstance(g[name], dict):
                    w = g[name]
                    a = torch.randn((w.shape[0], r), generator=generator, device=w.device) * (1.0 / r)
                    g[name] = {
                        "w": w,
                        "a": a.to(w.dtype),
                        "b": torch.zeros((r, w.shape[1]), dtype=w.dtype, device=w.device),
                        "s": torch.tensor(alpha / r, dtype=w.dtype, device=w.device),
                    }
            nl[group] = g
        layers.append(nl)
    out["text"]["layers"] = layers
    return out


def strip_lora(params):
    """Adapter-DISABLED view of a LoRA tree: the same tree with each LoRA leaf
    replaced by its base tensor (shared, not copied). A spec tree of a LoRA tree
    (param_shardings) strips alike."""
    if is_lora(params):
        return params["w"]
    if isinstance(params, dict):
        return {k: strip_lora(v) for k, v in params.items()}
    if isinstance(params, list):
        return [strip_lora(v) for v in params]
    if isinstance(params, tuple):  # a spec tree's tuples keep their type (parallel/mesh.QKVSpec)
        return type(params)(strip_lora(v) for v in params)
    return params


def merge_lora(params):
    """Fold the adapters into the base weights (export / serving handoff): w + (a @ b
    * s) computed in fp32 and cast to w's dtype."""
    if is_lora(params):
        delta = params["a"].float() @ params["b"].float() * params["s"].float()
        return params["w"] + delta.to(params["w"].dtype)
    if isinstance(params, dict):
        return {k: merge_lora(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [merge_lora(v) for v in params]
    return params


def frozen_leaves(params) -> List[torch.Tensor]:
    """The leaves of a LoRA tree the optimizer must not step: every base `w` and
    every `s` (the JAX package's mask_base_updates zeroes their updates, weight decay
    included). They still get gradients, which count in the global norm."""
    out: List[torch.Tensor] = []

    def walk(node):
        if is_lora(node):
            out.extend([node["w"], node["s"]])
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return out
