"""Weight-only int8 layouts for the decoder (port of ops/quant.py).

`quantize_decoder_int8` stores the decoder matmul weights as int8 values with one
scale per output channel, `fuse_decoder_matmuls` concatenates the attention input
projections and the MLP gate/up, and `qdot` is the product every decoder matmul goes
through, whatever layout its weight has.

What the int8 layout does NOT do here: save bytes per decode step. The reference
feeds int8 weights into its matrix unit through a mixed-dtype product; PyTorch has no
such product, so `qdot` widens the int8 values to the activations' dtype
(`x @ q.to(x.dtype)`) and applies the scale to the output. That is the reference's
algebra, x @ (q * s) == (x @ q) * s for column scales, and it is what the CPU tests
hold against the reference; on the card it reads the int8 weights, writes and reads a
widened copy, and so moves more bytes than bf16 weights do. A hand-written W8A16 GEMM
that reads int8 and multiplies in bf16 is what makes the layout pay; until it exists,
`--quantize int8` is a way to check a checkpoint's accuracy under int8 weights, not a
way to decode faster. Measured by chip_smoke.py's serving phase on an NVIDIA H100 80GB
HBM3 (700 W) at Qwen2.5-VL-3B width: one decoder matmul at the decode shape (8 x 2048 @
2048 x 11008, device time, L2 cold) takes 0.022 ms as a bf16 `torch.mm` and 0.084 ms
through `qdot` over int8; the serving engine's decode step with 8 live rows, replayed
from its captured graph, takes 7.35 ms of wall time over bf16 weights and 15.58 ms over
the int8 layout.

Opt-in; the accuracy impact must be validated per checkpoint before serving with it.
"""

from __future__ import annotations

import torch

from ..models.params import tree_leaves


def quantize_int8(w: torch.Tensor):
    """(in, out) weight -> {"q": int8, "s": (1, out) scale in the original dtype}."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(w.dtype)}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain, quantized ({"q", "s"}) or LoRA ({"w", "a", "b", "s"}) weights.

    Quantized: the int8 values are exact in x's dtype, so the product runs there and
    the per-output-channel scale multiplies the output (see the module docstring for
    what that costs on the card)."""
    if is_quantized(w):
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].to(y.dtype)
    if isinstance(w, dict) and "a" in w and "b" in w:  # LoRA
        return x @ w["w"] + ((x @ w["a"]) @ w["b"]) * w["s"].to(x.dtype)
    return x @ w


def quantize_decoder_int8(params, lm_head: bool = False):
    """Quantize the text-decoder layer matmuls in a param tree (returns a new tree;
    norms, biases and the embedding are untouched and shared). Handles the plain
    layout (wq/wk/wv, wg/wu) and the fused one from `fuse_decoder_matmuls` (wqkv, wgu).

    lm_head=True also stores an int8 COPY of the logits head as text["lm_head_q8"]
    (the token lookup keeps reading the embedding in its own dtype);
    logits_from_hidden takes it when present."""
    out = {"vision": params["vision"], "text": dict(params["text"])}
    if lm_head:
        text = params["text"]
        w = text["embed"]["weight"].t() if "lm_head" not in text else text["lm_head"]["weight"]
        out["text"]["lm_head_q8"] = quantize_int8(w)
    new_layers = []
    for layer in params["text"]["layers"]:
        nl = {"input_ln": layer["input_ln"], "post_ln": layer["post_ln"]}
        attn = dict(layer["attn"])
        for k in ("wq", "wk", "wv", "wo", "wqkv"):
            if k in attn:
                attn[k] = quantize_int8(attn[k])
        nl["attn"] = attn
        nl["mlp"] = {k: quantize_int8(v) for k, v in layer["mlp"].items()}
        new_layers.append(nl)
    out["text"]["layers"] = new_layers
    return out


def fuse_decoder_matmuls(params):
    """Serving-time layout: concatenate the attention input projections (wq|wk|wv ->
    wqkv, biases likewise) and the MLP gate/up (wg|wu -> wgu) along the output dim, so
    a layer issues five matmuls instead of seven.

    Numerics are identical: x @ concat(A, B) == concat(x @ A, x @ B), and int8
    per-output-column scales survive an output-dim concat (quantize after fusing ==
    quantize then fuse). Compose as fuse -> quantize_decoder_int8. A layer that is
    already fused is returned as the same object."""
    out = {"vision": params["vision"], "text": dict(params["text"])}
    new_layers = []
    for layer in params["text"]["layers"]:
        a = layer["attn"]
        if "wqkv" in a:  # already fused
            new_layers.append(layer)
            continue
        attn = {
            "wqkv": torch.cat([a["wq"], a["wk"], a["wv"]], dim=1),
            "bqkv": torch.cat([a["bq"], a["bk"], a["bv"]], dim=0),
            "wo": a["wo"],
        }
        m = layer["mlp"]
        mlp = {"wgu": torch.cat([m["wg"], m["wu"]], dim=1), "wd": m["wd"]}
        new_layers.append({"input_ln": layer["input_ln"], "post_ln": layer["post_ln"],
                           "attn": attn, "mlp": mlp})
    out["text"]["layers"] = new_layers
    return out


def quantized_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
