"""Plain PyTorch reference of MiMo-V2.5's decoder, written from the published
configuration (config.json of XiaomiMiMo/MiMo-V2.5, the MiMo-V2-Flash family): no
kernels, no cache, no batching, float32 with TF32 off. It imports torch and numpy, and
nothing of the program.

Decoder: RMSNorm (eps `layernorm_epsilon`); each layer's kind from
`hybrid_layer_pattern` (0 global, 1 sliding window): one fused q | k | v product (no
bias) into H query heads and Hkv key/value heads (global 64 / `num_key_value_heads` 4,
window `swa_num_attention_heads` 64 / `swa_num_key_value_heads` 8), keys 192 and values
128 wide; the 1D rotary (rotate-half) over the first int(192 x `partial_rotary_factor`)
= 64 dims of each q and k head at sequential positions, theta `rope_theta` (global) or
`swa_rope_theta` (window); logits over sqrt(192), causal, a window layer's query at t
seeing only the keys s > t - `sliding_window`, and a learned sink logit per head
(`add_swa_attention_sink_bias`) as one more softmax column with value 0; the heads'
outputs times `attention_value_scale`, then o_proj; the MLP by `moe_layer_freq`: 0 a
dense SwiGLU, 1 routed experts: sigmoid scores in fp32 over `n_routed_experts`, the top
`num_experts_per_tok` of scores plus the score-correction bias (noaux_tc, one group),
weights the chosen scores over their sum (`norm_topk_prob`, no scaling), no shared
expert; an untied head.

The vision tower is the Qwen2.5-VL reference's (portbench/reference/qwen2_5_vl.py) at
the configuration's `vision_config`, its output at the decoder's width: a stand-in, as
the configuration file says.

Departures from the published model, each forced by the benchmark and given the same in
the program: the first `num_hidden_layers` layers only; of each routed layer the experts
this device holds (`expert_parallel`: `n_routed_experts` per device, this device's
range from its rank), the router over all of them, an absent expert's pick adding
nothing (what the other devices would add is left out); random weights by name (HF-style
names, Linear weights (in, out)); a byte-level tokenizer.

Routing near-ties (`moe`, `forced`): at random weights the k-th and (k + 1)-th best
scores lie close, and two precisions break such ties apart, after which the difference
cascades. Given the choices another computation made (`forced`, per routed layer), the
reference takes them for a token where every one of them lies within `margin` of its own
k-th best score (score plus bias), and otherwise keeps its own and counts the token in
`outside`; each token's largest such shortfall is kept in `deficits`. `Precision.linear`
(portbench/reference/qwen2_5_vl.py) is the one place a product happens, the router's
included, so the fp8 control can stand in the program's place; each product upcasts its
own weight.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .qwen2_5_vl import Precision, logit_gaps, rotate_half, set_fp32, vision_forward  # noqa: F401 (re-exported)

TEXT = "model."
HEAD = "lm_head.weight"
SINK = "self_attn.attention_sink_bias"


def held(cfg: dict) -> range:
    """The routed experts this device holds, by their global numbers."""
    n = cfg["n_routed_experts"]
    ep = cfg.get("expert_parallel", {"size": 1, "rank": 0})
    return range(n * ep["rank"], n * (ep["rank"] + 1))


def kind(cfg: dict, i: int) -> dict:
    """Layer i's attention: heads, KV heads, widths, rotary dims and theta, window, sink."""
    window = cfg["hybrid_layer_pattern"][i] == 1
    p = "swa_" if window else ""
    dq = cfg[p + "head_dim"]
    return {"H": cfg[p + "num_attention_heads"] if window else cfg["num_attention_heads"],
            "Hkv": cfg[p + "num_key_value_heads"], "dq": dq, "dv": cfg[p + "v_head_dim"],
            "r": int(dq * cfg["partial_rotary_factor"]),
            "theta": cfg["swa_rope_theta"] if window else cfg["rope_theta"],
            "window": cfg["sliding_window"] if window else 0,
            "sink": cfg["add_swa_attention_sink_bias"] if window else cfg["add_full_attention_sink_bias"]}


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _swiglu(h, W, prefix, prec):
    g = prec.linear(h, W[prefix + "gate_proj.weight"])
    u = prec.linear(h, W[prefix + "up_proj.weight"])
    return prec.linear(F.silu(g) * u, W[prefix + "down_proj.weight"])


class Routing:
    """What one decoder pass did at its routed layers: the choices it made (`chosen`, one
    (S, k) tensor a routed layer), and, where it was given choices to follow, the tokens
    it could not follow (`outside`) and each followed token's largest shortfall below its
    own k-th best (`deficits`)."""

    def __init__(self, forced: Optional[List[torch.Tensor]] = None, margin: float = 0.0):
        self.forced, self.margin = forced, margin
        self.chosen: List[torch.Tensor] = []
        self.outside = 0
        self.deficits: List[float] = []


def moe(W: Dict, cfg: dict, h: torch.Tensor, prefix: str, prec: Precision, routing: Routing) -> torch.Tensor:
    """The routed layer over tokens h (S, hidden): this device's part, a loop over the
    held experts the tokens chose."""
    k = cfg["num_experts_per_tok"]
    s = torch.sigmoid(prec.linear(h, W[prefix + "gate.weight"]))
    sel = s + W[prefix + "gate.e_score_correction_bias"].float()
    top = torch.topk(sel, k, dim=-1)
    chosen = top.indices
    if routing.forced is not None:
        other = torch.as_tensor(routing.forced[len(routing.chosen)], device=h.device).long()
        kth = top.values[:, -1:]
        short = (kth - sel.gather(1, other)).clamp(min=0).amax(-1)  # (S,) the largest shortfall
        differs = (torch.sort(other, -1).values != torch.sort(chosen, -1).values).any(-1)
        follow = differs & (short <= routing.margin)
        routing.outside += int((differs & ~follow).sum())
        routing.deficits += short[follow].tolist()
        chosen = torch.where(follow[:, None], other, chosen)
    routing.chosen.append(chosen)
    w = s.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * (cfg.get("routed_scaling_factor") or 1.0)
    y = torch.zeros_like(h)
    mine = held(cfg)
    for e in torch.unique(chosen).tolist():
        if e in mine:
            tok, slot = (chosen == e).nonzero(as_tuple=True)
            y[tok] += w[tok, slot, None] * _swiglu(h[tok], W, f"{prefix}experts.{e}.", prec)
    return y


def _turn(x, cos, sin, r):
    """The first r dims of each head turned by rotate-half, the rest as they are."""
    return torch.cat([x[..., :r] * cos + rotate_half(x[..., :r]) * sin, x[..., r:]], -1)


def attention(W: Dict, cfg: dict, i: int, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Layer i's attention over h (S, hidden) at positions 0 .. S - 1 -> (S, hidden)."""
    a = kind(cfg, i)
    p = f"{TEXT}layers.{i}."
    S, dev = h.shape[0], h.device
    H, Hkv, dq, dv, r = a["H"], a["Hkv"], a["dq"], a["dv"], a["r"]
    qkv = prec.linear(h, W[p + "self_attn.qkv_proj.weight"])
    q = qkv[:, : H * dq].reshape(S, H, dq)
    k = qkv[:, H * dq: (H + Hkv) * dq].reshape(S, Hkv, dq)
    v = qkv[:, (H + Hkv) * dq:].reshape(S, Hkv, dv)
    inv = 1.0 / (a["theta"] ** (torch.arange(0, r, 2, device=dev).float() / r))
    f = torch.arange(S, device=dev).float()[:, None] * inv
    emb = torch.cat([f, f], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    q, k = _turn(q, cos, sin, r), _turn(k, cos, sin, r)
    k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    t = torch.arange(S, device=dev)
    live = t[None, :] <= t[:, None]
    if a["window"]:
        live &= t[None, :] > t[:, None] - a["window"]
    logits = torch.einsum("shd,thd->hst", q, k).mul(dq ** -0.5).masked_fill(~live, float("-inf"))
    if a["sink"]:
        logits = torch.cat([logits, W[p + SINK].float()[:, None, None].expand(H, S, 1)], -1)
    probs = logits.softmax(-1)[..., :S]
    out = torch.einsum("hst,thd->shd", probs, v).reshape(S, H * dv) * cfg["attention_value_scale"]
    return prec.linear(out, W[p + "self_attn.o_proj.weight"])


def decoder_logits(W: Dict, cfg: dict, x: torch.Tensor, at: Sequence[int], prec: Precision,
                   routing: Optional[Routing] = None) -> torch.Tensor:
    """Causal decoder over embeddings x (S, hidden) at positions 0 .. S - 1 -> fp32
    logits (len(at), vocab) of the rows `at`. routing: the pass's routing record (and
    the choices it follows), a fresh one where not given."""
    routing = Routing() if routing is None else routing
    eps = cfg["layernorm_epsilon"]
    x = x.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"{TEXT}layers.{i}."
        x = x + attention(W, cfg, i, _rms(x, W[p + "input_layernorm.weight"], eps), prec)
        h = _rms(x, W[p + "post_attention_layernorm.weight"], eps)
        x = x + (moe(W, cfg, h, p + "mlp.", prec, routing) if cfg["moe_layer_freq"][i]
                 else _swiglu(h, W, p + "mlp.", prec))
    x = _rms(x[list(at)], W[TEXT + "norm.weight"], eps)
    return prec.linear(x, W[HEAD] if HEAD in W else W[TEXT + "embed_tokens.weight"].t())


def embed(W: Dict, ids: Sequence[int], images: List[torch.Tensor], starts: Sequence[int]) -> torch.Tensor:
    """Token embeddings with image j's embeddings in place of the tokens from starts[j]
    on (by the prompt's layout, so a served token equal to the image id stays a token)."""
    table = W[TEXT + "embed_tokens.weight"]
    x = table[torch.as_tensor(list(ids), device=table.device)].float()
    for img, start in zip(images, starts):
        x[start:start + img.shape[0]] = img.float()
    return x
