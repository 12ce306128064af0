"""The routed-expert layer of Kimi-VL's decoder (DeepSeek-V3's MoE), and the dense
SwiGLU of its first layers.

For a token's normed hidden state x, with E = 64 routed experts, k = 6 chosen:

- s = sigmoid(x W_g), in fp32 over the E experts;
- the chosen experts are the top k of s + b, b the score-correction bias (noaux_tc;
  one group, so the group step chooses nothing);
- w_i = routed_scaling_factor * s_i / sum_chosen s (norm_topk_prob), 2.446 for Kimi-VL;
- y = sum_i w_i E_i(x) + S(x), with E_i(x) = (silu(x W_g,i) * (x W_u,i)) W_d,i, a SwiGLU
  of width 1408, and S the shared experts' SwiGLU of width n_shared x 1408 = 2816.

The first `first_k_dense_replace` layers hold one dense SwiGLU (width 11264) instead.

The experts' weights are stacked, (E, in, out) per product. A forward sorts its
(token, choice) pairs by expert (a stable argsort on the device), counts them per expert
and runs each of the three products as one grouped GEMM over the sorted rows
(`grouped_mm`: `torch._grouped_mm` on CUDA, whose group offsets are read on the device),
so nothing waits for the host and a decode step that holds the layer is captured like
any other. Each choice's output is put back in (token, choice) order and the k of a
token are summed in fp32 with their weights. An expert that no token chose is a group
of no rows. In the pair decode the router and the experts run on the concatenated batch
of both waves, so each expert's weights are read once a step for both.

Tracing (utils/profiling.py): the device span `moe.experts` around the grouped
products; outside a stream capture the host span `moe.route` around the router and the
counters `moe.tokens_routed` (tokens) and `moe.experts_touched` (experts that got a row,
summed over layers; reading it waits for the device, so only while the tracer is on).

Inference only: a gradient through the layer raises before any launch.

Params of a routed layer: gate (hidden, E), bias (E,), wg, wu (E, hidden, width),
wd (E, width, hidden), shared.{wg, wu, wd}. Of a dense one: wg, wu, wd.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..config import KimiTextConfig
from ..ops import _cuda
from ..utils.profiling import tracer


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows [offs[g - 1], offs[g]) of x (M, K) times w[g] (K, N), for each group g:
    (M, N) in x's dtype. offs (G,) int32 are the groups' cumulative ends. CUDA:
    `torch._grouped_mm` (one launch, the offsets read on the device); CPU: a loop over
    the groups (reads the offsets on the host)."""
    if x.device.type == "cuda":
        out = torch._grouped_mm(x, w, offs=offs)
        _cuda.count_launch(grouped_mm)
        return out
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[g]
        lo = hi
    return out


grouped_mm.launches = 0  # launches on CUDA, a captured step's replays included (ops/_cuda.py::count_launch)


def swiglu(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def route(p, cfg: KimiTextConfig, x2: torch.Tensor):
    """x2 (N, hidden) -> (chosen experts (N, k) int64, their weights (N, k) fp32)."""
    s = torch.sigmoid(x2.float() @ p["gate"].float())
    idx = torch.topk(s + p["bias"].float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def moe_forward(p, cfg: KimiTextConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., hidden) -> the layer's output, in x's dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("MoE: inference only (no backward through the routed experts)")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    N, k = x2.shape[0], cfg.num_experts_per_tok
    eager = not (x.device.type == "cuda" and torch.cuda.is_current_stream_capturing())
    with tracer.span("moe.route") if eager else contextlib.nullcontext():
        idx, w = route(p, cfg, x2)
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        # scatter_add_, not bincount: bincount reads its input's max on the host
        counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int64, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        offs = torch.cumsum(counts, 0).to(torch.int32)
        xs = x2.index_select(0, order // k)
    if eager and tracer.on:
        tracer.count("moe.tokens_routed", N)
        tracer.count("moe.experts_touched", int((counts > 0).sum()))
    with tracer.span("moe.experts", device=True):
        h = F.silu(grouped_mm(xs, p["wg"], offs)) * grouped_mm(xs, p["wu"], offs)
        ys = grouped_mm(h, p["wd"], offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys).reshape(N, k, -1)
    out = swiglu(p["shared"], x2).float()
    for i in range(k):  # the k choices summed in fp32, one (N, hidden) slice at a time
        out += w[:, i, None] * y[:, i].float()
    return out.to(x.dtype).reshape(shape)

