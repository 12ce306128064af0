"""The routed-expert layer of Kimi-VL's and MiMo-V2.5's decoders (DeepSeek-V3's MoE),
and the dense SwiGLU of their first layers.

For a token's normed hidden state x, with E = 64 routed experts, k = 6 chosen:

- s = sigmoid(x W_g), in fp32 over the E experts;
- the chosen experts are the top k of s + b, b the score-correction bias (noaux_tc;
  one group, so the group step chooses nothing);
- w_i = routed_scaling_factor * s_i / sum_chosen s (norm_topk_prob), 2.446 for Kimi-VL,
  1 for MiMo-V2.5 (its config gives none);
- y = sum_i w_i E_i(x) + S(x), with E_i(x) = (silu(x W_g,i) * (x W_u,i)) W_d,i, a SwiGLU
  of width 1408, and S the shared experts' SwiGLU of width n_shared x 1408 = 2816 (MiMo-V2.5:
  256 experts of width 2048, k = 8, no shared expert).

Expert parallelism: a layer told that this device holds the experts [e0, e1)
(`cfg.experts_held`) routes over all E and computes only the part of y its own experts
give: the picks that land on [e0, e1) go through the grouped products, each with its
weight from the routing over all E, and the others (`moe.picks_elsewhere`) are left to
the devices that hold them (on one device, left out). Its expert weights are stacked
(e1 - e0, in, out). Outside a stream capture the layer reads the held picks' count (one
host read a layer) and gathers, multiplies and adds back those picks alone; a captured
step, whose sizes are fixed, gathers every pick, the absent ones past the last group,
and zeroes their rows, with the same sums. With every expert held (Kimi-VL) the layer is
the one described above, computed as before.

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
counters `moe.tokens_routed` (tokens), `moe.experts_touched` (held experts that got a
row), `moe.picks_held` and `moe.picks_elsewhere` (the (token, choice) picks that land on
this device's experts and on absent ones), summed over layers; they count only while the
tracer is on, as reading `moe.experts_touched` waits for the device.

Inference only: a gradient through the layer raises before any launch.

Params of a routed layer: gate (hidden, E), bias (E,), wg, wu (E_held, hidden, width),
wd (E_held, width, hidden), shared.{wg, wu, wd} where the model has shared experts. Of a
dense one: wg, wu, wd.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

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


def route(p, cfg, x2: torch.Tensor):
    """x2 (N, hidden) -> (chosen experts (N, k) int64, their weights (N, k) fp32)."""
    s = torch.sigmoid(x2.float() @ p["gate"].float())
    idx = torch.topk(s + p["bias"].float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * (cfg.routed_scaling_factor or 1.0)


def moe_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (..., hidden) -> the layer's output (this device's experts' part of it), in x's dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("MoE: inference only (no backward through the routed experts)")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    N, k = x2.shape[0], cfg.num_experts_per_tok
    held = cfg.experts_held
    some = held is not None and tuple(held) != (0, cfg.n_routed_experts)
    eager = not (x.device.type == "cuda" and torch.cuda.is_current_stream_capturing())
    compact = some and eager  # sizes may come from the device: only the held picks are gathered
    with tracer.span("moe.route") if eager else contextlib.nullcontext():
        idx, w = route(p, cfg, x2)
        flat = idx.reshape(-1)
        n_groups = cfg.n_routed_experts
        if some:  # this device's experts are groups 0 .. e1 - e0 - 1; the absent picks sort last, in no group
            n_groups = held[1] - held[0]
            mine = (flat >= held[0]) & (flat < held[1])
            flat = torch.where(mine, flat - held[0], n_groups)
        order = torch.argsort(flat, stable=True)
        # scatter_add_, not bincount: bincount reads its input's max on the host
        counts = torch.zeros(n_groups + some, dtype=torch.int64, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat))[:n_groups]
        offs = torch.cumsum(counts, 0).to(torch.int32)
        if compact:  # a held pick's rank among its token's held picks; one read of their counts
            mine = mine.reshape(N, k)
            rank = torch.where(mine, mine.cumsum(1) - 1, k).reshape(-1)
            per_rank = torch.zeros(k + 1, dtype=torch.int64, device=x.device).scatter_add_(
                0, rank, torch.ones_like(rank))[:k].tolist()
            order = order[:sum(per_rank)]
        xs = x2.index_select(0, order // k)
    n_held = order.shape[0] if compact else N * k
    if eager and tracer.on:
        tracer.count("moe.tokens_routed", N)
        tracer.count("moe.experts_touched", int((counts > 0).sum()))
        tracer.count("moe.picks_held", n_held)
        tracer.count("moe.picks_elsewhere", N * k - n_held)
    out = swiglu(p["shared"], x2).float() if "shared" in p else x2.new_zeros(x2.shape, dtype=torch.float32)
    if n_held == 0:
        return out.to(x.dtype).reshape(shape)
    with tracer.span("moe.experts", device=True):
        h = F.silu(grouped_mm(xs, p["wg"], offs)) * grouped_mm(xs, p["wu"], offs)
        ys = grouped_mm(h, p["wd"], offs)
    if compact:
        # The held picks by rank: a token's picks added in the order of its choices, as the
        # loop below adds them, and no token twice in one index_add_, so the sum is the same
        # on every run.
        by_rank = torch.argsort(rank[order], stable=True)
        picks = order[by_rank]
        tok, wt = picks // k, w.reshape(-1)[picks]
        lo = 0
        for n in per_rank:
            if n:
                out.index_add_(0, tok[lo:lo + n], wt[lo:lo + n, None] * ys[by_rank[lo:lo + n]].float())
            lo += n
        return out.to(x.dtype).reshape(shape)
    y = torch.empty_like(ys).index_copy_(0, order, ys).reshape(N, k, -1)
    if some:  # the rows past the last group hold no product: an absent pick adds nothing here
        y = torch.where(mine.reshape(N, k, 1), y, torch.zeros((), dtype=y.dtype, device=y.device))
    for i in range(k):  # the k choices summed in fp32, one (N, hidden) slice at a time
        out += w[:, i, None] * y[:, i].float()
    return out.to(x.dtype).reshape(shape)
