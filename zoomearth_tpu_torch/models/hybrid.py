"""MiMo-V2.5's attention layers, window and global, and the cache that holds both.

A layer's kind is its config.HybridAttention (MiMoTextConfig.layer_attention(i)): with x
the normed hidden state, H query heads and Hkv key/value heads (global 64 / 4, window
64 / 8), dq = 192, dv = 128, r = 64 rotary dims:

- [q | k | v] = x W_qkv (one fused product), H x dq, Hkv x dq and Hkv x dv;
- the first r dims of each q and k head turn by the 1D rotary (rotate-half) at the
  token's position, theta 1e7 (global) or 1e4 (window); the other dq - r pass;
- score_h(t, s) = q_h(t) . k_g(s) / sqrt(dq) over the keys s <= t of the head's group
  g = h / (H / Hkv); a window layer sees only t - window < s (window 128: the token and
  its 127 predecessors) and adds a learned sink logit per head as one more softmax
  column whose value is 0;
- out = value_scale x concat_h(softmax(score_h) v_g) W_o (attention is linear in v, so
  the published value scale is applied to the heads' outputs).

The cache keeps per layer k (B, Hkv, T, dq) and v (B, Hkv, T, dv), Hkv by the layer's
kind (`HybridCache`): a window layer 8 x (192 + 128) values a token, a global layer 4 x
(192 + 128). Every layer keeps full-length slots; the window layers' kernels read only
their window. So a chunk prefill over a kept prefix (the stage-2 continuation) finds
each row's 127 keys before its kept point where they were written.

Kernels: prefill, chunk prefill and the no-cache path run K2 at key width 192 and value
width 128 (`flash_causal_attention`; the window layers with the band and the sinks),
decode runs K6 (`ops/flash_gqa_decode.py`; 16 heads a KV head in the global layers,
8 with the window and the sinks in the window layers).

Tracing (utils/profiling.py): outside a stream capture, the device span `attn.window`
around a window layer's attention, and, while the tracer is on, the counter
`attn.window_keys`: the (row, KV head, slot) key rows those launches read (reading it
waits for the device).

Inference only: a gradient raises before any launch, as does an int8 cache.

Params of a layer's attention: wqkv (E, H dq + Hkv (dq + dv)), wo (H dv, E), and for a
window layer sink (H,) fp32.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from ..config import HybridAttention, MiMoTextConfig
from ..ops.flash_causal import flash_causal_attention
from ..ops.flash_gqa_decode import flash_gqa_decode, walked
from ..ops.quant import qdot
from ..utils.profiling import tracer
from .decoder import KVCache, _cache_write, _require_no_grad
from .rope import _inv_freq, apply_rotary


class HybridCache(KVCache):
    """Preallocated cache of MiMo-V2.5's layers: per layer k (B, Hkv, T, dq) and v (B, Hkv,
    T, dv) with the layer's own Hkv, written in place, with KVCache's `length`, `rows`,
    `clone` and `grown` semantics."""

    description = "a cache of window and global layers (MiMo-V2.5)"

    @staticmethod
    def create(cfg: MiMoTextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu") -> "HybridCache":
        if dtype == torch.int8:
            raise NotImplementedError("HybridCache: no int8 cache for MiMo-V2.5's layers; use the model's dtype")
        k, v = [], []
        for i in range(cfg.num_hidden_layers):
            a = cfg.layer_attention(i)
            k.append(torch.zeros((batch, a.num_key_value_heads, max_len, a.qk_head_dim), dtype=dtype, device=device))
            v.append(torch.zeros((batch, a.num_key_value_heads, max_len, a.v_head_dim), dtype=dtype, device=device))
        return HybridCache(k, v, torch.zeros((batch,), dtype=torch.int32, device=device))


def rope_cos_sin(positions: torch.Tensor, a: HybridAttention):
    """positions (B, S) -> cos, sin (B, S, rope_dim) fp32 of the kind's 1D rotary (rotate-half layout)."""
    f = positions[..., None].float() * _inv_freq(a.rope_dim, a.rope_theta, positions.device)
    emb = torch.cat([f, f], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _partial_rotary(x, cos, sin, r: int):
    """The first r dims of each head turned (in fp32, rounded once to x.dtype), the rest as they are."""
    return torch.cat([apply_rotary(x[..., :r], cos, sin), x[..., r:]], dim=-1)


def project(p, a: HybridAttention, x, cos, sin):
    """x (B, S, E) -> turned q (B, S, H, dq), turned k (B, S, Hkv, dq), v (B, S, Hkv, dv)."""
    B, S, _ = x.shape
    H, Hkv, dq, dv = a.num_attention_heads, a.num_key_value_heads, a.qk_head_dim, a.v_head_dim
    qkv = qdot(x, p["wqkv"])
    q = qkv[..., : H * dq].reshape(B, S, H, dq)
    k = qkv[..., H * dq: (H + Hkv) * dq].reshape(B, S, Hkv, dq)
    v = qkv[..., (H + Hkv) * dq:].reshape(B, S, Hkv, dv)
    return _partial_rotary(q, cos, sin, a.rope_dim), _partial_rotary(k, cos, sin, a.rope_dim), v


def _traced(a: HybridAttention, device):
    """The span of a window layer's attention, where one is recorded (eager, tracer on)."""
    eager = not (device.type == "cuda" and torch.cuda.is_current_stream_capturing())
    return tracer.span("attn.window", device=True) if a.window > 0 and eager else contextlib.nullcontext()


def _count_keys(a: HybridAttention, positions, kv_len, T: int) -> None:
    """attn.window_keys += the (row, KV head, slot) key rows a window layer's launch reads:
    per row, the slots from its smallest query position's window edge to its largest
    position, within kv_len."""
    if not (a.window > 0 and tracer.on) or (positions.device.type == "cuda"
                                             and torch.cuda.is_current_stream_capturing()):
        return
    klen = kv_len.to(torch.int64).clamp(0, T)
    hi = torch.minimum(positions.to(torch.int64).amax(1) + 1, klen)
    lo = (positions.to(torch.int64).amin(1) - a.window + 1).clamp(min=0)
    tracer.count("attn.window_keys", int((hi - lo).clamp(min=0).sum()) * a.num_key_value_heads)


def decode(p, a: HybridAttention, q, k, v, cache_kv, cache_len, attend_len: Optional[int], write_pos=None):
    """One token a row (S == 1): write its k and v at cache_len (or write_pos), then K6 over
    the attend_len prefix views of the layer's cache. Returns the heads' outputs (B, 1,
    H dv) before the value scale and W_o."""
    _require_no_grad(q)
    B = q.shape[0]
    _cache_write(cache_kv, k, v, cache_len, cache_len[:, None] if write_pos is None else write_pos)
    kc, vc = cache_kv[0], cache_kv[1]
    if attend_len is not None and attend_len < kc.shape[2]:
        kc, vc = kc[:, :, :attend_len], vc[:, :, :attend_len]
    kv_len = cache_len + 1
    if a.window > 0 and tracer.on and not (q.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        tracer.count("attn.window_keys", int(walked(kv_len, kc.shape[2], a.window).sum()) * a.num_key_value_heads)
    out = flash_gqa_decode(q[:, 0], kc, vc, kv_len, a.qk_head_dim**-0.5, a.window, p.get("sink"))
    return out.reshape(B, 1, -1)


def attention(p, a: HybridAttention, x, cos, sin, positions, attn_valid, cache_kv=None, cache_len=None,
              write_pos=None, attend_len: Optional[int] = None, index=None):
    """The attention of one layer (decoder._attn_layer's arguments): (B, S, E) after W_o.

    No cache: K2 over this forward's own keys. S > 1 with a cache: k and v written at
    write_pos (or as S slots from cache_len), then K2 over the cache. S == 1: K6."""
    B, S, _ = x.shape
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("hybrid attention: inference only (no backward through the band, the sinks or K6)")
    with _traced(a, x.device):
        q, k, v = project(p, a, x, cos, sin)
        if cache_kv is not None and S == 1:
            out = decode(p, a, q, k, v, cache_kv, cache_len, attend_len, write_pos)
        else:
            if cache_kv is None:
                k, v = k.transpose(1, 2), v.transpose(1, 2)
                kv_len = attn_valid.sum(dim=1).to(torch.int32)
            else:
                if cache_kv[0].dtype == torch.int8:
                    raise NotImplementedError("hybrid attention: no int8 cache")
                _cache_write(cache_kv, k, v, cache_len, write_pos, index)
                k, v, kv_len = cache_kv[0], cache_kv[1], cache_len + S
            _count_keys(a, positions, kv_len, k.shape[2])
            out = flash_causal_attention(q, k, v, positions, kv_len, window=a.window, sink=p.get("sink"))
        return qdot(out.reshape(B, S, -1) * a.value_scale, p["wo"])


def pair_attention(p, a: HybridAttention, x, cos, sin, groups: List):
    """Pair decode: the projections on the concatenated batch, then K6 per row group against
    its own cache and attend span. groups: (rows, cache layer (k, v, ...), cache_len,
    attend_len) per group."""
    with _traced(a, x.device):
        q, k, v = project(p, a, x, cos, sin)
        out = torch.cat([decode(p, a, q[rows], k[rows], v[rows], kv, length, attend)
                         for rows, kv, length, attend in groups])
        return qdot(out * a.value_scale, p["wo"])
