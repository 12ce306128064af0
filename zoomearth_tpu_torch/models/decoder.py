"""Qwen2.5 text decoder: RMSNorm + GQA attention with M-RoPE + SwiGLU MLP
(port of models/decoder.py).

One forward serves no-cache full-sequence runs, prefill into a cache, chunk prefill
into an existing cache and single-token decode. Attention always goes through the
kernel dispatchers: K2 (`flash_causal_attention`) for S > 1, K3
(`flash_decode_attention`) for S == 1. On CPU tensors they run their plain torch
versions; on CUDA tensors the hand-written kernels. There is no size threshold and
no environment switch.

Params: embed.weight; layers[i].{input_ln,post_ln}.scale, .attn.{wq,bq,wk,bk,wv,bv,wo}
(or the fused .attn.{wqkv,bqkv,wo}), .mlp.{wg,wu,wd} (or fused .mlp.{wgu,wd});
final_ln.scale; lm_head.weight when untied. Matrices are (in, out).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_causal import flash_causal_attention
from ..ops.flash_decode import flash_decode_attention
from ..config import TextConfig
from .rope import apply_rotary, mrope_cos_sin
from .vit import rms_norm


class KVCache:
    """Preallocated KV cache: per-layer (B, Hkv, T, D) tensors, UPDATED IN PLACE.

    decoder_forward writes the new keys/values into these tensors and returns the
    same object with `length` advanced, instead of a new cache as the reference's
    pure functions do. A caller that needs the old contents afterwards (a shared
    prefix holder) must pass a copy (see Generator.run_chunk_prefill). `length` is a
    (B,) int32 tensor of valid entries per row; it is replaced, not mutated.

    The kv-head-major layout keeps (T, D) minor, as the reference; the kernels read
    any prefix view of it through strides. The int8 cache mode is not ported yet.
    """

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor], length: torch.Tensor):
        self.k = k
        self.v = v
        self.length = length

    @staticmethod
    def create(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu") -> "KVCache":
        if dtype == torch.int8:
            raise NotImplementedError("int8 KV cache: ROADMAP queue 1, item 'int8 KV cache'")
        shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        L = cfg.num_hidden_layers
        return KVCache(
            k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    def clone(self) -> "KVCache":
        return KVCache([t.clone() for t in self.k], [t.clone() for t in self.v], self.length.clone())

    def grown(self, max_len: int) -> "KVCache":
        """A copy zero-extended to max_len rows (the original is left untouched)."""
        def g(t):
            out = t.new_zeros(t.shape[:2] + (max_len,) + t.shape[3:])
            out[:, :, : t.shape[2]] = t
            return out

        return KVCache([g(t) for t in self.k], [g(t) for t in self.v], self.length.clone())


def _drop_write(cache: torch.Tensor, write_pos: torch.Tensor, values: torch.Tensor) -> None:
    """cache[b, :, write_pos[b, s]] = values[b, s] in place, DROPPING slots outside
    [0, T) — the reference's `.at[...].set(mode="drop")`. An index of T would be a
    device-side assert on CUDA, so out-of-range writes are masked before indexing.

    S == 1 (decode) stays free of host syncs: a dropped write rewrites the row's
    current value at a clamped slot (one write per row, so no index collides).
    S > 1 filters the writes with a boolean mask (one host sync per call)."""
    B, S = write_pos.shape
    T = cache.shape[2]
    values = values.to(cache.dtype)
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, S)
    keep = (write_pos >= 0) & (write_pos < T)
    if S == 1:
        pos = write_pos.clamp(0, T - 1)
        old = cache[bidx, :, pos]  # (B, 1, Hkv, D)
        cache[bidx, :, pos] = torch.where(keep[..., None, None], values, old)
    else:
        cache[bidx[keep], :, write_pos[keep]] = values[keep]


def _slice_write(cache: torch.Tensor, start: torch.Tensor, values: torch.Tensor) -> None:
    """Per-row contiguous write of S slots at start[b] (the reference's vmapped
    dynamic_update_slice, which clamps the start into [0, T - S])."""
    B, S = values.shape[:2]
    T = cache.shape[2]
    start = start.clamp(0, max(T - S, 0))
    slots = start[:, None] + torch.arange(S, device=cache.device)[None]
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, S)
    cache[bidx, :, slots] = values.to(cache.dtype)


def _attn_layer(
    p,
    cfg: TextConfig,
    x,  # (B, S, E)
    cos,
    sin,  # (B, S, head_dim)
    positions,  # (B, S) causal-order positions (cache slots)
    attn_valid,  # (B, S) bool: real (non-pad) input tokens
    cache_kv=None,  # (k_cache, v_cache) (B, Hkv, T, D), written in place
    cache_len=None,  # (B,)
    write_pos=None,  # (B, S) explicit kv write slots; >= T drops
    attend_len: Optional[int] = None,  # decode attends only cache[:, :, :attend_len]
):
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "wqkv" in p:  # fused layout: one matmul, then split
        qkv = x @ p["wqkv"] + p["bqkv"]
        q = qkv[..., : H * D].reshape(B, S, H, D)
        k = qkv[..., H * D : (H + Hkv) * D].reshape(B, S, Hkv, D)
        v = qkv[..., (H + Hkv) * D :].reshape(B, S, Hkv, D)
    else:
        q = (x @ p["wq"] + p["bq"]).reshape(B, S, H, D)
        k = (x @ p["wk"] + p["bk"]).reshape(B, S, Hkv, D)
        v = (x @ p["wv"] + p["bv"]).reshape(B, S, Hkv, D)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    if cache_kv is None:
        # No cache: slot t is token t. The right-padded attn_valid is the prefix
        # [0, kv_len), and causality excludes the pad tail from real queries.
        kv_len = attn_valid.sum(dim=1).to(torch.int32)
        out = flash_causal_attention(q, k.transpose(1, 2), v.transpose(1, 2), positions, kv_len)
    else:
        k_cache, v_cache = cache_kv
        if write_pos is None and S == 1:
            write_pos = cache_len[:, None]
        if write_pos is not None:
            _drop_write(k_cache, write_pos, k)
            _drop_write(v_cache, write_pos, v)
        else:
            _slice_write(k_cache, cache_len, k)
            _slice_write(v_cache, cache_len, v)
        if S == 1:
            if attend_len is not None and attend_len < k_cache.shape[2]:
                k_att, v_att = k_cache[:, :, :attend_len], v_cache[:, :, :attend_len]
            else:
                k_att, v_att = k_cache, v_cache
            out = flash_decode_attention(q, k_att, v_att, cache_len + 1)
        else:
            out = flash_causal_attention(q, k_cache, v_cache, positions, cache_len + S)
    return out.reshape(B, S, H * D) @ p["wo"]


def _mlp(p, x):
    if "wgu" in p:  # fused layout: one gate|up matmul, then split
        gu = x @ p["wgu"]
        F_ = gu.shape[-1] // 2
        return (F.silu(gu[..., :F_]) * gu[..., F_:]) @ p["wd"]
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def decoder_forward(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, E)
    position_ids: torch.Tensor,  # (3, B, S) M-RoPE positions
    attn_positions: Optional[torch.Tensor] = None,  # (B, S) causal-order positions
    attn_valid: Optional[torch.Tensor] = None,  # (B, S) bool
    cache: Optional[KVCache] = None,
    update_cache_len: bool = True,
    write_pos: Optional[torch.Tensor] = None,
    attend_len: Optional[int] = None,
):
    """Run the decoder stack. Returns (hidden_states, cache) — the same cache object,
    written in place, with length advanced by S when update_cache_len.

    - No cache: attn_positions defaults to iota and attn_valid must be a right-padded
      prefix mask (slot order == position order).
    - Cache prefill/decode: attn_positions are cache slot indices (cache_len + iota).
    M-RoPE position_ids drive the rotary; attn_positions drive causal masking."""
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if attn_positions is None:
        attn_positions = torch.arange(S, device=dev)[None].expand(B, S)
    if attn_valid is None:
        attn_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_ln"]["scale"], cfg.rms_norm_eps)
        cache_kv = (cache.k[i], cache.v[i]) if cache is not None else None
        attn_out = _attn_layer(
            layer["attn"], cfg, h, cos, sin, attn_positions, attn_valid, cache_kv,
            cache.length if cache is not None else None,
            write_pos=write_pos, attend_len=attend_len,
        )
        x = x + attn_out
        h = rms_norm(x, layer["post_ln"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(layer["mlp"], h)
    x = rms_norm(x, params["final_ln"]["scale"], cfg.rms_norm_eps)
    if cache is not None and update_cache_len:
        cache.length = cache.length + S
    return x, cache


def logits_from_hidden(params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """(..., E) -> (..., V) logits in fp32, accumulated in fp32 from the weights'
    own dtype.

    On CUDA a bf16 head uses cuBLAS's fp32-output GEMM (`torch.mm(..., out_dtype=)`),
    so no fp32 copy of the 151936 x E embedding is materialised and argmax ties do
    not multiply as they would with bf16 logits. On the CPU a bf16 head is upcast
    (tests only); fp32 params are exact fp32 everywhere."""
    if cfg.tie_word_embeddings:
        w = params["embed"]["weight"].t()  # (E, V) view
    else:
        w = params["lm_head"]["weight"]
    h = hidden.to(w.dtype)
    if w.dtype == torch.float32:
        return h @ w
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h.device.type == "cuda":
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = h2.float() @ w.float()
    return out.reshape(*lead, out.shape[-1])
