"""Multi-head latent attention (MLA) of Kimi-VL's DeepSeek-V3-style decoder, and its
latent cache.

With x the normed hidden state of the token at position t, H = 16 heads, r = 512
(kv_lora_rank), dn = 128 (qk_nope_head_dim), dr = 64 (qk_rope_head_dim), dv = 128:

- q = x W_q gives H x [q_n (dn) | q_r (dr)];
- [c~ (r) | k~_r (dr)] = x W_kva, c = RMSNorm(c~) (eps 1e-5);
- q_r and k_r = RoPE_t(k~_r) turn over dr dims with theta 800000, after DeepSeek-V3's
  de-interleave (pairs (2i, 2i + 1) become (i, i + dr/2)) and rotate-half;
- [k_n,h | v_h] = c W_kvb,h, with W_kvb (r, H (dn + dv)) as H blocks [W_UK,h | W_UV,h];
- score_h(t, s) = (q_n,h . k_n,h(s) + q_r,h . k_r(s)) / sqrt(dn + dr);
- out = concat_h(softmax(score_h) v_h) W_o.

The cache keeps [c | k_r] per token and layer: one latent "head" of r + dr = 576
values (`LatentCache`), against 2 x 16 x 128 for a GQA cache of the same heads.

Two forms of the same attention:

- expanded (prefill, chunk prefill, no cache): k_n and v of every slot the queries see
  are made from the latents (`expand`, the device span `mla.expand`), k = [k_n | k_r]
  of width 192 and v of width 128, and K2 runs at key width 192 and value width 128;
  the chunk prefill expands the kept latent prefix with the chunk, layer by layer;
- absorbed (decode): q^_h = q_n,h W_UK,h^T of width r, score = ([q^_h | q_r,h] .
  [c | k_r]) / sqrt(dn + dr), o^_h = sum_s p c(s) of width r, o_h = o^_h W_UV,h. K5
  (ops/flash_mla_decode.py) reads each row's latent cache once for all 16 heads; its
  scale is passed as 1/sqrt(dn + dr), not derived from the 576-wide keys.

Inference only: a gradient through MLA raises before any launch, as does an int8
latent cache.

Params of a layer's attention: wq (E, H (dn + dr)), wkva (E, r + dr), kv_norm.scale (r),
wkvb (r, H (dn + dv)), wo (H dv, E), matrices (in, out).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..config import KimiTextConfig
from ..ops.flash_causal import flash_causal_attention
from ..ops.flash_mla_decode import flash_mla_decode
from ..ops.quant import qdot
from ..utils.profiling import tracer
from .decoder import KVCache, _drop_write, _require_no_grad, _slice_write
from .rope import _inv_freq, rotate_half
from .vit import rms_norm


class LatentCache(KVCache):
    """Preallocated latent cache: per layer one (B, 1, T, r + dr) tensor (`k`; `v` is
    empty), written in place, with KVCache's `length`, `rows`, `clone` and `grown`
    semantics, so the Generator's prefills, pair decode, attend buckets and captured
    steps use it as they use a KV cache."""

    description = "a latent cache (Kimi-VL)"

    @staticmethod
    def create(cfg: KimiTextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu") -> "LatentCache":
        if dtype == torch.int8:
            raise NotImplementedError("LatentCache: no int8 latent cache; use the model's dtype")
        shape = (batch, 1, max_len, cfg.latent_dim)
        return LatentCache([torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_hidden_layers)],
                           [], torch.zeros((batch,), dtype=torch.int32, device=device))

    def layer(self, i: int):
        return (self.k[i], None, None, None)

    def _map(self, fn) -> "LatentCache":
        return LatentCache([fn(t) for t in self.k], [], self.length.clone())

    def rows(self, rows: slice) -> "LatentCache":
        return LatentCache([t[rows] for t in self.k], [], self.length[rows])


def rope_cos_sin(positions: torch.Tensor, cfg: KimiTextConfig):
    """positions (B, S) -> cos, sin (B, S, dr) fp32 of the 1D rotary (rotate-half layout)."""
    f = positions[..., None].float() * _inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, positions.device)
    emb = torch.cat([f, f], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x (B, S, [H,] dr) de-interleaved and turned (DeepSeek-V3's order), in fp32,
    rounded once to x.dtype. cos/sin (B, S, dr)."""
    d = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    if x.dim() == 4:
        cos, sin = cos[:, :, None], sin[:, :, None]
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def project(p, cfg: KimiTextConfig, x, cos, sin):
    """x (B, S, E) -> q_n (B, S, H, dn), turned q_r (B, S, H, dr), and the latents
    [c | k_r] (B, S, r + dr) the cache keeps."""
    B, S, _ = x.shape
    H, dn, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = qdot(x, p["wq"]).reshape(B, S, H, cfg.q_head_dim)
    kva = qdot(x, p["wkva"])
    c = rms_norm(kva[..., :r], p["kv_norm"]["scale"], cfg.rms_norm_eps)
    latent = torch.cat([c, apply_rope(kva[..., r:], cos, sin)], dim=-1)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin), latent


def expand(p, cfg: KimiTextConfig, latent: torch.Tensor):
    """Latents (B, L, r + dr) -> k (B, H, L, dn + dr) and v (B, H, L, dv), as views
    whose rows K2 reads through their strides."""
    B, L, _ = latent.shape
    H, dn, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    with tracer.span("mla.expand", device=True):
        kv = qdot(latent[..., :r], p["wkvb"]).reshape(B, L, H, dn + cfg.v_head_dim)
        k = torch.cat([kv[..., :dn], latent[:, :, None, r:].expand(B, L, H, cfg.qk_rope_head_dim)], dim=-1)
    return k.transpose(1, 2), kv[..., dn:].transpose(1, 2)


def _absorbed_weights(p, cfg: KimiTextConfig):
    """(W_UK as (H, dn, r), W_UV as (H, r, dv)): views of wkvb, no copy."""
    H, dn, dv, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    w = p["wkvb"].reshape(r, H, dn + dv)
    return w[:, :, :dn].permute(1, 2, 0), w[:, :, dn:].permute(1, 0, 2)


def decode(p, cfg: KimiTextConfig, q_n, q_r, latent, cache_lat, cache_len, attend_len: Optional[int],
           write_pos=None):
    """One token a row (S == 1) in the absorbed form: write its latent at cache_len (or
    write_pos), then K5 over the attend_len prefix view of the latent cache. Returns
    the heads' outputs (B, 1, H dv) before W_o."""
    _require_no_grad(q_n)
    B = q_n.shape[0]
    _drop_write(cache_lat, cache_len[:, None] if write_pos is None else write_pos, latent[:, :, None])
    if attend_len is not None and attend_len < cache_lat.shape[2]:
        cache_lat = cache_lat[:, :, :attend_len]
    w_uk, w_uv = _absorbed_weights(p, cfg)
    q_hat = torch.bmm(q_n[:, 0].transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, r)
    q_full = torch.cat([q_hat, q_r[:, 0]], dim=-1)
    o_lat = flash_mla_decode(q_full, cache_lat, cache_len + 1, cfg.q_head_dim**-0.5, cfg.kv_lora_rank)  # (B, H, r)
    o = torch.bmm(o_lat.transpose(0, 1), w_uv).transpose(0, 1)  # (B, H, dv)
    return o.reshape(B, 1, -1)


def attention(p, cfg: KimiTextConfig, x, cos, sin, positions, attn_valid, cache_kv=None, cache_len=None,
              write_pos=None, attend_len: Optional[int] = None, index=None):
    """The attention of one layer (decoder._attn_layer's arguments): (B, S, E) after W_o.

    No cache: the expanded form over this forward's own latents. S > 1 with a cache:
    the latents written at write_pos (or as S slots from cache_len), then the expanded
    form over the first attend_len slots of the cache (all of them where not given).
    S == 1: the absorbed form on K5."""
    B, S, _ = x.shape
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("MLA: inference only (no backward through latent attention or its kernels)")
    q_n, q_r, latent = project(p, cfg, x, cos, sin)
    if cache_kv is not None and S == 1:
        out = decode(p, cfg, q_n, q_r, latent, cache_kv[0], cache_len, attend_len, write_pos)
        return qdot(out, p["wo"])
    q = torch.cat([q_n, q_r], dim=-1)
    if cache_kv is None:
        k, v = expand(p, cfg, latent)
        kv_len = attn_valid.sum(dim=1).to(torch.int32)
    else:
        cache_lat = cache_kv[0]
        if write_pos is not None:
            _drop_write(cache_lat, write_pos, latent[:, :, None], index)
        else:
            _slice_write(cache_lat, cache_len, latent[:, :, None])
        L = cache_lat.shape[2] if attend_len is None else min(attend_len, cache_lat.shape[2])
        k, v = expand(p, cfg, cache_lat[:, 0, :L])
        kv_len = cache_len + S
    out = flash_causal_attention(q, k, v, positions, kv_len)
    return qdot(out.reshape(B, S, -1), p["wo"])


def pair_attention(p, cfg: KimiTextConfig, x, cos, sin, groups: List):
    """Pair decode: the projections on the concatenated batch, then the absorbed form per
    row group against its own cache and attend span. groups: (rows, cache layer
    (latents, ...), cache_len, attend_len) per group."""
    B, S, _ = x.shape
    q_n, q_r, latent = project(p, cfg, x, cos, sin)
    out = torch.cat([decode(p, cfg, q_n[rows], q_r[rows], latent[rows], lat[0], length, attend)
                     for rows, lat, length, attend in groups])
    return qdot(out, p["wo"])
