"""Qwen2.5 text decoder: RMSNorm + GQA attention with M-RoPE + SwiGLU MLP
(port of models/decoder.py).

One forward serves no-cache full-sequence runs, prefill into a cache, chunk prefill
into an existing cache and single-token decode. Attention always goes through the
kernel dispatchers: K2 (`flash_causal_attention`) for S > 1, K3
(`flash_decode_attention`) for S == 1. On CPU tensors they run their plain torch
versions; on CUDA tensors the hand-written kernels. There is no size threshold and
no environment switch. Training runs the no-cache path, where K2 has a backward;
a cache path asked for a gradient raises before any launch (the caches are
written in place and K3 has no backward). `decoder_forward_pair` is the co-batched decode step over two
caches; an int8 cache (`KVCache.create(dtype=torch.int8)`) sends both kernels through
their int8 entries.

Every family's decoder runs through the same functions under one per-layer rule:
`cfg.layer_attention(i)` is the config layer i's attention runs by, and its
`attention_kind` names the module of models/ that computes it (`_attention_module`):
None is the GQA code here (Qwen2.5, InternVL), "mla" models/mla.py (Kimi-VL's latent
attention over a LatentCache), "hybrid" models/hybrid.py (MiMo-V2.5's window and global
layers over a HybridCache). Such a module gives `attention`, `pair_attention` and
`rope_cos_sin` (the rotary of its layer config, from the first position plane: those
families' positions are sequential, the three planes equal), and is imported at the first
call, as it imports this module. `_mlp` hands the routed-expert layers
(`cfg.is_moe_layer(i)`) to models/moe.py.

Params: embed.weight; layers[i].{input_ln,post_ln}.scale, .attn.{wq,bq,wk,bk,wv,bv,wo}
(or the fused .attn.{wqkv,bqkv,wo}), .mlp.{wg,wu,wd} (or fused .mlp.{wgu,wd});
final_ln.scale; lm_head.weight when untied. Matrices are (in, out); each may be a
plain tensor or an int8 / LoRA dict (every matmul goes through ops.quant.qdot), and
lm_head_q8, when present, is the int8 copy of the logits head.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_causal import flash_causal_attention
from ..ops.flash_decode import flash_decode_attention
from ..ops.quant import qdot
from ..config import TextConfig
from .rope import apply_rotary, mrope_cos_sin
from .vit import rms_norm


class KVCache:
    """Preallocated KV cache: per-layer (B, Hkv, T, D) tensors, UPDATED IN PLACE.

    decoder_forward writes the new keys/values into these tensors and returns the
    same object with `length` advanced, instead of a new cache as the reference's
    pure functions do. A caller that needs the old contents afterwards (a shared
    prefix holder) must pass a copy (see Generator.run_chunk_prefill). `length` is a
    (B,) int32 tensor of valid entries per row. The cache owns ONE such tensor for
    its lifetime: the forwards advance it with `add_`, the Generator's prefills set
    it with `copy_`, so a decode step that is captured once and replayed keeps
    reading the tensor it captured. `clone()` and `grown()` give the copy its own;
    `rows()` is a view of some rows whose writes, `length` included, land in this
    cache.

    The kv-head-major layout keeps (T, D) minor, as the reference; the kernels read
    any prefix view of it through strides.

    int8 mode (`create(dtype=torch.int8)`): k/v hold per-token-quantized values
    (`_quantize_kv`) and kscale/vscale, per layer (B, Hkv, T), their scales. The
    reference stores the scales in bf16; here the bf16-ROUNDED scale is kept in an
    fp32 tensor, which is what the kernels read, so a prefix view goes to them as it
    is and no launch converts or copies it. Attention stays exact with respect to the
    quantized values: ks multiplies the logit columns, vs multiplies p before p @ v.
    """

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor], length: torch.Tensor,
                 kscale: Optional[List[torch.Tensor]] = None, vscale: Optional[List[torch.Tensor]] = None):
        self.k = k
        self.v = v
        self.length = length
        self.kscale = kscale
        self.vscale = vscale

    @staticmethod
    def create(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        L = cfg.num_hidden_layers

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)]

        quant = dtype == torch.int8
        return KVCache(
            k=zeros(shape, dtype), v=zeros(shape, dtype),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            kscale=zeros(shape[:3], torch.float32) if quant else None,
            vscale=zeros(shape[:3], torch.float32) if quant else None,
        )

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def quantized(self) -> bool:
        return self.kscale is not None

    def layer(self, i: int):
        """(k, v, kscale, vscale) of layer i; the scales are None unless int8."""
        return (self.k[i], self.v[i], self.kscale[i] if self.quantized else None,
                self.vscale[i] if self.quantized else None)

    def _map(self, fn) -> "KVCache":
        return KVCache([fn(t) for t in self.k], [fn(t) for t in self.v], self.length.clone(),
                       [fn(t) for t in self.kscale] if self.quantized else None,
                       [fn(t) for t in self.vscale] if self.quantized else None)

    def rows(self, rows: slice) -> "KVCache":
        """The cache of rows `rows` as views of this one's tensors (contiguous, as the
        batch dimension leads): a forward into it writes these rows in place."""
        def r(ts):
            return [t[rows] for t in ts] if ts is not None else None

        return KVCache(r(self.k), r(self.v), self.length[rows], r(self.kscale), r(self.vscale))

    def clone(self) -> "KVCache":
        return self._map(torch.clone)

    def grown(self, max_len: int) -> "KVCache":
        """A copy zero-extended to max_len rows (the original is left untouched)."""
        def g(t):
            out = t.new_zeros(t.shape[:2] + (max_len,) + t.shape[3:])
            out[:, :, : t.shape[2]] = t
            return out

        return self._map(g)


def _quantize_kv(x: torch.Tensor):
    """(B, S, Hkv, D) -> (int8 values, (B, S, Hkv) scales), symmetric per token: the
    reference's arithmetic step for step. The values are quantized with the fp32
    scale; the scale that is kept is that scale rounded to bf16 (as the reference
    stores it), held in fp32."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16).float()


def write_index(write_pos, T: int, device=None):
    """The (row, token, slot) index tensors of the writes that land in [0, T), from
    write_pos (B, S): what `_drop_write` needs at S > 1. The kept writes depend on
    write_pos alone, so one index serves k, v and both scale tensors of every layer
    of a forward. From a numpy array (the Generator has the chunk's rows on the
    host) nothing waits for the device; from a device tensor it is one host sync."""
    if isinstance(write_pos, torch.Tensor):
        keep = (write_pos >= 0) & (write_pos < T)
        rows, cols = keep.nonzero(as_tuple=True)
        return rows, cols, write_pos[rows, cols].long()
    write_pos = np.asarray(write_pos)
    rows, cols = np.nonzero((write_pos >= 0) & (write_pos < T))
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (rows, cols, write_pos[rows, cols]))


def _drop_write(cache: torch.Tensor, write_pos: torch.Tensor, values: torch.Tensor, index=None) -> None:
    """cache[b, :, write_pos[b, s]] = values[b, s] in place, DROPPING slots outside
    [0, T) — the reference's `.at[...].set(mode="drop")`. An index of T would be a
    device-side assert on CUDA, so out-of-range writes are masked before indexing.
    cache is (B, Hkv, T, D) with values (B, S, Hkv, D), or the int8 cache's scales
    (B, Hkv, T) with values (B, S, Hkv).

    S == 1 (decode) stays free of host syncs: a dropped write rewrites the row's
    current value at a clamped slot (one write per row, so no index collides).
    S > 1 writes through `index` (see write_index; built here when not given)."""
    B, S = write_pos.shape
    T = cache.shape[2]
    values = values.to(cache.dtype)
    if S == 1:
        bidx = torch.arange(B, device=cache.device)[:, None]
        keep = ((write_pos >= 0) & (write_pos < T)).reshape((B, 1) + (1,) * (values.dim() - 2))
        pos = write_pos.clamp(0, T - 1)
        old = cache[bidx, :, pos]  # (B, 1, Hkv[, D])
        cache[bidx, :, pos] = torch.where(keep, values, old)
    else:
        rows, cols, slots = write_index(write_pos, T) if index is None else index
        cache[rows, :, slots] = values[rows, cols]


def _slice_write(cache: torch.Tensor, start: torch.Tensor, values: torch.Tensor) -> None:
    """Per-row contiguous write of S slots at start[b] (the reference's vmapped
    dynamic_update_slice, which clamps the start into [0, T - S]); values (B, S, Hkv, D)
    into a (B, Hkv, T, D) cache, or (B, S, Hkv) into its (B, Hkv, T) scales."""
    B, S = values.shape[:2]
    T = cache.shape[2]
    start = start.clamp(0, max(T - S, 0))
    slots = start[:, None] + torch.arange(S, device=cache.device)[None]
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, S)
    cache[bidx, :, slots] = values.to(cache.dtype)


def _project_qkv(p, cfg: TextConfig, x, cos, sin):
    """x (B, S, E) -> rotated q (B, S, H, D), rotated k and v (B, S, Hkv, D). The
    separate layout's head counts are its matrices' (a tensor rank's own heads)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "wqkv" in p:  # fused layout: one matmul, then split
        qkv = qdot(x, p["wqkv"]) + p["bqkv"]
        q = qkv[..., : H * D].reshape(B, S, H, D)
        k = qkv[..., H * D : (H + Hkv) * D].reshape(B, S, Hkv, D)
        v = qkv[..., (H + Hkv) * D :].reshape(B, S, Hkv, D)
    else:
        q = (qdot(x, p["wq"]) + p["bq"]).reshape(B, S, -1, D)
        k = (qdot(x, p["wk"]) + p["bk"]).reshape(B, S, -1, D)
        v = (qdot(x, p["wv"]) + p["bv"]).reshape(B, S, -1, D)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _cache_write(cache_kv, k, v, cache_len, write_pos=None, index=None) -> None:
    """Write one forward's keys and values (B, S, Hkv, D) into a layer's cache,
    quantizing them first when it is int8 (then the scales are written too): at
    write_pos where given (out-of-range slots dropped), else as S slots from
    cache_len[b]."""
    k_cache, v_cache, ks_cache, vs_cache = cache_kv
    pairs = [(k_cache, k), (v_cache, v)]
    if k_cache.dtype == torch.int8:
        (k, ks_new), (v, vs_new) = _quantize_kv(k), _quantize_kv(v)
        pairs = [(k_cache, k), (v_cache, v), (ks_cache, ks_new), (vs_cache, vs_new)]
    for cache, values in pairs:
        if write_pos is not None:
            _drop_write(cache, write_pos, values, index)
        else:
            _slice_write(cache, cache_len, values)


def _require_no_grad(q) -> None:
    """The cache paths are inference-only: refuse a gradient on the host, before any
    kernel is launched or any cache written."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("decoder: a forward with a KV cache has no backward; train through the no-cache path "
                           "(cache=None), or run under torch.no_grad() / torch.inference_mode()")


def _decode_write_attend(q, k, v, cache_kv, cache_len, attend_len: Optional[int], write_pos=None):
    """Single-token (S == 1) cache write + attention for ONE row group: quantize when
    the cache is int8, drop-write the new token at cache_len (or at write_pos), attend
    (K3) over the attend_len prefix views of the cache (and of its scales). Shared by
    decoder_forward's decode step and by decoder_forward_pair, where the dense
    matmuls run on a concatenated batch but each group keeps its own cache and
    attend span."""
    _require_no_grad(q)
    _cache_write(cache_kv, k, v, cache_len, cache_len[:, None] if write_pos is None else write_pos)
    if attend_len is not None and attend_len < cache_kv[0].shape[2]:
        cache_kv = tuple(c[:, :, :attend_len] if c is not None else None for c in cache_kv)
    return flash_decode_attention(q, cache_kv[0], cache_kv[1], cache_len + 1, cache_kv[2], cache_kv[3])


def _layer_attention(cfg, i: int):
    """The config layer i's attention runs by: cfg.layer_attention(i), or cfg itself for
    a config without the rule (a GQA decoder's, such as the JAX package's TextConfig the
    parity tests hand in)."""
    rule = getattr(cfg, "layer_attention", None)
    return cfg if rule is None else rule(i)


_ATTENTION_MODULES: dict = {}  # attention_kind -> module, filled at the first call (they import this one)


def _attention_module(acfg):
    """The module that computes attention of a layer config's kind, or None for the GQA
    code here (see the module docstring)."""
    kind = getattr(acfg, "attention_kind", None)
    if kind is None:
        return None
    if not _ATTENTION_MODULES:
        from . import hybrid, mla

        _ATTENTION_MODULES.update(mla=mla, hybrid=hybrid)
    return _ATTENTION_MODULES[kind]


def _attn_layer(
    p,
    cfg: TextConfig,  # the layer's attention config: cfg.layer_attention(i) of the decoder's
    x,  # (B, S, E)
    cos,
    sin,  # (B, S, head_dim)
    positions,  # (B, S) causal-order positions (cache slots)
    attn_valid,  # (B, S) bool: real (non-pad) input tokens
    cache_kv=None,  # (k_cache, v_cache, kscale, vscale) of one layer, written in place
    cache_len=None,  # (B,)
    write_pos=None,  # (B, S) explicit kv write slots; >= T drops
    attend_len: Optional[int] = None,  # decode attends only cache[:, :, :attend_len]
    index=None,  # write_index(write_pos, T), shared by every layer of the forward
    tp=None,  # parallel.collectives.TensorParallel at this layer's attn (no-cache path only)
):
    module = _attention_module(cfg)
    if module is not None:
        if tp is not None:
            raise NotImplementedError(f"decoder: no tensor-parallel forward through {module.__name__}'s attention")
        return module.attention(p, cfg, x, cos, sin, positions, attn_valid, cache_kv, cache_len, write_pos,
                                attend_len, index)
    B, S, _ = x.shape
    split = False
    if tp is not None:
        _separate_layout(tp, p, "wqkv")
        p, split = tp.block(p, cols=("wq", "wk", "wv"), rows=("wo",))
        if split:
            p = tp.share_kv_head(p, cfg.num_key_value_heads)  # this rank's KV head whole, where ranks share one
            x = tp.f(x)
    q, k, v = _project_qkv(p, cfg, x, cos, sin)

    if cache_kv is None:
        # No cache: slot t is token t. The right-padded attn_valid is the prefix
        # [0, kv_len), and causality excludes the pad tail from real queries.
        kv_len = attn_valid.sum(dim=1).to(torch.int32)
        out = flash_causal_attention(q, k.transpose(1, 2), v.transpose(1, 2), positions, kv_len)
    elif S == 1:
        out = _decode_write_attend(q, k, v, cache_kv, cache_len, attend_len, write_pos)
    else:
        _require_no_grad(q)
        _cache_write(cache_kv, k, v, cache_len, write_pos, index)
        out = flash_causal_attention(q, cache_kv[0], cache_kv[1], positions, cache_len + S, cache_kv[2], cache_kv[3])
    out = qdot(out.reshape(B, S, -1), p["wo"])
    return tp.g(out) if split else out


def _separate_layout(tp, p, fused: str) -> None:
    """A tensor-parallel forward takes the separate layout the rules split; the fused
    inference layout (ops.quant.fuse_decoder_matmuls) is refused."""
    if fused in p:
        raise ValueError(f"{tp.path}: a tensor-parallel forward takes the separate layout, not the fused {fused!r}")


def _mlp(p, x, tp=None, cfg=None, i: int = 0):
    """Layer i's MLP: SwiGLU; with `tp` on this rank's slice of the width when the
    block's matrices are split (then all-reduced over tensor). A config's routed-expert
    layers (cfg.is_moe_layer(i)) go to models.moe."""
    if cfg is not None and getattr(cfg, "is_moe_layer", lambda i: False)(i):
        if tp is not None:
            raise NotImplementedError("decoder: no tensor-parallel forward through routed experts")
        from .moe import moe_forward

        return moe_forward(p, cfg, x)
    split = False
    if tp is not None:
        _separate_layout(tp, p, "wgu")
        p, split = tp.block(p, cols=("wg", "wu"), rows=("wd",))
        if split:
            x = tp.f(x)
    if "wgu" in p:  # fused layout: one gate|up matmul, then split
        gu = qdot(x, p["wgu"])
        F_ = gu.shape[-1] // 2
        return qdot(F.silu(gu[..., :F_]) * gu[..., F_:], p["wd"])
    out = qdot(F.silu(qdot(x, p["wg"])) * qdot(x, p["wu"]), p["wd"])
    return tp.g(out) if split else out


def _rotary(acfg, position_ids):
    """cos/sin of a layer config in a forward: M-RoPE over the head dim for the GQA code
    here, else its module's 1D rotary from the first position plane."""
    module = _attention_module(acfg)
    if module is not None:
        return module.rope_cos_sin(position_ids[0], acfg)
    return mrope_cos_sin(position_ids, acfg.head_dim, acfg.mrope_section, acfg.rope_theta)


class _Rotaries:
    """The cos/sin of each distinct layer config of one forward, made at first use."""

    def __init__(self, position_ids):
        self.position_ids = position_ids
        self.made = {}

    def __call__(self, acfg):
        key = id(acfg)
        if key not in self.made:
            self.made[key] = _rotary(acfg, self.position_ids)
        return self.made[key]


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
    index=None,  # write_index(write_pos, T) when the caller has it (S > 1)
    tp=None,  # parallel.collectives.TensorParallel at params (a tensor mesh's training forward)
):
    """Run the decoder stack. Returns (hidden_states, cache) — the same cache object,
    written in place, with length advanced in place by S when update_cache_len.

    - No cache: attn_positions defaults to iota and attn_valid must be a right-padded
      prefix mask (slot order == position order).
    - Cache prefill/decode: attn_positions are cache slot indices (cache_len + iota).
    M-RoPE position_ids drive the rotary; attn_positions drive causal masking.

    tp: the no-cache path over a tensor mesh: each layer's attention and MLP run on
    this rank's heads and width where the rules split them (K2 on the local heads),
    whole otherwise (TensorParallel.block)."""
    if tp is not None and cache is not None:
        raise ValueError("decoder: a tensor-parallel forward is the no-cache training path; decode on the gathered tree")
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if attn_positions is None:
        attn_positions = torch.arange(S, device=dev)[None].expand(B, S)
    if attn_valid is None:
        attn_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    if cache is not None and write_pos is not None and S > 1 and index is None:
        index = write_index(write_pos, cache.max_len)  # once, for every layer's k, v and scales
    rotary = _Rotaries(position_ids)
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        acfg = _layer_attention(cfg, i)
        cos, sin = rotary(acfg)
        h = rms_norm(x, layer["input_ln"]["scale"], cfg.rms_norm_eps)
        attn_out = _attn_layer(
            layer["attn"], acfg, h, cos, sin, attn_positions, attn_valid,
            cache.layer(i) if cache is not None else None,
            cache.length if cache is not None else None,
            write_pos=write_pos, attend_len=attend_len, index=index,
            tp=None if tp is None else tp.at("layers", i, "attn"),
        )
        x = x + attn_out
        h = rms_norm(x, layer["post_ln"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(layer["mlp"], h, None if tp is None else tp.at("layers", i, "mlp"), cfg, i)
    x = rms_norm(x, params["final_ln"]["scale"], cfg.rms_norm_eps)
    if cache is not None and update_cache_len:
        cache.length.add_(S)
    return x, cache


def decoder_forward_pair(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (Ba + Bb, 1, E) concatenated decode batch
    position_ids: torch.Tensor,  # (3, Ba + Bb, 1)
    cache_a: KVCache,
    cache_b: KVCache,
    attend_a: Optional[int] = None,
    attend_b: Optional[int] = None,
):
    """One decode step over TWO independent caches sharing a single dense pass.

    Rows [0:Ba] advance cache_a, rows [Ba:] advance cache_b. The qkv / output / MLP
    matmuls and the norms (and, at the caller, the logits head) run on the
    CONCATENATED batch, so the weights are read once for both groups. Attention runs
    per group against its own cache with its own attend span (one K3 launch each), so
    a short-context group never pays the long group's cache reads. Returns (hidden,
    cache_a, cache_b): the same objects, written in place, lengths advanced by 1."""
    Ba = cache_a.k[0].shape[0]
    B, S, _ = inputs_embeds.shape
    assert S == 1, "pair decode is single-token only"
    rotary = _Rotaries(position_ids)
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        acfg = _layer_attention(cfg, i)
        cos, sin = rotary(acfg)
        h = rms_norm(x, layer["input_ln"]["scale"], cfg.rms_norm_eps)
        module = _attention_module(acfg)
        if module is not None:
            x = x + module.pair_attention(layer["attn"], acfg, h, cos, sin, [
                (slice(0, Ba), cache_a.layer(i), cache_a.length, attend_a),
                (slice(Ba, B), cache_b.layer(i), cache_b.length, attend_b)])
        else:
            q, k, v = _project_qkv(layer["attn"], cfg, h, cos, sin)
            out = torch.cat([
                _decode_write_attend(q[:Ba], k[:Ba], v[:Ba], cache_a.layer(i), cache_a.length, attend_a),
                _decode_write_attend(q[Ba:], k[Ba:], v[Ba:], cache_b.layer(i), cache_b.length, attend_b),
            ])
            x = x + qdot(out.reshape(B, S, -1), layer["attn"]["wo"])
        h = rms_norm(x, layer["post_ln"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(layer["mlp"], h, None, cfg, i)
    x = rms_norm(x, params["final_ln"]["scale"], cfg.rms_norm_eps)
    cache_a.length.add_(1)
    cache_b.length.add_(1)
    return x, cache_a, cache_b


def _head_mm(h2, w):
    """(N, E) @ (E, V) -> fp32 (N, V), accumulated in fp32 from the weights' dtype."""
    if h2.device.type == "cuda":
        return torch.mm(h2, w, out_dtype=torch.float32)
    return h2.float() @ w.float()


class LogitsHead(torch.autograd.Function):
    """The fp32-output head with a gradient. cuBLAS's fp32-output GEMM has no
    derivative of its own, so the backward is written out: the fp32 logits' gradient
    g is rounded to the weights' dtype and goes through two products of that dtype
    (fp32 accumulation), dh = g w^T and dw = h^T g, in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        return _head_mm(h2, w)

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dh = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(h2.t(), g) if ctx.needs_input_grad[1] else None
        return dh, dw


def logits_from_hidden(params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """(..., E) -> (..., V) logits in fp32, accumulated in fp32 from the weights'
    own dtype.

    On CUDA a bf16 head uses cuBLAS's fp32-output GEMM (`torch.mm(..., out_dtype=)`),
    so no fp32 copy of the 151936 x E embedding is materialised and argmax ties do
    not multiply as they would with bf16 logits. On the CPU a bf16 head is upcast
    (tests only); fp32 params are exact fp32 everywhere. Under autograd the bf16 head
    goes through LogitsHead, whose backward is two products.

    An int8 copy of the head at params["lm_head_q8"]
    (quantize_decoder_int8(lm_head=True)) takes the head's place: its values are
    widened to the hidden state's dtype for the product, and the per-output-column
    scale multiplies the fp32 logits (exact algebra). It is not trained: asked for a
    gradient it raises."""
    scale = None
    if "lm_head_q8" in params:
        if torch.is_grad_enabled() and hidden.requires_grad:
            raise RuntimeError("logits_from_hidden: the int8 head (lm_head_q8) has no backward; train the bf16 head")
        scale = params["lm_head_q8"]["s"].float()
        w = params["lm_head_q8"]["q"].to(hidden.dtype)
    elif cfg.tie_word_embeddings:
        w = params["embed"]["weight"].t()  # (E, V) view
    else:
        w = params["lm_head"]["weight"]
    h = hidden.to(w.dtype)
    if w.dtype == torch.float32:
        out = h @ w
    else:
        out = LogitsHead.apply(h.reshape(-1, h.shape[-1]), w)
        out = out.reshape(*h.shape[:-1], out.shape[-1])
    return out if scale is None else out * scale
