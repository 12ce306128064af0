"""K2: causal GQA attention for prefill and chunk prefill.

Replaces zoomearth_tpu/ops/flash_causal.py::flash_causal_attention (Pallas). The
kernel is hand-written CUDA C++ for Hopper (csrc/flash_causal.cu, whose header says
what bounds it and what its design does about it). It has two variants, chosen
inside the C entry point from the dtypes alone (`zt_flash_causal_variant`): "mma", the
tensor-core flash core (csrc/flash_mma.cuh: wgmma at D = 128, mma.sync at the smaller
head dims) with 128 (head, position) rows a block, for bf16 queries against bf16 or
int8 K/V (the model's path), and for latent attention's expanded form and MiMo-V2.5's
global layers at key width 192 and value width 128 (`zt_flash_causal_mla`: v narrower
than q and k, bf16, no lse), and with a band and sinks for MiMo-V2.5's window layers
(`zt_flash_causal_band`, the same widths: `window` keys up to each query's position, a
sink logit per head as one more softmax column of value 0); and "fma", fp32 arithmetic with 64 rows a block, for fp32 queries, which bf16
products would cost their precision. Here:

- `flash_causal_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises). There is no fallback and no size threshold. Where a gradient
  is asked for (autograd on, an input that requires grad: the decoder's no-cache
  training path, where k and v arrive as transposed views of the (B, S, Hkv, D)
  projections) it goes through `CausalAttention`, an autograd.Function whose forward
  (which also returns each row's log-sum-exp) and backward dispatch the same way;
  the backward kernels are csrc/flash_causal_bwd.cu (the reference's Pallas kernel has
  no VJP to port): for bf16 the tensor-core backward of csrc/flash_bwd.cuh ("mma"),
  for fp32 fp32 arithmetic ("fma"), chosen in C (`zt_flash_bwd_variant`). The backward
  takes bf16 or fp32 K/V only: int8 K/V under autograd raises before any launch. dk
  and dv sum over the G query heads of a kv head and come back in k's and v's own
  layout. A row with no live key gets zero gradients.
- `flash_causal_attention_plain` / `flash_causal_attention_bwd_plain` are the plain
  torch versions of both directions, the forward including the int8 K/V algebra and
  the band and sinks (`band_sink_attention_plain`).
- `block_key_bounds` is what each block of the kernel works out for itself: where
  its key loop ends and below which key no compare is needed; the backward's dk/dv
  kernel skips a tile of query rows by the same bound.
- `work` / `work_bwd` are the least work a call needs (flops, bytes), from its inputs.
- `causal_attention_cuda.launches` counts kernel launches, `.variants` by variant,
  `.int8_launches` those on int8 K/V; `causal_attention_bwd_cuda.launches` counts
  backward calls (each launches the dq kernel, then the dk/dv kernel, then, where the
  dk/dv kernel's key blocks are split among several blocks to fill the card
  (`dkdv_splits`), the kernel that adds their partials), `.variants` by variant.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, causal_attention
from .flash_attention import BWD_ROWS

ROWS = 128  # (head, query) rows per block of the tensor-core variant (FM_ROWS in csrc/flash_mma.cuh)
ROWS_FMA = 64  # of the fp32 variant (CAU_ROWS in csrc/flash_causal.cu); G = H / Hkv must divide both
TILE = 64  # keys per tile of the tensor-core variant (FM_BKV)
MLA_WIDTHS = (192, 128)  # the (key, value) widths of the one instantiation whose value width differs
BWD_TILE = 32  # (position, head) rows per tile of the backward's dk/dv kernels (BWD_TILE in csrc/flash_bwd.cuh)
BWD_BLOCKS_PER_SM = 4  # the backward's dk/dv blocks to aim for, per SM of the card: its FMA variant
BWD_BLOCKS_PER_SM_MMA = 3  # and its tensor-core variant (one resident block an SM; 1-6 tried on the H100, 3 fastest)


def block_key_bounds(positions: torch.Tensor, kv_len: torch.Tensor, T: int, bq: int):
    """(hi, full), each (B, ceil(S / bq)) int32, of the blocks of bq query positions:
    the block walks keys [0, hi), hi = min(largest position + 1, kv_len), and every
    key below full = min(smallest position + 1, kv_len) is live for each of its rows,
    so a tile [t0, t0 + TILE) needs the causal/length compare iff t0 + TILE > full
    (`tile_needs_mask`). kv_len is clipped to [0, T], positions to [-1, T - 1]."""
    B, S = positions.shape
    n = -(-S // bq)
    klen = kv_len.to(torch.int32).clamp(0, T)[:, None]
    pos = positions.to(torch.int32).clamp(-1, T - 1)
    pad = n * bq - S
    hi = torch.nn.functional.pad(pos, (0, pad), value=-1).reshape(B, n, bq).amax(-1)
    lo = torch.nn.functional.pad(pos, (0, pad), value=T).reshape(B, n, bq).amin(-1)
    return torch.minimum(hi + 1, klen), torch.minimum(lo + 1, klen)


def tile_needs_mask(t0: int, full: int, tile: int = TILE) -> bool:
    return t0 + tile > full


def work(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, T: int,
         itemsize: int, kv_itemsize: int | None = None) -> tuple[int, int]:
    """(flops, bytes) one call needs at the least: both products over each query's
    live keys only (4 * D * H * sum over (b, s) of min(position + 1, kv_len)), q read
    and out written once, and the k/v rows (with their fp32 scales for int8 K/V) that
    any query of the row sees, min(largest position + 1, kv_len), read once."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    klen = kv_len.long().clamp(0, T)[:, None]
    live = torch.minimum(positions.long().clamp(-1, T - 1) + 1, klen)
    rows = int(live.amax(1).sum())
    nbytes = 2 * positions.numel() * H * D * itemsize + 2 * rows * Hkv * D * kv_itemsize
    if kv_itemsize == 1:
        nbytes += 2 * rows * Hkv * 4
    return 4 * D * H * int(live.sum()), nbytes


def work_bwd(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, T: int,
             itemsize: int) -> tuple[int, int]:
    """(flops, bytes) one backward call needs at the least: five products over each
    query's live keys (10 * D * H per live pair), q, o, dO read and dq written once
    with the fp32 lse, and the k/v rows any query of the row sees read once and their
    dk/dv written once."""
    klen = kv_len.long().clamp(0, T)[:, None]
    live = torch.minimum(positions.long().clamp(-1, T - 1) + 1, klen)
    rows = int(live.amax(1).sum())
    n = positions.numel() * H
    return 10 * D * H * int(live.sum()), 4 * n * D * itemsize + 4 * n + 4 * rows * Hkv * D * itemsize


def dkdv_splits(key_blocks: int, Hkv: int, B: int, n_qtiles: int, target: int) -> int:
    """How many blocks share each block of keys in the backward's dk/dv kernel: enough
    to reach `target` blocks (BWD_BLOCKS_PER_SM_MMA or BWD_BLOCKS_PER_SM a streaming
    multiprocessor, by variant), at most one per tile of query rows. Split s of n takes
    the tiles [s * per, (s + 1) * per), per = ceil(n_qtiles / n)."""
    return max(1, min(n_qtiles, -(-target // (key_blocks * Hkv * B))))


def _causal_mask(positions, kv_len, T):
    """(B, S, T): slot t is live for the query at positions[b, s]."""
    slot = torch.arange(T, device=positions.device)
    return (slot[None, None, :] <= positions[:, :, None]) & (slot[None, None, :] < kv_len.to(slot.dtype)[:, None, None])


def _causal_logits(q, k, positions, kv_len):
    """(B, Hkv, G, S, T) fp32 scaled logits with the dead slots at -inf."""
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    logits = torch.einsum("bskgd,bktd->bkgst", q.float().reshape(B, S, Hkv, H // Hkv, D), k.float()) * D**-0.5
    return logits.masked_fill(~_causal_mask(positions, kv_len, T)[:, None, None], float("-inf"))


def band_sink_attention_plain(q, k, v, positions, kv_len, window: int = 0, sink=None):
    """Plain torch version of the band and the sinks, in fp32, cast to q.dtype: the
    query at positions[b, s] sees kv slots t <= positions[b, s], t < kv_len[b] and, with
    window > 0, t > positions[b, s] - window; sink (H,) adds one column per head with
    that logit (scaled units) and value 0. q (B, S, H, D), k (B, Hkv, T, D), v (B, Hkv,
    T, DV) -> (B, S, H, DV); a row with no live slot gives 0."""
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    logits = torch.einsum("bskgd,bktd->bkgst", q.float().reshape(B, S, Hkv, G, D), k.float()) * D**-0.5
    live = _causal_mask(positions, kv_len, T)
    if window > 0:
        live = live & (torch.arange(T, device=q.device)[None, None, :] > positions[:, :, None] - window)
    logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    if sink is not None:
        col = sink.float().reshape(1, Hkv, G, 1, 1).expand(B, Hkv, G, S, 1)
        logits = torch.cat([logits, col], dim=-1)
    p = torch.softmax(logits, dim=-1)[..., :T] * live[:, None, None]
    out = torch.einsum("bkgst,bktd->bskgd", p, v.float())
    return out.reshape(B, S, H, v.shape[3]).to(q.dtype)


def flash_causal_attention_plain(q, k, v, positions, kv_len, ks=None, vs=None, return_lse: bool = False,
                                 window: int = 0, sink=None):
    """Plain torch version in fp32, cast to q.dtype. The query at positions[b, s]
    sees kv slots t <= positions[b, s] and t < kv_len[b]. With ks/vs (B, Hkv, T), k/v
    hold int8 values: ks scales the logit columns and vs scales p before p@v. With
    return_lse (bf16 or fp32 K/V) also each row's log-sum-exp of the scaled logits,
    (B, S, H) fp32, NEG_INF for a row with no live key (whose output here is the
    mean of v, where the kernel gives 0). With window > 0 or a sink: band_sink_attention_plain."""
    if window > 0 or sink is not None:
        return band_sink_attention_plain(q, k, v, positions, kv_len, window, sink)
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    slot = torch.arange(T, device=q.device)
    valid = slot[None, :] < kv_len.to(slot.dtype)[:, None]
    if ks is None:
        out = causal_attention(
            q.float(), k.float(), v.float(), positions=positions,
            kv_positions=slot[None].expand(B, T), valid=valid,
        ).to(q.dtype)
        if not return_lse:
            return out
        lse = torch.logsumexp(_causal_logits(q, k, positions, kv_len), dim=-1)  # (B, Hkv, G, S)
        lse = lse.masked_fill(torch.isneginf(lse), NEG_INF).permute(0, 3, 1, 2).reshape(B, S, H)
        return out, lse.contiguous()
    if return_lse:
        raise NotImplementedError("flash_causal_attention: no backward for int8 K/V")
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k.float())
    logits = logits * ks.float()[:, :, None, None, :] * D**-0.5
    mask = (slot[None, None, :] <= positions[:, :, None]) & valid[:, None, :]  # (B, S, T)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1) * vs.float()[:, :, None, None, :]
    out = torch.einsum("bkgst,bktd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_causal_attention_bwd_plain(q, k, v, positions, kv_len, out, dout, lse):
    """Plain torch version of the backward, in fp32 from the forward's out and lse:
    p = exp(z - lse) on live slots (0 elsewhere; a row with no live key has none, so
    it gets zero gradients whatever its out), delta = rowsum(dO * out),
    ds = p (dO v^T - delta); dq = scale ds k, dk = scale ds^T q and dv = p^T dO, both
    summed over the G query heads of each kv head. Returns (dq, dk, dv) in q's dtype,
    dq (B, S, H, D), dk and dv (B, Hkv, T, D), contiguous."""
    B, S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    dog = dout.float().reshape(B, S, Hkv, G, D)
    lse_g = lse.reshape(B, S, Hkv, G).permute(0, 2, 3, 1)  # (B, Hkv, G, S)
    p = torch.exp(_causal_logits(q, k, positions, kv_len) - lse_g[..., None])  # exp(-inf) = 0 on dead slots
    delta = (dog * out.float().reshape(B, S, Hkv, G, D)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bskgd,bktd->bkgst", dog, v.float()) - delta[..., None])
    dq = torch.einsum("bkgst,bktd->bskgd", ds, k.float()).reshape(B, S, H, D) * D**-0.5
    dk = torch.einsum("bkgst,bskgd->bktd", ds, qg) * D**-0.5
    dv = torch.einsum("bkgst,bskgd->bktd", p, dog)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def causal_attention_cuda(q, k, v, positions, kv_len, ks=None, vs=None, return_lse: bool = False,
                          window: int = 0, sink=None):
    """Launch K2. q (B, S, H, D) fp32/bf16; k/v (B, Hkv, T, D) of q's dtype or int8
    (then ks/vs are required); all with unit stride on D, other strides free, except
    that the tensor-core variant (bf16 q) needs bases and strides that are whole
    16-byte multiples and raises ValueError otherwise. With return_lse also returns
    the (B, S, H) fp32 log-sum-exp of each row's scaled logits (NEG_INF for a row with
    no live key). window > 0 or a sink (H,) fp32 takes the band form at key width 192 and
    value width 128 (`_causal_band_cuda`). Nothing here waits for the device."""
    name = "flash_causal_attention"
    _cuda.require_cuda(name, q, k, v, positions, kv_len, ks, vs)
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if window > 0 or sink is not None:
        return _causal_band_cuda(name, q, k, v, positions, kv_len, window, sink)
    if v.shape[3] != k.shape[3] and not return_lse and ks is None:
        return _causal_mla_cuda(name, q, k, v, positions, kv_len)
    if v.shape != k.shape or v.dtype != k.dtype or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: k/v must be (B, Hkv, T, D) of one dtype")
    if H % Hkv or ROWS_FMA % (H // Hkv):
        raise ValueError(f"{name}: H / Hkv must divide {ROWS_FMA} (H={H}, Hkv={Hkv})")
    qc = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    quant = k.dtype == torch.int8
    kc = _cuda.dtype_code(k, name, (q.dtype, torch.int8))
    rows = _cuda.lib().zt_flash_causal_variant(qc, kc, D)
    if rows < 0:
        raise ValueError(f"{name}: no kernel for head dim {D}")
    variant = "mma" if rows == ROWS else "fma"
    if variant == "mma":
        _cuda.require_aligned16(name, q, k, v)
    if quant:
        ks, vs = _cuda.scale_views(name, ks, vs)
    else:
        ks = vs = None
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device) if return_lse else None
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    rc = _cuda.lib().zt_flash_causal(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(ks), _cuda.ptr(vs),
        _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(out), B, S, H, Hkv, T, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        ks.stride(0) if quant else 0, ks.stride(1) if quant else 0,
        D**-0.5, qc, kc, _cuda.stream(q.device), _cuda.ptr(lse),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_cuda, variant, int8=quant)
    return (out, lse) if return_lse else out


def _causal_mla_cuda(name, q, k, v, positions, kv_len):
    """K2 at key width 192 and value width 128 (latent attention's expanded form): the
    tensor-core core with a DV-wide value tile and output, bf16, no lse. Counted as a
    K2 launch of the "mma" variant."""
    B, S, H, D = q.shape
    Hkv, T, DV = k.shape[1], k.shape[2], v.shape[3]
    if (D, DV) != MLA_WIDTHS or k.shape[3] != D or v.shape[:3] != k.shape[:3] or k.shape[0] != B:
        raise ValueError(f"{name}: a value width apart from the key width runs at {MLA_WIDTHS} only "
                         f"(q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or H % Hkv or ROWS % (H // Hkv):
        raise ValueError(f"{name}: key width {D} with value width {DV} takes bf16 q/k/v and H / Hkv dividing {ROWS}")
    _cuda.require_aligned16(name, q, k, v)
    out = torch.empty((B, S, H, DV), dtype=q.dtype, device=q.device)
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    rc = _cuda.lib().zt_flash_causal_mla(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(out),
        B, S, H, Hkv, T, D, DV, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), D**-0.5, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_cuda, "mma")
    return out


def _causal_band_cuda(name, q, k, v, positions, kv_len, window: int, sink):
    """K2 with a band and sinks at key width 192 and value width 128 (MiMo-V2.5's window
    layers): bf16 q/k/v, window > 0, sink a (H,) fp32 tensor or None, no lse. Counted as
    a K2 launch of the "mma" variant."""
    B, S, H, D = q.shape
    Hkv, T, DV = k.shape[1], k.shape[2], v.shape[3]
    if (D, DV) != MLA_WIDTHS or k.shape[3] != D or v.shape[:3] != k.shape[:3] or k.shape[0] != B or window <= 0:
        raise ValueError(f"{name}: the band runs at widths {MLA_WIDTHS} with window > 0 (q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, window {window})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or H % Hkv or ROWS % (H // Hkv):
        raise ValueError(f"{name}: the band takes bf16 q/k/v and H / Hkv dividing {ROWS}")
    if sink is not None:
        _cuda.require_cuda(name, q, sink)
        if sink.shape != (H,) or sink.dtype != torch.float32 or not sink.is_contiguous():
            raise ValueError(f"{name}: sink must be a contiguous ({H},) fp32 tensor (got {tuple(sink.shape)}, "
                             f"{sink.dtype})")
    _cuda.require_aligned16(name, q, k, v)
    out = torch.empty((B, S, H, DV), dtype=q.dtype, device=q.device)
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    rc = _cuda.lib().zt_flash_causal_band(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(sink),
        _cuda.ptr(out), B, S, H, Hkv, T, D, DV, int(window), q.stride(0), q.stride(1), q.stride(2), k.stride(0),
        k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2), D**-0.5, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_cuda, "mma")
    return out


causal_attention_cuda.launches = 0
causal_attention_cuda.variants = {"mma": 0, "fma": 0}
causal_attention_cuda.int8_launches = 0  # of them, on int8 K/V


def _require_trainable(name, q, k, v, ks=None, vs=None):
    """The backward's refusals, on the host before any launch."""
    if ks is not None or vs is not None or k.dtype == torch.int8:
        raise NotImplementedError(f"{name}: no backward for int8 K/V (the int8 cache is inference-only)")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the backward takes bf16 or fp32 q/k/v of one dtype (got {q.dtype}, {k.dtype})")


def causal_attention_bwd_cuda(q, k, v, positions, kv_len, out, dout, lse):
    """Launch K2's backward (the dq kernel, then the dk/dv kernel, split over the query
    tiles by dkdv_splits, then the kernel that adds the splits' partials, on the
    current stream): the tensor-core variant for bf16 (q/k/v bases and strides whole
    16-byte multiples, else ValueError), the FMA variant for fp32 (`zt_flash_bwd_variant`
    chooses). q/k/v as the forward took them (k/v any strides with unit stride on D); out
    and dout (B, S, H, D); lse (B, S, H) fp32 from the forward. Returns (dq, dk, dv): dq
    contiguous (B, S, H, D), dk and dv (B, Hkv, T, D) in k's and v's own layout where that
    is dense (the decoder's transposed views), contiguous otherwise. Nothing here waits
    for the device."""
    name = "flash_causal_attention_bwd"
    _cuda.require_cuda(name, q, k, v, positions, kv_len, out, dout, lse)
    _require_trainable(name, q, k, v)
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: q/out/dout must be (B, S, H, D) and k/v (B, Hkv, T, D)")
    if H % Hkv or BWD_TILE % (H // Hkv):
        raise ValueError(f"{name}: H / Hkv must divide {BWD_TILE} (H={H}, Hkv={Hkv})")
    if lse.shape != (B, S, H) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be (B, S, H) fp32")
    code = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    rows = _cuda.lib().zt_flash_bwd_variant(code, D)
    if rows < 0 or D not in (16, 32, 64, 128):
        raise ValueError(f"{name}: no kernel for head dim {D}")
    variant = "mma" if rows == BWD_ROWS else "fma"
    if variant == "mma":
        _cuda.require_aligned16(name, q, k, v)
    out, dout, lse = _cuda.aligned16(out), _cuda.aligned16(dout.to(q.dtype)), lse.contiguous()
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    qhi = block_key_bounds(positions, kv_len, T, BWD_TILE // (H // Hkv))[0].contiguous()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_sm = BWD_BLOCKS_PER_SM_MMA if variant == "mma" else BWD_BLOCKS_PER_SM
    nsplit = dkdv_splits(-(-T // rows), Hkv, B, qhi.shape[1], per_sm * sms)
    part = torch.empty((2, nsplit, B, Hkv, T, D), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().zt_flash_causal_bwd(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), _cuda.ptr(dout), _cuda.ptr(lse),
        _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(qhi), _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv),
        _cuda.ptr(delta), _cuda.ptr(part), B, S, H, Hkv, T, D, qhi.shape[1], nsplit,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), dk.stride(0), dk.stride(1), dk.stride(2),
        dv.stride(0), dv.stride(1), dv.stride(2), D**-0.5, code, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_bwd_cuda, variant)
    return dq, dk, dv


causal_attention_bwd_cuda.launches = 0
causal_attention_bwd_cuda.variants = {"mma": 0, "fma": 0}


class CausalAttention(torch.autograd.Function):
    """K2 with a gradient (bf16 or fp32 K/V): the forward keeps (q, k, v, positions,
    kv_len, out, lse) for the backward; both directions take the plain version on the
    CPU and the kernel on CUDA."""

    @staticmethod
    def forward(ctx, q, k, v, positions, kv_len):
        if q.device.type == "cpu":
            out, lse = flash_causal_attention_plain(q, k, v, positions, kv_len, return_lse=True)
        else:
            out, lse = causal_attention_cuda(q, k, v, positions, kv_len, return_lse=True)
        ctx.save_for_backward(q, k, v, positions, kv_len, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, positions, kv_len, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_causal_attention_bwd_plain(q, k, v, positions, kv_len, out, dout, lse)
        else:
            dq, dk, dv = causal_attention_bwd_cuda(q, k, v, positions, kv_len, out, dout, lse)
        return dq, dk, dv, None, None


def flash_causal_attention(q, k, v, positions, kv_len, ks=None, vs=None, window: int = 0, sink=None):
    """Causal GQA attention over a kv-head-major (B, Hkv, T, D) cache; exact.
    positions (B, S) query slots, kv_len (B,) live slots. Returns (B, S, H, DV).
    window > 0: each query sees only the `window` slots up to its position; sink (H,):
    a sink logit per head (both inference only). Under autograd with an input that
    requires grad it is differentiable (CausalAttention; bf16 or fp32 K/V only, int8
    raises)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if window > 0 or sink is not None:
            raise NotImplementedError("flash_causal_attention: no backward for the band or the sinks")
        _require_trainable("flash_causal_attention", q, k, v, ks, vs)
        return CausalAttention.apply(q, k, v, positions, kv_len)
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, positions, kv_len, ks, vs, window=window, sink=sink)
    if window > 0 or sink is not None:
        return causal_attention_cuda(q, k, v, positions, kv_len, window=window, sink=sink)
    return causal_attention_cuda(q, k, v, positions, kv_len, ks, vs)
