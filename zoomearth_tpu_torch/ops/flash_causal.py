"""K2: causal GQA attention for prefill and chunk prefill.

Replaces zoomearth_tpu/ops/flash_causal.py::flash_causal_attention (Pallas). The
kernel is hand-written CUDA C++ for Hopper (csrc/flash_causal.cu, whose header says
what bounds it and what its design does about it). It has two variants, chosen
inside the C entry point from the dtypes alone (`zt_flash_causal_variant`): "mma", the
tensor-core flash core (csrc/flash_mma.cuh: wgmma at D = 128, mma.sync at the smaller
head dims) with 128 (head, position) rows a block, for bf16 queries against bf16 or
int8 K/V (the model's path); and "fma", fp32 arithmetic with 64 rows a block, for
fp32 queries, which bf16 products would cost their precision. Here:

- `flash_causal_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises). There is no fallback and no size threshold.
- `flash_causal_attention_plain` is the plain torch version of the same function,
  including the int8 K/V algebra.
- `block_key_bounds` is what each block of the kernel works out for itself: where
  its key loop ends and below which key no compare is needed.
- `work` is the least work a call needs (flops, bytes), from its inputs.
- `causal_attention_cuda.launches` counts kernel launches, `.variants` by variant,
  `.int8_launches` those on int8 K/V.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, causal_attention

ROWS = 128  # (head, query) rows per block of the tensor-core variant (FM_ROWS in csrc/flash_mma.cuh)
ROWS_FMA = 64  # of the fp32 variant (CAU_ROWS in csrc/flash_causal.cu); G = H / Hkv must divide both
TILE = 64  # keys per tile of the tensor-core variant (FM_BKV)


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


def flash_causal_attention_plain(q, k, v, positions, kv_len, ks=None, vs=None):
    """Plain torch version in fp32, cast to q.dtype. The query at positions[b, s]
    sees kv slots t <= positions[b, s] and t < kv_len[b]. With ks/vs (B, Hkv, T), k/v
    hold int8 values: ks scales the logit columns and vs scales p before p@v."""
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    slot = torch.arange(T, device=q.device)
    valid = slot[None, :] < kv_len.to(slot.dtype)[:, None]
    if ks is None:
        out = causal_attention(
            q.float(), k.float(), v.float(), positions=positions,
            kv_positions=slot[None].expand(B, T), valid=valid,
        )
        return out.to(q.dtype)
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k.float())
    logits = logits * ks.float()[:, :, None, None, :] * D**-0.5
    mask = (slot[None, None, :] <= positions[:, :, None]) & valid[:, None, :]  # (B, S, T)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1) * vs.float()[:, :, None, None, :]
    out = torch.einsum("bkgst,bktd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def causal_attention_cuda(q, k, v, positions, kv_len, ks=None, vs=None):
    """Launch K2. q (B, S, H, D) fp32/bf16; k/v (B, Hkv, T, D) of q's dtype or int8
    (then ks/vs are required); all with unit stride on D, other strides free, except
    that the tensor-core variant (bf16 q) needs bases and strides that are whole
    16-byte multiples and raises ValueError otherwise. Nothing here waits for the
    device."""
    name = "flash_causal_attention"
    _cuda.require_cuda(name, q, k, v, positions, kv_len, ks, vs)
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
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
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    rc = _cuda.lib().zt_flash_causal(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(ks), _cuda.ptr(vs),
        _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(out), B, S, H, Hkv, T, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        ks.stride(0) if quant else 0, ks.stride(1) if quant else 0,
        D**-0.5, qc, kc, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_cuda, variant, int8=quant)
    return out


causal_attention_cuda.launches = 0
causal_attention_cuda.variants = {"mma": 0, "fma": 0}
causal_attention_cuda.int8_launches = 0  # of them, on int8 K/V


def flash_causal_attention(q, k, v, positions, kv_len, ks=None, vs=None):
    """Causal GQA attention over a kv-head-major (B, Hkv, T, D) cache; exact.
    positions (B, S) query slots, kv_len (B,) live slots. Returns (B, S, H, D)."""
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, positions, kv_len, ks, vs)
    return causal_attention_cuda(q, k, v, positions, kv_len, ks, vs)
