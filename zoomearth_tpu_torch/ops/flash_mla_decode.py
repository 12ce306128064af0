"""K5: single-token latent-attention (MLA) decode over the latent cache, absorbed form.

Each row's H query heads read one latent head: q (B, H, Dk) with Dk = r + dr (the
absorbed q^ of width r and the turned q_r), the cache (B, 1, T, Dk) of [c | k_r], and
o_h = sum_t softmax_t(scale q_h . kv_t) kv_t[:Dv] with Dv = r: the value is the
latent c itself. The scale is passed in (1/sqrt(dn + dr) for Kimi-VL), never derived
from Dk. The kernel is hand-written CUDA C++ for Hopper (csrc/flash_mla_decode.cu,
whose header says what bounds it and what its design does about it) on the split plan
of K3's (decode_split.cuh: the key axis split across blocks) and the shared split
merge (split_merge.cu). It reads a [:, :, :attend_len] prefix view of the cache in
place, so the Generator's attend buckets and captured steps hold.

- `flash_mla_decode` dispatches by device: CPU -> plain version, CUDA -> kernel (or
  raises). There is no fallback.
- `flash_mla_decode_plain` is the plain torch version, in fp32.
- `split_plan` is how the kernel splits the key axis, from the shapes alone.
- `work` is the least (flops, bytes) of a call.
- `mla_decode_cuda.launches` counts calls of the kernel, each of which runs two
  launches: the split pass and the merge.

A row with kv_len == 0 gives 0 (nothing is read; the merge writes 0).
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF

TILE = 32  # slots per staged tile (K5_TILE in csrc/flash_mla_decode.cu): a split is a whole number of them
HEADS = 16  # query heads a block serves (K5_HEADS: one m16 tile of the tensor-core products)
DK, DV = 576, 512  # the widths the kernel is instantiated at
# Blocks per call: four waves of the two blocks each of the H100's 132 SMs holds.
TARGET_BLOCKS = 4 * 2 * 132


def split_plan(B: int, T: int) -> tuple[int, int]:
    """(split length, split count) of K5's key axis from the shapes alone (never from
    kv_len): about TARGET_BLOCKS blocks of (row, split), the length a multiple of TILE."""
    want = -(-TARGET_BLOCKS // max(B, 1))
    per = -(-T // want)
    split = -(-per // TILE) * TILE
    return split, -(-T // split)


def work(kv_len: torch.Tensor, T: int, H: int, Dk: int, Dv: int, itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) one call needs at the least: both products over each row's live
    slots (2 H (Dk + Dv) a slot), the live latent rows read once, q read and out
    written once."""
    live = int(kv_len.to(torch.int64).clamp(0, T).sum())
    B = kv_len.shape[0]
    return 2 * H * (Dk + Dv) * live, live * Dk * itemsize + B * H * (Dk + Dv) * itemsize


def flash_mla_decode_plain(q, cache, kv_len, scale: float, dv: int = DV):
    """Plain torch version in fp32, cast to q.dtype. q (B, H, Dk); cache (B, 1, T, Dk);
    kv_len (B,). Returns (B, H, dv)."""
    T = cache.shape[2]
    kvf = cache[:, 0].float()
    logits = torch.einsum("bhd,btd->bht", q.float(), kvf) * scale
    valid = torch.arange(T, device=q.device)[None, :] < kv_len.to(torch.int64)[:, None]
    logits = logits.masked_fill(~valid[:, None], NEG_INF)
    p = torch.softmax(logits, dim=-1) * valid[:, None]
    return torch.einsum("bht,btd->bhd", p, kvf[..., :dv]).to(q.dtype)


def mla_decode_cuda(q, cache, kv_len, scale: float):
    """Launch K5: the split pass over B x nsplit blocks (split_plan), then the split
    merge. q (B, 16, 576) bf16 with unit stride on the last dim; cache (B, 1, T, 576)
    bf16, unit stride on the last dim, rows and strides whole 16-byte multiples from a
    16-byte aligned base (a [:, :, :attend_len] prefix view is read in place); kv_len
    (B,) int. Returns (B, 16, 512) bf16. Nothing here waits for the device."""
    name = "flash_mla_decode"
    _cuda.require_cuda(name, q, cache, kv_len)
    B, H, Dk = q.shape
    T = cache.shape[2]
    if H != HEADS or Dk != DK or cache.shape[1] != 1 or cache.shape[3] != DK or T < 1:
        raise ValueError(f"{name}: needs q (B, {HEADS}, {DK}) and a (B, 1, T, {DK}) cache "
                         f"(q {tuple(q.shape)}, cache {tuple(cache.shape)})")
    if q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q and the cache must be bf16 (got {q.dtype}, {cache.dtype})")
    _cuda.require_aligned16(name, q, cache)
    split, nsplit = split_plan(B, T)
    part = torch.empty(B * nsplit * H * (DV + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, DV), dtype=q.dtype, device=q.device)
    kv_len = kv_len.to(torch.int32).clamp(0, T).contiguous()
    rc = _cuda.lib().zt_flash_mla_decode(
        _cuda.ptr(q), _cuda.ptr(cache), _cuda.ptr(kv_len), _cuda.ptr(part), _cuda.ptr(out), B, T, split, nsplit,
        q.stride(0), q.stride(1), cache.stride(0), cache.stride(2), float(scale), _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(mla_decode_cuda)
    return out


mla_decode_cuda.launches = 0


def flash_mla_decode(q, cache, kv_len, scale: float, dv: int = DV):
    """MLA decode attention in the absorbed form: rows attend to their first kv_len
    latent slots. q (B, H, Dk), cache (B, 1, T, Dk) -> (B, H, dv) in q.dtype, dv the
    latent width r (the kernel's: 512)."""
    if q.device.type == "cpu":
        return flash_mla_decode_plain(q, cache, kv_len, scale, dv)
    if dv != DV:
        raise ValueError(f"flash_mla_decode: the kernel's value width is {DV} (got {dv})")
    return mla_decode_cuda(q, cache, kv_len, scale)
