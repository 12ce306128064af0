"""K6: single-token GQA decode at key width 192 and value width 128 (MiMo-V2.5's layers).

Each row's G = H / Hkv query heads of a KV head read that head's key stream (192 wide)
and value stream (128 wide): G = 16 in the global layers, 8 in the window layers, which
also read only the last `window` slots of each row and take a sink logit per head as one
more softmax column of value 0. The kernel is hand-written CUDA C++ for Hopper
(csrc/flash_gqa_decode.cu, whose header says what bounds it and what its design does
about it) on K5's core, the split plan of K3's and the shared split merge
(split_merge.cu). It reads [:, :, :attend_len] prefix views of the cache in place, so the
Generator's attend buckets and captured steps hold.

- `flash_gqa_decode` dispatches by device: CPU -> plain version, CUDA -> kernel (or
  raises). There is no fallback.
- `flash_gqa_decode_plain` is the plain torch version, in fp32.
- `split_plan` is how the kernel splits each row's key span, from the shapes alone.
- `work` is the least (flops, bytes) of a call.
- `gqa_decode_cuda.launches` counts calls of the kernel, each of which runs two launches:
  the split pass and the merge.

A row with kv_len == 0 gives 0 (nothing is read; the merge writes 0).
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF

TILE = 32  # slots per staged tile (K6_TILE in csrc/flash_gqa_decode.cu): a split is a whole number of them
GROUPS = (8, 16)  # query heads a KV head, as instantiated
DK, DV = 192, 128  # the widths the kernel is instantiated at
# Blocks per call: four waves of the two blocks each of the H100's 132 SMs holds.
TARGET_BLOCKS = 4 * 2 * 132


def split_plan(pairs: int, span: int) -> tuple[int, int]:
    """(split length, split count) of K6's key span from the shapes alone (never from
    kv_len): about TARGET_BLOCKS blocks of (row, KV head, split), the length a multiple
    of TILE. span: T, or min(T, window) for a window layer."""
    want = -(-TARGET_BLOCKS // max(pairs, 1))
    per = -(-span // want)
    split = -(-per // TILE) * TILE
    return split, -(-span // split)


def walked(kv_len: torch.Tensor, T: int, window: int) -> torch.Tensor:
    """(B,) the slots each row attends to: min(kv_len, window) for window > 0, else
    kv_len, both clipped to [0, T]."""
    klen = kv_len.to(torch.int64).clamp(0, T)
    return klen.clamp(max=window) if window > 0 else klen


def work(kv_len: torch.Tensor, T: int, H: int, Hkv: int, Dk: int, Dv: int, window: int = 0,
         itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) one call needs at the least: both products over each row's walked
    slots (2 H (Dk + Dv) a slot), each walked slot's key and value rows of every KV head
    read once, q read and out written once."""
    live = int(walked(kv_len, T, window).sum())
    B = kv_len.shape[0]
    return 2 * H * (Dk + Dv) * live, (live * Hkv * (Dk + Dv) + B * H * (Dk + Dv)) * itemsize


def flash_gqa_decode_plain(q, k, v, kv_len, scale: float, window: int = 0, sink=None):
    """Plain torch version in fp32, cast to q.dtype. q (B, H, Dk); k (B, Hkv, T, Dk);
    v (B, Hkv, T, Dv); kv_len (B,); sink (H,) or None. Returns (B, H, Dv)."""
    B, H, Dk = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    logits = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(B, Hkv, G, Dk), k.float()) * scale
    slot = torch.arange(T, device=q.device)[None, :]
    klen = kv_len.to(torch.int64).clamp(0, T)[:, None]
    live = (slot < klen) & (slot >= klen - walked(kv_len, T, window)[:, None])
    logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    if sink is not None:
        logits = torch.cat([logits, sink.float().reshape(1, Hkv, G, 1).expand(B, Hkv, G, 1)], dim=-1)
    p = torch.softmax(logits, dim=-1)[..., :T] * live[:, None, None]
    return torch.einsum("bkgt,bktd->bkgd", p, v.float()).reshape(B, H, v.shape[3]).to(q.dtype)


def gqa_decode_cuda(q, k, v, kv_len, scale: float, window: int = 0, sink=None):
    """Launch K6: the split pass over (B * Hkv) x nsplit blocks (split_plan), then the
    split merge. q (B, H, 192) bf16 with unit stride on the last dim; k (B, Hkv, T, 192)
    and v (B, Hkv, T, 128) bf16, unit stride on the last dim, rows and strides whole
    16-byte multiples from a 16-byte aligned base (prefix views are read in place); H /
    Hkv 8 or 16; kv_len (B,) int; sink (H,) fp32 contiguous or None. Returns (B, H, 128)
    bf16. Nothing here waits for the device."""
    name = "flash_gqa_decode"
    _cuda.require_cuda(name, q, k, v, kv_len, sink)
    B, H, Dk = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if (Dk, k.shape[3], v.shape[3]) != (DK, DK, DV) or v.shape[:3] != k.shape[:3] or k.shape[0] != B or T < 1 \
            or H % Hkv or H // Hkv not in GROUPS:
        raise ValueError(f"{name}: needs q (B, H, {DK}), k (B, Hkv, T, {DK}), v (B, Hkv, T, {DV}) with H / Hkv in "
                         f"{GROUPS} (q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q, k and v must be bf16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if sink is not None and (sink.shape != (H,) or sink.dtype != torch.float32 or not sink.is_contiguous()):
        raise ValueError(f"{name}: sink must be a contiguous ({H},) fp32 tensor")
    _cuda.require_aligned16(name, q, k, v)
    split, nsplit = split_plan(B * Hkv, min(T, window) if window > 0 else T)
    G = H // Hkv
    part = torch.empty(B * Hkv * nsplit * G * (DV + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, DV), dtype=q.dtype, device=q.device)
    klen = kv_len.to(torch.int32).clamp(0, T).contiguous()
    walk = walked(klen, T, window).to(torch.int32) if window > 0 else klen
    rc = _cuda.lib().zt_flash_gqa_decode(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(klen), _cuda.ptr(walk), _cuda.ptr(sink),
        _cuda.ptr(part), _cuda.ptr(out), B, Hkv, T, G, split, nsplit, q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2), float(scale), int(window),
        _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(gqa_decode_cuda)
    return out


gqa_decode_cuda.launches = 0


def flash_gqa_decode(q, k, v, kv_len, scale: float, window: int = 0, sink=None):
    """GQA decode attention at key width 192 and value width 128: row b attends to its
    last min(kv_len, window) slots (all kv_len where window is 0), with a sink logit per
    head where given. q (B, H, Dk), k (B, Hkv, T, Dk), v (B, Hkv, T, Dv) -> (B, H, Dv)."""
    if q.device.type == "cpu":
        return flash_gqa_decode_plain(q, k, v, kv_len, scale, window, sink)
    return gqa_decode_cuda(q, k, v, kv_len, scale, window, sink)
