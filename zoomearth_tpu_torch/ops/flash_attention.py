"""K1: packed varlen (segment-id) self-attention — the ViT's full-attention blocks.

Replaces zoomearth_tpu/ops/flash_attention.py::flash_segment_attention (Pallas).
The kernel is hand-written CUDA C++ for Hopper (csrc/flash_segment.cu, whose header
says what bounds it and what its design does about it). It has two variants, chosen
inside the C entry point from the dtype and head dim alone (`zt_flash_segment_variant`):
"mma", the tensor-core flash core (csrc/flash_mma.cuh: wgmma at D = 80 and 128,
mma.sync at the other head dims) with 128 rows a block, for bf16 with D a multiple
of 16 (the model's path); and "fma", fp32 arithmetic with 64 rows a block, for fp32
inputs and D = 8, which bf16 products would cost their precision. Here:

- `flash_segment_attention` dispatches by device: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel (or raises). There is no fallback.
- `flash_segment_attention_plain` is the plain torch version of the same function.
- `segment_kv_ranges` is the launch prep: the contiguous kv row range of each
  query block, from two searchsorteds over the ascending segment ids;
  `tile_needs_mask` is the kernel's rule for skipping the segment compare.
- `work` is the least work a call needs (flops, bytes), from its inputs.
- `segment_attention_cuda.launches` counts kernel launches, `.variants` by variant.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import segment_attention

# Segment id used for padding rows. Must sort AFTER all real ids (ascending layout).
PAD_SEG = 2**30
BLOCK_Q = 128  # query rows per block of the tensor-core variant (FM_ROWS in csrc/flash_mma.cuh)
BLOCK_Q_FMA = 64  # of the fp32 variant (SEG_ROWS in csrc/flash_segment.cu)
TILE = 64  # keys per tile of the tensor-core variant (FM_BKV)


def segment_kv_ranges(seg: torch.Tensor, block_q: int = BLOCK_Q):
    """(first, last) int32 kv rows per query block: rows [first, last) hold every
    segment present in the block. Requires ascending segment ids."""
    S = seg.shape[0]
    n_q = -(-S // block_q)
    starts = torch.arange(n_q, device=seg.device) * block_q
    ends = torch.clamp(starts + block_q, max=S) - 1
    first = torch.searchsorted(seg, seg[starts], right=False)
    last = torch.searchsorted(seg, seg[ends], right=True)
    return first.to(torch.int32), last.to(torch.int32)


def tile_needs_mask(seg: torch.Tensor, s0: int, t0: int, hi: int, block_q: int = BLOCK_Q, tile: int = TILE) -> bool:
    """Whether the block of query rows [s0, s0 + block_q) must compare segment ids on
    the key tile [t0, t0 + tile) of its range ending at hi, as the tensor-core variant
    decides it: not when the block's rows share one id and the whole tile lies below
    hi with that id at both ends (ids ascend, so at every key between)."""
    S = seg.shape[0]
    first, last = int(seg[s0]), int(seg[min(s0 + block_q, S) - 1])
    if first != last or t0 + tile > hi:
        return True
    return not (int(seg[t0]) == first and int(seg[t0 + tile - 1]) == first)


def work(seg: torch.Tensor, H: int, D: int, itemsize: int) -> tuple[int, int]:
    """(flops, bytes) one call needs at the least: both products over each row's own
    segment only (4 * D * H * sum of squared segment lengths; the pad rows are one
    segment), and q, k, v read and out written once."""
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    return 4 * D * H * int((counts.long() ** 2).sum()), 4 * seg.shape[0] * H * D * itemsize


def flash_segment_attention_plain(q, k, v, seg):
    """Plain torch version: dense segment-masked attention in fp32, cast to q.dtype."""
    return segment_attention(q.float(), k.float(), v.float(), seg).to(q.dtype)


def segment_attention_cuda(q, k, v, seg):
    """Launch K1. q/k/v (S, H, D) fp32 or bf16 with unit stride on D (any other
    strides; the tensor-core variant needs bases and strides that are whole 16-byte
    multiples and raises ValueError otherwise); seg (S,) ascending ids. Returns a
    contiguous (S, H, D) tensor. Nothing here waits for the device."""
    name = "flash_segment_attention"
    _cuda.require_cuda(name, q, k, v, seg)
    S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share shape and dtype")
    code = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    block_q = _cuda.lib().zt_flash_segment_variant(code, D)
    if block_q < 0:
        raise ValueError(f"{name}: no kernel for head dim {D}")
    variant = "mma" if block_q == BLOCK_Q else "fma"
    if variant == "mma":
        _cuda.require_aligned16(name, q, k, v)
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    seg = seg.to(torch.int32).contiguous()
    first, last = segment_kv_ranges(seg, block_q)
    rc = _cuda.lib().zt_flash_segment(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(seg), _cuda.ptr(first),
        _cuda.ptr(last), _cuda.ptr(out), S, H, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        D**-0.5, code, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(segment_attention_cuda, variant)
    return out


segment_attention_cuda.launches = 0
segment_attention_cuda.variants = {"mma": 0, "fma": 0}


def flash_segment_attention(q, k, v, seg):
    """Packed varlen self-attention, exact: tokens attend within their segment.
    q/k/v (S, H, D); seg (S,) ascending segment ids (pads use PAD_SEG)."""
    if q.device.type == "cpu":
        return flash_segment_attention_plain(q, k, v, seg)
    return segment_attention_cuda(q, k, v, seg)
