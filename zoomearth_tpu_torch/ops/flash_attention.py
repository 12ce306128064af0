"""K1: packed varlen (segment-id) self-attention — the ViT's full-attention blocks.

Replaces zoomearth_tpu/ops/flash_attention.py::flash_segment_attention (Pallas).
The kernel is hand-written CUDA C++ for Hopper (csrc/flash_segment.cu, whose header
says what bounds it and what its design does about it). Here:

- `flash_segment_attention` dispatches by device: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel (or raises). There is no fallback.
- `flash_segment_attention_plain` is the plain torch version of the same function.
- `segment_kv_ranges` is the launch prep: the contiguous kv row range of each
  64-row query block, from two searchsorteds over the ascending segment ids.
- `segment_attention_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import segment_attention

# Segment id used for padding rows. Must sort AFTER all real ids (ascending layout).
PAD_SEG = 2**30
BLOCK_Q = 64  # query rows per kernel block (SEG_ROWS in csrc/flash_segment.cu)


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


def flash_segment_attention_plain(q, k, v, seg):
    """Plain torch version: dense segment-masked attention in fp32, cast to q.dtype."""
    return segment_attention(q.float(), k.float(), v.float(), seg).to(q.dtype)


def segment_attention_cuda(q, k, v, seg):
    """Launch K1. q/k/v (S, H, D) fp32 or bf16 with unit stride on D (any other
    strides); seg (S,) ascending ids. Returns a contiguous (S, H, D) tensor."""
    name = "flash_segment_attention"
    _cuda.require_cuda(name, q, k, v, seg)
    S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share shape and dtype")
    code = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    seg = seg.to(torch.int32).contiguous()
    first, last = segment_kv_ranges(seg)
    rc = _cuda.lib().zt_flash_segment(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(seg), _cuda.ptr(first),
        _cuda.ptr(last), _cuda.ptr(out), S, H, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        D**-0.5, code, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(segment_attention_cuda)
    return out


segment_attention_cuda.launches = 0


def flash_segment_attention(q, k, v, seg):
    """Packed varlen self-attention, exact: tokens attend within their segment.
    q/k/v (S, H, D); seg (S,) ascending segment ids (pads use PAD_SEG)."""
    if q.device.type == "cpu":
        return flash_segment_attention_plain(q, k, v, seg)
    return segment_attention_cuda(q, k, v, seg)
