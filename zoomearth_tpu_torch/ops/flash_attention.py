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
  version, a CUDA tensor to the kernel (or raises). There is no fallback. Where a
  gradient is asked for (autograd on, an input that requires grad) it goes through
  `SegmentAttention`, an autograd.Function whose forward and backward dispatch the
  same way: the forward also returns each row's log-sum-exp `lse`, the backward
  kernels (csrc/flash_segment_bwd.cu: dq, then dk and dv; the reference's Pallas
  kernel has no VJP to port) read it. They have two variants, chosen in C from the
  dtype and head dim (`zt_flash_bwd_variant`, mirrored by `bwd_variant_rows`): "mma",
  the tensor-core backward of csrc/flash_bwd.cuh (128 rows and keys a block), for bf16
  at D a multiple of 16 (the model's path), and "fma", fp32 arithmetic, for fp32
  inputs and D = 8. A backward on CUDA tensors launches that kernel or raises; it never
  recomputes through the plain version or falls back to the other variant.
- `flash_segment_attention_plain` / `flash_segment_attention_bwd_plain` are the
  plain torch versions of both directions, in fp32.
- `segment_kv_ranges` is the launch prep: the contiguous kv row range of each
  query block, from two searchsorteds over the ascending segment ids; by the mask's
  symmetry it is also the query range of a block of keys, which the backward's dk/dv
  kernel walks. `tile_needs_mask` is the kernel's rule for skipping the compare.
- `work` / `work_bwd` are the least work a call needs (flops, bytes), from its inputs.
- `segment_attention_cuda.launches` counts kernel launches, `.variants` by variant;
  `segment_attention_bwd_cuda.launches` counts backward calls (each launches the dq
  kernel, then the dk/dv kernel), `.variants` by variant.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, segment_attention

# Segment id used for padding rows. Must sort AFTER all real ids (ascending layout).
PAD_SEG = 2**30
BLOCK_Q = 128  # query rows per block of the tensor-core variant (FM_ROWS in csrc/flash_mma.cuh)
BLOCK_Q_FMA = 64  # of the fp32 variant (SEG_ROWS in csrc/flash_segment.cu)
TILE = 64  # keys per tile of the tensor-core variant (FM_BKV)
# The backward (csrc/flash_bwd.cuh): rows (dq) and keys (dk/dv) per block of its
# tensor-core variant (BM_ROWS), query rows per tile of its dk/dv kernels (BWD_TILE,
# both variants), and the FMA variant's threads per block (BWD_THREADS)
BWD_ROWS = 128
BWD_TILE = 32
BWD_THREADS = 256


def bwd_variant_rows(dtype: torch.dtype, D: int) -> int:
    """The backward's variant rule as the C query zt_flash_bwd_variant states it: rows
    per block of the variant a dtype and head dim get, BWD_ROWS for the tensor-core
    ("mma") kernels (bf16, D a multiple of 16 up to 128), the FMA kernels' rows (fp32,
    and bf16 at D = 8: BWD_THREADS over 8 threads a row from D = 64 on, 4 below), or -1."""
    if dtype not in (torch.float32, torch.bfloat16) or D not in (8, 16, 32, 64, 80, 128):
        return -1
    if dtype == torch.bfloat16 and D % 16 == 0:
        return BWD_ROWS
    return BWD_THREADS // (8 if D >= 64 else 4)


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


def work_bwd(seg: torch.Tensor, H: int, D: int, itemsize: int) -> tuple[int, int]:
    """(flops, bytes) one backward call needs at the least: five products over each
    row's own segment (s = q k^T, dp = dO v^T, dv = p^T dO, dq = ds k, dk = ds^T q:
    10 * D * H per live pair), q, k, v, o and dO read and dq, dk, dv written once, the
    fp32 lse read once."""
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    S = seg.shape[0]
    return 10 * D * H * int((counts.long() ** 2).sum()), 8 * S * H * D * itemsize + 4 * S * H


def _segment_logits(q, k, seg):
    """(H, S, T) fp32 scaled logits with the keys of other segments at -inf."""
    logits = torch.einsum("shd,thd->hst", q.float(), k.float()) * q.shape[-1] ** -0.5
    return logits.masked_fill((seg[:, None] != seg[None, :])[None], float("-inf"))


def _lse_rows(logits):
    """Each row's log-sum-exp over its live keys; NEG_INF where it has none. The
    backward masks dead pairs itself, so this value only marks the row."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse.masked_fill(torch.isneginf(lse), NEG_INF)


def flash_segment_attention_plain(q, k, v, seg, return_lse: bool = False):
    """Plain torch version: dense segment-masked attention in fp32, cast to q.dtype.
    With return_lse also each row's log-sum-exp of the scaled logits, (S, H) fp32."""
    out = segment_attention(q.float(), k.float(), v.float(), seg).to(q.dtype)
    if not return_lse:
        return out
    return out, _lse_rows(_segment_logits(q, k, seg)).t().contiguous()


def flash_segment_attention_bwd_plain(q, k, v, seg, out, dout, lse):
    """Plain torch version of the backward, in fp32 from the forward's out and lse:
    p = exp(z - lse) on each row's own segment (0 elsewhere), delta = rowsum(dO * out),
    ds = p (dO v^T - delta); dq = scale ds k, dk = scale ds^T q, dv = p^T dO. Returns
    (dq, dk, dv) in q's dtype, contiguous (S, H, D)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(_segment_logits(q, k, seg) - lse.t()[:, :, None])  # (H, S, T); exp(-inf) = 0 off-segment
    delta = (dof * out.float()).sum(-1).t()  # (H, S)
    ds = p * (torch.einsum("shd,thd->hst", dof, vf) - delta[:, :, None])
    dq = torch.einsum("hst,thd->shd", ds, kf) * scale
    dk = torch.einsum("hst,shd->thd", ds, qf) * scale
    dv = torch.einsum("hst,shd->thd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def segment_attention_cuda(q, k, v, seg, return_lse: bool = False):
    """Launch K1. q/k/v (S, H, D) fp32 or bf16 with unit stride on D (any other
    strides; the tensor-core variant needs bases and strides that are whole 16-byte
    multiples and raises ValueError otherwise); seg (S,) ascending ids. Returns a
    contiguous (S, H, D) tensor, and with return_lse also the (S, H) fp32 log-sum-exp
    of each row's scaled logits (NEG_INF for a row with no live key). Nothing here
    waits for the device."""
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
    lse = torch.empty((S, H), dtype=torch.float32, device=q.device) if return_lse else None
    seg = seg.to(torch.int32).contiguous()
    first, last = segment_kv_ranges(seg, block_q)
    rc = _cuda.lib().zt_flash_segment(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(seg), _cuda.ptr(first),
        _cuda.ptr(last), _cuda.ptr(out), S, H, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        D**-0.5, code, _cuda.stream(q.device), _cuda.ptr(lse),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(segment_attention_cuda, variant)
    return (out, lse) if return_lse else out


segment_attention_cuda.launches = 0
segment_attention_cuda.variants = {"mma": 0, "fma": 0}


def segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse):
    """Launch K1's backward (the dq kernel, then the dk/dv kernel, on the current
    stream): the tensor-core variant for bf16 at D a multiple of 16 (q/k/v bases and
    strides whole 16-byte multiples, else ValueError), the FMA variant for fp32 and
    D = 8 (`zt_flash_bwd_variant` chooses). q/k/v as the forward took them (any strides
    with unit stride on D), out and dout (S, H, D) of q's dtype, lse (S, H) fp32 from the
    forward. Returns (dq, dk, dv), contiguous (S, H, D) of q's dtype. Nothing here waits
    for the device."""
    name = "flash_segment_attention_bwd"
    _cuda.require_cuda(name, q, k, v, seg, out, dout, lse)
    S, H, D = q.shape
    if any(t.shape != q.shape or t.dtype != q.dtype for t in (k, v, out, dout)):
        raise ValueError(f"{name}: q/k/v/out/dout must share shape and dtype")
    if lse.shape != (S, H) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be (S, H) fp32")
    code = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    rows = _cuda.lib().zt_flash_bwd_variant(code, D)
    if rows < 0:
        raise ValueError(f"{name}: no kernel for head dim {D}")
    variant = "mma" if rows == BWD_ROWS else "fma"
    if variant == "mma":
        _cuda.require_aligned16(name, q, k, v)
    out, dout, lse = _cuda.aligned16(out), _cuda.aligned16(dout), lse.contiguous()
    seg = seg.to(torch.int32).contiguous()
    first, last = segment_kv_ranges(seg, rows)
    dq, dk, dv = (torch.empty((S, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((S, H), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().zt_flash_segment_bwd(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), _cuda.ptr(dout), _cuda.ptr(lse),
        _cuda.ptr(seg), _cuda.ptr(first), _cuda.ptr(last), _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv),
        _cuda.ptr(delta), S, H, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        D**-0.5, code, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(segment_attention_bwd_cuda, variant)
    return dq, dk, dv


segment_attention_bwd_cuda.launches = 0
segment_attention_bwd_cuda.variants = {"mma": 0, "fma": 0}


class SegmentAttention(torch.autograd.Function):
    """K1 with a gradient: the forward keeps (q, k, v, seg, out, lse) for the backward;
    both directions take the plain version on the CPU and the kernel on CUDA."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        if q.device.type == "cpu":
            out, lse = flash_segment_attention_plain(q, k, v, seg, return_lse=True)
        else:
            out, lse = segment_attention_cuda(q, k, v, seg, return_lse=True)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_segment_attention_bwd_plain(q, k, v, seg, out, dout, lse)
        else:
            dq, dk, dv = segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse)
        return dq, dk, dv, None


def flash_segment_attention(q, k, v, seg):
    """Packed varlen self-attention, exact: tokens attend within their segment.
    q/k/v (S, H, D); seg (S,) ascending segment ids (pads use PAD_SEG). Under autograd
    with an input that requires grad it is differentiable (SegmentAttention)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SegmentAttention.apply(q, k, v, seg)
    if q.device.type == "cpu":
        return flash_segment_attention_plain(q, k, v, seg)
    return segment_attention_cuda(q, k, v, seg)
