"""K4: single-token GQA decode attention over a paged KV pool.

Replaces zoomearth_tpu/ops/paged_attention.py (Pallas). KV lives in pools of
fixed-size pages `(P, Hkv, page, D)`; each row owns a block table of page ids, and
slot t of row b lives at `pool[block_table[b, t // page], :, t % page]`. The kernel
is hand-written CUDA C++ for Hopper (csrc/paged_decode.cu, whose header says what
bounds it and what its design does about it).

- `paged_decode_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises).
- `paged_decode_attention_plain` is the plain torch version of the kernel.
- `paged_decode_attention_reference` is the gather oracle, as in the reference.
- `page_counts` is the launch prep: the pages each row walks, ceil(len / page).
- `append_to_pages` writes one decode step's k/v into the pools (plain torch: the
  reference's is an XLA scatter, not a Pallas kernel).
- `paged_decode_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import decode_attention

MAX_G = 8  # query heads per kv head (DEC_MAXG in csrc/common.cuh)


def page_counts(lengths: torch.Tensor, page_size: int) -> torch.Tensor:
    """Pages each row's decode walks: ceil(lengths / page_size) (int32)."""
    return torch.div(lengths.to(torch.int32) + page_size - 1, page_size, rounding_mode="floor")


def _live_lengths(lengths: torch.Tensor, block_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """lengths clipped to [0, capacity]: a row never reads past its block table."""
    return lengths.to(torch.int32).clamp(0, block_table.shape[1] * page_size)


def read_bytes(lengths: torch.Tensor, block_table: torch.Tensor, page_size: int, Hkv: int, D: int,
               itemsize: int) -> int:
    """Pool bytes one K4 call reads: k and v rows of the live slots only."""
    return int(_live_lengths(lengths, block_table, page_size).sum()) * Hkv * D * itemsize * 2


def work(lengths: torch.Tensor, block_table: torch.Tensor, page_size: int, H: int, Hkv: int, D: int,
         itemsize: int) -> tuple[int, int]:
    """(flops, bytes) one K4 call needs at the least: both products over each row's
    live slots, the live k/v rows (read_bytes) and their pages' block-table entries
    read once, q read and out written once."""
    live = _live_lengths(lengths, block_table, page_size)
    pages = int(torch.div(live + page_size - 1, page_size, rounding_mode="floor").sum())
    nbytes = read_bytes(lengths, block_table, page_size, Hkv, D, itemsize) + 4 * pages \
        + 2 * lengths.shape[0] * H * D * itemsize
    return 4 * D * H * int(live.sum()), nbytes


def _gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, page, D) pages named by (B, max_pages) -> contiguous (B, Hkv, max_pages * page, D)."""
    B, max_pages = block_table.shape
    _, Hkv, page, D = pool.shape
    g = pool[block_table.long()]  # (B, max_pages, Hkv, page, D)
    return g.transpose(1, 2).reshape(B, Hkv, max_pages * page, D)


def paged_decode_attention_reference(q, kpool, vpool, block_table, lengths, *, page_size=256):
    """The reference's oracle: gather every table entry's page into a contiguous cache,
    then the masked GQA softmax (ops/attention.decode_attention). Like JAX's gather,
    it clamps page ids into [0, P); a row with lengths == 0 gives the mean of v over
    its gathered slots (every logit masked), not the kernel's 0."""
    ids = block_table.clamp(0, kpool.shape[0] - 1)
    k, v = _gather(kpool, ids), _gather(vpool, ids)
    return decode_attention(q[:, None], k, v, kv_len=lengths)[:, 0]


def paged_decode_attention_plain(q, kpool, vpool, block_table, lengths, *, page_size=256):
    """Plain torch version of K4 in fp32, cast to q.dtype: the gather oracle over the
    pages each row walks, with two differences that follow the Pallas kernel. Table
    entries at or past a row's page count are never read (they may hold any value),
    and a row with lengths <= 0 gives 0, where the oracle gives the mean of v."""
    lens = _live_lengths(lengths, block_table, page_size)
    live = torch.arange(block_table.shape[1], device=q.device)[None] < page_counts(lens, page_size)[:, None]
    ids = torch.where(live, block_table.to(torch.int32), 0)
    k, v = _gather(kpool, ids).float(), _gather(vpool, ids).float()
    out = decode_attention(q[:, None].float(), k, v, kv_len=lens)[:, 0]
    out = torch.where((lens > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_decode_cuda(q, kpool, vpool, block_table, lengths, *, page_size=256):
    """Launch K4. q (B, H, D); pools (P, Hkv, page_size, D) of q's dtype (fp32 or
    bf16) with unit stride on D; block_table (B, max_pages) int32 whose first
    ceil(lengths[b] / page_size) entries of row b are page ids in [0, P)."""
    name = "paged_decode_attention"
    _cuda.require_cuda(name, q, kpool, vpool, block_table, lengths)
    B, H, D = q.shape
    P, Hkv, page, _ = kpool.shape
    if page != page_size or vpool.shape != kpool.shape:
        raise ValueError(f"{name}: pools must both be (P, Hkv, {page_size}, D), got {tuple(kpool.shape)}, "
                         f"{tuple(vpool.shape)}")
    if vpool.stride() != kpool.stride():
        raise ValueError(f"{name}: k/v pools must share strides")
    if H % Hkv or H // Hkv > MAX_G or D > 128:
        raise ValueError(f"{name}: needs H / Hkv <= {MAX_G} and D <= 128 (H={H}, Hkv={Hkv}, D={D})")
    code = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    if kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"{name}: pools must have q's dtype {q.dtype}")
    q = q.contiguous()
    bt = block_table.to(torch.int32).contiguous()
    lens = _live_lengths(lengths, bt, page_size).contiguous()
    npages = page_counts(lens, page_size).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    rc = _cuda.lib().zt_paged_decode(
        _cuda.ptr(q), _cuda.ptr(kpool), _cuda.ptr(vpool), _cuda.ptr(bt), _cuda.ptr(npages),
        _cuda.ptr(lens), _cuda.ptr(out), B, H, Hkv, page_size, D, bt.stride(0),
        kpool.stride(0), kpool.stride(1), kpool.stride(2), D**-0.5, code, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(paged_decode_cuda)
    return out


paged_decode_cuda.launches = 0


def paged_decode_attention(q, kpool, vpool, block_table, lengths, *, page_size=256):
    """GQA decode attention over paged KV: q (B, H, D) -> (B, H, D) in q.dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kpool, vpool, block_table, lengths, page_size=page_size)
    return paged_decode_cuda(q, kpool, vpool, block_table, lengths, page_size=page_size)


def append_to_pages(kpool, vpool, k_new, v_new, block_table, lengths, *, page_size=256):
    """Write one decode step's k/v (B, Hkv, D) at each row's position lengths[b]:
    page block_table[b, lengths[b] // page_size], slot lengths[b] % page_size.

    The pools are updated IN PLACE and returned (the reference returns new arrays).
    A row at capacity (lengths[b] >= max_pages * page_size) drops its write, as the
    reference's drop-mode scatter does. Its table is never indexed at max_pages and
    no page id P is ever written: on CUDA either would be a device-side assert, so
    the rows are filtered before indexing (one host sync per call)."""
    max_pages = block_table.shape[1]
    pos = lengths.long()
    keep = (pos >= 0) & (pos < max_pages * page_size)
    rows = keep.nonzero().squeeze(1)
    pos = pos[rows]
    pages = block_table[rows, pos // page_size].long()
    slots = pos % page_size
    kpool[pages, :, slots] = k_new[rows].to(kpool.dtype)
    vpool[pages, :, slots] = v_new[rows].to(vpool.dtype)
    return kpool, vpool
