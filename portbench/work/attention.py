"""Frozen copies of the attention kernels' `work()` (zoomearth_tpu_torch/ops/
flash_attention.py, flash_causal.py, flash_decode.py as of the benchmark's first
version): the operations and bytes one call needs at the least. A later change to
the program cannot move the yardstick its rooflines are read against.

Each returns (flops, bytes); a bound is max(flops / peak FLOP/s, bytes / peak B/s).
"""

from __future__ import annotations

import torch


def segment_work(seg: torch.Tensor, H: int, D: int, itemsize: int) -> tuple[int, int]:
    """K1 (packed varlen self-attention): both products over each row's own segment
    only (4 D H sum of squared segment lengths; pad rows are one segment), q, k, v
    read and out written once."""
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    return 4 * D * H * int((counts.long() ** 2).sum()), 4 * seg.shape[0] * H * D * itemsize


def segment_work_bwd(seg: torch.Tensor, H: int, D: int, itemsize: int) -> tuple[int, int]:
    """K1's backward: five products over each row's own segment (10 D H a live pair),
    q, k, v, o, dO read and dq, dk, dv written once, the fp32 lse read once."""
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    S = seg.shape[0]
    return 10 * D * H * int((counts.long() ** 2).sum()), 8 * S * H * D * itemsize + 4 * S * H


def causal_work(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, T: int,
                itemsize: int, kv_itemsize: int | None = None) -> tuple[int, int]:
    """K2 (causal prefill over a cache): both products over each query's live keys
    (4 D H sum over (b, s) of min(position + 1, kv_len)), q read and out written once,
    and the k/v rows any query of the row sees read once (with fp32 scales for int8)."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    klen = kv_len.long().clamp(0, T)[:, None]
    live = torch.minimum(positions.long().clamp(-1, T - 1) + 1, klen)
    rows = int(live.amax(1).sum())
    nbytes = 2 * positions.numel() * H * D * itemsize + 2 * rows * Hkv * D * kv_itemsize
    if kv_itemsize == 1:
        nbytes += 2 * rows * Hkv * 4
    return 4 * D * H * int(live.sum()), nbytes


def causal_work_bwd(positions: torch.Tensor, kv_len: torch.Tensor, H: int, Hkv: int, D: int, T: int,
                    itemsize: int) -> tuple[int, int]:
    """K2's backward: five products over each query's live keys, q, o, dO read and dq
    written once with the fp32 lse, the k/v rows read once and dk/dv written once."""
    klen = kv_len.long().clamp(0, T)[:, None]
    live = torch.minimum(positions.long().clamp(-1, T - 1) + 1, klen)
    rows = int(live.amax(1).sum())
    n = positions.numel() * H
    return 10 * D * H * int(live.sum()), 4 * n * D * itemsize + 4 * n + 4 * rows * Hkv * D * itemsize


def decode_work(kv_len: torch.Tensor, T: int, H: int, Hkv: int, D: int, itemsize: int,
                q_itemsize: int = 2) -> tuple[int, int]:
    """K3 (one-token decode over a cache): both products over each row's live slots
    (kv_len clipped to [0, T]), those k/v rows read once (with fp32 scales for int8),
    q read and out written once. kv_len may hold several steps' rows stacked: the
    sums then add up those steps."""
    live = int(kv_len.to(torch.int32).clamp(0, T).sum())
    nbytes = live * Hkv * D * itemsize * 2 + 2 * kv_len.shape[0] * H * D * q_itemsize
    if itemsize == 1:
        nbytes += 2 * live * Hkv * 4
    return 4 * D * H * live, nbytes
