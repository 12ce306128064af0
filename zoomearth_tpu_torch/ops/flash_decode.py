"""K3: single-token GQA decode attention over the slot cache.

Replaces zoomearth_tpu/ops/flash_decode.py::flash_decode_attention (Pallas). The
kernel is hand-written CUDA C++ for Hopper: the split pass it shares with K4
(csrc/decode_split.cuh, whose header says what bounds it and what its design does
about it) instantiated with the slot cache's addresses (csrc/flash_decode.cu).
Unlike the TPU kernel it takes any T (no T % 512 rule) and reads a strided prefix
view of the cache in place.

- `flash_decode_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises).
- `flash_decode_attention_plain` is the plain torch version, int8 algebra included.
- `live_lengths` is the launch prep: the slots each row reads (kv_len clipped to
  [0, T]); `read_bytes` is the cache traffic that follows from it, `work` the least
  (flops, bytes) of a call.
- `split_plan` is how the kernel splits the key axis across blocks, from the
  shapes alone; `decode_partials_plain` and `merge_splits_plain` are the plain
  versions of its two passes (the per-split softmax states and the split merge
  that K4 and P2 share).
- `decode_attention_cuda.launches` counts calls of the kernel, each of which runs
  two launches: the split pass and the merge; `.int8_launches` those on int8 caches.

A row with kv_len == 0 gives the mean of v over all T slots it is handed: every
logit is masked alike. That is what the JAX decoder's default decode gives
(zoomearth_tpu/ops/attention.py::decode_attention, the XLA path; the Pallas K3 is
opt-in there, models/decoder.py:32-41, 224-229), and what this module's plain
version and kernel give. The Pallas K3 differs on such a row: it walks its row
block's ncb * 512 slots (ncb the longest row's chunk count, at least 1) and gives
the mean of v over those, a result of its TPU tiling. The port follows the
decoder's path, whose answer does not depend on which rows share a block.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, decode_attention

MAX_G = 8  # query heads per kv head (K3_MAXG in csrc/decode_split.cuh)
TILE = 32  # slots per staged tile (K3_TILE): a split is a whole number of tiles
# Blocks per call: four waves of the three blocks each of the H100's 132 SMs holds.
# Rows' live lengths are not known on the host, and many short splits keep the SMs
# busy whichever of them are live (against one wave: 10-32 % less device time at
# B = 8-64, 13 % more at B = 32, T = 1536; NVIDIA H100 80GB HBM3, 700 W).
TARGET_BLOCKS = 4 * 3 * 132


def live_lengths(kv_len: torch.Tensor, T: int) -> torch.Tensor:
    """Slots each row's decode reads: kv_len clipped to [0, T] (int32)."""
    return kv_len.to(torch.int32).clamp(0, T)


def read_bytes(kv_len: torch.Tensor, T: int, Hkv: int, D: int, itemsize: int) -> int:
    """Cache bytes one K3 call reads: k and v rows of the live slots only."""
    return int(live_lengths(kv_len, T).sum()) * Hkv * D * itemsize * 2


def work(kv_len: torch.Tensor, T: int, H: int, Hkv: int, D: int, itemsize: int,
         q_itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) one decode-attention call needs at the least: both products over
    each row's live slots (4 * D * H * sum of kv_len), the live k/v rows (read_bytes;
    with their fp32 scales for int8 caches) read once, q read and out written once."""
    live = int(live_lengths(kv_len, T).sum())
    nbytes = read_bytes(kv_len, T, Hkv, D, itemsize) + 2 * kv_len.shape[0] * H * D * q_itemsize
    if itemsize == 1:
        nbytes += 2 * live * Hkv * 4
    return 4 * D * H * live, nbytes


def split_plan(B: int, Hkv: int, T: int) -> tuple[int, int]:
    """(split length, split count) of K3's key axis, from the shapes alone (never
    from kv_len, whose values would need a host sync): about TARGET_BLOCKS blocks of
    (row, kv head, split), the length a multiple of TILE. Split s covers slots
    [s * length, min((s + 1) * length, T)); the count is the least that covers T."""
    want = -(-TARGET_BLOCKS // max(B * Hkv, 1))  # splits per (row, kv head)
    per = -(-T // want)
    split = -(-per // TILE) * TILE
    return split, -(-T // split)


def decode_partials_plain(q, k_cache, v_cache, kv_len, split_len, ks=None, vs=None):
    """K3's split pass in fp32: for each (row, kv head) pair, split and query head,
    the softmax state over the split's live slots. A row with no live slot is read
    as T slots with equal logits. Returns (m (P, S, G), l (P, S, G), acc (P, S, G, D),
    walked (P,)) with P = B * Hkv pairs (row-major), S the split count; only the
    first walked[p] splits of pair p were walked (the others hold no slot)."""
    q3 = (q[:, 0] if q.dim() == 4 else q).float()
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    S = -(-T // split_len)
    lens = live_lengths(kv_len, T)
    dead = lens == 0
    live = torch.where(dead, T, lens)
    logits = torch.einsum("bkgd,bktd->bkgt", q3.reshape(B, Hkv, G, D) * D**-0.5, k_cache.float())
    if ks is not None:
        logits = logits * ks.float()[:, :, None, :]
    logits = torch.where(dead[:, None, None, None], 0.0, logits)
    pad = S * split_len - T
    valid = torch.arange(S * split_len, device=q.device)[None] < live[:, None]  # (B, S * L)
    logits = torch.nn.functional.pad(logits, (0, pad)).masked_fill(~valid[:, None, None], NEG_INF)
    logits = logits.reshape(B, Hkv, G, S, split_len)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None]) * valid.reshape(B, 1, 1, S, split_len)
    l = p.sum(-1)
    if vs is not None:
        p = p * torch.nn.functional.pad(vs.float(), (0, pad)).reshape(B, Hkv, 1, S, split_len)
    v = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad)).reshape(B, Hkv, S, split_len, D)
    acc = torch.einsum("bkgsl,bksld->bksgd", p, v)
    walked = torch.div(live + split_len - 1, split_len, rounding_mode="floor").repeat_interleave(Hkv)
    return (m.transpose(2, 3).reshape(B * Hkv, S, G), l.transpose(2, 3).reshape(B * Hkv, S, G),
            acc.reshape(B * Hkv, S, G, D), walked)


def merge_splits_plain(m, l, acc, walked):
    """The split merge (csrc/split_merge.cu) in plain torch: per pair p and query
    head, sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), M = max_s m_s,
    over the pair's first walked[p] splits. m, l (P, S, G); acc (P, S, G, D).
    Returns (P, G, D)."""
    S = m.shape[1]
    walk = (torch.arange(S, device=m.device)[None] < walked[:, None])[..., None]  # (P, S, 1)
    M = m.masked_fill(~walk, float("-inf")).amax(1, keepdim=True)
    f = torch.where(walk, torch.exp(m - M), 0.0)
    return (f[..., None] * acc).sum(1) / torch.clamp((f * l).sum(1), min=1e-30)[..., None]


def flash_decode_attention_plain(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """Plain torch version in fp32, cast to q.dtype. q (B, 1, H, D) or (B, H, D)."""
    had_s = q.dim() == 4
    q4 = q if had_s else q[:, None]
    T = k_cache.shape[2]
    kv_len = live_lengths(kv_len, T)
    if ks is None:
        out = decode_attention(q4.float(), k_cache.float(), v_cache.float(), kv_len=kv_len)
    else:
        B, _, H, D = q4.shape
        Hkv = k_cache.shape[1]
        qg = q4[:, 0].float().reshape(B, Hkv, H // Hkv, D)
        logits = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float())
        logits = logits * ks.float()[:, :, None, :] * D**-0.5
        valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
        logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(logits, dim=-1) * vs.float()[:, :, None, :]
        out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float()).reshape(B, 1, H, D)
    out = out.to(q.dtype)
    return out if had_s else out[:, 0]


def decode_attention_cuda(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """Launch K3: one C call that runs the split pass over (B * Hkv) x nsplit blocks
    (split_plan) and then the split merge. q (B, 1, H, D) or (B, H, D); caches
    (B, Hkv, T, D) of q's dtype or int8 (then ks/vs (B, Hkv, T) are required), unit
    stride on D, rows and other strides whole 16-byte multiples from a 16-byte
    aligned base (a [:, :, :attend_len] prefix view of a cache is read in place).
    Nothing here waits for the device."""
    name = "flash_decode_attention"
    had_s = q.dim() == 4
    q3 = q[:, 0] if had_s else q
    _cuda.require_cuda(name, q3, k_cache, v_cache, kv_len, ks, vs)
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{name}: k/v caches must share shape and dtype")
    if H % Hkv or H // Hkv > MAX_G or D > 128 or D % 8 or T < 1:
        raise ValueError(f"{name}: needs H / Hkv <= {MAX_G}, D <= 128 a multiple of 8 and T >= 1 "
                         f"(H={H}, Hkv={Hkv}, D={D}, T={T})")
    qc = _cuda.dtype_code(q3, name, (torch.float32, torch.bfloat16))
    quant = k_cache.dtype == torch.int8
    kc = _cuda.dtype_code(k_cache, name, (q3.dtype, torch.int8))
    item = k_cache.element_size()
    if any((x * item) % 16 for c in (k_cache, v_cache) for x in (D, *c.stride()[:3])) or \
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: k/v rows and strides must be whole 16-byte multiples from a 16-byte aligned "
                         f"base (the kernel copies 16-byte vectors; strides {k_cache.stride()}, "
                         f"{v_cache.stride()})")
    if quant:
        ks, vs = _cuda.scale_views(name, ks, vs)
    else:
        ks = vs = None
    split, nsplit = split_plan(B, Hkv, T)
    part = torch.empty(B * Hkv * nsplit * (H // Hkv) * (D + 2), dtype=torch.float32, device=q3.device)
    out = torch.empty((B, H, D), dtype=q3.dtype, device=q3.device)
    kv_len = live_lengths(kv_len, T).contiguous()
    rc = _cuda.lib().zt_flash_decode(
        _cuda.ptr(q3), _cuda.ptr(k_cache), _cuda.ptr(v_cache), _cuda.ptr(ks), _cuda.ptr(vs),
        _cuda.ptr(kv_len), _cuda.ptr(part), _cuda.ptr(out), B, H, Hkv, T, D, split, nsplit,
        q3.stride(0), q3.stride(1), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        ks.stride(0) if quant else 0, ks.stride(1) if quant else 0,
        D**-0.5, qc, kc, _cuda.stream(q3.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(decode_attention_cuda, int8=quant)
    return out[:, None] if had_s else out


decode_attention_cuda.launches = 0
decode_attention_cuda.int8_launches = 0  # of them, on int8 caches


def flash_decode_attention(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """GQA decode attention: rows attend to their first kv_len slots. Returns the
    same rank as q, in q.dtype."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, kv_len, ks, vs)
    return decode_attention_cuda(q, k_cache, v_cache, kv_len, ks, vs)
