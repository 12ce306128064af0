"""Probes of decode attention on the card: the stream floor (P1) and the big-product
design (P2). Port of scripts/probe_attn.py.

(P1) `stream_only` reads the same (rb, Hkv, chunk, D) k/v blocks as decode attention
     with a trivial reduction: its time is the copy floor K3 and K4 are held against.
     Its kernel is one persistent launch that streams k and v through a shared-memory
     ring with bulk asynchronous copies (csrc/probe_stream.cu, whose header says what
     bounds it and what its design does about it); a call is one memset and one launch.
(P2) `bigmm_decode_attention` is decode attention with one (N*C, D) @ (D, N*G)
     product per chunk over the N = RB * Hkv (row, kv head) pairs of a row block,
     of which only the diagonal blocks are kept. Its kernel splits the chunk walk
     into SPLIT-key ranges across blocks and merges their softmax states with K3's
     split merge (`bigmm_partials_plain` is the plain version of its split pass).

Each has a dispatch function (CPU -> plain version, CUDA -> kernel or raise), a plain
torch version and a CUDA wrapper with a launch counter; the kernels are
csrc/probe_stream.cu and csrc/probe_bigmm.cu.

On a machine with one NVIDIA GPU:  python -m zoomearth_tpu_torch.scripts.probe_attn
It times P1 and P2 (each beside its plain version), K3 and the plain decode attention
in turns, L2 cold, at B=32, H=16, Hkv=2, D=128, T=1536, bf16, lengths 600-1200, per
call (CUDA events) and on the device (CUDA graph replays), and prints ms per call
and per 36-layer step, with P1's GB/s of cache read and P2's of cache walked.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda
from ..ops.attention import NEG_INF, decode_attention
from ..ops.flash_decode import decode_attention_cuda
from ..ops.flash_decode import work as flash_decode_work
from .timing import PLAIN, time_in_turns

LAYERS = 36
HBM_TBPS = 3.35  # the H100 SXM's published device-memory rate


# ---------------- (P1) stream-only ----------------

def _stream_shapes(q, k_cache, chunk, rb):
    B, _, H, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if rb <= 0 or B % rb:
        raise ValueError(f"stream_only: B={B} is not a multiple of rb={rb}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"stream_only: T={T} is not a multiple of chunk={chunk}")
    if rb * H > min(64, rb * Hkv * chunk):
        raise ValueError(f"stream_only: rb * H = {rb * H} output rows exceed the 64 summed rows")
    return B, H, Hkv, T, D


def stream_only_plain(q, k_cache, v_cache, kv_len=None, *, chunk=512, rb=4):
    """Plain torch version of P1. q (B, 1, H, D) gives the output's shape and dtype;
    kv_len is ignored (the probe reads every slot). Returns (out, sums): out (B, 1, H, D)
    the TPU probe's output (per row block, the fp32 sum over chunks of the first 64
    rows of each chunk's flattened (rb, Hkv, chunk, D) k and v blocks), and sums
    (B // rb,) fp32 the sum of every k and v element of the row block (taken in fp64)."""
    B, H, Hkv, T, D = _stream_shapes(q, k_cache, chunk, rb)
    nb, nc = B // rb, T // chunk

    def first_rows(x):
        x = x.reshape(nb, rb, Hkv, nc, chunk, D).permute(0, 3, 1, 2, 4, 5)
        return x.reshape(nb, nc, rb * Hkv * chunk, D)[:, :, :64].float()

    acc = (first_rows(k_cache) + first_rows(v_cache)).sum(1)  # (nb, <=64, D)
    out = acc[:, : rb * H].reshape(B, 1, H, D).to(q.dtype)
    sums = (k_cache.reshape(nb, -1).double().sum(1) + v_cache.reshape(nb, -1).double().sum(1)).float()
    return out, sums


def stream_out_rows(H: int, Hkv: int, chunk: int, rb: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where the kernel finds out's rows: flattened row f < rb * H of a chunk's
    (rb, Hkv, chunk, D) block is slot s[f] of kv head h[f] of row r[f] of the row block,
    in every chunk (f = (r * Hkv + h) * chunk + s). Returns (r, h, s), each (rb * H,)."""
    f = torch.arange(rb * H)
    return f // chunk // Hkv, f // chunk % Hkv, f % chunk


def stream_only_cuda(q, k_cache, v_cache, kv_len=None, *, chunk=512, rb=4):
    """Launch P1: one memset (of sums) and one kernel. k/v (B, Hkv, T, D) contiguous,
    fp32 or bf16, rows a multiple of 16 bytes from 16-byte aligned bases (the kernel's
    bulk copies need both). sums is added with atomics, in an order that changes from
    run to run: equal to the plain version's to ~1e-7 of the summed magnitudes, not
    bit for bit. Nothing here waits for the device."""
    name = "stream_only"
    _cuda.require_cuda(name, q, k_cache, v_cache)
    B, H, Hkv, T, D = _stream_shapes(q, k_cache, chunk, rb)
    kc = _cuda.dtype_code(k_cache, name, (torch.float32, torch.bfloat16))
    oc = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{name}: k/v caches must share shape and dtype")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name}: k/v caches must be contiguous")
    if (D * k_cache.element_size()) % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: k/v rows must be whole 16-byte vectors, 16-byte aligned")
    sums = torch.empty((B // rb,), dtype=torch.float32, device=q.device)  # cleared by the C call
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    rc = _cuda.lib().zt_probe_stream(
        _cuda.ptr(k_cache), _cuda.ptr(v_cache), _cuda.ptr(sums), _cuda.ptr(out),
        B, H, Hkv, T, D, rb, chunk, kc, oc, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(stream_only_cuda)
    return out[:, None], sums


stream_only_cuda.launches = 0


def stream_only(q, k_cache, v_cache, kv_len=None, *, chunk=512, rb=4):
    """P1: returns (out (B, 1, H, D), sums (B // rb,))."""
    if q.device.type == "cpu":
        return stream_only_plain(q, k_cache, v_cache, kv_len, chunk=chunk, rb=rb)
    return stream_only_cuda(q, k_cache, v_cache, kv_len, chunk=chunk, rb=rb)


def stream_bytes(k_cache) -> int:
    """Cache bytes one P1 call reads: all of k and v."""
    return 2 * k_cache.numel() * k_cache.element_size()


def stream_work(q, k_cache, rb: int = 4) -> tuple[int, int]:
    """(flops, bytes) one P1 call needs at the least: one fp32 add per k and v element
    (the row blocks' sums), every element read once, out and the sums written once."""
    return 2 * k_cache.numel(), stream_bytes(k_cache) + q.numel() * q.element_size() + 4 * (q.shape[0] // rb)


# ---------------- (P2) big-product attention ----------------

MAX_PAIRS = 8  # (row, kv head) pairs per row block: warps per block in csrc/probe_bigmm.cu
SPLIT = 64  # keys of every pair per block of the kernel's split pass


def row_block(B: int) -> int:
    """Rows per row block: the largest of 4, 2, 1 that divides B."""
    return next(r for r in (4, 2, 1) if B % r == 0)


def block_chunks(kv_len, T: int, chunk: int, RB: int) -> torch.Tensor:
    """Chunks each row block walks (int32, (B // RB,)): the largest per-row count
    max(ceil(kv_len / chunk), 1) of the block, kv_len clipped to [0, T]."""
    lens = kv_len.to(torch.int32).clamp(0, T)
    n = torch.div(lens + chunk - 1, chunk, rounding_mode="floor").clamp_min(1)
    return n.reshape(-1, RB).amax(1).to(torch.int32)


def _bigmm_check(T, chunk):
    if chunk <= 0 or T % chunk:
        raise ValueError(f"bigmm_decode_attention: T={T} is not a multiple of chunk={chunk} (the "
                         "reference drops the tail slots without a word; the port refuses)")


def walked_bytes(kv_len, T: int, chunk: int, Hkv: int, D: int) -> int:
    """Cache bytes one P2 call reads: k and v (bf16) of every slot its row blocks walk."""
    RB = row_block(kv_len.shape[0])
    return int(block_chunks(kv_len, T, chunk, RB).sum()) * chunk * RB * Hkv * D * 2 * 2


def bigmm_work(kv_len, T: int, H: int, Hkv: int, D: int) -> tuple[int, int]:
    """(flops, bytes) the function P2 computes needs at the least: decode attention
    over each row's live slots (flash_decode.work, bf16), not the slots its row blocks
    walk nor its N / 2-fold extra multiplies."""
    return flash_decode_work(kv_len, T, H, Hkv, D, 2)


def bigmm_partials_plain(q, k_cache, v_cache, kv_len, *, chunk=512, split=SPLIT):
    """P2's split pass in fp32: per (row, kv head) pair, split of `split` keys and
    query head, the softmax state over the split's walked slots, logits past kv_len
    masked to -1e30 with no liveness test (a split with none live weighs all its
    slots alike). Returns (m, l, acc, walked) as decode_partials_plain does; pair p
    walked ceil(ncb * chunk / split) splits of its row block's ncb chunks."""
    q3 = (q[:, 0] if q.dim() == 4 else q).float()
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    _bigmm_check(T, chunk)
    S = -(-T // split)
    pad = S * split - T
    lens = kv_len.to(torch.int32).clamp(0, T)
    walk = block_chunks(lens, T, chunk, row_block(B)).repeat_interleave(row_block(B)) * chunk  # (B,)
    pos = torch.arange(S * split, device=q.device)[None]
    logits = torch.einsum("bkgd,bktd->bkgt", q3.reshape(B, Hkv, G, D), k_cache.float()) * D**-0.5
    logits = torch.nn.functional.pad(logits, (0, pad)).masked_fill(~(pos < lens[:, None])[:, None, None], NEG_INF)
    in_walk = (pos < walk[:, None]).reshape(B, 1, 1, S, split)
    logits = logits.reshape(B, Hkv, G, S, split).masked_fill(~in_walk, float("-inf"))
    m = logits.amax(-1)
    p = torch.where(in_walk, torch.exp(logits - m.clamp_min(NEG_INF)[..., None]), 0.0)
    v = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad)).reshape(B, Hkv, S, split, D)
    acc = torch.einsum("bkgsl,bksld->bksgd", p, v)
    walked = torch.div(walk + split - 1, split, rounding_mode="floor").repeat_interleave(Hkv)
    return (m.transpose(2, 3).reshape(B * Hkv, S, G), p.sum(-1).transpose(2, 3).reshape(B * Hkv, S, G),
            acc.reshape(B * Hkv, S, G, D), walked)


def bigmm_decode_attention_plain(q, k_cache, v_cache, kv_len, *, chunk=512):
    """Plain torch version of P2 in fp32, cast to q.dtype. q (B, 1, H, D) or (B, H, D).
    A row with kv_len > 0 gives decode attention over its first kv_len slots. A row
    with kv_len == 0 gives what the Pallas kernel gives: every logit masked, so the
    mean of v over the ncb * chunk slots its row block walks."""
    had_s = q.dim() == 4
    q3 = q[:, 0] if had_s else q
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    _bigmm_check(T, chunk)
    RB = row_block(B)
    lens = kv_len.to(torch.int32).clamp(0, T)
    span = block_chunks(lens, T, chunk, RB).repeat_interleave(RB) * chunk  # slots walked per row
    v = v_cache.float()
    out = decode_attention(q3[:, None].float(), k_cache.float(), v, kv_len=lens)[:, 0]
    walked = torch.arange(T, device=q.device)[None] < span[:, None]
    mean = (v * walked[:, None, :, None]).sum(2) / span[:, None, None]  # (B, Hkv, D)
    mean = mean.repeat_interleave(H // Hkv, dim=1)
    out = torch.where((lens == 0)[:, None, None], mean, out).to(q.dtype)
    return out[:, None] if had_s else out


def bigmm_decode_cuda(q, k_cache, v_cache, kv_len, *, chunk=512):
    """Launch P2: one C call that runs the split pass over (B / RB) x ceil(T / SPLIT)
    blocks and then K3's split merge. q (B, 1, H, D) or (B, H, D), caches
    (B, Hkv, T, D), all bf16, contiguous and 16-byte aligned; H = 8 Hkv, D = 128,
    RB * Hkv <= 8, chunk a multiple of 16 dividing T. Nothing here waits for the device."""
    name = "bigmm_decode_attention"
    had_s = q.dim() == 4
    q3 = (q[:, 0] if had_s else q).contiguous()
    _cuda.require_cuda(name, q3, k_cache, v_cache, kv_len)
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    _bigmm_check(T, chunk)
    for t in (q3, k_cache, v_cache):
        _cuda.dtype_code(t, name, (torch.bfloat16,))
    RB = row_block(B)
    if H != 8 * Hkv or D != 128 or RB * Hkv > MAX_PAIRS or chunk % 16:
        raise ValueError(f"{name}: needs H = 8 Hkv, D = 128, RB * Hkv <= {MAX_PAIRS} and chunk % 16 == 0 "
                         f"(H={H}, Hkv={Hkv}, D={D}, RB={RB}, chunk={chunk})")
    if v_cache.shape != k_cache.shape or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name}: k/v caches must be contiguous and of one shape")
    if any(t.data_ptr() % 16 for t in (q3, k_cache, v_cache)):
        raise ValueError(f"{name}: q and the k/v caches must be 16-byte aligned (the kernel loads 16-byte vectors)")
    lens = kv_len.to(torch.int32).clamp(0, T).contiguous()
    ncb = block_chunks(lens, T, chunk, RB).contiguous()
    nsplit = -(-T // SPLIT)
    part = torch.empty(B * Hkv * nsplit * 8 * (D + 2), dtype=torch.float32, device=q3.device)
    out = torch.empty((B, H, D), dtype=q3.dtype, device=q3.device)
    rc = _cuda.lib().zt_probe_bigmm(
        _cuda.ptr(q3), _cuda.ptr(k_cache), _cuda.ptr(v_cache), _cuda.ptr(lens), _cuda.ptr(ncb),
        _cuda.ptr(part), _cuda.ptr(out), B, H, Hkv, T, D, RB, chunk, SPLIT, D**-0.5, _cuda.stream(q3.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(bigmm_decode_cuda)
    return out[:, None] if had_s else out


bigmm_decode_cuda.launches = 0


def bigmm_decode_attention(q, k_cache, v_cache, kv_len, *, chunk=512):
    """P2: decode attention; returns the same rank as q, in q.dtype."""
    if q.device.type == "cpu":
        return bigmm_decode_attention_plain(q, k_cache, v_cache, kv_len, chunk=chunk)
    return bigmm_decode_cuda(q, k_cache, v_cache, kv_len, chunk=chunk)


# ---------------- the measurement ----------------

SEED = 0
SHAPE = (32, 16, 2, 128, 1536)  # B, H, Hkv, D, T: the reference probe's (probe_attn.py:169-173)
CHUNK = 512


def probe_inputs(device, B=SHAPE[0]):
    """The reference probe's tensors from a numpy generator seeded with SEED, bf16 on
    `device`; lengths 600-1199. B: another batch than the probe's, for a longer stream."""
    _, H, Hkv, D, T = SHAPE
    rng = np.random.default_rng(SEED)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    q, k, v = bf16((B, 1, H, D)), bf16((B, Hkv, T, D)), bf16((B, Hkv, T, D))
    lens = torch.from_numpy(rng.integers(600, 1200, size=B).astype(np.int32)).to(device)
    return q, k, v, lens


def measure(q, k, v, lens, extra=()):
    """Time, in turns: plain decode attention and K3 at the ragged lengths, P2 at
    chunk 512 ragged and at len = T, and P1 at len = T, each of P1 and P2 beside its
    plain version; then the caller's `extra` (name, function, bytes or None) cases, in
    the same turns. Returns {case: (ms per call, device ms per call, GB/s of cache
    read (P1) or walked (P2) on device time, or None)}."""
    Hkv, T, D = k.shape[1], k.shape[2], k.shape[3]
    full = torch.full_like(lens, T)
    cases = [
        ("plain decode_attention len600-1200", lambda: decode_attention(q, k, v, kv_len=lens), None),
        ("K3 flash_decode len600-1200", lambda: decode_attention_cuda(q, k, v, lens), None),
    ]
    for label, ln in (("len600-1200", lens), ("len=T", full)):
        cases += [(f"P2 bigmm512 {label}", lambda ln=ln: bigmm_decode_attention(q, k, v, ln, chunk=CHUNK),
                   walked_bytes(ln, T, CHUNK, Hkv, D)),
                  (f"P2 bigmm512 {label}{PLAIN}",
                   lambda ln=ln: bigmm_decode_attention_plain(q, k, v, ln, chunk=CHUNK), None)]
    cases += [("P1 stream_only (copy floor) len=T", lambda: stream_only(q, k, v, full), stream_bytes(k)),
              (f"P1 stream_only (copy floor) len=T{PLAIN}", lambda: stream_only_plain(q, k, v, full), stream_bytes(k))]
    cases += list(extra)
    ms, dev = time_in_turns([c[1] for c in cases])
    return {name: (t, d, None if nbytes is None else nbytes / d / 1e6)
            for (name, _, nbytes), t, d in zip(cases, ms, dev)}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_attn: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    q, k, v, lens = probe_inputs(dev)
    ref = decode_attention(q.float(), k.float(), v.float(), kv_len=lens)
    out = bigmm_decode_attention(q, k, v, lens, chunk=CHUNK)
    print(f"bigmm parity max|d| vs fp32 decode attention: {(out.float() - ref).abs().max().item():.3e}")
    print(torch.cuda.get_device_name(0))
    for name, (ms, dev, gbs) in measure(q, k, v, lens).items():
        rate = f" | {gbs:.1f} GB/s of cache read or walked on device time (HBM {HBM_TBPS} TB/s)" if gbs else ""
        print(f"{name}: {ms:.4f} ms/call ({ms * LAYERS:.2f} ms/{LAYERS}-layer) | device {dev:.4f} ms/call "
              f"({dev * LAYERS:.2f} ms/{LAYERS}-layer){rate}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
