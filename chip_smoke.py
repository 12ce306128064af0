#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (zoomearth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the smoke: every phase below, then the two JSON lines
    python3 chip_smoke.py --profile   # device and build, then where the 3B slice's time goes

Phases, each fatal on failure (nothing is caught):

1. device  — exits 1 without CUDA; prints the card's name and power limit.
2. build   — compiles the hand-written kernels (csrc/*.cu) with nvcc for sm_90a.
3. kernels — K1 (segment), K2 (causal prefill / chunk prefill, int8) and K3 (decode,
   int8, strided prefix view) against their plain torch versions at the main path's
   shapes, in bf16: max abs error against a stated tolerance, and the times (CUDA
   events, timed in turns: plain, kernel, library, library, kernel, plain, ...; median
   of 10 each after 2 warm-ups each; L2 flushed before every call), per call and on
   the device (CUDA graph replays). The library call is one
   scaled_dot_product_attention on the same inputs with the mask built beforehand: a
   yardstick timed here and called nowhere in the port. Each case also gets its bound:
   the least time the card could take, the larger of its flops over 989 TFLOP/s and
   its bytes over 3.35 TB/s, both counted from the case's inputs by the `work`
   function beside the wrapper. Then, untimed, K1, K2 and K3 where they have edges:
   K2 at kv_len 0, positions either side of a tile boundary, S no multiple of 16, pad
   rows past kv_len, bf16 and int8, the transposed no-cache view and a prefix view; K1
   at segments of 16-64 rows, a boundary inside a tile, S no multiple of 128, the pad
   tail, the fused-qkv views; K3 at kv_len 0, rows ending either side of a split
   boundary, T not a whole number of splits, bf16, int8 and the strided view.
4. parity  — the tiny config in fp32 on the card through every kernel (K1/K2's fp32
   variants) against the CPU plain path (which the CPU tests hold against the JAX
   package): logits and greedy tokens. Then in bf16 on the card: prefill through the
   kernels (K2's tensor-core variant) against the same weights through the plain
   versions.
5. slice   — Qwen2.5-VL-3B at full width with random bf16 weights from a seeded
   torch.Generator: run_inference over 16 synthetic 5000 px LRS-GRO-shaped samples
   (batch 8, greedy, 64 + 64 new tokens, forced bbox so stage 2 always runs), then
   one run_episodes(reuse_cache=True) batch. Every record must be written and every
   kernel launched by that run, K1 and K2 through their tensor-core variants only.
6. decode-variants — the decode-attention entry points beside the serving path, at
   the reference's shapes. First the checks: K4 (paged decode) against its plain
   version and K3 at (B=32|64, T=4096, 30 % live, pages 64|256); P1 (stream probe)
   and P2 (big-product decode) against their plain versions at B=32, T=1536; then,
   untimed, K4 and P1 at their edges: K4 at pages of 16, 64 and 256 with lengths 0,
   1, either side of a split and of a page boundary, capacity and past it, and
   block-table tails of ids far outside the pool, bf16 and fp32, against its plain
   version and K3; P1 at row blocks of 4, 2 and 1, chunks of 512 and under 64, bf16
   and fp32. Then,
   with the counts at 0, the entry points' own runs (zoomearth_tpu_torch.scripts
   probe_attn.measure and paged_256_test.measure_cell, which time each kernel beside
   its plain version in turns; P1's rate is of the cache it reads, P2's of the cache
   its row blocks walk, on device time) and a paged decode loop whose full row must
   be left unchanged; K4, P1 and P2 must each have launched. A count is of launches
   through the wrapper: calls captured into a CUDA graph are not counted, nor its
   replays.

The second-to-last line is {"kernels": [...]} (every case of each kernel with its
time, its plain version's, the library call's where there is one, its bound and the
share of it reached; the untimed checks; launches from the path that runs it: calls
of the wrapper, and each K3, K4 or P2 call runs two kernels, its split pass and the
split merge; a P1 call is one memset and one kernel); the last is the device contract
line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# bf16 roundings of attention outputs below 2: of the output, of the inputs' products and, in
# K1/K2's tensor-core variants and P2, of the softmax weights p (the kernels accumulate in fp32)
TOL_BF16 = 2e-2
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16 tensor-core rate and HBM rate
LIBRARY = " (library call)"  # a case's library yardstick among an entry point's timed cases
SAMPLES, BATCH, NEW_TOKENS = 16, 8, 64


def log(msg):
    print(msg, flush=True)


def max_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def timing_row(label, check, times, plain_times, card, work, library_times=None, gb_per_s=None):
    """Log one kernel case (its check against its plain version, with the tolerance;
    its times from time_in_turns, per call and on the device, beside its plain
    version's and the library call's; its bound from work = (flops, bytes)) and
    return it as a row of the kernels line."""
    (ms, dev), (plain_ms, plain_dev) = times, plain_times
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"
    rate = f" ({gb_per_s:.1f} GB/s on device time)" if gb_per_s else ""
    lib = "no single PyTorch call computes this"
    if library_times:
        lib = (f"library {library_times[0]:.4f} ms per call, {library_times[1]:.4f} ms device, kernel/library "
               f"{dev / library_times[1]:.3f}")
    log(f"  {label}: max_abs_err {check['max_abs_err']:.3e} (tol {check['tol']}) | per call: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, kernel/plain {ms / plain_ms:.3f} | device: kernel {dev:.4f} ms{rate}, plain "
        f"{plain_dev:.4f} ms, kernel/plain {dev / plain_dev:.3f} | {lib} | bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), share of bound {bound_ms / dev:.3f} | L2 cold | {card}")
    row = {"case": label, **check, "ms": ms, "plain_ms": plain_ms, "kernel_over_plain": ms / plain_ms,
           "device_ms": dev, "plain_device_ms": plain_dev, "device_kernel_over_plain": dev / plain_dev,
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / dev,
           "library_ms": library_times[0] if library_times else None,
           "library_device_ms": library_times[1] if library_times else None,
           "kernel_over_library": dev / library_times[1] if library_times else None}
    if gb_per_s:
        row["gb_per_s_device"] = gb_per_s
    return row


def sdpa(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call, q (B, H, S, D),
    k/v (B, Hkv, T, D), mask a boolean tensor built beforehand (True = attend)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


def sdpa_backends(fn):
    """Names of the SDPA backends that take this call (PyTorch picks among them itself)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                fn()
            torch.cuda.synchronize()
            ok.append(backend.name)
        except RuntimeError:
            pass
    return ok


def case(label, kernel, plain, card, work, library=None, nbytes=None):
    """One kernel case: its output against its plain version's (max abs error within
    TOL_BF16), the library call's too where there is one, then all of them timed in
    turns, L2 cold: per call (CUDA events around each call) and on the device (CUDA
    graph replays)."""
    import torch

    from zoomearth_tpu_torch.scripts.timing import time_in_turns

    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not (err <= TOL_BF16 and bool(torch.isfinite(out.float()).all())):
        raise AssertionError(f"{label}: kernel disagrees with its plain version ({err})")
    check = {"max_abs_err": err, "tol": TOL_BF16}
    if library is not None:
        check["library_max_abs_err"] = max_err(library(), ref)
        log(f"  {label}: library call vs plain version max_abs_err {check['library_max_abs_err']:.3e} (tol {TOL_BF16}); "
            f"SDPA backends that take it: {sdpa_backends(library)}")
        if not check["library_max_abs_err"] <= TOL_BF16:
            raise AssertionError(f"{label}: the library yardstick disagrees with the plain version")
    ms, dev = time_in_turns([plain, kernel] + ([library] if library is not None else []))
    return timing_row(label, check, (ms[1], dev[1]), (ms[0], dev[0]), card, work,
                      (ms[2], dev[2]) if library is not None else None, nbytes and nbytes / dev[1] / 1e6)


def check_kernels(card):
    """Each kernel against its plain version at main-path shapes; returns ({kernel
    name: (source, TPU kernel it replaces, [case rows])}, {kernel name: untimed checks})."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=g, device=dev) * 0.02 + 0.005).to(bf)

    rows = {}
    # K1: stage-1 ViT full-attention block at B=8: 7 full 512 px images (1296 patches),
    # one partial image and a pad tail, S = 10368, H = 16, D = 80; q/k/v are strided
    # views of the fused qkv projection, as the ViT passes them.
    S, H, D = 10368, 16, 80
    runs = [1296] * 7 + [800]
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                    + [torch.full((S - sum(runs),), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
    qkv = randn(S, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    seg_mask = seg[:, None] == seg[None, :]
    e1 = case("K1 segment S=10368 H=16 D=80", lambda: K1.segment_attention_cuda(q, k, v, seg),
              lambda: K1.flash_segment_attention_plain(q, k, v, seg), card, K1.work(seg, H, D, 2),
              lambda: sdpa(q[None].transpose(1, 2), k[None].transpose(1, 2), v[None].transpose(1, 2),
                           seg_mask)[0].transpose(0, 1))
    del seg_mask
    rows["flash_segment_attention"] = ("zoomearth_tpu_torch/csrc/flash_segment.cu",
                                       "zoomearth_tpu/ops/flash_attention.py:92", [e1])

    def causal_mask(pos, kvl, T):
        slot = torch.arange(T, device=dev)
        return ((slot[None, None] <= pos[:, :, None]) & (slot[None, None] < kvl[:, None, None]))[:, None]

    # K2 (a): stage-1 prefill, B=8, S=512 into the 4096-row cache, kv_len = S.
    B, S, H, Hkv, D, T = 8, 512, 16, 2, 128, 4096
    q2 = randn(B, S, H, D)
    kc, vc = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    kvl = torch.full((B,), S, device=dev)
    mask_a = causal_mask(pos, kvl, T)
    e2a = case("K2 prefill B=8 S=512 T=4096", lambda: K2.causal_attention_cuda(q2, kc, vc, pos, kvl),
               lambda: K2.flash_causal_attention_plain(q2, kc, vc, pos, kvl), card,
               K2.work(pos, kvl, H, Hkv, D, T, 2),
               lambda: sdpa(q2.transpose(1, 2), kc, vc, mask_a).transpose(1, 2))
    # K2 (b): stage-2 chunk prefill, B=8, S=384 into T=1280 at ragged keep_len.
    S, T = 384, 1280
    q3 = randn(B, S, H, D)
    kc2, vc2 = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    keep = torch.tensor([500, 896, 640, 513, 777, 720, 600, 896], device=dev)
    pos2 = keep[:, None] + torch.arange(S, device=dev)[None]
    kvl2 = keep + S
    mask_b = causal_mask(pos2, kvl2, T)
    e2b = case("K2 chunk B=8 S=384 T=1280 ragged keep", lambda: K2.causal_attention_cuda(q3, kc2, vc2, pos2, kvl2),
               lambda: K2.flash_causal_attention_plain(q3, kc2, vc2, pos2, kvl2), card,
               K2.work(pos2, kvl2, H, Hkv, D, T, 2),
               lambda: sdpa(q3.transpose(1, 2), kc2, vc2, mask_b).transpose(1, 2))
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    e2c = case("K2 chunk int8 K/V", lambda: K2.causal_attention_cuda(q3, k8, v8, pos2, kvl2, ks, vs),
               lambda: K2.flash_causal_attention_plain(q3, k8, v8, pos2, kvl2, ks, vs), card,
               K2.work(pos2, kvl2, H, Hkv, D, T, 2, 1))  # no single PyTorch call takes int8 K/V with scales
    rows["flash_causal_attention"] = ("zoomearth_tpu_torch/csrc/flash_causal.cu",
                                      "zoomearth_tpu/ops/flash_causal.py:124", [e2a, e2b, e2c])

    def length_mask(kvl, T):
        return (torch.arange(T, device=dev)[None] < kvl[:, None])[:, None, None]

    # K3: decode, B=8, ragged kv_len including 1 and T.
    qd = randn(B, 1, H, D)
    e3 = []
    for T in (1280, 4096):
        kd, vd = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        kvl3 = torch.tensor([1, T, T // 2, 700, 1000, T - 1, 3, 512], device=dev)
        m3 = length_mask(kvl3, T)
        e3.append(case(f"K3 decode B=8 T={T}", lambda: K3.decode_attention_cuda(qd, kd, vd, kvl3),
                       lambda: K3.flash_decode_attention_plain(qd, kd, vd, kvl3), card,
                       K3.work(kvl3, T, H, Hkv, D, 2), lambda: sdpa(qd.transpose(1, 2), kd, vd, m3).transpose(1, 2),
                       K3.read_bytes(kvl3, T, Hkv, D, 2)))
        if T == 1280:
            k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
            e3.append(case("K3 decode int8 T=1280", lambda: K3.decode_attention_cuda(qd, k8, v8, kvl3, ks, vs),
                           lambda: K3.flash_decode_attention_plain(qd, k8, v8, kvl3, ks, vs), card,
                           K3.work(kvl3, T, H, Hkv, D, 1), None, K3.read_bytes(kvl3, T, Hkv, D, 1)))
    # the decoder's [:, :, :attend_len] prefix view of the 4096-row cache, read in place
    kv_view, vv_view = kd[:, :, :1280], vd[:, :, :1280]
    kvl4 = torch.tensor([1, 1280, 640, 700, 1000, 1279, 3, 512], device=dev)
    m4 = length_mask(kvl4, 1280)
    e3.append(case("K3 decode strided attend_len=1280 view of T=4096",
                   lambda: K3.decode_attention_cuda(qd, kv_view, vv_view, kvl4),
                   lambda: K3.flash_decode_attention_plain(qd, kv_view, vv_view, kvl4), card,
                   K3.work(kvl4, 1280, H, Hkv, D, 2),
                   lambda: sdpa(qd.transpose(1, 2), kv_view, vv_view, m4).transpose(1, 2),
                   K3.read_bytes(kvl4, 1280, Hkv, D, 2)))
    rows["flash_decode_attention"] = ("zoomearth_tpu_torch/csrc/flash_decode.cu",
                                      "zoomearth_tpu/ops/flash_decode.py:94", e3)
    log("[kernels] untimed checks where the kernels have edges")
    return rows, {"flash_segment_attention": check_k1_edges(randn),
                  "flash_causal_attention": check_k2_edges(randn, int8, scales),
                  "flash_decode_attention": check_k3_edges(randn, int8, scales)}


def edge_check(label, out, ref, tol=TOL_BF16):
    """One untimed check: log and return it; raise if the kernel disagrees."""
    import torch

    torch.cuda.synchronize()
    err = max_err(out, ref)
    log(f"  {label}: max_abs_err {err:.3e} (tol {tol}), untimed")
    if not (err <= tol and bool(torch.isfinite(out.float()).all())):
        raise AssertionError(f"{label}: kernel disagrees with its plain version ({err})")
    return {"case": label, "max_abs_err": err, "tol": tol}


def check_k1_edges(randn):
    """K1's tensor-core variant against its plain version, untimed, where it has
    edges: segments of 16-64 rows as the windowed blocks have them (every tile masked,
    boundaries inside tiles, key ranges that start mid-tile), one long segment whose
    inner tiles skip the compare, S not a multiple of 128, the PAD_SEG tail; on the
    fused-qkv views and on contiguous tensors. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1

    dev = torch.device("cuda")
    H, D = 16, 80
    layouts = {"windows of 16-64 rows + pad tail": [64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64, 64, 64, 16, 64],
               "one 1296-row image between windows + pad tail": [40, 1296, 64, 24],
               "two segments split inside a tile, no pad": [100, 91]}
    checks = []
    before = dict(K1.segment_attention_cuda.variants)
    for label, runs in layouts.items():
        pad = 0 if "no pad" in label else 37
        S = sum(runs) + pad
        assert S % 128, S
        seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                        + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
        qkv = randn(S, 3, H, D)
        for layout, (q, k, v) in (("fused-qkv views", (qkv[:, 0], qkv[:, 1], qkv[:, 2])),
                                  ("contiguous", tuple(qkv[:, i].contiguous() for i in range(3)))):
            out = K1.segment_attention_cuda(q, k, v, seg)
            ref = K1.flash_segment_attention_plain(q, k, v, seg)
            checks.append(edge_check(f"K1 {label}, S={S}, {layout}", out, ref))
    ran = {name: n - before[name] for name, n in K1.segment_attention_cuda.variants.items()}
    assert ran == {"mma": len(checks), "fma": 0}, f"K1 edge checks ran {ran}"
    return checks


def check_k2_edges(randn, int8, scales):
    """K2's tensor-core variant against its plain version, untimed, where it has edges:
    a row with kv_len 0 (no live key: 0, where the plain version's softmax over equal
    masked logits gives the mean of v), positions ending one before, at and after a
    tile boundary, S not a multiple of 16, pad rows whose positions exceed kv_len and
    come in no order; bf16 and int8 K/V, a prefix view of a longer cache and the
    transposed view the decoder passes without a cache. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    B, S, H, Hkv, D, T = 5, 40, 16, 2, 128, 300
    tile = K2.TILE
    ar = torch.arange(S, device=dev)
    pad_pos = torch.cat([100 + ar[:20], torch.tensor([299, 121, 250, 120, 5, 180, 150, 299, 122, 64] * 2, device=dev)])
    pos = torch.stack([ar, tile - S + ar, tile - S + 1 + ar, 2 * tile - S - 1 + ar, pad_pos])
    kvl = torch.tensor([0, tile, tile + 1, 2 * tile - 1, 120], device=dev)

    def expected(q, k, v, pos, kvl, a=None, b=None):
        ref = K2.flash_causal_attention_plain(q, k, v, pos, kvl, a, b)
        dead = torch.minimum(pos + 1, kvl[:, None]) <= 0
        return torch.where(dead[:, :, None, None], torch.zeros_like(ref), ref)

    q = randn(B, S, H, D)
    kf, vf = randn(B, Hkv, T + 212, D), randn(B, Hkv, T + 212, D)
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    cases = {"bf16": (kf[:, :, :T].contiguous(), vf[:, :, :T].contiguous(), None, None),
             "int8 K/V": (k8, v8, ks, vs), "prefix view": (kf[:, :, :T], vf[:, :, :T], None, None)}
    checks = []
    before = dict(K2.causal_attention_cuda.variants)
    for label, (k, v, a, b) in cases.items():
        out = K2.causal_attention_cuda(q, k, v, pos, kvl, a, b)
        checks.append(edge_check(f"K2 {label} B={B} S={S} T={T}, kv_len {kvl.tolist()}", out,
                                 expected(q, k, v, pos, kvl, a, b)))
        assert not bool(out[0].any()), "K2: a row with kv_len 0 must give 0"
    # no cache: k/v are (B, S, Hkv, D) projections passed as transposed views, slot t is token t
    S2 = 150
    q2, k2, v2 = randn(B, S2, H, D), randn(B, S2, Hkv, D).transpose(1, 2), randn(B, S2, Hkv, D).transpose(1, 2)
    pos2 = torch.arange(S2, device=dev)[None].expand(B, S2).contiguous()
    kvl2 = torch.tensor([S2, 0, tile, tile + 1, 97], device=dev)
    out = K2.causal_attention_cuda(q2, k2, v2, pos2, kvl2)
    checks.append(edge_check(f"K2 transposed no-cache view B={B} S=T={S2}, kv_len {kvl2.tolist()}", out,
                             expected(q2, k2, v2, pos2, kvl2)))
    ran = {name: n - before[name] for name, n in K2.causal_attention_cuda.variants.items()}
    assert ran == {"mma": len(checks), "fma": 0}, f"K2 edge checks ran {ran}"
    return checks


def check_k3_edges(randn, int8, scales):
    """K3 against its plain version, untimed, where its split pass and merge have
    edges: rows with kv_len 0 (the mean of v over all T slots), rows ending one slot
    before, at and after a split boundary, and a T that is not a whole number of
    splits; bf16 and int8 K/V, and the strided prefix view. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3

    B, H, Hkv, D, T = 8, 16, 2, 128, 1000
    split = K3.split_plan(B, Hkv, T)[0]
    assert T % split, (T, split)
    dev = torch.device("cuda")
    q = randn(B, 1, H, D)
    kvl = torch.tensor([0, 1, split - 1, split, split + 1, 2 * split, T, 0], device=dev)
    kf, vf = randn(B, Hkv, T + 536, D), randn(B, Hkv, T + 536, D)
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    cases = {"bf16": (kf[:, :, :T].contiguous(), vf[:, :, :T].contiguous(), None, None),
             "int8 K/V": (k8, v8, ks, vs), "strided view": (kf[:, :, :T], vf[:, :, :T], None, None)}
    checks = []
    for label, (k, v, a, b) in cases.items():
        out = K3.decode_attention_cuda(q, k, v, kvl, a, b)
        ref = K3.flash_decode_attention_plain(q, k, v, kvl, a, b)
        checks.append(edge_check(f"K3 {label} B=8 T={T} (split {split}), kv_len {kvl.tolist()}", out, ref))
    return checks


def check_tiny_parity():
    """Tiny config: in fp32 every kernel on the card against the CPU plain path, then
    in bf16 the card's kernels against the plain versions on the card."""
    import dataclasses

    import numpy as np
    import torch

    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models import decoder, vit
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator, prepare_batch

    cfg = VLMConfig.tiny()
    rng = np.random.default_rng(0)
    tok = cfg.tokens
    seqs, imgs = [], []
    for i, grid in enumerate([(1, 4, 4), (1, 8, 8), (1, 6, 10)]):
        n = grid[1] * grid[2] // 4
        seqs.append([tok.im_start, 40 + i, tok.vision_start] + [tok.image_pad] * n
                    + [tok.vision_end] + [50 + j for j in range(3 + 4 * i)])
        imgs.append([(rng.standard_normal((grid[1] * grid[2], cfg.vision.patch_dim)).astype(np.float32), grid)])
    batch = prepare_batch(cfg, seqs, imgs, length_buckets=(64,), patch_buckets=(256,))
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    gen = GenerationConfig(max_new_tokens=16, temperature=0.0)
    cpu_g = Generator(params, cfg, max_cache_len=128)
    gpu_g = Generator(map_tree(lambda t: t.cuda(), params), cfg, max_cache_len=128)
    lc = cpu_g.run_prefill(batch, max_new=16)[0]
    lg = gpu_g.run_prefill(batch, max_new=16)[0].cpu()
    err = (lc - lg).abs().max().item()
    toks_cpu, toks_gpu = cpu_g.generate(batch, gen), gpu_g.generate(batch, gen)
    log(f"  tiny fp32 prefill logits max_abs_err {err:.3e} (tol 1e-4); greedy tokens "
        f"{'identical' if toks_cpu == toks_gpu else 'DIFFER'} ({sum(map(len, toks_gpu))} tokens)")
    if not (err <= 1e-4 and toks_cpu == toks_gpu):
        raise AssertionError("tiny-config parity on the card failed")

    # bf16: the same weights and batch through the kernels (K2's tensor-core variant at
    # head dim 16; K1's fp32-arithmetic variant, the tiny ViT's head dim 8 being no
    # multiple of 16) and through the plain versions, both on the card
    bf_g = Generator(map_tree(lambda t: t.cuda().to(torch.bfloat16), params),
                     dataclasses.replace(cfg, dtype="bfloat16"), max_cache_len=128)
    before = dict(K2.causal_attention_cuda.variants)
    lk = bf_g.run_prefill(batch, max_new=16)[0]
    ran = {name: n - before[name] for name, n in K2.causal_attention_cuda.variants.items()}
    kernels = (vit.flash_segment_attention, decoder.flash_causal_attention)
    vit.flash_segment_attention, decoder.flash_causal_attention = (K1.flash_segment_attention_plain,
                                                                   K2.flash_causal_attention_plain)
    try:
        lp = bf_g.run_prefill(batch, max_new=16)[0]
    finally:
        vit.flash_segment_attention, decoder.flash_causal_attention = kernels
    err = max_err(lk, lp)
    # bf16 activations through two layers: one bf16 step (2^-8) of logits of size ~4, a few times over
    tol = 6e-2
    log(f"  tiny bf16 prefill logits, kernels vs plain versions on the card: max_abs_err {err:.3e} (tol {tol}; "
        f"max |logit| {lp.abs().max().item():.2f}); K2 variants that ran: {ran}")
    if not (err <= tol and ran["mma"] > 0 and ran["fma"] == 0 and bool(torch.isfinite(lk).all())):
        raise AssertionError("tiny-config bf16 parity on the card failed")


def synthetic_tile(seed, size=5000):
    """A 5000 px RGB tile: coarse random blocks upsampled (LRS-GRO tiles are ~5000 px)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (50, 50, 3), dtype=np.uint8)
    return Image.fromarray(np.kron(small, np.ones((size // 50, size // 50, 1), dtype=np.uint8)))


def slice_setup():
    """The 3B slice's model and inputs: Qwen2.5-VL-3B at full width with random bf16
    weights from seed 0, the processor, 16 LRS-GRO-shaped samples over 4 synthetic
    tiles, greedy generation of NEW_TOKENS tokens per stage."""
    import types

    import torch

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params, param_count
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer
    from zoomearth_tpu_torch.train.data import LRSGROSample

    t0 = time.time()
    cfg = VLMConfig.qwen2_5_vl_3b()
    params = init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    log(f"  Qwen2.5-VL-3B random bf16 params: {param_count(params) / 1e9:.3f} B")
    processor = Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=512 * 512)
    # The byte-level FakeTokenizer makes the verbatim instruction ~2300 tokens (over the
    # 2048 length bucket): keep the prompt's structure with a shortened instruction.
    instruction = PT.INSTRUCTION_EVAL[:80] + "<|im_end|><|im_start|>assistant\n"
    PT.stage1_prompt = lambda q: PT.PREFIX + q + instruction
    # Random weights emit no bbox: force one so stage 2 always runs.
    EP.extract_bboxes = lambda text, scale=1.0: [[2200, 2200, 2380, 2350]]

    tiles = {f"tile{i}.png": synthetic_tile(i) for i in range(4)}
    samples = [LRSGROSample(question_id=str(i), image_name=f"tile{i % 4}.png", category="object",
                            question=f"what is near the marked area {i}?", higher_level="perception",
                            ground_truth="ship", bbox=[2200, 2200, 2380, 2350], type="object")
               for i in range(SAMPLES)]
    return types.SimpleNamespace(
        cfg=cfg, processor=processor, tiles=tiles, samples=samples, init_s=init_s,
        generator=Generator(params, cfg, max_cache_len=4096),
        gen=GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0))


def run_slice(card):
    import torch

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.eval.infer import run_inference
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3

    env = slice_setup()
    cfg, generator, processor, samples, tiles, gen = (env.cfg, env.generator, env.processor, env.samples, env.tiles,
                                                     env.gen)
    phases = {"init_params_s": env.init_s}
    kernels = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        out_path = os.path.join(out_dir, "smoke0.jsonl")
        for k in kernels:
            k.launches = 0
        for k in kernels[:2]:
            k.variants = dict.fromkeys(k.variants, 0)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run_inference(generator, processor, samples, out_path, batch_size=BATCH, gen=gen, stage2_gen=gen,
                      image_loader=lambda s: tiles[s.image_name])
        torch.cuda.synchronize()
        phases["run_inference_s"] = time.time() - t0
        t0 = time.time()
        reuse = EP.run_episodes(generator, processor, [s.question for s in samples[:BATCH]],
                                [tiles[s.image_name] for s in samples[:BATCH]], gen=gen, reuse_cache=True)
        torch.cuda.synchronize()
        phases["run_episodes_reuse_s"] = time.time() - t0
        launches = {k.__name__: k.launches for k in kernels}
        variants = {k.__name__: dict(k.variants) for k in kernels[:2]}
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(line) for line in open(out_path)]

    assert len(records) == SAMPLES, f"{len(records)} of {SAMPLES} records written"
    assert sorted(r["question_id"] for r in records) == sorted(s.question_id for s in samples)
    assert all(r["error"] is False and isinstance(r["stage1"], str) for r in records)
    assert len(reuse) == BATCH and all(not r.error for r in reuse)
    assert all(n > 0 for n in launches.values()), f"kernel launches on the main path: {launches}"
    # the bf16 main path runs K1 and K2 on the tensor cores, never through their fp32-arithmetic variants
    assert all(v == {"mma": launches[name], "fma": 0} for name, v in variants.items()), variants
    # a direct look at the model's output on one stage-1 batch: finite fp32 logits
    batch = EP._stage1_inputs(generator, processor, [s.question for s in samples[:BATCH]],
                              [tiles[s.image_name] for s in samples[:BATCH]], 512)[-1]
    logits = generator.run_prefill(batch, max_new=NEW_TOKENS)[0]
    assert logits.shape == (BATCH, cfg.text.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    stage2_lens = sorted({len(r["stage2"]) for r in records})
    log(f"  {len(records)} records written; stage-2 text lengths {stage2_lens[:5]}...")
    log(f"  stage-1 batch: S={batch.input_ids.shape[1]} patches={batch.pixel_values.shape[0]} "
        f"win_mode={batch.vision_meta['win_mode']}")
    for name, secs in phases.items():
        log(f"  {name}: {secs:.2f} s | {card}")
    log(f"  peak memory allocated: {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB of it allocated before the run) "
        f"| {card}")
    log(f"  main-path kernel launches: {launches}; K1/K2 by variant: {variants}")
    return {"flash_segment_attention": launches["segment_attention_cuda"],
            "flash_causal_attention": launches["causal_attention_cuda"],
            "flash_decode_attention": launches["decode_attention_cuda"]}


def profile_slice(card):
    """`--profile`: where the slice's time goes. One batch of 8 questions after a
    warm-up batch: the phases of stage 1 on the host clock (synchronized), then
    run_inference of the 8 questions without and under torch.profiler, with the
    device time of the kernels by group and of every kernel that takes at least 1 %
    of the total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.eval.infer import run_inference

    env = slice_setup()
    generator, processor, gen = env.generator, env.processor, env.gen
    batch8 = env.samples[:BATCH]
    questions, images = [s.question for s in batch8], [env.tiles[s.image_name] for s in batch8]

    def infer(out_dir, name):
        torch.cuda.synchronize()
        t0 = time.time()
        run_inference(generator, processor, batch8, os.path.join(out_dir, name), batch_size=BATCH, gen=gen,
                      stage2_gen=gen, image_loader=lambda s: env.tiles[s.image_name])
        torch.cuda.synchronize()
        return time.time() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        infer(out_dir, "warm.jsonl")
        t0 = time.time()
        batch = EP._stage1_inputs(generator, processor, questions, images, 512)[-1]
        log(f"  stage-1 host prep (resize {BATCH} tiles, tokenize, patchify): {time.time() - t0:.3f} s | {card}")
        for label, fn in (("stage-1 prefill (ViT + decoder)", lambda: generator.run_prefill(batch, max_new=NEW_TOKENS)),
                          (f"stage-1 generate (prefill + {NEW_TOKENS} decode steps)", lambda: generator.generate(batch, gen))):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            log(f"  {label}, S={batch.input_ids.shape[1]}: {time.time() - t0:.3f} s | {card}")
        log(f"  run_inference of {BATCH} questions, no profiler: {infer(out_dir, 'plain.jsonl'):.3f} s | {card}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = infer(out_dir, "prof.jsonl")
    # kernels only: an operator's row repeats the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    log(f"  run_inference of {BATCH} questions under the profiler: wall {wall:.3f} s, device kernel time {total:.1f} ms "
        f"| {card}")
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    groups = {"GEMM kernels (nvjet, cutlass, gemv)": ("nvjet", "cutlass", "gemm", "gemv"),
              "K1 zt::flash_segment": ("zt::flash_segment",), "K2 zt::flash_causal": ("zt::flash_causal",),
              "K3 zt::flash_decode_split + zt::split_merge": ("zt::flash_decode", "zt::split_merge")}
    for label, keys in groups.items():
        hit = [(ms, n) for key, ms, n in rows if any(k in key for k in keys)]
        ms, n = sum(m for m, _ in hit), sum(c for _, c in hit)
        log(f"    {ms:9.1f} ms {100 * ms / total:5.1f} % {n:7d} calls {1e3 * ms / max(n, 1):9.1f} us  {label}")
    rest = [r for r in rows if not any(k in r[0] for keys in groups.values() for k in keys)]
    ms, n = sum(r[1] for r in rest), sum(r[2] for r in rest)
    log(f"    {ms:9.1f} ms {100 * ms / total:5.1f} % {n:7d} calls {1e3 * ms / max(n, 1):9.1f} us  every other kernel "
        f"(elementwise, copies, reductions, indexing)")
    log("  kernels with at least 1 % of the device time, and every kernel of this repository:")
    for key, ms, count in sorted(rows, key=lambda r: -r[1]):
        if ms >= 0.01 * total or "zt::" in key:
            log(f"    {ms:9.1f} ms {100 * ms / total:5.1f} % {count:7d} calls {1e3 * ms / count:9.1f} us  {key[:100]}")


def check_k4_edges():
    """K4 against its plain version and against K3 on the same k/v, untimed, where the
    split pass meets pages: pages of 16 (a 32-slot tile crosses them), 64 and 256; rows
    of length 0 (K4 gives 0 and reads nothing), 1, either side of a split and of a page
    boundary, capacity and past it; block-table entries past each row's pages set to
    ids far outside the pool (a read of one would fault); bf16 D=128 (tol 2e-2) and
    fp32 D=32 (tol 1e-4: fp32 sums in another order). Returns the checks."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, Hkv = 8, 16, 2
    checks = []
    for page in (16, 64, 256):
        for dtype, D, tol in ((torch.bfloat16, 128, TOL_BF16), (torch.float32, 32, 1e-4)):
            T = max(4 * page, 256)
            split = K3.split_plan(B, Hkv, T)[0]
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
            kpool, vpool, bt = PT.to_pages(k, v, page, np.random.default_rng(6))
            lens = torch.tensor([0, 1, split - 1, split + 1, page - 1, page + 1, T, T + 9], device=dev)
            tail = torch.arange(T // page, device=dev)[None] >= K4.page_counts(lens.clamp(max=T), page)[:, None]
            bt = torch.where(tail, torch.full_like(bt, 2**30), bt)
            out = K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=page)
            label = f"K4 page {page} {str(dtype).split('.')[1]} D={D} T={T} (split {split}), lengths {lens.tolist()}"
            checks.append(edge_check(label, out, K4.paged_decode_attention_plain(q, kpool, vpool, bt, lens,
                                                                                 page_size=page), tol))
            checks.append(edge_check(label + " vs K3 on the same k/v, rows with a live slot", out[1:],
                                     K3.decode_attention_cuda(q, k, v, lens)[1:], tol))
            if bool(out[0].any()):
                raise AssertionError(f"{label}: a row with no live slot must give 0")
    return checks


def check_p1_edges():
    """P1 against its plain version, untimed, where its tiling has edges: row blocks of
    4, 2 and 1 rows, chunks of 512 and chunks under 64 (the first 64 flattened rows
    then span several kv heads and rows), row blocks that are no whole number of
    tiles, bf16 and fp32. out to one step of its dtype (fp32 sums in another order,
    one rounding), sums to 1e-6 of the summed magnitudes (atomics in any order).
    Returns the checks."""
    import torch

    from zoomearth_tpu_torch.scripts import probe_attn as PA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    checks = []
    for B, H, Hkv, D, T, chunk, rb in ((8, 16, 2, 128, 1536, 512, 4), (6, 16, 2, 128, 1024, 512, 2),
                                       (3, 16, 2, 64, 1536, 512, 1), (4, 8, 2, 32, 96, 16, 2),
                                       (4, 4, 1, 16, 200, 40, 4), (5, 16, 2, 64, 96, 8, 1)):
        for dtype, step in ((torch.bfloat16, 2.0**-7), (torch.float32, 1e-6)):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, 1, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
            (out, sums), (ref, ref_sums) = (fn(q, k, v, chunk=chunk, rb=rb)
                                            for fn in (PA.stream_only_cuda, PA.stream_only_plain))
            torch.cuda.synchronize()
            step_ok = bool(((out.float() - ref.float()).abs() <= step * ref.float().abs() + 1e-5).all())
            mass = (k.double().abs() + v.double().abs()).reshape(B // rb, -1).sum(1)
            sum_err = ((sums.double() - ref_sums.double()).abs() / mass).max().item()
            label = f"P1 B={B} H={H} Hkv={Hkv} D={D} T={T} chunk {chunk} rb {rb} {str(dtype).split('.')[1]}"
            log(f"  {label}: out max_abs_err {max_err(out, ref):.3e} (tol one step, {step:.1e} of the value), sums "
                f"{sum_err:.3e} of the summed magnitudes (tol 1e-6), untimed")
            if not (step_ok and sum_err <= 1e-6):
                raise AssertionError(f"{label}: P1 disagrees with its plain version")
            checks.append({"case": label, "max_abs_err": max_err(out, ref), "sum_err_over_mass": sum_err,
                           "tol": f"{step:.1e} of the value; sum 1e-6 of the summed magnitudes"})
    return checks


def cell_label(B, T, live):
    return f"B={B} T={T} {int(live * 100)}% live"


def check_decode_variants():
    """K4, P1 and P2 against their plain versions, K4 also against K3 and P2 against
    fp32 decode attention, on the entry points' own inputs. Returns {kernel name:
    {case: checks}}, the cases named as the entry points name them."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT
    from zoomearth_tpu_torch.scripts import probe_attn as PA

    err = max_err
    dev = torch.device("cuda")
    checks = {"paged_decode_attention": {}, "stream_only": {}, "bigmm_decode_attention": {}}
    for B, T, live in PT.CELLS:
        rng = np.random.default_rng(PT.SEED)  # as measure_cell draws them
        q, k, v, lens = PT.cell_inputs(rng, B, T, live, dev)
        k3 = K3.decode_attention_cuda(q, k, v, lens)[:, 0]
        for page in PT.PAGES:
            kpool, vpool, bt = PT.to_pages(k, v, page, rng)
            out = K4.paged_decode_cuda(q[:, 0], kpool, vpool, bt, lens, page_size=page)
            ref = K4.paged_decode_attention_plain(q[:, 0], kpool, vpool, bt, lens, page_size=page)
            c = {"max_abs_err": err(out, ref), "max_abs_err_vs_k3": err(out, k3), "tol": TOL_BF16}
            log(f"  {cell_label(B, T, live)} K4 paged[{page}]: vs its plain version {c['max_abs_err']:.3e}, vs K3 "
                f"on the same k/v {c['max_abs_err_vs_k3']:.3e} (tol {TOL_BF16})")
            assert max(c["max_abs_err"], c["max_abs_err_vs_k3"]) <= TOL_BF16, "K4 disagrees"
            assert bool(torch.isfinite(out.float()).all()), "K4 gave non-finite values"
            checks["paged_decode_attention"][f"{cell_label(B, T, live)} K4 paged[{page}]"] = c
        del k, v, kpool, vpool

    q, k, v, lens = PA.probe_inputs(dev)
    full = torch.full_like(lens, k.shape[2])
    (o, s), (r, rs) = PA.stream_only_cuda(q, k, v, full), PA.stream_only_plain(q, k, v, full)
    # fp32 sums in another order, then one bf16 rounding: one bf16 step (2^-7 of the
    # value) apart at most; the element sum to 1e-6 of the summed magnitudes
    step_ok = bool(((o.float() - r.float()).abs() <= 2.0**-7 * r.float().abs() + 1e-5).all())
    mass = (k.double().abs() + v.double().abs()).reshape(rs.shape[0], -1).sum(1)
    sum_err = ((s.double() - rs.double()).abs() / mass).max().item()
    checks["stream_only"]["P1 stream_only (copy floor) len=T"] = {
        "max_abs_err": err(o, r), "sum_err_over_mass": sum_err,
        "tol": "2^-7 of the value; sum 1e-6 of the summed magnitudes"}
    log(f"  P1: out vs its plain version {err(o, r):.3e} (tol one bf16 step, 2^-7 of the value), sum {sum_err:.3e} "
        f"of the summed magnitudes (tol 1e-6)")
    assert step_ok and sum_err <= 1e-6, "P1 disagrees with its plain version"
    for label, ln in (("len600-1200", lens), ("len=T", full)):
        out = PA.bigmm_decode_cuda(q, k, v, ln, chunk=PA.CHUNK)
        c = {"max_abs_err": err(out, PA.bigmm_decode_attention_plain(q, k, v, ln, chunk=PA.CHUNK)),
             "max_abs_err_vs_decode_attention": err(out, K3.flash_decode_attention_plain(q, k, v, ln)),
             "tol": TOL_BF16}
        log(f"  P2 {label}: vs its plain version {c['max_abs_err']:.3e}, vs fp32 decode attention "
            f"{c['max_abs_err_vs_decode_attention']:.3e} (tol {TOL_BF16})")
        assert max(c["max_abs_err"], c["max_abs_err_vs_decode_attention"]) <= TOL_BF16, "P2 disagrees"
        assert bool(torch.isfinite(out.float()).all()), "P2 gave non-finite values"
        checks["bigmm_decode_attention"][f"P2 bigmm512 {label}"] = c
    return checks


def run_decode_variants(card, checks):
    """The decode-attention entry points as a user runs them (probe_attn.measure,
    paged_256_test.measure_cell at both cells) and a paged decode loop, with the
    launch counts set to 0 just before and read just after. Their in-turns times of
    K4, P1 and P2 beside their plain versions, with `checks`, make the kernels-line
    rows; returns (rows as check_kernels returns them, launches by kernel name)."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT
    from zoomearth_tpu_torch.scripts import probe_attn as PA
    from zoomearth_tpu_torch.scripts.timing import PLAIN

    wrappers = {"paged_decode_attention": K4.paged_decode_cuda, "stream_only": PA.stream_only_cuda,
                "bigmm_decode_attention": PA.bigmm_decode_cuda}
    for w in wrappers.values():
        w.launches = 0
    q, k, v, lens = PA.probe_inputs(torch.device("cuda"))
    B, H, Hkv, D, T = PA.SHAPE
    full = torch.full_like(lens, T)
    slot = torch.arange(T, device=lens.device)
    work = {"P1 stream_only (copy floor) len=T": PA.stream_work(q, k)}
    library = []  # P2's yardstick: one SDPA call with a length mask, timed in the entry point's own turns
    for label, ln in (("len600-1200", lens), ("len=T", full)):
        mask = (slot[None] < ln[:, None])[:, None, None]
        fn = lambda mask=mask: sdpa(q.transpose(1, 2), k, v, mask).transpose(1, 2)  # noqa: E731
        lib_err = max_err(fn(), K3.flash_decode_attention_plain(q, k, v, ln))
        log(f"  P2 bigmm512 {label}: library call vs fp32 decode attention max_abs_err {lib_err:.3e} (tol {TOL_BF16}); "
            f"SDPA backends that take it: {sdpa_backends(fn)}")
        assert lib_err <= TOL_BF16, "P2's library yardstick disagrees with decode attention"
        library.append((f"P2 bigmm512 {label}{LIBRARY}", fn, None))
        work[f"P2 bigmm512 {label}"] = PA.bigmm_work(ln, T, H, Hkv, D)
    times = PA.measure(q, k, v, lens, library)
    del q, k, v, library, fn, mask  # the probe's tensors, before the paged cells allocate theirs
    for name, (ms, dev, gbs) in times.items():
        rate = f", {gbs:.1f} GB/s of cache {'walked' if name.startswith('P2') else 'read'}" if gbs else ""
        log(f"  probe_attn {name}: {ms:.4f} ms/call, {ms * PA.LAYERS:.2f} ms/{PA.LAYERS}-layer | device "
            f"{dev:.4f} ms/call, {dev * PA.LAYERS:.2f} ms/{PA.LAYERS}-layer{rate} | L2 cold | {card}")
    for B, T, live in PT.CELLS:
        cell_lens = torch.from_numpy(PT.cell_lengths(np.random.default_rng(PT.SEED), B, T, live))  # measure_cell's
        for page in PT.PAGES:
            work[f"{cell_label(B, T, live)} K4 paged[{page}]"] = K4.work(
                cell_lens, torch.empty((B, T // page), dtype=torch.int32), page, PT.H, PT.HKV, PT.D, 2)
        cell, err = PT.measure_cell(B, T, live)
        log(f"  paged_256_test {cell_label(B, T, live)}: K4 vs K3 max_abs_err {err:.3e}")
        for name, (ms, dev, gbs) in cell.items():
            rate = f", {gbs:.1f} GB/s of live cache read" if gbs else ""
            log(f"    {name}: {ms * PT.LAYERS:.3f} ms/{PT.LAYERS}-layer step ({ms:.4f} ms/call) | device "
                f"{dev * PT.LAYERS:.3f} ms/{PT.LAYERS}-layer step ({dev:.4f} ms/call{rate}) | L2 cold | {card}")
            times[f"{cell_label(B, T, live)} {name}"] = (ms, dev, gbs)
    err, unchanged, same = PT.decode_loop(torch.device("cuda"))
    log(f"  paged decode loop: K4 vs K3 max_abs_err {err:.3e} (tol {TOL_BF16}); full row's pages unchanged: "
        f"{unchanged}; pools equal the contiguous cache on live slots: {same}")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"  decode-variants launches (eager; graph replays run the kernels without the wrappers): {launches}")
    assert unchanged and same and err <= TOL_BF16, "paged decode loop failed"
    assert all(n > 0 for n in launches.values()), f"decode-variant kernels not launched: {launches}"

    log("  each kernel case against its plain version, from the runs above:")
    sources = {"paged_decode_attention": ("zoomearth_tpu_torch/csrc/paged_decode.cu",
                                          "zoomearth_tpu/ops/paged_attention.py:95"),
               "stream_only": ("zoomearth_tpu_torch/csrc/probe_stream.cu", "scripts/probe_attn.py:43"),
               "bigmm_decode_attention": ("zoomearth_tpu_torch/csrc/probe_bigmm.cu", "scripts/probe_attn.py:124")}
    rows = {}
    for name, cases in checks.items():
        rows[name] = (*sources[name], [
            timing_row(label, check, times[label][:2], times[label + PLAIN][:2], card, work[label],
                       times[label + LIBRARY][:2] if label + LIBRARY in times else None, times[label][2])
            for label, check in cases.items()])
    gbs = rows["stream_only"][2][0]["gb_per_s_device"]
    if not gbs < 1000 * PA.HBM_TBPS:
        raise AssertionError(f"P1 reports {gbs:.1f} GB/s, above the card's {PA.HBM_TBPS} TB/s: its loads were removed")
    return rows, launches


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from zoomearth_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.time()
    path = _cuda.build()
    _cuda.lib()
    log(f"[build] {path.name} in {time.time() - t0:.1f} s (nvcc sm_90a)")
    ptxas = open(str(path) + ".log").read() if os.path.exists(str(path) + ".log") else ""
    spills = [ln.strip() for ln in ptxas.splitlines()
              if "spill stores" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"  ptxas: {len(spills)} kernel instantiations with spills" + (f", e.g. {spills[0]}" if spills else ""))
    if "--profile" in argv:
        log("[profile] Qwen2.5-VL-3B bf16, one batch of 8 after a warm-up batch")
        profile_slice(card)
        return 0

    log("[kernels] bf16, main-path shapes, kernel vs plain version, timed in turns")
    rows, untimed = check_kernels(card)
    log("[parity] tiny config: fp32 card kernels vs CPU plain path, bf16 card kernels vs plain versions on the card")
    check_tiny_parity()
    log("[slice] Qwen2.5-VL-3B bf16, run_inference + run_episodes(reuse_cache=True)")
    launches = run_slice(card)
    log("[decode-variants] K4 / P1 / P2 checked at the reference's shapes and at their edges, then the entry "
        "points' runs")
    checks = check_decode_variants()
    untimed.update({"paged_decode_attention": check_k4_edges(), "stream_only": check_p1_edges()})
    variant_rows, variant_launches = run_decode_variants(card, checks)
    rows.update(variant_rows)
    launches.update(variant_launches)

    kernels = []
    for name, (source, replaces, cases) in rows.items():
        checks = untimed.get(name, [])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(c["max_abs_err"] for c in cases + checks),
            **{key: cases[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                                              "library_device_ms", "share_of_bound")},
            "cases": cases,
            **({"untimed_checks": checks} if checks else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
