"""Port kernel modules (K1 segment, K2 causal, K3 decode) and the plain attention ops
against the JAX package on the CPU; the tensor-core variants' launch prep, their
arithmetic (emulated tile by tile in torch) and every kernel's `work` count.

Each kernel module's plain torch version is held against the JAX Pallas kernel run
in interpret mode, on the cases of the JAX package's own kernel tests, fp32 to
atol 5e-5 (the repo's parity bar). The launch-prep helpers are held against the
formulas of the JAX wrappers. On the CPU every dispatcher takes the plain version
and launches nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models.vit import vision_metadata as jax_vision_metadata
from zoomearth_tpu.ops import attention as JA
from zoomearth_tpu.ops.flash_attention import flash_segment_attention as jax_flash_segment
from zoomearth_tpu.ops.flash_causal import flash_causal_attention as jax_flash_causal
from zoomearth_tpu.ops.flash_decode import flash_decode_attention as jax_flash_decode
from zoomearth_tpu.ops.sampling import _top_p_filter as jax_top_p_filter
from zoomearth_tpu_torch.ops import _cuda
from zoomearth_tpu_torch.ops import attention as TA
from zoomearth_tpu_torch.ops import flash_attention as K1
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_decode as K3
from zoomearth_tpu_torch.ops import paged_attention as K4
from zoomearth_tpu_torch.ops.sampling import greedy, sample, top_p_filter

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
ATOL = 5e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# K1: segment attention
# ---------------------------------------------------------------------------

def _seg_case(name):
    if name == "single":
        return 64, 4, 16, np.zeros(64, np.int32), (32, 32)
    if name == "windows":
        meta = jax_vision_metadata([(1, 8, 8), (1, 4, 8)], CFG.vision)
        return meta.seg_window.shape[0], 2, 8, meta.seg_window.astype(np.int32), (32, 32)
    if name == "full_multi_image":
        meta = jax_vision_metadata([(1, 8, 8), (1, 4, 8)], CFG.vision)
        return meta.seg_full.shape[0], 2, 8, meta.seg_full.astype(np.int32), (32, 64)
    if name == "padded_bucket":
        meta = jax_vision_metadata([(1, 6, 6)], CFG.vision, pad_to=64)
        return 64, 2, 8, meta.seg_window.astype(np.int32), (32, 32)
    if name == "non_multiple":
        return 80, 2, 8, np.repeat(np.arange(5), 16).astype(np.int32), (32, 32)
    if name == "vit_head_dim_80":
        seg = np.concatenate([np.repeat(np.arange(3), [70, 50, 90]), np.full(46, 2**30)])
        return 256, 2, 80, seg.astype(np.int32), (64, 64)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["single", "windows", "full_multi_image", "padded_bucket",
                                  "non_multiple", "vit_head_dim_80"])
def test_k1_plain_matches_jax_kernel(case):
    S, H, D, seg, (bq, bkv) = _seg_case(case)
    q, k, v = (_rand((S, H, D), s) for s in (1, 2, 3))
    ref = np.asarray(jax_flash_segment(q, k, v, seg, block_q=bq, block_kv=bkv, interpret=True))
    out = K1.flash_segment_attention(_t(q), _t(k), _t(v), _t(seg)).numpy()
    real = seg != 2**30  # pad rows are garbage by contract
    np.testing.assert_allclose(out[real], ref[real], atol=ATOL, rtol=1e-4)


def test_k1_plain_ignores_other_segments():
    """Poisoning every other segment's k/v must not reach segment 0's rows."""
    S = 128
    q, k, v = (_rand((S, 1, 8), s) for s in (5, 6, 7))
    seg = np.repeat(np.arange(4), 32).astype(np.int32)
    k[32:] = 1e4
    v[32:] = -1e4
    clean = K1.flash_segment_attention(_t(q[:32]), _t(k[:32]), _t(v[:32]), _t(seg[:32]))
    out = K1.flash_segment_attention(_t(q), _t(k), _t(v), _t(seg))
    np.testing.assert_allclose(out[:32].numpy(), clean.numpy(), atol=1e-6)


@pytest.mark.parametrize("block", [K1.BLOCK_Q_FMA, K1.BLOCK_Q])
@pytest.mark.parametrize("grids,pad_to", [([(1, 8, 8), (1, 4, 8)], 0), ([(1, 6, 6)], 64),
                                          ([(1, 36, 36)] * 2, 0), ([(1, 10, 14)], 256)])
def test_k1_kv_ranges_match_jax_wrapper_formula(grids, pad_to, block):
    """segment_kv_ranges (row units) against the JAX wrapper's block-range formula
    (flash_attention.py:117-133: pad to a whole number of blocks with PAD_SEG, then two
    searchsorteds) for block_q = block_kv = 64 (the fp32 variant) and 128 (the
    tensor-core variant)."""
    meta = jax_vision_metadata(grids, CFG.vision, pad_to=pad_to)
    for seg in (meta.seg_window, meta.seg_full):
        seg = seg.astype(np.int32)
        S = seg.shape[0]
        n_q = -(-S // block)
        padded = np.concatenate([seg, np.full(n_q * block - S, K1.PAD_SEG, np.int32)])
        qb = jnp.asarray(padded).reshape(n_q, block)
        first = np.asarray(jnp.searchsorted(padded, qb.min(axis=1), side="left"))
        last = np.asarray(jnp.searchsorted(padded, qb.max(axis=1), side="right"))
        starts = first // block
        ends = np.minimum(-(-last // block), n_q)
        f, l = K1.segment_kv_ranges(_t(seg), block)
        np.testing.assert_array_equal(f.numpy(), first)
        # the wrapper's pad rows extend the last block's range past S; the port has no pad rows
        np.testing.assert_array_equal(l.numpy(), np.minimum(last, S))
        np.testing.assert_array_equal(f.numpy() // block, starts)
        np.testing.assert_array_equal(np.minimum(-(-l.numpy() // block), n_q), ends)


# ---------------------------------------------------------------------------
# The tensor-core variants of K1 and K2 (csrc/flash_mma.cuh), emulated on the CPU:
# the same tiles, the same base-2 online softmax with 0 as the reference of a row that
# has seen no live key, P rounded to bf16 before P @ V, the mask only on the tiles the
# launch prep says need it, int8 scales on the fp32 accumulator.
# ---------------------------------------------------------------------------

TOL_BF16 = 2e-2  # bf16 roundings of outputs below 2 (inputs' products, P, the output)
LOG2E = 1.4426950408889634


def _emulate_flash_mma(q, k, v, live, lo, hi, needs_mask, ks=None, vs=None, tile=64):
    """q (R, D) bf16; k/v (T, D) bf16 or int8; live (R, T) bool; the key range
    [lo, hi) in tiles of `tile`, rows past hi read as zeros; needs_mask(t0) -> bool."""
    R, D = q.shape
    neg = torch.tensor(TA.NEG_INF)
    m, l, o = torch.full((R,), TA.NEG_INF), torch.zeros(R), torch.zeros(R, D)
    qf = q.float()
    for t0 in range(lo, hi, tile):
        n = min(tile, hi - t0)
        kt, vt = torch.zeros(tile, D), torch.zeros(tile, D)
        kt[:n], vt[:n] = k[t0:t0 + n].float(), v[t0:t0 + n].float()  # int8 widens to bf16 exactly
        s = (qf @ kt.T) * (D**-0.5 * LOG2E)
        if ks is not None:
            s[:, :n] *= ks[t0:t0 + n]
            s[:, n:] = 0.0
        if needs_mask(t0):
            ok = torch.zeros(R, tile, dtype=torch.bool)
            ok[:, :n] = live[:, t0:t0 + n]
            s = torch.where(ok, s, neg)
        else:
            assert n == tile and bool(live[:, t0:t0 + n].all()), "an unmasked tile must be live throughout"
        m_new = torch.maximum(m, s.amax(1))
        ref = torch.where(m_new > 0.5 * TA.NEG_INF, m_new, torch.zeros(()))
        alpha = torch.exp2(m - ref)
        p = torch.exp2(s - ref[:, None])
        l = l * alpha + p.sum(1)
        if vs is not None:
            p[:, :n] *= vs[t0:t0 + n]
        o = o * alpha[:, None] + p.bfloat16().float() @ vt
        m = m_new
    return (o / l.clamp_min(1e-30)[:, None]).bfloat16()


def _emulate_k2(q, k, v, positions, kv_len, ks=None, vs=None):
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    bq = K2.ROWS // G
    hi, full = K2.block_key_bounds(positions, kv_len, T, bq)
    out = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    slot = torch.arange(T)
    masked_tiles = 0
    for b in range(B):
        for blk in range(hi.shape[1]):
            rows = range(blk * bq, min((blk + 1) * bq, S))
            live_s = (slot[None] <= positions[b, rows.start:rows.stop, None]) & (slot[None] < kv_len[b])
            for kh in range(Hkv):
                qb = q[b, rows.start:rows.stop, kh * G:(kh + 1) * G].transpose(0, 1).reshape(-1, D)  # row = g * n + s

                def needs(t0, b=b, blk=blk):
                    nonlocal masked_tiles
                    r = K2.tile_needs_mask(t0, int(full[b, blk]))
                    masked_tiles += r
                    return r

                o = _emulate_flash_mma(qb, k[b, kh], v[b, kh], live_s.repeat(G, 1), 0, int(hi[b, blk]), needs,
                                       None if ks is None else ks[b, kh], None if vs is None else vs[b, kh])
                out[b, rows.start:rows.stop, kh * G:(kh + 1) * G] = o.reshape(G, len(rows), D).transpose(0, 1)
    return out, masked_tiles


def _k2_expected(q, k, v, positions, kv_len, ks=None, vs=None):
    """The plain version, with 0 for a row that has no live key (the kernels' answer;
    the plain softmax over equal masked logits gives the mean of v there)."""
    ref = K2.flash_causal_attention_plain(q, k, v, positions, kv_len, ks, vs)
    dead = torch.minimum(positions + 1, kv_len[:, None]) <= 0
    return torch.where(dead[:, :, None, None], torch.zeros_like(ref), ref)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G,D", [(8, 32), (2, 16)])
def test_k2_tensor_core_arithmetic_matches_plain(G, D, quant):
    """Rows either side of a tile boundary, kv_len 0, S no multiple of the block's
    positions, pad rows past kv_len in no order: the emulated kernel against the plain
    version in bf16, and whole tiles below every row's position skip the compare."""
    rng = np.random.default_rng(G + D)
    B, S, Hkv, T = 5, 40, 2, 300
    H = G * Hkv
    ar = np.arange(S)
    pad_pos = np.concatenate([100 + ar[:20], rng.integers(0, T, 20)])
    positions = torch.from_numpy(np.stack([ar, 24 + ar, 25 + ar, 87 + ar, pad_pos]).astype(np.int32))
    kv_len = torch.tensor([0, 64, 65, 127, 120], dtype=torch.int32)
    q = _t(_rand((B, S, H, D), 60)).bfloat16()
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.025, (B, Hkv, T)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.025, (B, Hkv, T)).astype(np.float32))
    else:
        k, v, ks, vs = _t(_rand((B, Hkv, T, D), 61)).bfloat16(), _t(_rand((B, Hkv, T, D), 62)).bfloat16(), None, None
    out, masked = _emulate_k2(q, k, v, positions, kv_len, ks, vs)
    ref = _k2_expected(q, k, v, positions, kv_len, ks, vs)
    assert float((out.float() - ref.float()).abs().max()) <= TOL_BF16
    assert not bool(out[0].any())  # kv_len 0: no live key, 0
    total = sum(-(-int(h) // K2.TILE) for h in K2.block_key_bounds(positions, kv_len, T, K2.ROWS // G)[0].flatten()) * Hkv
    assert 0 < masked < total  # some tiles take the compare, some skip it


@pytest.mark.parametrize("bq", [16, 64])
def test_k2_block_key_bounds_match_brute_force(bq):
    rng = np.random.default_rng(bq)
    B, S, T = 4, 70, 200
    positions = torch.from_numpy(rng.integers(-1, T + 30, (B, S)).astype(np.int32))
    kv_len = torch.tensor([0, 57, T, T + 9], dtype=torch.int32)
    hi, full = K2.block_key_bounds(positions, kv_len, T, bq)
    assert hi.shape == full.shape == (B, -(-S // bq))
    for b in range(B):
        klen = min(max(int(kv_len[b]), 0), T)
        for blk in range(hi.shape[1]):
            pos = positions[b, blk * bq:(blk + 1) * bq].tolist()
            live = np.array([[t <= p and t < klen for t in range(T)] for p in pos])
            walked = np.flatnonzero(live.any(0))
            assert int(hi[b, blk]) == (walked[-1] + 1 if walked.size else 0)
            dense = np.flatnonzero(~live.all(0))
            assert int(full[b, blk]) == (dense[0] if dense.size else T)
            for t0 in range(0, int(hi[b, blk]), K2.TILE):
                whole = t0 + K2.TILE <= T and bool(live[:, t0:t0 + K2.TILE].all())
                assert K2.tile_needs_mask(t0, int(full[b, blk])) == (not whole)


def _emulate_k1(q, k, v, seg):
    S, H, D = q.shape
    first, last = K1.segment_kv_ranges(seg, K1.BLOCK_Q)
    out = torch.zeros(S, H, D, dtype=torch.bfloat16)
    masked = total = 0
    for blk in range(first.shape[0]):
        s0, s1 = blk * K1.BLOCK_Q, min((blk + 1) * K1.BLOCK_Q, S)
        live = seg[s0:s1, None] == seg[None, :]
        lo, hi = int(first[blk]), int(last[blk])
        for h in range(H):
            def needs(t0, s0=s0, hi=hi):
                nonlocal masked, total
                r = K1.tile_needs_mask(seg, s0, t0, hi)
                masked, total = masked + r, total + 1
                return r

            out[s0:s1, h] = _emulate_flash_mma(q[s0:s1, h], k[:, h], v[:, h], live, lo, hi, needs)
    return out, masked, total


@pytest.mark.parametrize("runs,pad,all_masked", [
    ([64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40], 37, True),  # windows of 16-64 rows: every tile compares
    ([40, 500, 64, 24], 13, False),  # one long segment: its inner tiles skip the compare
    ([100, 91], 0, False),  # a boundary inside a tile, no pad
])
def test_k1_tensor_core_arithmetic_matches_plain(runs, pad, all_masked):
    S, H, D = sum(runs) + pad, 2, 80
    assert S % K1.BLOCK_Q
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                    + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)])
    q, k, v = (_t(_rand((S, H, D), s)).bfloat16() for s in (70, 71, 72))
    out, masked, total = _emulate_k1(q, k, v, seg)
    ref = K1.flash_segment_attention_plain(q, k, v, seg)
    assert float((out.float() - ref.float()).abs().max()) <= TOL_BF16
    assert (masked == total) if all_masked else (0 < masked < total)


def test_k1_work_matches_brute_force():
    seg = torch.tensor([0] * 5 + [1] * 3 + [4] * 7 + [K1.PAD_SEG] * 2, dtype=torch.int32)
    H, D = 3, 16
    pairs = int((seg[:, None] == seg[None, :]).sum())
    assert pairs == 25 + 9 + 49 + 4
    assert K1.work(seg, H, D, 2) == (4 * D * H * pairs, 4 * seg.shape[0] * H * D * 2)


@pytest.mark.parametrize("kv_itemsize", [2, 1])
def test_k2_work_matches_brute_force(kv_itemsize):
    rng = np.random.default_rng(3)
    B, S, T, H, Hkv, D = 3, 9, 40, 4, 2, 16
    positions = torch.from_numpy(rng.integers(-1, T + 5, (B, S)).astype(np.int32))
    kv_len = torch.tensor([0, 17, T + 3], dtype=torch.int32)
    pairs = rows = 0
    for b in range(B):
        klen = min(int(kv_len[b]), T)
        live = np.array([[t <= int(p) and t < klen for t in range(T)] for p in positions[b]])
        pairs += int(live.sum())
        rows += int(live.any(0).sum())
    flops, nbytes = K2.work(positions, kv_len, H, Hkv, D, T, 2, kv_itemsize)
    assert flops == 4 * D * H * pairs
    scales = 2 * rows * Hkv * 4 if kv_itemsize == 1 else 0
    assert nbytes == 2 * B * S * H * D * 2 + 2 * rows * Hkv * D * kv_itemsize + scales


def test_decode_kernels_work_counts_live_slots():
    kv_len = torch.tensor([-3, 0, 1, 100, 5000], dtype=torch.int32)
    T, H, Hkv, D = 256, 16, 2, 128
    live = 0 + 0 + 1 + 100 + 256
    assert K3.work(kv_len, T, H, Hkv, D, 2) == (4 * D * H * live, 2 * live * Hkv * D * 2 + 2 * 5 * H * D * 2)
    assert K3.work(kv_len, T, H, Hkv, D, 1) == (4 * D * H * live,
                                                 2 * live * Hkv * D + 2 * live * Hkv * 4 + 2 * 5 * H * D * 2)
    bt = torch.zeros((5, 4), dtype=torch.int32)  # capacity 4 pages of 64 = 256 slots
    pages = 0 + 0 + 1 + 2 + 4
    assert K4.work(kv_len, bt, 64, H, Hkv, D, 2) == (4 * D * H * live,
                                                      2 * live * Hkv * D * 2 + 4 * pages + 2 * 5 * H * D * 2)


def test_tensor_core_variants_refuse_misaligned_views():
    """The 16-byte cp.async copies need 16-byte bases, rows and strides: the check the
    wrappers run before a launch, on the views the model makes and on ones it does not."""
    qkv = torch.zeros(32, 3, 16, 80, dtype=torch.bfloat16)
    _cuda.require_aligned16("k1", qkv[:, 0], qkv[:, 1], qkv[:, 2])  # the ViT's fused-qkv views
    cache = torch.zeros(2, 2, 64, 128, dtype=torch.bfloat16)
    _cuda.require_aligned16("k2", cache, cache[:, :, :40], torch.zeros(2, 40, 2, 128, dtype=torch.bfloat16).transpose(1, 2))
    _cuda.require_aligned16("k2", torch.zeros(2, 2, 64, 128, dtype=torch.int8))
    for bad in (cache[..., 4:68],  # rows start 8 bytes in
                torch.zeros(2, 2, 64, 132, dtype=torch.bfloat16)[..., :128],  # 264-byte row stride
                torch.zeros(64, 2, 20, dtype=torch.bfloat16),  # 40-byte rows
                torch.zeros(2 * 2 * 64 * 128 + 4, dtype=torch.bfloat16)[4:].reshape(2, 2, 64, 128)):  # base 8 bytes in
        with pytest.raises(ValueError, match="16-byte"):
            _cuda.require_aligned16("k2", bad)


# ---------------------------------------------------------------------------
# K2: causal GQA
# ---------------------------------------------------------------------------

def _causal_inputs(B, S, T, H, Hkv, D, seed):
    q = _rand((B, S, H, D), seed)
    k = _rand((B, Hkv, T, D), seed + 1)
    v = _rand((B, Hkv, T, D), seed + 2)
    return q, k, v


@pytest.mark.parametrize("B,S,T,H,Hkv,D,starts,kv_len", [
    (2, 64, 64, 4, 2, 16, (0, 0), (64, 64)),  # self-attention, square
    (1, 64, 64, 4, 4, 16, (0,), (64,)),  # MHA
    (2, 32, 128, 4, 2, 16, (40, 70), (72, 102)),  # chunk prefill into a cache
    (2, 64, 64, 4, 2, 16, (0, 0), (64, 40)),  # ragged kv_len
    (1, 80, 80, 4, 2, 16, (0,), (80,)),  # S not a block multiple
    (2, 48, 1280, 16, 2, 128, (700, 1100), (748, 1148)),  # 3B head shape, T = 1280
])
def test_k2_plain_matches_jax_kernel(B, S, T, H, Hkv, D, starts, kv_len):
    q, k, v = _causal_inputs(B, S, T, H, Hkv, D, seed=B + S)
    positions = (np.asarray(starts)[:, None] + np.arange(S)[None]).astype(np.int32)
    kv_len = np.asarray(kv_len, np.int32)
    ref = np.asarray(jax_flash_causal(q, k, v, positions, kv_len, block_q=32, block_kv=32,
                                      interpret=True))
    out = K2.flash_causal_attention(_t(q), _t(k), _t(v), _t(positions), _t(kv_len)).numpy()
    for b in range(B):  # rows whose position lies inside kv_len are meaningful
        n = int(np.sum(positions[b] < kv_len[b]))
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=ATOL, rtol=1e-4)


def _quantize_per_token(x):
    amax = np.abs(x).max(axis=-1)
    scale = np.maximum(amax, 1e-6) / 127.0
    q = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


@pytest.mark.parametrize("S,T", [(64, 64), (32, 200)])
def test_k2_plain_int8_matches_jax_kernel(S, T):
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v = _causal_inputs(B, S, T, H, Hkv, D, seed=7)
    k8, ks = _quantize_per_token(k)
    v8, vs = _quantize_per_token(v)
    # the JAX kernel streams bf16 scales: hand both sides the same bf16-rounded ones
    ks = np.asarray(jnp.asarray(ks).astype(jnp.bfloat16).astype(jnp.float32))
    vs = np.asarray(jnp.asarray(vs).astype(jnp.bfloat16).astype(jnp.float32))
    starts = np.array([T - S, T - S // 2], np.int32)
    positions = (starts[:, None] + np.arange(S)[None]).astype(np.int32)
    kv_len = np.minimum(starts + S, T).astype(np.int32)
    ref = np.asarray(jax_flash_causal(q, k8, v8, positions, kv_len, ks=ks, vs=vs,
                                      block_q=32, block_kv=32, interpret=True))
    out = K2.flash_causal_attention(_t(q), _t(k8), _t(v8), _t(positions), _t(kv_len),
                                    _t(ks), _t(vs)).numpy()
    for b in range(B):
        n = int(min(kv_len[b] - starts[b], S))
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=ATOL, rtol=1e-4)


# ---------------------------------------------------------------------------
# K3: decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,D,T,chunk", [
    (4, 16, 2, 128, 1024, 256),  # 3B GQA shape
    (3, 8, 4, 128, 512, 128),
    (2, 8, 8, 128, 512, 256),  # MHA (G=1)
    (2, 4, 2, 64, 256, 128),
])
def test_k3_plain_matches_jax_kernel(B, H, Hkv, D, T, chunk):
    rng = np.random.default_rng(0)
    q = _rand((B, 1, H, D), 1)
    k = _rand((B, Hkv, T, D), 2)
    v = _rand((B, Hkv, T, D), 3)
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    ref = np.asarray(jax_flash_decode(q, k, v, lens, chunk=chunk, interpret=True))
    out = K3.flash_decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


def test_k3_plain_edge_lengths_and_3d_q():
    B, H, Hkv, D, T, chunk = 5, 4, 2, 64, 512, 128
    q = _rand((B, H, D), 4)
    k = _rand((B, Hkv, T, D), 5)
    v = _rand((B, Hkv, T, D), 6)
    lens = np.array([1, T, chunk, chunk + 1, chunk - 1], np.int32)
    ref = np.asarray(jax_flash_decode(q, k, v, lens, chunk=chunk, interpret=True))
    out = K3.flash_decode_attention(_t(q), _t(k), _t(v), _t(lens))
    assert out.shape == (B, H, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-4)


def test_k3_plain_garbage_beyond_length_ignored():
    B, H, Hkv, D, T = 2, 4, 2, 64, 256
    q = _rand((B, 1, H, D), 7)
    k = _rand((B, Hkv, T, D), 8)
    v = _rand((B, Hkv, T, D), 9)
    lens = np.array([100, 200], np.int32)
    out1 = K3.flash_decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 100:], v2[0, :, 100:] = 1e4, -1e4
    k2[1, :, 200:], v2[1, :, 200:] = 1e4, -1e4
    out2 = K3.flash_decode_attention(_t(q), _t(k2), _t(v2), _t(lens)).numpy()
    np.testing.assert_array_equal(out1, out2)
    ref = np.asarray(jax_flash_decode(q, k2, v2, lens, chunk=128, interpret=True))
    np.testing.assert_allclose(out2, ref, atol=ATOL, rtol=1e-4)


def test_k3_plain_int8_matches_jax_kernel():
    rng = np.random.default_rng(4)
    B, H, Hkv, D, T, chunk = 4, 16, 2, 128, 1024, 256
    q = _rand((B, 1, H, D), 10)
    k8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    ks = np.asarray(jnp.asarray(rng.uniform(0.005, 0.03, (B, Hkv, T)), jnp.float32)
                    .astype(jnp.bfloat16).astype(jnp.float32))
    vs = np.asarray(jnp.asarray(rng.uniform(0.005, 0.03, (B, Hkv, T)), jnp.float32)
                    .astype(jnp.bfloat16).astype(jnp.float32))
    lens = np.array([1, T, chunk + 3, T // 2], np.int32)
    ref = np.asarray(jax_flash_decode(q, k8, v8, lens, ks, vs, chunk=chunk, interpret=True))
    out = K3.flash_decode_attention(_t(q), _t(k8), _t(v8), _t(lens), _t(ks), _t(vs)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("T,attend", [(1280, 1280), (1280, 768), (700, 700)])
def test_k3_plain_any_T_and_prefix_view(T, attend):
    """T need not be a multiple of 512 (the TPU kernel's rule), and the decoder's
    [:, :, :attend_len] prefix view is read in place: held against the JAX XLA
    decode_attention on the same prefix."""
    B, H, Hkv, D = 3, 16, 2, 128
    q = _rand((B, 1, H, D), 11)
    k = _rand((B, Hkv, T, D), 12)
    v = _rand((B, Hkv, T, D), 13)
    lens = np.array([1, attend, attend // 2 + 1], np.int32)
    kt, vt = _t(k)[:, :, :attend], _t(v)[:, :, :attend]
    assert not kt.is_contiguous() or attend == T
    ref = np.asarray(JA.decode_attention(q, k[:, :, :attend], v[:, :, :attend], kv_len=lens))
    out = K3.flash_decode_attention(_t(q), kt, vt, _t(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


def test_k3_live_lengths_match_jax_wrapper_formula():
    """live_lengths is the JAX wrapper's clip (flash_decode.py:123); the kernel reads
    exactly those slots, so its live-chunk count per row is the wrapper's n_chunks."""
    T, chunk = 1024, 512
    kv_len = np.array([-3, 0, 1, 511, 512, 513, 1024, 5000], np.int32)
    ours = K3.live_lengths(_t(kv_len), T).numpy()
    ref = np.asarray(jnp.clip(jnp.asarray(kv_len), 0, T))
    np.testing.assert_array_equal(ours, ref)
    n_chunks = np.maximum((ref + chunk - 1) // chunk, 1)
    np.testing.assert_array_equal(np.maximum(-(-ours // chunk), 1), n_chunks)
    assert K3.read_bytes(_t(kv_len), T, 2, 128, 2) == int(ref.sum()) * 2 * 128 * 2 * 2


@pytest.mark.parametrize("pairs", [2, 16, 64])
@pytest.mark.parametrize("T", [1, 16, 300, 1280, 4096])
def test_k3_split_plan_covers_the_key_axis_exactly(T, pairs):
    """Splits of a whole number of tiles, the last one reaching T and none wholly past
    it: [0, T) is covered once."""
    split, n = K3.split_plan(pairs // 2, 2, T)
    assert split > 0 and split % K3.TILE == 0 and n >= 1
    assert (n - 1) * split < T <= n * split
    covered = np.zeros(T, np.int32)
    for s in range(n):
        covered[s * split:min((s + 1) * split, T)] += 1
    assert np.all(covered == 1)


def test_k3_split_plan_fills_the_card_on_the_main_path():
    """B = 8, Hkv = 2 at T = 1280: at least two blocks for each of the H100's 132 SMs."""
    split, n = K3.split_plan(8, 2, 1280)
    assert 16 * n >= 2 * 132


def _k3_two_phase(q, k, v, kv_len, split, ks=None, vs=None):
    m, l, acc, walked = K3.decode_partials_plain(_t(q), _t(k), _t(v), _t(kv_len), split,
                                                 None if ks is None else _t(ks), None if vs is None else _t(vs))
    B, _, H, D = q.shape
    return K3.merge_splits_plain(m, l, acc, walked).reshape(B, 1, H, D).numpy()


@pytest.mark.parametrize("H,D,T", [(4, 16, 300), (16, 128, 1000)])
def test_k3_split_pass_and_merge_match_decode_attention(H, D, T):
    """K3's two passes in plain fp32 (the per-split softmax states, then the split
    merge) give the JAX decoder's decode_attention, at kv_len 0 (the mean of v over
    all T slots), 1, a split boundary and either side of it, and T, with T not a
    multiple of the split length."""
    B, Hkv = 6, 2
    split = K3.split_plan(B, Hkv, T)[0]
    assert T % split
    q, k, v = _rand((B, 1, H, D), 40), _rand((B, Hkv, T, D), 41), _rand((B, Hkv, T, D), 42)
    lens = np.array([0, 1, split - 1, split, split + 1, T], np.int32)
    ref = np.asarray(JA.decode_attention(q, k, v, kv_len=lens))
    np.testing.assert_allclose(_k3_two_phase(q, k, v, lens, split), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ref[0, 0], np.repeat(v[0].mean(1), H // Hkv, axis=0), atol=1e-6)


def test_k3_split_pass_and_merge_match_decode_attention_int8():
    B, H, Hkv, D, T = 6, 16, 2, 64, 500
    rng = np.random.default_rng(43)
    split = K3.split_plan(B, Hkv, T)[0]
    q = _rand((B, 1, H, D), 44)
    k8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, (B, Hkv, T)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, (B, Hkv, T)).astype(np.float32)
    lens = np.array([0, 1, split - 1, split, split + 1, T], np.int32)
    ref = np.asarray(JA.decode_attention_q8(q, k8, v8, ks, vs, kv_len=lens))
    np.testing.assert_allclose(_k3_two_phase(q, k8, v8, lens, split, ks, vs), ref, atol=1e-6, rtol=0)
    out = K3.flash_decode_attention(_t(q), _t(k8), _t(v8), _t(lens), _t(ks), _t(vs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_k3_plain_zero_length_row_is_the_decoders_default_decode():
    """kv_len == 0: the port's K3 (plain version here, the kernel on the card) gives
    the JAX decoder's default decode, zoomearth_tpu/ops/attention.py::decode_attention:
    every logit masked alike, so the mean of v over all T slots."""
    B, H, Hkv, D, T = 4, 4, 2, 16, 1024
    q, k, v = _rand((B, 1, H, D), 45), _rand((B, Hkv, T, D), 46), _rand((B, Hkv, T, D), 47)
    lens = np.array([0, 400, 0, T], np.int32)
    ref = np.asarray(JA.decode_attention(q, k, v, kv_len=lens))
    out = K3.flash_decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(out[0, 0], np.repeat(v[0].mean(1), H // Hkv, axis=0), atol=1e-6)


def test_k3_pallas_zero_length_row_differs_and_the_port_does_not_follow_it():
    """The Pallas K3 (opt-in in the JAX decoder) walks its row block's ncb * 512 slots,
    ncb the block's longest row in chunks, and gives a dead row the mean of v over
    those: here the first 512 of T = 2048, because the block's longest row is 400.
    That answer depends on which rows share a block, a result of the TPU tiling; the
    port gives the decoder's default answer, the mean over all T, as pinned above."""
    B, H, Hkv, D, T = 4, 4, 2, 16, 2048
    q, k, v = _rand((B, 1, H, D), 48), _rand((B, Hkv, T, D), 49), _rand((B, Hkv, T, D), 50)
    lens = np.array([0, 400, 100, 300], np.int32)
    pallas = np.asarray(jax_flash_decode(q, k, v, lens, chunk=512, interpret=True))
    np.testing.assert_allclose(pallas[0, 0], np.repeat(v[0, :, :512].mean(1), H // Hkv, axis=0), atol=1e-6)
    np.testing.assert_allclose(pallas[1:], np.asarray(JA.decode_attention(q, k, v, kv_len=lens))[1:],
                               atol=ATOL, rtol=1e-4)
    port = K3.flash_decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(port[0, 0], np.repeat(v[0].mean(1), H // Hkv, axis=0), atol=1e-6)
    assert np.abs(port[0] - pallas[0]).max() > 1e-2


# ---------------------------------------------------------------------------
# Plain ops the model calls directly, dispatch, sampling
# ---------------------------------------------------------------------------

def test_window_paths_match_jax():
    meta = jax_vision_metadata([(1, 8, 8), (1, 4, 8)], CFG.vision, pad_to=128)
    S, H, D = 128, 2, 8
    q, k, v = (_rand((S, H, D), s) for s in (20, 21, 22))
    ref = np.asarray(JA.window_block_attention(q, k, v))
    np.testing.assert_allclose(TA.window_block_attention(_t(q), _t(k), _t(v)).numpy(), ref, atol=ATOL)
    # 3B window geometry (64-patch windows) on a 512 px image's 36 x 36 grid
    vcfg = dataclasses.replace(CFG.vision, window_size=112)
    meta1 = jax_vision_metadata([(1, 36, 36)], vcfg, pad_to=1600)
    assert meta1.win_mode == 1
    S = 1600
    q, k, v = (_rand((S, H, D), s) for s in (23, 24, 25))
    ref = np.asarray(JA.gather_window_attention(q, k, v, meta1.win_gidx, meta1.win_valid, meta1.win_sidx))
    out = TA.gather_window_attention(_t(q), _t(k), _t(v), _t(meta1.win_gidx).long(),
                                     _t(meta1.win_valid), _t(meta1.win_sidx).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_cpu_dispatch_launches_no_kernel():
    before = (K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches,
              K3.decode_attention_cuda.launches, dict(K1.segment_attention_cuda.variants),
              dict(K2.causal_attention_cuda.variants))
    x = torch.randn(64, 2, 8)
    K1.flash_segment_attention(x, x, x, torch.zeros(64, dtype=torch.int32))
    q = torch.randn(1, 4, 4, 16)
    kv = torch.randn(1, 2, 8, 16)
    K2.flash_causal_attention(q, kv, kv, torch.arange(4)[None], torch.tensor([4]))
    K3.flash_decode_attention(q[:, :1], kv, kv, torch.tensor([8]))
    after = (K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches,
             K3.decode_attention_cuda.launches, K1.segment_attention_cuda.variants,
             K2.causal_attention_cuda.variants)
    assert before == after


@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.999])
def test_top_p_mask_matches_jax(top_p):
    logits = _rand((4, 97), 30) * 3
    logits[1, :5] = 7.0  # ties at the top
    ref = np.asarray(jax_top_p_filter(jnp.asarray(logits), top_p))
    out = top_p_filter(_t(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out[~np.isinf(out)], ref[~np.isinf(ref)])


def test_sampling_greedy_and_seeded():
    logits = _t(_rand((3, 50), 31))
    np.testing.assert_array_equal(greedy(logits).numpy(), np.argmax(logits.numpy(), -1))
    assert torch.equal(sample(logits, None, temperature=0.0), greedy(logits))
    a = sample(logits, torch.Generator().manual_seed(5), temperature=0.7, top_p=0.8)
    b = sample(logits, torch.Generator().manual_seed(5), temperature=0.7, top_p=0.8)
    assert torch.equal(a, b)
    keep = ~torch.isinf(top_p_filter(logits / 0.7, 0.8))
    assert bool(keep[torch.arange(3), a].all())  # draws stay inside the nucleus


# ---------------------------------------------------------------------------
# K1 and K2 backward: the plain versions against jax.vjp of the JAX package's plain
# attention (its Pallas kernels have no VJP), against torch autograd of the plain
# forward, and the autograd.Functions' CPU wiring
# ---------------------------------------------------------------------------

def _seg_bwd_case(name):
    """(S, H, D, seg) for the segment backward."""
    if name == "windows":  # the tiny ViT's windowed blocks: segments of 4-16 rows + a pad tail
        meta = jax_vision_metadata([(1, 8, 8), (1, 4, 8)], CFG.vision, pad_to=112)
        return 112, 4, 8, meta.seg_window.astype(np.int32)
    if name == "full_multi_image":
        meta = jax_vision_metadata([(1, 8, 8), (1, 4, 8)], CFG.vision, pad_to=112)
        return 112, 4, 8, meta.seg_full.astype(np.int32)
    if name == "boundaries_inside_blocks":  # segments across 32- and 64-row blocks, D = 80
        seg = np.concatenate([np.repeat(np.arange(4), [30, 45, 3, 70]), np.full(12, 2**30)])
        return 160, 2, 80, seg.astype(np.int32)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["windows", "full_multi_image", "boundaries_inside_blocks"])
def test_k1_plain_backward_matches_jax_vjp_and_autograd(case):
    S, H, D, seg = _seg_bwd_case(case)
    q, k, v, dout = (_rand((S, H, D), s) for s in (80, 81, 82, 83))
    jseg = jnp.asarray(seg)
    ref_out, vjp = jax.vjp(lambda a, b, c: JA.segment_attention(a, b, c, jseg), q, k, v)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv, tseg = _t(q), _t(k), _t(v), _t(seg)
    out, lse = K1.flash_segment_attention_plain(tq, tk, tv, tseg, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    got = K1.flash_segment_attention_bwd_plain(tq, tk, tv, tseg, out, _t(dout), lse)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL)
    # torch autograd of the plain forward gives the same
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(K1.flash_segment_attention_plain(*leaves, tseg), leaves, _t(dout))
    for g, r in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL)
    # lse is each row's log-sum-exp of its scaled logits over its own segment
    logits = torch.einsum("shd,thd->hst", tq, tk) * D**-0.5
    same = tseg[:, None] == tseg[None, :]
    ref_lse = torch.logsumexp(logits.masked_fill(~same[None], float("-inf")), -1).t()
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=ATOL)


def _causal_bwd_inputs(B, S, H, Hkv, D, seed):
    """q (B, S, H, D) and the (B, S, Hkv, D) projections the decoder transposes."""
    return _rand((B, S, H, D), seed), _rand((B, S, Hkv, D), seed + 1), _rand((B, S, Hkv, D), seed + 2)


@pytest.mark.parametrize("B,S,H,Hkv,D,kv_len", [
    (2, 40, 4, 2, 16, (40, 27)),  # the tiny decoder's heads; pad queries past kv_len see the live prefix
    (3, 33, 8, 1, 16, (33, 0, 5)),  # G = 8 as at 3B; a row with no live key
    (1, 24, 4, 4, 32, (24,)),  # G = 1
])
def test_k2_plain_backward_matches_jax_vjp_and_autograd(B, S, H, Hkv, D, kv_len):
    """The no-cache training path: k and v as transposed views, slot t is token t.
    Rows with no live key: JAX's plain softmax spreads them uniformly, so their dO
    is zeroed for the comparison, and the port's rule (zero gradients) is pinned
    apart."""
    q, kb, vb = _causal_bwd_inputs(B, S, H, Hkv, D, 84)
    dout = _rand((B, S, H, D), 87)
    kv_len = np.asarray(kv_len, np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    dead = np.minimum(pos + 1, kv_len[:, None]) <= 0
    dout_live = np.where(dead[:, :, None, None], 0, dout).astype(np.float32)
    valid = np.arange(S)[None] < kv_len[:, None]

    def jax_fwd(a, kk, vv):
        return JA.causal_attention(a, kk.transpose(0, 2, 1, 3), vv.transpose(0, 2, 1, 3),
                                   positions=jnp.asarray(pos), valid=jnp.asarray(valid))

    _, vjp = jax.vjp(jax_fwd, q, kb, vb)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout_live))]
    tq, tk, tv = _t(q), _t(kb).transpose(1, 2), _t(vb).transpose(1, 2)
    tpos, tkvl = _t(np.ascontiguousarray(pos)), _t(kv_len)
    out, lse = K2.flash_causal_attention_plain(tq, tk, tv, tpos, tkvl, return_lse=True)
    got = K2.flash_causal_attention_bwd_plain(tq, tk, tv, tpos, tkvl, out, _t(dout_live), lse)
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=ATOL)
    for g, r in zip(got[1:], ref[1:]):  # (B, Hkv, T, D) against the projections' (B, S, Hkv, D)
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), r, atol=ATOL)
    # the same against torch autograd of the plain forward, through the transposed views
    leaves = [x.clone().requires_grad_() for x in (_t(q), _t(kb), _t(vb))]
    auto = torch.autograd.grad(K2.flash_causal_attention_plain(leaves[0], leaves[1].transpose(1, 2),
                                                               leaves[2].transpose(1, 2), tpos, tkvl),
                               leaves, _t(dout_live))
    np.testing.assert_allclose(got[0].numpy(), auto[0].numpy(), atol=ATOL)
    for g, r in zip(got[1:], auto[1:]):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), r.numpy(), atol=ATOL)
    # a row with no live key: NEG_INF lse, zero dq, and its dO reaches no dk or dv
    assert bool((lse[torch.from_numpy(dead)] == TA.NEG_INF).all())
    full = K2.flash_causal_attention_bwd_plain(tq, tk, tv, tpos, tkvl, out, _t(dout), lse)
    assert not bool(full[0][torch.from_numpy(dead)].any())
    for a, b in zip(full, got):
        assert torch.equal(a[torch.from_numpy(~dead)] if a.shape == tq.shape else a, b[torch.from_numpy(~dead)]
                           if b.shape == tq.shape else b)


def test_autograd_functions_on_the_cpu():
    """Under autograd flash_segment_attention / flash_causal_attention go through
    their autograd.Functions: the forward saves (inputs, out, lse), the backward
    returns gradients shaped as the inputs (the transposed views included) equal to
    autograd of the plain forward; without a gradient nothing changes; on the CPU no
    kernel is counted."""
    counts = (K1.segment_attention_cuda.launches, K1.segment_attention_bwd_cuda.launches,
              K2.causal_attention_cuda.launches, K2.causal_attention_bwd_cuda.launches)
    S, H, D, seg = _seg_bwd_case("full_multi_image")
    qkv = _t(_rand((S, 3, H, D), 90)).requires_grad_()
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # strided views, as the ViT passes them
    out = K1.flash_segment_attention(q, k, v, _t(seg))
    assert type(out.grad_fn).__name__ == "SegmentAttentionBackward"
    assert len(out.grad_fn.saved_tensors) == 6
    dout = _t(_rand((S, H, D), 91))
    g = torch.autograd.grad(out, qkv, dout)[0]
    ref = torch.autograd.grad(K1.flash_segment_attention_plain(q, k, v, _t(seg)), qkv, dout)[0]
    assert g.shape == qkv.shape
    np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=ATOL)
    with torch.no_grad():
        plain = K1.flash_segment_attention(q, k, v, _t(seg))
    assert plain.grad_fn is None and torch.equal(plain, out.detach())

    qd, kb, vb = (_t(x).requires_grad_() for x in _causal_bwd_inputs(2, 20, 4, 2, 16, 92))
    pos, kvl = torch.arange(20)[None].expand(2, 20), torch.tensor([20, 13])
    out = K2.flash_causal_attention(qd, kb.transpose(1, 2), vb.transpose(1, 2), pos, kvl)
    assert type(out.grad_fn).__name__ == "CausalAttentionBackward"
    dout = _t(_rand((2, 20, 4, 16), 93))
    got = torch.autograd.grad(out, (qd, kb, vb), dout)
    ref = torch.autograd.grad(K2.flash_causal_attention_plain(qd, kb.transpose(1, 2), vb.transpose(1, 2), pos, kvl),
                              (qd, kb, vb), dout)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    # int8 K/V has no backward: refused before anything runs
    k8 = torch.zeros((2, 2, 20, 16), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        K2.flash_causal_attention(qd, k8, k8, pos, kvl, torch.ones(2, 2, 20), torch.ones(2, 2, 20))
    assert counts == (K1.segment_attention_cuda.launches, K1.segment_attention_bwd_cuda.launches,
                      K2.causal_attention_cuda.launches, K2.causal_attention_bwd_cuda.launches)


def test_backward_work_counts_five_products_per_live_pair():
    seg = torch.tensor([0] * 5 + [1] * 3 + [4] * 7 + [K1.PAD_SEG] * 2, dtype=torch.int32)
    H, D = 3, 16
    pairs = 25 + 9 + 49 + 4
    assert K1.work_bwd(seg, H, D, 2) == (10 * D * H * pairs, 8 * 17 * H * D * 2 + 4 * 17 * H)
    B, S, Hkv = 2, 6, 1
    pos = torch.arange(S)[None].expand(B, S)
    kv_len = torch.tensor([6, 3])
    live = 21 + (1 + 2 + 3 * 4)  # row 0: 1..6 keys; row 1: 1, 2, then 3 for the four past kv_len
    rows = 6 + 3
    assert K2.work_bwd(pos, kv_len, H, Hkv, D, S, 2) == (10 * D * H * live,
                                                         4 * B * S * H * D * 2 + 4 * B * S * H + 4 * rows * Hkv * D * 2)


@pytest.mark.parametrize("T,Hkv,B", [(2048, 2, 1), (150, 2, 5), (64, 8, 1), (4096, 2, 8)])
def test_k2_backward_splits_cover_every_query_tile_once(T, Hkv, B):
    """The dk/dv kernel's split plan: at most one split per query tile, enough splits
    to reach the target block count where there are tiles for it, and the splits'
    tile ranges cover [0, n_qtiles) exactly once."""
    G, rows = 8, 32
    key_blocks, n_qtiles = -(-T // rows), -(-T // (K2.BWD_TILE // G))
    target = K2.BWD_BLOCKS_PER_SM * 132  # the H100 SXM's streaming multiprocessors
    n = K2.dkdv_splits(key_blocks, Hkv, B, n_qtiles, target)
    assert 1 <= n <= n_qtiles
    assert key_blocks * Hkv * B * n >= min(target, key_blocks * Hkv * B * n_qtiles)
    per = -(-n_qtiles // n)
    covered = [t for s in range(n) for t in range(s * per, min(n_qtiles, (s + 1) * per))]
    assert covered == list(range(n_qtiles))


# ---------------------------------------------------------------------------
# The tensor-core backward of K1 and K2 (csrc/flash_bwd.cuh), emulated on the CPU: the
# same blocks of 128 rows (dq) and 128 keys (dk/dv), key tiles of 64 and query tiles of
# 32, a warp's 16 rows or keys skipping the tiles none of its pairs is live in, the
# compare only where the kernels make it, p = 2^(s scale log2e - lse log2e), P and dS
# rounded to bf16 as operands of the next product, fp32 sums, and K2's dk/dv split over
# the query tiles with its partials added in split order. Held at the card's tolerance
# (one bf16 step, 2^-7, of each gradient's largest value) against the fp32 plain
# backward and against jax.vjp of the JAX package's plain attention.
# ---------------------------------------------------------------------------

BWD_SMS = 132  # the H100 SXM's streaming multiprocessors, for the split plan


def _grad_tols(ref):
    return [2.0 ** -7 * float(r.abs().max()) for r in ref]


def _assert_within(got, ref, label):
    for name, a, b, tol in zip(("dq", "dk", "dv"), got, ref, _grad_tols(ref)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol, (label, name, err, tol)


def _emulate_bwd_dq(qs, dos, lse, delta, k, v, live, valid, lo, hi, needs_mask, warp_skips, scale):
    """One dq block: qs/dos (128, D) bf16 (zeros where the block has no row: valid
    False), lse/delta (128,) fp32 (0 there), k/v (T, D) bf16, live (128, T); keys [lo, hi)
    in tiles of 64, rows past hi read as zeros. Returns dq (128, D) in bf16 and the count
    of (warp, tile) pairs skipped."""
    R, D = qs.shape
    dq = torch.zeros(R, D)
    s2, skipped = scale * LOG2E, 0
    for t0 in range(lo, hi, K1.TILE):
        n = min(K1.TILE, hi - t0)
        kt, vt = torch.zeros(K1.TILE, D), torch.zeros(K1.TILE, D)
        kt[:n], vt[:n] = k[t0:t0 + n].float(), v[t0:t0 + n].float()
        s, dp = qs.float() @ kt.T, dos.float() @ vt.T
        p = torch.exp2(s * s2 - lse[:, None] * LOG2E)
        if needs_mask(t0):
            ok = torch.zeros(R, K1.TILE, dtype=torch.bool)
            ok[:, :n] = live[:, t0:t0 + n]
            p = torch.where(ok, p, torch.zeros(()))
        else:
            assert n == K1.TILE and bool(live[valid, t0:t0 + n].all()), "an unmasked tile must be live throughout"
        ds = p * (dp - delta[:, None])
        for w in range(R // 16):
            if warp_skips(w, t0, n):
                assert not bool(live[16 * w:16 * w + 16, t0:t0 + n].any()), "a skipped tile must hold no live pair"
                ds[16 * w:16 * w + 16] = 0.0
                skipped += 1
        dq += ds.bfloat16().float() @ kt
    return (dq * scale).bfloat16(), skipped


def _emulate_bwd_dkdv(kb, vb, tiles, scale):
    """One dk/dv block: kb/vb (128, D) bf16 (zeros past the keys); tiles a sequence of
    (q (32, D), dout (32, D) bf16, lse, delta (32,) fp32, live (128, 32), modes (8,) of
    0: the warp skips, 1: it compares, 2: all its pairs are live). Returns the fp32 sums
    (dk unscaled, dv)."""
    D = kb.shape[1]
    dk, dv = torch.zeros(kb.shape[0], D), torch.zeros(kb.shape[0], D)
    for qt, dot, lse, delta, live, modes in tiles:
        s, dp = kb.float() @ qt.float().T, vb.float() @ dot.float().T
        p = torch.exp2(s * (scale * LOG2E) - lse[None, :] * LOG2E)
        keep = torch.ones_like(live)
        for w, mode in enumerate(modes):
            rows = slice(16 * w, 16 * w + 16)
            if mode == 0:
                assert not bool(live[rows].any()), "a skipped tile must hold no live pair"
                keep[rows] = False
            elif mode == 1:
                keep[rows] = live[rows]
            else:
                assert bool(live[rows].all()), "an unmasked warp must be live throughout"
        p = torch.where(keep, p, torch.zeros(()))
        ds = p * (dp - delta[None, :])
        dv += p.bfloat16().float() @ dot.float()
        dk += ds.bfloat16().float() @ qt.float()
    return dk, dv


def _emulate_k1_bwd(q, k, v, seg, out, dout, lse):
    S, H, D = q.shape
    R, Q = K1.BWD_ROWS, K1.BWD_TILE
    scale = D**-0.5
    delta = (dout.float() * out.float()).sum(-1)  # (S, H)
    first, last = K1.segment_kv_ranges(seg, R)
    dq, dk, dv = (torch.zeros(S, H, D, dtype=torch.bfloat16) for _ in range(3))
    skipped = modes_seen = 0
    segl = seg.tolist()
    for blk in range(first.shape[0]):
        s0, s1 = blk * R, min((blk + 1) * R, S)
        lo, hi = int(first[blk]), int(last[blk])
        valid = torch.arange(R) < s1 - s0
        live = torch.zeros(R, S, dtype=torch.bool)
        live[:s1 - s0] = seg[s0:s1, None] == seg[None, :]

        def warp_skips(w, t0, n, s0=s0, s1=s1):
            if s0 + 16 * w >= s1:
                return True
            lo_id, hi_id = segl[s0 + 16 * w], segl[min(s0 + 16 * w + 15, s1 - 1)]
            return segl[t0 + n - 1] < lo_id or segl[t0] > hi_id

        for h in range(H):
            qs, dos = torch.zeros(R, D, dtype=torch.bfloat16), torch.zeros(R, D, dtype=torch.bfloat16)
            qs[:s1 - s0], dos[:s1 - s0] = q[s0:s1, h], dout[s0:s1, h]
            lse_b, delta_b = torch.zeros(R), torch.zeros(R)
            lse_b[:s1 - s0], delta_b[:s1 - s0] = lse[s0:s1, h], delta[s0:s1, h]
            got, n_skip = _emulate_bwd_dq(qs, dos, lse_b, delta_b, k[:, h], v[:, h], live, valid, lo, hi,
                                          lambda t0, s0=s0, hi=hi: K1.tile_needs_mask(seg, s0, t0, hi), warp_skips,
                                          scale)
            dq[s0:s1, h] = got[:s1 - s0]
            skipped += n_skip
        # the same range arrays serve the keys: rows [lo, hi) see keys [s0, s1)
        t_lo, t_hi = s0, s1
        for h in range(H):
            kb, vb = torch.zeros(R, D, dtype=torch.bfloat16), torch.zeros(R, D, dtype=torch.bfloat16)
            kb[:t_hi - t_lo], vb[:t_hi - t_lo] = k[t_lo:t_hi, h], v[t_lo:t_hi, h]
            tiles = []
            for r0 in range(lo, hi, Q):
                n = min(Q, hi - r0)
                rows = slice(r0, r0 + n)
                qt, dot = torch.zeros(Q, D, dtype=torch.bfloat16), torch.zeros(Q, D, dtype=torch.bfloat16)
                qt[:n], dot[:n] = q[rows, h], dout[rows, h]
                lt, dt = torch.zeros(Q), torch.zeros(Q)
                lt[:n], dt[:n] = lse[rows, h], delta[rows, h]
                lv = torch.zeros(R, Q, dtype=torch.bool)
                lv[:t_hi - t_lo, :n] = seg[t_lo:t_hi, None] == seg[None, rows]
                modes = []
                for w in range(R // 16):
                    j0 = t_lo + 16 * w
                    if j0 >= S or segl[r0 + n - 1] < segl[j0] or segl[r0] > segl[min(j0 + 15, S - 1)]:
                        modes.append(0)
                    elif (n == Q and j0 + 15 < S and segl[j0] == segl[j0 + 15] == segl[r0] == segl[r0 + n - 1]):
                        modes.append(2)
                    else:
                        modes.append(1)
                modes_seen += modes.count(0)
                tiles.append((qt, dot, lt, dt, lv, modes))
            gk, gv = _emulate_bwd_dkdv(kb, vb, tiles, scale)
            dk[t_lo:t_hi, h] = (gk * scale).bfloat16()[:t_hi - t_lo]
            dv[t_lo:t_hi, h] = gv.bfloat16()[:t_hi - t_lo]
    return (dq, dk, dv), skipped, modes_seen


@pytest.mark.parametrize("runs,pad,D", [
    ([64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64], 37, 80),  # windows of 16-64 rows + pad tail: warps skip
    ([40, 500, 64, 24], 13, 16),  # one long segment: boundaries inside tiles, unmasked tiles inside it
    ([100, 91], 0, 80),  # a boundary inside a block, S no multiple of 32
])
def test_k1_tensor_core_backward_matches_plain_and_jax(runs, pad, D):
    S, H = sum(runs) + pad, 2
    assert S % K1.BWD_TILE
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                    + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)])
    q, k, v, dout = (_t(_rand((S, H, D), s)).bfloat16() for s in (120, 121, 122, 123))
    out, lse = K1.flash_segment_attention_plain(q, k, v, seg, return_lse=True)
    got, skipped, warp_skips = _emulate_k1_bwd(q, k, v, seg, out, dout, lse)
    ref = K1.flash_segment_attention_bwd_plain(q.float(), k.float(), v.float(), seg, out.float(), dout.float(), lse)
    _assert_within(got, ref, "plain")
    jseg = jnp.asarray(seg.numpy())
    _, vjp = jax.vjp(lambda a, b, c: JA.segment_attention(a, b, c, jseg), *(x.float().numpy() for x in (q, k, v)))
    _assert_within(got, [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dout.float().numpy()))], "jax")
    if len(runs) > 2:
        assert skipped > 0 and warp_skips > 0  # warps skip tiles of other segments on both sides


def _emulate_k2_bwd(q, k, v, positions, kv_len, out, dout, lse):
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, R, Q = H // Hkv, K1.BWD_ROWS, K2.BWD_TILE
    scale = D**-0.5
    delta = (dout.float() * out.float()).sum(-1)  # (B, S, H)
    slot = torch.arange(T)
    klen = kv_len.clamp(0, T)
    dq = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    dk, dv = torch.zeros(B, Hkv, T, D, dtype=torch.bfloat16), torch.zeros(B, Hkv, T, D, dtype=torch.bfloat16)
    bq = R // G
    hi, full = K2.block_key_bounds(positions, kv_len, T, bq)
    for b in range(B):
        kl = int(klen[b])
        for blk in range(hi.shape[1]):
            r = torch.arange(R)
            s = blk * bq + r % bq
            valid = s < S
            sc = s.clamp(max=S - 1)
            pos = torch.where(valid, positions[b, sc], torch.full_like(sc, -1))
            live = (slot[None] <= pos[:, None]) & (slot[None] < kl) & valid[:, None]
            bound = torch.minimum(pos + 1, torch.tensor(kl)).clamp(min=0)

            def warp_skips(w, t0, n, bound=bound):
                return t0 >= int(bound[16 * w:16 * w + 16].max())

            for kh in range(Hkv):
                h = kh * G + r // bq
                z = torch.zeros((), dtype=torch.bfloat16)
                qs = torch.where(valid[:, None], q[b, sc, h], z)
                dos = torch.where(valid[:, None], dout[b, sc, h], z)
                lse_b = torch.where(valid, lse[b, sc, h], torch.zeros(()))
                delta_b = torch.where(valid, delta[b, sc, h], torch.zeros(()))
                got, _ = _emulate_bwd_dq(qs, dos, lse_b, delta_b, k[b, kh], v[b, kh], live, valid, 0, int(hi[b, blk]),
                                         lambda t0, f=int(full[b, blk]): K2.tile_needs_mask(t0, f), warp_skips, scale)
                dq[b, sc[valid], h[valid]] = got[valid]
    # dk/dv: blocks of 128 keys; the (position, head) rows position-major in tiles of 32, split over the blocks
    n_rows, n_qtiles = S * G, -(-S * G // Q)
    qhi = K2.block_key_bounds(positions, kv_len, T, Q // G)[0]
    key_blocks = -(-T // R)
    nsplit = K2.dkdv_splits(key_blocks, Hkv, B, n_qtiles, K2.BWD_BLOCKS_PER_SM_MMA * BWD_SMS)
    per = -(-n_qtiles // nsplit)
    for b in range(B):
        kl = int(klen[b])
        for kh in range(Hkv):
            for kb in range(key_blocks):
                t_lo = kb * R
                nk = min(R, T - t_lo)
                kbk, vbk = torch.zeros(R, D, dtype=torch.bfloat16), torch.zeros(R, D, dtype=torch.bfloat16)
                kbk[:nk], vbk[:nk] = k[b, kh, t_lo:t_lo + nk], v[b, kh, t_lo:t_lo + nk]
                keys = t_lo + torch.arange(R)
                sums = []
                for sp in range(nsplit):
                    tiles = []
                    for tile in range(sp * per, min(n_qtiles, (sp + 1) * per)):
                        if int(qhi[b, tile]) <= t_lo:
                            continue
                        rr = tile * Q + torch.arange(Q)
                        ok = rr < n_rows
                        n = int(ok.sum())
                        s_, g_ = (rr // G).clamp(max=S - 1), rr % G
                        z = torch.zeros((), dtype=torch.bfloat16)
                        qt = torch.where(ok[:, None], q[b, s_, kh * G + g_], z)
                        dot = torch.where(ok[:, None], dout[b, s_, kh * G + g_], z)
                        lt = torch.where(ok, lse[b, s_, kh * G + g_], torch.zeros(()))
                        dt = torch.where(ok, delta[b, s_, kh * G + g_], torch.zeros(()))
                        pos = torch.where(ok, positions[b, s_], torch.full_like(s_, -1))
                        lv = (keys[:, None] <= pos[None, :]) & (keys[:, None] < kl) & ok[None, :]
                        pc = pos[:n].clamp(max=T - 1)
                        modes = []
                        for w in range(R // 16):
                            wlo = t_lo + 16 * w
                            if min(int(pc.max()) + 1, kl) <= wlo:
                                modes.append(0)
                            elif n == Q and wlo + 16 <= min(int(pc.min()) + 1, kl):
                                modes.append(2)
                            else:
                                modes.append(1)
                        tiles.append((qt, dot, lt, dt, lv, modes))
                    sums.append(_emulate_bwd_dkdv(kbk, vbk, tiles, scale))
                gk, gv = sums[0]
                for pk, pv in sums[1:]:  # the partials added in split order
                    gk, gv = gk + pk, gv + pv
                dk[b, kh, t_lo:t_lo + nk] = (gk * scale).bfloat16()[:nk]
                dv[b, kh, t_lo:t_lo + nk] = gv.bfloat16()[:nk]
    return (dq, dk, dv), nsplit


@pytest.mark.parametrize("B,S,H,Hkv,D,kv_len", [
    (3, 150, 16, 2, 32, (150, 0, 97)),  # G = 8 as at 3B; a row with no live key; S no multiple of any tile
    (2, 70, 4, 4, 16, (70, 33)),  # G = 1; pad queries past kv_len
    (1, 40, 32, 1, 16, (40,)),  # G = 32, the most a tile of 32 rows allows
    (2, 90, 4, 2, 128, (90, 64)),  # G = 2 at the decoder's head dim
])
def test_k2_tensor_core_backward_matches_plain_and_jax(B, S, H, Hkv, D, kv_len):
    """The no-cache training path (slot t is token t). A row with no live key gets zero
    gradients and adds nothing to dk or dv, though its lse is NEG_INF (the exponent alone
    would give 1 there)."""
    q = _t(_rand((B, S, H, D), 124)).bfloat16()
    kp, vp = _t(_rand((B, S, Hkv, D), 125)).bfloat16(), _t(_rand((B, S, Hkv, D), 126)).bfloat16()
    k, v = kp.transpose(1, 2), vp.transpose(1, 2)
    dout = _t(_rand((B, S, H, D), 127)).bfloat16()
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    out, lse = K2.flash_causal_attention_plain(q, k, v, pos, kvl, return_lse=True)
    got, nsplit = _emulate_k2_bwd(q, k, v, pos, kvl, out, dout, lse)
    assert nsplit > 1  # the split plan of these shapes sums partials
    ref = K2.flash_causal_attention_bwd_plain(q.float(), k.float(), v.float(), pos, kvl, out.float(), dout.float(), lse)
    _assert_within(got, ref, "plain")
    dead = torch.minimum(pos + 1, kvl[:, None]) <= 0
    assert not bool(got[0][dead].any())
    # jax.vjp with the dead rows' dO zeroed (JAX's plain softmax spreads such a row evenly): the same dk and dv,
    # and dq of the live rows
    dout_live = torch.where(dead[:, :, None, None], torch.zeros(()), dout.float())
    valid = np.arange(S)[None] < np.asarray(kv_len)[:, None]
    _, vjp = jax.vjp(lambda a, kk, vv: JA.causal_attention(a, kk.transpose(0, 2, 1, 3), vv.transpose(0, 2, 1, 3),
                                                          positions=jnp.asarray(pos.numpy()), valid=jnp.asarray(valid)),
                     q.float().numpy(), kp.float().numpy(), vp.float().numpy())
    jq, jk, jv = (torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dout_live.numpy())))
    _assert_within(got, (jq, jk.transpose(1, 2), jv.transpose(1, 2)), "jax")


@pytest.mark.parametrize("T,Hkv,B", [(2048, 2, 1), (150, 2, 5), (64, 8, 1), (4096, 2, 8), (40, 1, 1)])
def test_k2_tensor_core_backward_splits_cover_every_query_tile_once(T, Hkv, B):
    """The tensor-core dk/dv kernel's split plan (blocks of BWD_ROWS keys, BWD_BLOCKS_PER_SM_MMA
    an SM): at most one split per query tile, enough splits to reach the target, and each
    tile in exactly one split, in order."""
    G = 8
    key_blocks, n_qtiles = -(-T // K1.BWD_ROWS), -(-T * G // K2.BWD_TILE)
    target = K2.BWD_BLOCKS_PER_SM_MMA * BWD_SMS
    n = K2.dkdv_splits(key_blocks, Hkv, B, n_qtiles, target)
    assert 1 <= n <= n_qtiles
    assert key_blocks * Hkv * B * n >= min(target, key_blocks * Hkv * B * n_qtiles)
    per = -(-n_qtiles // n)
    covered = [t for s in range(n) for t in range(s * per, min(n_qtiles, (s + 1) * per))]
    assert covered == list(range(n_qtiles))
    if (T, Hkv, B) == (2048, 2, 1):  # the SFT path: 16 x 2 blocks of keys, 13 splits
        assert (key_blocks, n) == (16, 13)


@pytest.mark.parametrize("dtype,D,rows", [
    (torch.bfloat16, 16, 128), (torch.bfloat16, 32, 128), (torch.bfloat16, 64, 128), (torch.bfloat16, 80, 128),
    (torch.bfloat16, 128, 128), (torch.bfloat16, 8, 64), (torch.float32, 8, 64), (torch.float32, 16, 64),
    (torch.float32, 64, 32), (torch.float32, 80, 32), (torch.float32, 128, 32), (torch.bfloat16, 96, -1),
    (torch.float16, 64, -1), (torch.float32, 48, -1),
])
def test_backward_variant_rule(dtype, D, rows):
    """The Python mirror of zt_flash_bwd_variant (the card tests hold the C query to it):
    bf16 at a head dim that is a multiple of 16 takes the tensor cores, 128 rows a block;
    fp32 never does (the fp32 parity runs keep their precision), nor D = 8."""
    assert K1.bwd_variant_rows(dtype, D) == rows
