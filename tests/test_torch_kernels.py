"""Port kernel modules (K1 segment, K2 causal, K3 decode) and the plain attention ops
against the JAX package on the CPU.

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
from zoomearth_tpu_torch.ops import attention as TA
from zoomearth_tpu_torch.ops import flash_attention as K1
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_decode as K3
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


@pytest.mark.parametrize("grids,pad_to", [([(1, 8, 8), (1, 4, 8)], 0), ([(1, 6, 6)], 64),
                                          ([(1, 36, 36)] * 2, 0), ([(1, 10, 14)], 256)])
def test_k1_kv_ranges_match_jax_wrapper_formula(grids, pad_to):
    """segment_kv_ranges (row units) against the JAX wrapper's block-range formula
    (flash_attention.py:126-133) for block_q = block_kv = 64."""
    meta = jax_vision_metadata(grids, CFG.vision, pad_to=pad_to)
    for seg in (meta.seg_window, meta.seg_full):
        seg = seg.astype(np.int32)
        S = seg.shape[0]
        if S % 64:
            continue
        bq = bkv = K1.BLOCK_Q
        qb = jnp.asarray(seg).reshape(S // bq, bq)
        first = jnp.searchsorted(seg, qb.min(axis=1), side="left")
        last = jnp.searchsorted(seg, qb.max(axis=1), side="right")
        starts = np.asarray(first // bkv)
        ends = np.asarray(jnp.minimum(-(-last // bkv), S // bkv))
        f, l = K1.segment_kv_ranges(_t(seg))
        np.testing.assert_array_equal(f.numpy(), np.asarray(first))
        np.testing.assert_array_equal(l.numpy(), np.asarray(last))
        np.testing.assert_array_equal(f.numpy() // bkv, starts)
        np.testing.assert_array_equal(-(-l.numpy() // bkv), ends)


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
              K3.decode_attention_cuda.launches)
    x = torch.randn(64, 2, 8)
    K1.flash_segment_attention(x, x, x, torch.zeros(64, dtype=torch.int32))
    q = torch.randn(1, 4, 4, 16)
    kv = torch.randn(1, 2, 8, 16)
    K2.flash_causal_attention(q, kv, kv, torch.arange(4)[None], torch.tensor([4]))
    K3.flash_decode_attention(q[:, :1], kv, kv, torch.tensor([8]))
    after = (K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches,
             K3.decode_attention_cuda.launches)
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
