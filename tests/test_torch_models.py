"""Port model modules (ViT, decoder, VLM) against the JAX package on the CPU.

The JAX package's random tiny parameters go through params_from_numpy, so both
packages compute the same function; inputs come from seeded numpy. fp32 activations
are held to atol 5e-5 (the repo's parity bar), cache contents likewise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models import decoder as JD
from zoomearth_tpu.models import vit as JV
from zoomearth_tpu.models import vlm as JM
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu_torch.models import decoder as TD
from zoomearth_tpu_torch.models import vit as TV
from zoomearth_tpu_torch.models import vlm as TM
from zoomearth_tpu_torch.models.params import init_vlm_params, param_count, params_from_numpy, tree_leaves

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
ATOL = 5e-5


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=1e-4)


def test_params_from_numpy_and_init_shapes(params):
    jp, tp = params
    jl = jax.tree.leaves(jp)
    tl = tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rp = init_vlm_params(CFG, torch.Generator().manual_seed(3))
    assert [t.shape for t in tree_leaves(rp)] == [t.shape for t in tl]
    assert param_count(rp) == param_count(tp)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def _vit_case(name, seed):
    rng = np.random.default_rng(seed)
    vcfg = CFG.vision
    if name == "win0":
        grids, pad = [(1, 8, 8), (1, 4, 8)], 128
    elif name == "win1":
        vcfg, grids, pad = dataclasses.replace(vcfg, window_size=112), [(1, 12, 20)], 256
    elif name == "win2":
        vcfg, grids, pad = dataclasses.replace(vcfg, window_size=112), [(1, 16, 16)], 256
    elif name in ("uint8", "compact"):
        grids, pad = [(1, 8, 8)], 64
    n = sum(t * h * w for t, h, w in grids)
    width = vcfg.patch_dim // (vcfg.temporal_patch_size if name == "compact" else 1)
    if name in ("uint8", "compact"):
        pv = rng.integers(0, 256, (pad, width)).astype(np.uint8)
    else:
        pv = rng.standard_normal((pad, width)).astype(np.float32)
    pv[n:] = 0
    return vcfg, JV.vision_metadata(grids, vcfg, pad_to=pad), pv


@pytest.mark.parametrize("case,win_mode", [("win0", 0), ("win1", 1), ("win2", 2),
                                           ("uint8", None), ("compact", None)])
def test_vit_forward_matches_jax(params, case, win_mode):
    jp, tp = params
    vcfg, meta, pv = _vit_case(case, seed=len(case))
    if win_mode is not None:
        assert meta.win_mode == win_mode
    plan = (meta.win_gidx, meta.win_valid, meta.win_sidx) if meta.win_mode == 1 else None
    ref = JV.vit_forward(jp["vision"], vcfg, pv, meta.perm, meta.inv_perm_merged, meta.seg_window,
                         meta.seg_full, meta.pos_ids, win_mode=meta.win_mode, win_plan=plan)
    dm = TV.meta_to_device(dataclasses.asdict(meta), "cpu")
    tplan = (dm["win_gidx"], dm["win_valid"], dm["win_sidx"]) if meta.win_mode == 1 else None
    out = TV.vit_forward(tp["vision"], vcfg, _t(pv), dm["perm"], dm["inv_perm_merged"],
                         dm["seg_window"], dm["seg_full"], dm["pos_ids"],
                         win_mode=meta.win_mode, win_plan=tplan)
    n_real = meta.num_patches // vcfg.merge_unit
    _close(out[:n_real], np.asarray(ref)[:n_real])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _dec_inputs(B, S, seed, start=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, CFG.text.hidden_size)).astype(np.float32)
    base = np.zeros(B, np.int64) if start is None else np.asarray(start)
    pos = (base[:, None] + np.arange(S)[None]).astype(np.int32)
    return x, np.broadcast_to(pos[None], (3, B, S)).copy(), pos


def _compare_cache(jc, tc, rows):
    for jk, jv, tk, tv in zip(jc.k, jc.v, tc.k, tc.v):
        for b, n in enumerate(rows):
            _close(tk[b, :, :n], np.asarray(jk)[b, :, :n])
            _close(tv[b, :, :n], np.asarray(jv)[b, :, :n])


def _prefill_both(params, B, S, T, lengths, seed=1):
    jp, tp = params
    x, pos3, apos = _dec_inputs(B, S, seed)
    valid = apos < np.asarray(lengths)[:, None]
    jc = JD.KVCache.create(CFG.text, B, T, jnp.float32)
    jh, jc = JD.decoder_forward(jp["text"], CFG.text, x, pos3, attn_positions=apos, attn_valid=valid,
                                cache=jc, update_cache_len=False)
    jc = jc._replace(length=jnp.asarray(lengths, jnp.int32))
    tc = TD.KVCache.create(CFG.text, B, T, torch.float32)
    th, tc = TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3), attn_positions=_t(apos),
                                attn_valid=_t(valid), cache=tc, update_cache_len=False)
    tc.length = _t(np.asarray(lengths, np.int32))
    return (jh, jc), (th, tc)


def test_decoder_prefill_matches_jax(params):
    B, S, T = 2, 24, 64
    (jh, jc), (th, tc) = _prefill_both(params, B, S, T, [24, 17])
    _close(th, jh)
    _compare_cache(jc, tc, [S, S])


def test_decoder_chunk_prefill_with_pad_rows_matches_jax(params):
    """Chunk prefill at per-row keep lengths; pad tokens write to slot T (dropped),
    including a row whose chunk is one token followed by pads."""
    jp, tp = params
    B, S0, T, S = 2, 24, 64, 16
    (_, jc), (_, tc) = _prefill_both(params, B, S0, T, [24, 17])
    keep = np.array([20, 9], np.int32)
    chunk_lens = np.array([16, 1], np.int32)
    x, pos3, _ = _dec_inputs(B, S, seed=5, start=keep + 3)
    apos = keep[:, None] + np.arange(S)[None]
    valid = np.arange(S)[None] < chunk_lens[:, None]
    write_pos = np.where(valid, apos, T).astype(np.int32)
    jc = jc._replace(length=jnp.asarray(keep))
    jh, jc = JD.decoder_forward(jp["text"], CFG.text, x, pos3, attn_positions=apos, attn_valid=valid,
                                cache=jc, update_cache_len=False, write_pos=jnp.asarray(write_pos))
    tc.length = _t(keep)
    th, tc = TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3), attn_positions=_t(apos),
                                attn_valid=_t(valid), cache=tc, update_cache_len=False,
                                write_pos=_t(write_pos))
    for b in range(B):
        _close(th[b, : chunk_lens[b]], np.asarray(jh)[b, : chunk_lens[b]])
    _compare_cache(jc, tc, [T, T])  # every slot: the dropped pad writes touched nothing


@pytest.mark.parametrize("attend_len", [None, 32])
def test_decoder_decode_attend_len_matches_jax(params, attend_len):
    jp, tp = params
    B, S0, T = 2, 24, 64
    (_, jc), (_, tc) = _prefill_both(params, B, S0, T, [24, 17])
    for step in range(3):
        x, pos3, _ = _dec_inputs(B, 1, seed=10 + step, start=np.array([30 + step, 20 + step]))
        jh, jc = JD.decoder_forward(jp["text"], CFG.text, x, pos3,
                                    attn_positions=jc.length[:, None], cache=jc, attend_len=attend_len)
        th, tc = TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3),
                                    attn_positions=tc.length[:, None], cache=tc, attend_len=attend_len)
        _close(th, jh)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    _compare_cache(jc, tc, [27, 20])


def test_decoder_fused_layout_matches_split(params):
    _, tp = params
    text = tp["text"]
    fused = dict(text, layers=[
        dict(l, attn={"wqkv": torch.cat([l["attn"]["wq"], l["attn"]["wk"], l["attn"]["wv"]], 1),
                      "bqkv": torch.cat([l["attn"]["bq"], l["attn"]["bk"], l["attn"]["bv"]]),
                      "wo": l["attn"]["wo"]},
             mlp={"wgu": torch.cat([l["mlp"]["wg"], l["mlp"]["wu"]], 1), "wd": l["mlp"]["wd"]})
        for l in text["layers"]])
    x, pos3, _ = _dec_inputs(2, 12, seed=3)
    a, _ = TD.decoder_forward(text, CFG.text, _t(x), _t(pos3))
    b, _ = TD.decoder_forward(fused, CFG.text, _t(x), _t(pos3))
    _close(a, b, atol=1e-5)


def test_drop_write_out_of_range_decode_rows():
    """Decode rows at cache_len >= T write nothing (the reference's drop mode): the
    index T never reaches the cache."""
    cache = torch.arange(2 * 1 * 4 * 2, dtype=torch.float32).reshape(2, 1, 4, 2)
    before = cache.clone()
    vals = torch.full((2, 1, 1, 2), -7.0)
    TD._drop_write(cache, torch.tensor([[1], [4]]), vals)
    expect = before.clone()
    expect[0, :, 1] = -7.0
    assert torch.equal(cache, expect)


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------

def _vlm_inputs(seed):
    from zoomearth_tpu.runtime.generate import prepare_batch as jax_prepare_batch

    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    grids = [(1, 4, 4), (1, 4, 6)]
    seqs, imgs = [], []
    for g in grids:
        n = g[0] * g[1] * g[2] // CFG.vision.merge_unit
        ids = ([tok.im_start] + list(rng.integers(1, 400, 3)) + [tok.vision_start]
               + [tok.image_pad] * n + [tok.vision_end] + list(rng.integers(1, 400, 4 + len(seqs))))
        seqs.append(ids)
        imgs.append([(rng.standard_normal((g[1] * g[2], CFG.vision.patch_dim)).astype(np.float32), g)])
    return jax_prepare_batch(CFG, seqs, imgs, length_buckets=(32,), patch_buckets=(64,))


def test_vlm_forward_no_cache_matches_jax(params):
    jp, tp = params
    b = _vlm_inputs(3)
    meta = {k: v for k, v in b.vision_meta.items() if k != "win_mode"}
    valid = np.arange(b.input_ids.shape[1])[None] < b.lengths[:, None]
    jl, _ = JM.vlm_forward(jp, CFG, b.input_ids, b.position_ids, pixel_values=b.pixel_values,
                           vision_meta=JM.vision_meta_to_device(JV.vision_metadata(
                               [(1, 4, 4), (1, 4, 6)], CFG.vision, pad_to=64)),
                           attn_valid=valid, win_mode=b.vision_meta["win_mode"])
    tl, _ = TM.vlm_forward(tp, CFG, _t(b.input_ids), _t(b.position_ids), pixel_values=_t(b.pixel_values),
                           vision_meta=TV.meta_to_device(meta, "cpu"), attn_valid=_t(valid),
                           win_mode=b.vision_meta["win_mode"])
    for r, n in enumerate(b.lengths):
        _close(tl[r, :n], np.asarray(jl)[r, :n])


def test_vlm_forward_cache_logit_index_matches_jax(params):
    jp, tp = params
    b = _vlm_inputs(4)
    B, S = b.input_ids.shape
    meta = {k: v for k, v in b.vision_meta.items() if k != "win_mode"}
    apos = np.broadcast_to(np.arange(S)[None], (B, S))
    valid = apos < b.lengths[:, None]
    jl, _ = JM.vlm_forward(jp, CFG, b.input_ids, b.position_ids, pixel_values=b.pixel_values,
                           vision_meta={k: jnp.asarray(v) for k, v in meta.items()},
                           attn_positions=apos, attn_valid=valid,
                           cache=JD.KVCache.create(CFG.text, B, 64, jnp.float32),
                           update_cache_len=False, logit_index=jnp.asarray(b.lengths - 1),
                           win_mode=b.vision_meta["win_mode"])
    tl, tc = TM.vlm_forward(tp, CFG, _t(b.input_ids), _t(b.position_ids), pixel_values=_t(b.pixel_values),
                            vision_meta=TV.meta_to_device(meta, "cpu"), attn_positions=_t(apos),
                            attn_valid=_t(valid), cache=TD.KVCache.create(CFG.text, B, 64, torch.float32),
                            update_cache_len=False, logit_index=_t(b.lengths - 1),
                            win_mode=b.vision_meta["win_mode"])
    assert tl.shape == (B, CFG.text.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)


def test_logits_bf16_head_is_fp32():
    cfg = VLMConfig.tiny()
    w = torch.randn(cfg.text.vocab_size, cfg.text.hidden_size).to(torch.bfloat16)
    h = torch.randn(3, cfg.text.hidden_size).to(torch.bfloat16)
    out = TD.logits_from_hidden({"embed": {"weight": w}}, cfg.text, h)
    assert out.dtype == torch.float32
    _close(out, h.float() @ w.float().t(), atol=1e-4)


# ---------------------------------------------------------------------------
# int8 KV cache, the pair decode step, precomputed vision embeddings, repairs
# ---------------------------------------------------------------------------

def test_quantize_kv_equals_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * rng.uniform(0.01, 30, (3, 5, 2, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-6 floor of the scale
    jq, js = JD._quantize_kv(jnp.asarray(x))
    tq, ts = TD._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32  # the bf16-rounded scale, held in fp32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.astype(jnp.float32)))
    tq16, ts16 = TD._quantize_kv(_t(x).bfloat16())
    jq16, js16 = JD._quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(tq16.numpy(), np.asarray(jq16))
    np.testing.assert_array_equal(ts16.numpy(), np.asarray(js16.astype(jnp.float32)))


def test_int8_cache_create_clone_grown_carry_scales():
    c = TD.KVCache.create(CFG.text, 2, 8, torch.int8)
    L, Hkv, D = CFG.text.num_hidden_layers, CFG.text.num_key_value_heads, CFG.text.head_dim
    assert c.quantized and len(c.kscale) == len(c.vscale) == L
    assert c.k[0].shape == (2, Hkv, 8, D) and c.k[0].dtype == torch.int8
    assert c.kscale[0].shape == (2, Hkv, 8) and c.kscale[0].dtype == torch.float32
    c.kscale[1][:] = 0.5
    c.k[1][:] = 3
    c.length[:] = 4
    for copy, rows in ((c.clone(), 8), (c.grown(12), 12)):
        assert copy.max_len == rows and copy.kscale[1].shape == (2, Hkv, rows)
        assert torch.equal(copy.kscale[1][:, :, :8], c.kscale[1]) and torch.equal(copy.k[1][:, :, :8], c.k[1])
        assert not bool(copy.kscale[1][:, :, 8:].any())
        assert copy.length.data_ptr() != c.length.data_ptr() and copy.length.tolist() == [4, 4]
    assert not TD.KVCache.create(CFG.text, 2, 8, torch.float32).quantized


def _jax_cache(B, T, dtype):
    return JD.KVCache.create(CFG.text, B, T, dtype)


def _compare_quant_cache(jc, tc):
    """int8 values and scales of every layer, every slot, bit for bit."""
    for i in range(len(jc.k)):
        np.testing.assert_array_equal(tc.k[i].numpy(), np.asarray(jc.k[i]))
        np.testing.assert_array_equal(tc.v[i].numpy(), np.asarray(jc.v[i]))
        np.testing.assert_array_equal(tc.kscale[i].numpy(), np.asarray(jc.kscale[i].astype(jnp.float32)))
        np.testing.assert_array_equal(tc.vscale[i].numpy(), np.asarray(jc.vscale[i].astype(jnp.float32)))


def _fill_caches(params, B, T, lengths, cache_dtype, seed):
    """A JAX and a port cache of one dtype prefilled with the same S = max(lengths)
    random inputs; returns (jax cache, port cache)."""
    jp, tp = params
    S = int(max(lengths))
    x, pos3, apos = _dec_inputs(B, S, seed)
    valid = apos < np.asarray(lengths)[:, None]
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[cache_dtype]
    _, jc = JD.decoder_forward(jp["text"], CFG.text, x, pos3, attn_positions=apos, attn_valid=valid,
                               cache=_jax_cache(B, T, jdt), update_cache_len=False)
    jc = jc._replace(length=jnp.asarray(lengths, jnp.int32))
    _, tc = TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3), attn_positions=_t(apos),
                               attn_valid=_t(valid), cache=TD.KVCache.create(CFG.text, B, T, tdt),
                               update_cache_len=False)
    tc.length.copy_(_t(np.asarray(lengths, np.int32)))
    return jc, tc


def test_decoder_int8_prefill_writes_equal_jax_and_hidden_is_close(params):
    """A fresh prefill into an int8 cache: the first layer's stored values and scales
    equal the reference's bit for bit (the same inputs are quantized). The hidden
    states are held looser: the reference reads an int8 cache at small S through a
    dequantized bf16 copy (k * ks rounded to bf16), K2's algebra applies the scales to
    fp32 logits. Later layers' stored values inherit that difference."""
    jp, tp = params
    B, S, T = 2, 24, 64
    x, pos3, apos = _dec_inputs(B, S, 1)
    valid = apos < np.asarray([24, 17])[:, None]
    jh, jc = JD.decoder_forward(jp["text"], CFG.text, x, pos3, attn_positions=apos, attn_valid=valid,
                                cache=_jax_cache(B, T, jnp.int8), update_cache_len=False)
    th, tc = TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3), attn_positions=_t(apos),
                                attn_valid=_t(valid), cache=TD.KVCache.create(CFG.text, B, T, torch.int8),
                                update_cache_len=False)
    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
    np.testing.assert_array_equal(tc.kscale[0].numpy(), np.asarray(jc.kscale[0].astype(jnp.float32)))
    np.testing.assert_array_equal(tc.vscale[0].numpy(), np.asarray(jc.vscale[0].astype(jnp.float32)))
    # bf16 rounding (2^-8) of the dequantized keys and values, through two layers
    _close(th[0], np.asarray(jh)[0], atol=3e-2)
    _close(th[1, :17], np.asarray(jh)[1, :17], atol=3e-2)


@pytest.mark.parametrize("cache_dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2), ("int8", ATOL)])
def test_decoder_forward_pair_matches_jax(params, cache_dtype, atol):
    """One dense pass over Ba = 3 and Bb = 2 rows, each group against its own cache
    with its own attend span; three steps. Both packages start from the SAME cache
    contents (the JAX prefill's, copied over), so the int8 step is exact algebra on
    both sides (decode_attention_q8 there, K3's plain version here): fp32 tolerance,
    new values and scales bit for bit. A bf16-dtype cache under fp32 weights rounds
    the stored rows on both sides; the products of bf16 rows are then taken in other
    orders (one bf16 step of the hidden state)."""
    jp, tp = params
    Ta, Tb, attend_a, attend_b = 64, 48, 32, None
    len_a, len_b = [20, 9, 14], [30, 5]
    ja, ta = _fill_caches(params, 3, Ta, len_a, cache_dtype, seed=21)
    jb, tb = _fill_caches(params, 2, Tb, len_b, cache_dtype, seed=22)

    def adopt(jc, tc):  # the port's cache takes the JAX cache's contents
        for name in ("k", "v") + (("kscale", "vscale") if tc.quantized else ()):
            for dst, src in zip(getattr(tc, name), getattr(jc, name)):
                dst.copy_(_t(np.asarray(src.astype(jnp.float32))).to(dst.dtype))

    adopt(ja, ta)
    adopt(jb, tb)
    la, lb = ta.length.data_ptr(), tb.length.data_ptr()
    for step in range(3):
        x, pos3, _ = _dec_inputs(5, 1, seed=40 + step, start=np.asarray(len_a + len_b) + step)
        jh, ja, jb = JD.decoder_forward_pair(jp["text"], CFG.text, x, pos3, ja, jb, attend_a, attend_b)
        th, ta2, tb2 = TD.decoder_forward_pair(tp["text"], CFG.text, _t(x), _t(pos3), ta, tb, attend_a, attend_b)
        assert ta2 is ta and tb2 is tb
        _close(th, jh, atol=atol)
        np.testing.assert_array_equal(ta.length.numpy(), np.asarray(ja.length))
        np.testing.assert_array_equal(tb.length.numpy(), np.asarray(jb.length))
    assert (ta.length.data_ptr(), tb.length.data_ptr()) == (la, lb)  # advanced in place
    if cache_dtype == "int8":
        # the first layer's new rows are the same inputs quantized: exact
        for jc, tc in ((ja, ta), (jb, tb)):
            np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
            np.testing.assert_array_equal(tc.kscale[0].numpy(), np.asarray(jc.kscale[0].astype(jnp.float32)))
    else:  # a bf16 row one layer on may land one bf16 step (2^-6 below 4) to the side
        for jc, tc, lens in ((ja, ta, len_a), (jb, tb, len_b)):
            for name in ("k", "v"):
                for jt, tt in zip(getattr(jc, name), getattr(tc, name)):
                    for b, n in enumerate(lens):
                        _close(tt[b, :, :n + 3].float(), np.asarray(jt.astype(jnp.float32))[b, :, :n + 3],
                               atol=ATOL if cache_dtype == "float32" else 2e-2)


def test_decoder_forward_pair_equals_two_solo_steps(params):
    """fp32: the concatenated pass gives each group what its own solo step gives."""
    _, tp = params
    _, ta = _fill_caches(params, 2, 64, [20, 9], "float32", seed=31)
    _, tb = _fill_caches(params, 3, 64, [12, 30, 7], "float32", seed=32)
    sa, sb = ta.clone(), tb.clone()
    x, pos3, _ = _dec_inputs(5, 1, seed=50, start=np.asarray([20, 9, 12, 30, 7]))
    th, _, _ = TD.decoder_forward_pair(tp["text"], CFG.text, _t(x), _t(pos3), ta, tb, 32, None)
    ha, _ = TD.decoder_forward(tp["text"], CFG.text, _t(x[:2]), _t(pos3[:, :2]), cache=sa, attend_len=32)
    hb, _ = TD.decoder_forward(tp["text"], CFG.text, _t(x[2:]), _t(pos3[:, 2:]), cache=sb)
    _close(th, torch.cat([ha, hb]), atol=1e-5)
    for pair, solo in ((ta, sa), (tb, sb)):
        assert torch.equal(pair.length, solo.length)
        for a, b in zip(pair.k + pair.v, solo.k + solo.v):
            _close(a, b, atol=1e-5)


def test_vlm_forward_vision_embeds_equal_pixel_values_and_jax(params):
    jp, tp = params
    b = _vlm_inputs(5)
    meta = {k: v for k, v in b.vision_meta.items() if k != "win_mode"}
    valid = np.arange(b.input_ids.shape[1])[None] < b.lengths[:, None]
    win_mode = b.vision_meta["win_mode"]
    dmeta = TV.meta_to_device(meta, "cpu")
    tl, _ = TM.vlm_forward(tp, CFG, _t(b.input_ids), _t(b.position_ids), pixel_values=_t(b.pixel_values),
                           vision_meta=dmeta, attn_valid=_t(valid), win_mode=win_mode)
    emb = TM.compute_vision_embeds(tp, CFG, _t(b.pixel_values), dmeta, win_mode)
    te, _ = TM.vlm_forward(tp, CFG, _t(b.input_ids), _t(b.position_ids), vision_embeds=emb, attn_valid=_t(valid))
    assert torch.equal(te, tl)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    jemb = JM.compute_vision_embeds(jp, CFG, b.pixel_values, jmeta, win_mode)
    n_real = int((b.input_ids == CFG.tokens.image_pad).sum())
    _close(emb[:n_real], np.asarray(jemb)[:n_real])
    jl, _ = JM.vlm_forward(jp, CFG, b.input_ids, b.position_ids, vision_embeds=jemb, attn_valid=valid)
    for r, n in enumerate(b.lengths):
        _close(te[r, :n], np.asarray(jl)[r, :n])


def test_write_index_from_host_equals_from_device_and_is_built_once(params, monkeypatch):
    """The kept (row, token, slot) writes of a chunk prefill depend on write_pos alone:
    built from the host array they equal those built from the tensor, a forward
    without a ready index builds it once for every layer's k and v, and the cache
    comes out bit for bit the same either way."""
    _, tp = params
    B, T, S = 2, 64, 16
    keep, chunk_lens = np.array([20, 9], np.int32), np.array([16, 1], np.int32)
    apos = keep[:, None] + np.arange(S)[None]
    valid = np.arange(S)[None] < chunk_lens[:, None]
    write_pos = np.where(valid, apos, T).astype(np.int32)
    for a, b in zip(TD.write_index(write_pos, T), TD.write_index(_t(write_pos), T)):
        assert a.dtype == b.dtype == torch.int64 and torch.equal(a, b)
    assert TD.write_index(write_pos, T)[2].tolist() == list(range(20, 36)) + [9]
    built = []
    orig = TD.write_index
    monkeypatch.setattr(TD, "write_index", lambda *a, **kw: (built.append(1), orig(*a, **kw))[1])
    x, pos3, _ = _dec_inputs(B, S, seed=5, start=keep + 3)
    caches = []
    for index in (None, orig(write_pos, T)):
        _, tc = _fill_caches(params, B, T, [24, 17], "float32", seed=1)
        tc.length.copy_(_t(keep))
        TD.decoder_forward(tp["text"], CFG.text, _t(x), _t(pos3), attn_positions=_t(apos), attn_valid=_t(valid),
                           cache=tc, update_cache_len=False, write_pos=_t(write_pos), index=index)
        caches.append(tc)
    assert len(built) == 1  # the forward without an index built one, once; the other built none
    for a, b in zip(caches[0].k + caches[0].v, caches[1].k + caches[1].v):
        assert torch.equal(a, b)


def test_drop_write_scales_and_out_of_range_rows():
    """The 3-D variant (an int8 cache's scales): decode rows past the end write nothing,
    chunk writes go through the shared index."""
    scales = torch.arange(2 * 1 * 4, dtype=torch.float32).reshape(2, 1, 4)
    before = scales.clone()
    TD._drop_write(scales, torch.tensor([[2], [4]]), torch.full((2, 1, 1), -7.0))
    expect = before.clone()
    expect[0, :, 2] = -7.0
    assert torch.equal(scales, expect)
    wp = torch.tensor([[0, 1, 4], [4, 3, 4]])
    TD._drop_write(scales, wp, torch.tensor([[[1.0], [2.0], [3.0]], [[4.0], [5.0], [6.0]]]), TD.write_index(wp, 4))
    expect[0, :, 0], expect[0, :, 1], expect[1, :, 3] = 1.0, 2.0, 5.0
    assert torch.equal(scales, expect)
