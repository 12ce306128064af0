"""The Generator's two opt-in memory levers on the CPU, against the JAX package's
Generator: the split-row prefill (`prefill_split_rows`) and the right-sized stage-1
cache (`right_size_cache`), through run_prefill, generate, continue_generate and
runtime/pipeline.py::run_paired_waves.

Both packages get the JAX package's tiny random parameters (fp32) and the same
host-prepared batches, whose vision embeddings are computed once by the JAX package
(the split applies to the embeds path only). Logits and fp32 caches agree to 5e-5;
tokens, lengths and shapes exactly. The split prefill and the one-shot prefill of the
port run the same arithmetic on fewer rows, so their caches agree to 5e-5 in every
fp32 cache; a bf16 or int8 cache, against either, is held to what its own rounding
allows (one bf16 step of a value, one int8 step, the scale's bf16 step): fp32 sums
over fewer rows may put a value on the other side of a rounding edge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.models.vit import vision_metadata
from zoomearth_tpu.models.vlm import compute_vision_embeds, vision_meta_to_device
from zoomearth_tpu.runtime import generate as JG
from zoomearth_tpu.runtime import pipeline as JP
from zoomearth_tpu_torch.models import decoder as TD
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.runtime import pipeline as TP

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
TOL = 5e-5
GREEDY = 10  # decode budget of the split cases


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _gens(params, **kw):
    jp, tp = params
    kw = {"max_cache_len": 256, "cache_dtype": "float32", **kw}
    return JG.Generator(jp, CFG, **kw), TG.Generator(tp, CFG, **kw)


def _row(seed, grid=(1, 4, 4)):
    """(ids, images) of one stage-1 prompt; its length grows with the seed."""
    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    pv = rng.standard_normal((grid[0] * grid[1] * grid[2], CFG.vision.patch_dim)).astype(np.float32)
    n = (grid[0] * grid[1] * grid[2]) // CFG.vision.merge_unit
    ids = ([tok.im_start] + [int(t) for t in rng.integers(1, 400, size=5)] + [tok.vision_start]
           + [tok.image_pad] * n + [tok.vision_end] + [7] * seed)
    return ids, [(pv, grid)]


def _patch_batch(seeds, grid=(1, 4, 4)):
    rows = [_row(s, grid) for s in seeds]
    return JG.prepare_batch(CFG, [r[0] for r in rows], [r[1] for r in rows],
                            length_buckets=(64,), patch_buckets=(128,))


def _embeds(params, batch, grid=(1, 4, 4)):
    """The batch with its patches replaced by the JAX package's vision embeddings
    (vision_meta None: the embeds path)."""
    meta = vision_metadata([grid] * batch.input_ids.shape[0], CFG.vision, pad_to=batch.pixel_values.shape[0])
    emb = compute_vision_embeds(params[0], CFG, jnp.asarray(batch.pixel_values), vision_meta_to_device(meta),
                                win_mode=meta.win_mode)
    return dataclasses.replace(batch, pixel_values=np.array(emb), vision_meta=None)


def _embeds_batch(params, seeds):
    return _embeds(params, _patch_batch(seeds))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cache_leaves(c):
    """name -> list of per-layer arrays (k, v, and the int8 scales where present)."""
    out = {"k": list(c.k), "v": list(c.v)}
    if getattr(c, "kscale", None) is not None:
        out["kscale"], out["vscale"] = list(c.kscale), list(c.vscale)
    return out


def _assert_caches_close(a, b, rule):
    """Every leaf of cache a within `rule(name, x_a, x_b)` of cache b's, elementwise."""
    la, lb = _cache_leaves(a), _cache_leaves(b)
    assert sorted(la) == sorted(lb)
    for name in la:
        for x, y in zip(la[name], lb[name]):
            x, y = _np(x), _np(y)
            assert x.shape == y.shape, name
            err = np.abs(x - y)
            bound = rule(name, x, y)
            assert (err <= bound).all(), (name, float(err.max()))


def _exact_to(tol):
    return lambda name, x, y: tol


def _rounding_of(dtype):
    """The largest difference the cache dtype's own rounding leaves between the two
    packages: one bf16 step of the value (8 bits of mantissa), one int8 step, and a
    scale's bf16 step; fp32 to TOL."""
    def rule(name, x, y):
        if dtype == "float32":
            return TOL
        if dtype == "int8" and name in ("k", "v"):
            return 1.0
        return np.maximum(np.abs(x), np.abs(y)) * 2.0 ** -7 + 1e-6
    return rule


def _assert_low_precision_caches_close(a, b, dtype):
    """A bf16 or int8 cache of the port against the JAX package's. The first layer's
    keys and values come from the same embeddings: to the dtype's rounding. Later
    layers' come from hidden states that went through attention over the cache, which
    the two packages read in different precisions (the JAX prefill through a bf16
    copy), so each layer's values, dequantized, are held within 2^-6 of that layer's
    largest value: an int8 step is 1/127 of a token's largest value, two bf16 steps
    2^-7."""
    _assert_caches_close(_first_layer(a), _first_layer(b), _rounding_of(dtype))
    for name in ("k", "v"):
        for i in range(CFG.text.num_hidden_layers):
            x, y = _np(getattr(a, name)[i]), _np(getattr(b, name)[i])
            if dtype == "int8":
                x = x * _np(getattr(a, name + "scale")[i])[..., None]
                y = y * _np(getattr(b, name + "scale")[i])[..., None]
            assert np.abs(x - y).max() <= 2.0 ** -6 * np.abs(y).max(), (name, i)


def _first_layer(c):
    return TD.KVCache([c.k[0]], [c.v[0]], None, [c.kscale[0]] if c.kscale is not None else None,
                      [c.vscale[0]] if c.vscale is not None else None)


def _count_k2(monkeypatch):
    """Row counts of every K2 call the decoder makes, from here on."""
    rows = []
    orig = TD.flash_causal_attention

    def counted(q, *a, **kw):
        rows.append(q.shape[0])
        return orig(q, *a, **kw)

    monkeypatch.setattr(TD, "flash_causal_attention", counted)
    return rows


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_split_prefill_against_jax_and_the_one_shot_prefill(params, cache_dtype, monkeypatch):
    """prefill_split_rows=2 over 4 embeds rows of different lengths: K2 runs on 2-row
    slices (2 per layer), the cache keeps its one `length` tensor, and the first
    logits, every cache leaf and the lengths equal the port's one-shot prefill's
    (logits 5e-5, the cache to its dtype's rounding) and the JAX split Generator's
    (5e-5 for logits and an fp32 cache; a bf16 or int8 cache as
    _assert_low_precision_caches_close says, its logits to 1e-2, the int8 rule of
    test_torch_slice). Greedy tokens are those of the one-shot prefill, and with an
    fp32 cache those of the JAX package."""
    batch = _embeds_batch(params, (1, 2, 3, 4))
    assert len(set(batch.lengths.tolist())) == 4
    jg, tg = _gens(params, cache_dtype=cache_dtype, prefill_split_rows=2)
    _, tg_full = _gens(params, cache_dtype=cache_dtype)
    rows = _count_k2(monkeypatch)
    with torch.inference_mode():
        logits, cache, attend = tg.run_prefill(batch, max_new=GREEDY)
        length_ptr = cache.length.data_ptr()
        assert rows == [2] * (2 * CFG.text.num_hidden_layers)
        del rows[:]
        ref_logits, ref_cache, ref_attend = tg_full.run_prefill(batch, max_new=GREEDY)
        assert rows == [4] * CFG.text.num_hidden_layers
    assert attend == ref_attend and cache.max_len == ref_cache.max_len == 256
    assert cache.length.tolist() == ref_cache.length.tolist() == batch.lengths.tolist()
    assert cache.length.data_ptr() == length_ptr
    np.testing.assert_allclose(_np(logits), _np(ref_logits), atol=TOL, rtol=0)
    _assert_caches_close(cache, ref_cache, _rounding_of(cache_dtype))

    j_logits, j_cache, j_attend = jg.run_prefill(batch, max_new=GREEDY)
    assert j_attend == attend
    assert np.asarray(j_cache.length).tolist() == batch.lengths.tolist()
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), atol=TOL if cache_dtype == "float32" else 1e-2,
                               rtol=0)
    if cache_dtype == "float32":
        _assert_caches_close(cache, j_cache, _exact_to(TOL))
    else:
        _assert_low_precision_caches_close(cache, j_cache, cache_dtype)

    gen_t = TG.GenerationConfig(max_new_tokens=GREEDY)
    out = tg.generate(batch, gen_t)
    assert out == tg_full.generate(batch, gen_t)
    if cache_dtype == "float32":
        assert out == jg.generate(batch, JG.GenerationConfig(max_new_tokens=GREEDY))


@pytest.mark.parametrize("case", ["rows_do_not_divide", "patches_with_vision_meta", "batch_not_above_rows"])
def test_split_prefill_takes_the_one_shot_path_where_the_reference_does(params, case, monkeypatch):
    """The split applies only where the reference's does (R and B > R and B % R == 0,
    embeds, no vision_meta): a batch of 3 rows under R = 2, a batch carrying patches
    and vision_meta, and 2 rows under R = 2 each go through one one-shot prefill, one
    K2 call per layer over every row, with logits equal to the JAX Generator's (same
    R) to 5e-5 and its tokens."""
    seeds = {"rows_do_not_divide": (1, 2, 3), "patches_with_vision_meta": (1, 2, 3, 4),
             "batch_not_above_rows": (1, 2)}[case]
    batch = _patch_batch(seeds)
    if case != "patches_with_vision_meta":
        batch = _embeds(params, batch)
    jg, tg = _gens(params, prefill_split_rows=2)
    rows = _count_k2(monkeypatch)
    with torch.inference_mode():
        logits, cache, _ = tg.run_prefill(batch, max_new=GREEDY)
    assert rows == [len(seeds)] * CFG.text.num_hidden_layers
    j_logits, j_cache, _ = jg.run_prefill(batch, max_new=GREEDY)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), atol=TOL, rtol=0)
    _assert_caches_close(cache, j_cache, _exact_to(TOL))
    assert tg.generate(batch, TG.GenerationConfig(max_new_tokens=GREEDY)) == jg.generate(
        batch, JG.GenerationConfig(max_new_tokens=GREEDY))


def _chunk(seed, grid=(1, 2, 4)):
    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    pv = rng.standard_normal((grid[0] * grid[1] * grid[2], CFG.vision.patch_dim)).astype(np.float32)
    n = (grid[0] * grid[1] * grid[2]) // CFG.vision.merge_unit
    return [tok.vision_start] + [tok.image_pad] * n + [tok.vision_end], [(pv, grid)]


@pytest.mark.parametrize("split", [0, 2])
def test_right_size_cache_grows_in_continue_generate(params, split):
    """right_size_cache=True (max_cache_len 512): generate's stage-1 cache is 256 slots
    (bucket of 64 + 8), continue_generate with a 300-token budget grows it to 512, and
    the tokens of both stages equal the JAX right-sized Generator's and a full-size
    Generator's; the grown cache equals the JAX package's to 5e-5 slot for slot (its
    zero-extended tail included) and the lengths exactly. With split = 2 the stage-1
    batch is 4 embeds rows prefilled in 2-row slices into the right-sized cache."""
    kw = {"max_cache_len": 512, "right_size_cache": True, "prefill_split_rows": split}
    jg, tg = _gens(params, **kw)
    _, t_full = _gens(params, max_cache_len=512)
    b1 = _embeds_batch(params, (1, 2, 3, 4))
    gen1, gen2 = TG.GenerationConfig(max_new_tokens=8), TG.GenerationConfig(max_new_tokens=300)
    out1, cache = tg.generate(b1, gen1, return_cache=True)
    j_out1, j_cache = jg.generate(b1, JG.GenerationConfig(max_new_tokens=8), return_cache=True)
    assert cache.max_len == np.asarray(j_cache.k[0]).shape[2] == 256
    assert out1 == j_out1 == t_full.generate(b1, gen1)
    old = [k.clone() for k in cache.k]
    length_before = cache.length.tolist()

    chunks = [_chunk(30 + b) for b in range(4)]
    keep = np.asarray([int(b1.lengths[b]) + len(out1[b]) for b in range(4)], np.int32)
    starts = [int(b1.next_pos[b]) + len(out1[b]) for b in range(4)]
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks], starts,
                                 length_buckets=(16,), patch_buckets=(64,))
    out2, cache2 = tg.continue_generate(cache, bc, keep, gen2, return_cache=True)
    j_out2, j_cache2 = jg.continue_generate(j_cache, bc, keep, JG.GenerationConfig(max_new_tokens=300),
                                            return_cache=True)
    assert cache2.max_len == np.asarray(j_cache2.k[0]).shape[2] == 512
    assert out2 == j_out2
    assert cache2.length.tolist() == np.asarray(j_cache2.length).tolist()
    _assert_caches_close(cache2, j_cache2, _exact_to(TOL))
    # growth kept the stage-1 slots below each row's keep, and left the 256-slot cache as it was
    assert cache.length.tolist() == length_before
    for k_old, k_stage1, k_new in zip(old, cache.k, cache2.k):
        assert torch.equal(k_stage1, k_old)
        for b in range(4):
            assert torch.equal(k_new[b, :, : keep[b]], k_old[b, :, : keep[b]])

    # the full-size Generator's continuation gives the same tokens
    f_out1, f_cache = t_full.generate(b1, gen1, return_cache=True)
    assert f_cache.max_len == 512
    assert t_full.continue_generate(f_cache, bc, keep, gen2) == out2


def test_grown_cache_zero_extends_every_leaf():
    """KVCache.grown: every leaf (k, v and the int8 scales) keeps its slots and is zero
    past them, with a length tensor of its own."""
    c = TD.KVCache.create(CFG.text, 2, 8, torch.int8)
    for t in c.k + c.v:
        t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8))
    for t in c.kscale + c.vscale:
        t.uniform_(0.5, 1.0)
    c.length.copy_(torch.tensor([3, 8], dtype=torch.int32))
    g = c.grown(16)
    assert g.max_len == 16 and g.length.tolist() == [3, 8] and g.length.data_ptr() != c.length.data_ptr()
    for a, b in zip(c.k + c.v + c.kscale + c.vscale, g.k + g.v + g.kscale + g.vscale):
        assert torch.equal(b[:, :, :8], a) and not b[:, :, 8:].any()


def _embeds_hooks(params, B):
    """Two-stage hooks: stage 1 a B-row embeds batch (the split's input), stage 2 a
    text continuation."""
    def build_stage1(w):
        return _embeds_batch(params, tuple(range(1 + w, 1 + w + B)))

    def build_stage2(w, out1, base_lengths, base_next):
        rngw = np.random.default_rng(100 + w)
        chunks = [[int(t) for t in rngw.integers(1, 300, size=3)] for _ in range(B)]
        keep = np.asarray([int(base_lengths[b]) + len(out1[b]) for b in range(B)], np.int32)
        starts = [int(base_next[b]) + len(out1[b]) for b in range(B)]
        return TG.prepare_continuation(CFG, chunks, [[] for _ in range(B)], starts, length_buckets=(16,)), keep, None

    return build_stage1, build_stage2


@pytest.mark.parametrize("edges", ["dummy", "solo"])
def test_paired_waves_over_a_split_generator_match_jax(params, edges, monkeypatch):
    """run_paired_waves over a Generator with prefill_split_rows=2 on 4-row embeds
    waves: every wave's stage-1 prefill runs in 2-row slices (K2 on 2 rows), and the
    tokens of both stages of every wave equal the JAX runner's over its own split
    Generator."""
    jg, tg = _gens(params, prefill_split_rows=2)
    s1, s2 = _embeds_hooks(params, 4)
    got = {}
    rows = _count_k2(monkeypatch)
    TP.run_paired_waves(tg, 3, s1, s2, gen1=TG.GenerationConfig(max_new_tokens=6),
                        gen2=TG.GenerationConfig(max_new_tokens=9), seed=0, edges=edges,
                        on_complete=lambda w, o1, o2: got.__setitem__(w, (o1, o2)))
    assert rows.count(2) == 3 * 2 * CFG.text.num_hidden_layers
    ref = {}
    JP.run_paired_waves(jg, 3, s1, s2, gen1=JG.GenerationConfig(max_new_tokens=6),
                        gen2=JG.GenerationConfig(max_new_tokens=9), seed=0, edges=edges,
                        on_complete=lambda w, o1, o2: ref.__setitem__(w, (o1, o2)))
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    assert all(got[w] == ref[w] for w in got)
