"""The port's serving path against the JAX package on the CPU: the continuous-batching
ServingEngine and run_episodes_served.

Both packages get the JAX package's tiny random parameters (fp32) and the same
requests. Greedy decoding must be token for token the JAX engine's (and the port's own
Generator's); with the int8 KV cache a row may differ by a tie only (`_ties_only`, the
rule of tests/test_torch_slice.py). Sampled rows draw other numbers than JAX's from one
seed, so they are held to what must hold: tokens in range, greedy rows of the same
batch unchanged, two engines with one seed agree. The scheduler's behaviour (refusals,
the pump, cancellation, failure isolation, random traffic) is held to the assertions of
the JAX package's own engine tests. Every wait has a timeout of its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent import prompts as PT
from zoomearth_tpu.agent.processor import Processor
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.runtime import generate as JG
from zoomearth_tpu.serve import engine as JE
from zoomearth_tpu.serve import episodes as JEP
from zoomearth_tpu.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.serve import engine as TE
from zoomearth_tpu_torch.serve import episodes as TEP

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
INT8_LOGITS_ATOL = 1e-2  # the size of the int8 quantization's own effect on these logits (max |logit| ~0.5)
WAIT = 60  # seconds a test waits for one completion before it fails


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engines(params, **kw):
    """[(module, engine)]: the JAX package's engine, then the port's on the CPU."""
    kw = {"cache_dtype": "float32", **kw}
    return [(JE, JE.ServingEngine(params[0], CFG, **kw)), (TE, TE.ServingEngine(params[1], CFG, **kw))]


def _port(params, **kw):
    return TE.ServingEngine(params[1], CFG, **{"cache_dtype": "float32", **kw})


def _image(grid, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((grid[0] * grid[1] * grid[2], CFG.vision.patch_dim)).astype(np.float32), grid


def _prompt(seed, n_text=8, grid=None):
    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    ids = [tok.im_start] + [int(i) for i in rng.integers(1, 400, size=n_text)]
    imgs = []
    if grid:
        pv, g = _image(grid, seed)
        n = (g[0] * g[1] * g[2]) // CFG.vision.merge_unit
        ids += [tok.vision_start] + [tok.image_pad] * n + [tok.vision_end]
        imgs = [(pv, g)]
    return ids, imgs


def _serve(M, engine, prompts, prefix="r", each=False, **kw):
    """Submit the prompts and drain the engine; each=True drains after every submit (so a
    prefix hit or miss does not depend on batching). Returns the token lists."""
    for i, (ids, imgs) in enumerate(prompts):
        engine.submit(M.Request(request_id=f"{prefix}{i}", token_ids=ids, images=imgs, **kw))
        if each:
            engine.run_until_idle()
    engine.run_until_idle()
    return [engine.get_completion(f"{prefix}{i}", timeout=1).token_ids for i in range(len(prompts))]


def _generator_output(gen, G, ids, imgs, max_new):
    batch = G.prepare_batch(CFG, [ids], [imgs], length_buckets=(64,), patch_buckets=(64,) if imgs else (0,))
    return gen.generate(batch, G.GenerationConfig(max_new_tokens=max_new))[0]


def _same_up_to_stop(got, want, max_new):
    """The engine runs a row to "length"; the Generator trims at a stop token."""
    got = got[: len(want)]
    return got == want[: len(got)] and len(got) >= min(max_new, len(want))


def _ties_only(jg, prompts, outs, refs, bound):
    """Greedy rows that differ must differ by a TIE: where row r first departs from the
    JAX engine's tokens (step t), the JAX package's own logits for prompt + its
    tokens[:t] (a fresh prefill through a Generator of the same cache dtype) must hold
    the port's token within `bound` of the one it chose itself. Returns the number of
    rows that differed."""
    stops = (CFG.tokens.eos, CFG.tokens.endoftext)
    tied = 0
    for (ids, imgs), out, ref in zip(prompts, outs, refs):
        if out == ref:
            continue
        t = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b), min(len(out), len(ref)))
        b = JG.prepare_batch(CFG, [list(ids) + list(ref[:t])], [imgs], length_buckets=(128,), patch_buckets=(64,))
        logits = np.asarray(jg.run_prefill(b)[0])[0]
        ours = logits[out[t]] if t < len(out) else max(logits[s] for s in stops)
        theirs = logits[ref[t]] if t < len(ref) else max(logits[s] for s in stops)
        assert theirs - ours < bound, (t, float(theirs - ours))
        tied += 1
    return tied


# ---------------------------------------------------------------------------
# Against the JAX engine, token for token
# ---------------------------------------------------------------------------

def test_mixed_burst_matches_jax_engine_and_port_generator(params):
    prompts = [_prompt(1, 6), _prompt(2, 9, grid=(1, 4, 4)), _prompt(3, 12)]
    outs, stats = [], []
    for M, e in _engines(params, max_slots=2, max_seq_len=128, decode_chunk=4, length_buckets=(64, 128),
                         patch_buckets=(64,)):
        outs.append(_serve(M, e, prompts, max_tokens=10))
        stats.append({k: e.stats[k] for k in ("completed", "decode_steps", "prefills", "prefill_rows",
                                              "decode_live_row_steps", "decode_device_row_steps")})
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    gen = TG.Generator(params[1], CFG, max_cache_len=256, cache_dtype="float32")
    for (ids, imgs), got in zip(prompts, outs[1]):
        assert _same_up_to_stop(got, _generator_output(gen, TG, ids, imgs, 10), 10)
    assert any(len(o) == 10 for o in outs[1])


def test_queue_beyond_capacity_and_slot_reuse_matches_jax_engine(params):
    prompts = [_prompt(10 + i, 5 + i) for i in range(5)]
    outs = []
    for M, e in _engines(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,),
                         patch_buckets=(0,)):
        outs.append(_serve(M, e, prompts, prefix="q", max_tokens=4))
        assert all(len(t) <= 4 for t in outs[-1])
        assert e.stats["completed"] == 5 and e.stats["prefill_rows"] == 5
        assert e.stats["prefills"] <= 5  # admissions are batched
        assert not e.active.any() and all(s.request is None for s in e.slots)
    assert outs[1] == outs[0]


def _prefix_requests(seed):
    tok = CFG.tokens
    rng = np.random.default_rng(seed)
    pv, grid = _image((1, 4, 4), seed)
    n_img = (grid[0] * grid[1] * grid[2]) // CFG.vision.merge_unit
    prefix_ids = ([tok.im_start] + [int(i) for i in rng.integers(1, 400, size=4)]
                  + [tok.vision_start] + [tok.image_pad] * n_img + [tok.vision_end])
    suffixes = [[int(i) for i in rng.integers(1, 400, size=6)] for _ in range(3)]
    return prefix_ids, [(prefix_ids + suf, [(pv, grid)]) for suf in suffixes]


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefix_cache_miss_then_hits_match_jax_engine_and_the_cold_path(params, cache_dtype):
    """Requests sharing a 'system + image' span: the first misses and saves it, the next
    two hit (their ViT pass and the span's prefill skipped). Tokens equal the JAX
    engine's and the port's own cold path; with the int8 cache the prefix pool carries
    the values and the scale rows, so a hit reads the bytes a cold prefill writes."""
    prefix_ids, prompts = _prefix_requests(7 if cache_dtype == "float32" else 11)
    kw = dict(max_slots=2, max_seq_len=128, decode_chunk=4, cache_dtype=cache_dtype, length_buckets=(64, 128),
              patch_buckets=(64,))
    outs = []
    for M, e in _engines(params, **kw):
        outs.append(_serve(M, e, prompts, prefix="p", each=True, max_tokens=8, prefix_key="imgA",
                           prefix_len=len(prefix_ids), n_prefix_images=1))
        assert e.stats["prefix_saves"] == 1 and e.stats["prefix_hits"] == 2
    cold = _serve(TE, _port(params, **kw), prompts, prefix="p", each=True, max_tokens=8)
    assert outs[1] == cold
    if cache_dtype == "float32":
        assert outs[1] == outs[0]
    else:
        jg = JG.Generator(params[0], CFG, max_cache_len=256, cache_dtype="int8")
        assert _ties_only(jg, prompts, outs[1], outs[0], INT8_LOGITS_ATOL) <= 1


def test_prefix_pool_rows_are_reused_least_recently_used_first(params):
    """The prefix pool's free list and its LRU eviction: with two pool rows, a third
    key evicts the key used longest ago, and no two live keys share a row."""
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=4, length_buckets=(64,), patch_buckets=(0,))
    e.max_prefixes, e._free_prefix_rows = 2, [1, 0]
    prompts = {k: _prompt(40 + i, 10)[0] for i, k in enumerate("abc")}

    def ask(key, rid):
        e.submit(TE.Request(request_id=rid, token_ids=prompts[key], images=[], max_tokens=3, prefix_key=key,
                            prefix_len=6))
        e.run_until_idle()
        return e.get_completion(rid, timeout=1).token_ids

    first = {k: ask(k, f"{k}0") for k in "ab"}
    assert ask("a", "a1") == first["a"] and e.stats["prefix_hits"] == 1  # a is now the fresher of the two
    ask("c", "c0")
    assert sorted(e.prefix_store) == ["a", "c"] and e.stats["prefix_saves"] == 3
    assert sorted(x.index for x in e.prefix_store.values()) == [0, 1]
    assert ask("a", "a2") == first["a"] and ask("b", "b1") == first["b"]  # a hit; b evicted, so a miss again
    assert e.stats["prefix_hits"] == 2 and e.stats["prefix_saves"] == 4


def test_int8_kv_cache_engine_matches_jax_engine_up_to_ties(params):
    """The row-compacted prefill carries the int8 cache's per-token scales through its
    gather and write-back, and a prefix_key request saves its span."""
    prompts = [_prompt(21, 6), _prompt(22, 9, grid=(1, 4, 4)), _prompt(23, 12)]
    outs = []
    for M, e in _engines(params, max_slots=2, max_seq_len=128, decode_chunk=4, cache_dtype="int8",
                         length_buckets=(64, 128), patch_buckets=(0, 64)):
        e.admission_debounce_s = 0.0
        for i, (ids, imgs) in enumerate(prompts):
            e.submit(M.Request(request_id=f"q{i}", token_ids=ids, images=imgs, max_tokens=6,
                               prefix_key="p" if i == 0 else None, prefix_len=3 if i == 0 else 0))
        e.run_until_idle()
        outs.append([e.get_completion(f"q{i}", timeout=1).token_ids for i in range(3)])
        assert e.stats["prefix_saves"] == 1
    assert all(len(t) >= 1 for t in outs[1])
    jg = JG.Generator(params[0], CFG, max_cache_len=256, cache_dtype="int8")
    assert _ties_only(jg, prompts, outs[1], outs[0], INT8_LOGITS_ATOL) <= 1


@pytest.mark.parametrize("attend_buckets", [(), (64, 128, 256)], ids=["full-span", "bucketed"])
def test_decode_attend_bucketing_matches_jax_engine(params, attend_buckets):
    """Decode reads only a prefix view of the cache covering the live rows' extents: an
    engine whose allocation (512) exceeds the rows' needs gives the JAX engine's tokens
    with bucketing on and off, and the bucketed one really read a prefix."""
    prompts = [_prompt(60 + i, n_text=6, grid=(1, 4, 4) if i % 2 else None) for i in range(3)]
    outs, attends = [], []
    for M, e in _engines(params, max_slots=2, max_seq_len=512, decode_chunk=4, length_buckets=(64,),
                         patch_buckets=(0, 16)):
        e.decode_attend_buckets = attend_buckets
        if M is TE:
            for name in ("_decode_steps", "_decode_steps_compact"):
                def spy(*a, _fn=getattr(e, name), **kw):
                    attends.append(kw["attend_len"])
                    return _fn(*a, **kw)
                setattr(e, name, spy)
        outs.append(_serve(M, e, prompts, prefix="a", max_tokens=8, temperature=0.0))
    assert outs[1] == outs[0]
    assert attends and all(a is None for a in attends) == (attend_buckets == ())
    assert attend_buckets == () or set(attends) <= {64, 128}


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_compact_decode_equals_full_width_decode(params, cache_dtype):
    """Row compaction (gather the live rows, step them, write them back) gives the
    tokens of the full-width chunk that runs in place on the pool, while stepping
    fewer device rows; in fp32 both equal the JAX engine's."""
    prompts = [_prompt(70, 7), _prompt(71, 5, grid=(1, 4, 4)), _prompt(72, 9), _prompt(73, 4), _prompt(74, 11)]
    kw = dict(max_slots=4, max_seq_len=128, decode_chunk=3, cache_dtype=cache_dtype, length_buckets=(64,),
              patch_buckets=(0, 16))
    budgets = [3, 12, 5, 9, 7]  # rows leave at different ticks, so the live count passes through every bucket

    def run(M, e):
        for i, (ids, imgs) in enumerate(prompts):
            e.submit(M.Request(request_id=f"c{i}", token_ids=ids, images=imgs, max_tokens=budgets[i]))
        e.run_until_idle()
        return [e.get_completion(f"c{i}", timeout=1).token_ids for i in range(len(prompts))]

    compact, full = _port(params, **kw), _port(params, **kw)
    assert compact.decode_row_buckets == (2,)
    full.decode_row_buckets = ()
    out_c, out_f = run(TE, compact), run(TE, full)
    assert out_c == out_f
    assert compact.stats["decode_live_row_steps"] == full.stats["decode_live_row_steps"]
    assert compact.stats["decode_device_row_steps"] < full.stats["decode_device_row_steps"]
    assert full.stats["decode_device_row_steps"] == 4 * full.stats["decode_steps"]
    if cache_dtype == "float32":
        assert out_c == run(JE, JE.ServingEngine(params[0], CFG, **kw))


def test_hold_and_continue_matches_jax_engine_and_the_unbroken_sequence(params):
    """stage 1 (held) + continuation equals one request over the full ids, the JAX
    engine's tokens, and the port's Generator over the unbroken sequence."""
    ids = _prompt(1)[0]
    chunk = [7, 8, 9]
    outs = []
    for M, e in _engines(params, max_slots=2, max_seq_len=512, decode_chunk=2,
                         length_buckets=(64, 128, 256, 512), patch_buckets=(0, 16, 64)):
        e.submit(M.Request(request_id="a", token_ids=ids, images=[], max_tokens=6, hold_slot=True))
        e.run_until_idle()
        c1 = e.get_completion("a", timeout=5)
        assert "a" in e.held
        e.submit_continuation(M.Continuation(parent_request_id="a", request_id="a2", chunk_ids=chunk, images=[],
                                             kept_tokens=len(c1.token_ids), max_tokens=5))
        e.run_until_idle()
        c2 = e.get_completion("a2", timeout=5)
        full = ids + c1.token_ids + chunk
        e.submit(M.Request(request_id="full", token_ids=full, images=[], max_tokens=5))
        e.run_until_idle()
        assert c2.token_ids == e.get_completion("full", timeout=5).token_ids
        assert not e.held and not e.active.any()
        outs.append((c1.token_ids, c2.token_ids, full))
    assert outs[1] == outs[0]
    gen = TG.Generator(params[1], CFG, max_cache_len=256, cache_dtype="float32")
    assert _same_up_to_stop(outs[1][1], _generator_output(gen, TG, outs[1][2], [], 5), 5)


def test_continuation_keeping_part_of_stage_one_with_an_image_chunk_matches_jax_engine(params):
    """A continuation that keeps only the first tokens of stage 1 and prefills a crop's
    vision tokens (the episode pattern), at kept counts either side of what the cache
    holds: the row's cache is cut to prompt + kept, and the last produced token, which
    the cache never held, is re-fed when it is kept."""
    ids, imgs = _prompt(5, 6, grid=(1, 4, 4))
    pv, g = _image((1, 2, 4), 6)
    tok = CFG.tokens
    chunk = [tok.vision_start] + [tok.image_pad] * 2 + [tok.vision_end]
    for kept in (2, 5, 6):
        outs = []
        for M, e in _engines(params, max_slots=2, max_seq_len=256, decode_chunk=2, length_buckets=(64,),
                             patch_buckets=(0, 16)):
            e.submit(M.Request(request_id="s1", token_ids=ids, images=imgs, max_tokens=6, hold_slot=True))
            e.run_until_idle()
            c1 = e.get_completion("s1", timeout=5)
            e.submit_continuation(M.Continuation(parent_request_id="s1", request_id="s2", chunk_ids=chunk,
                                                 images=[(pv, g)], kept_tokens=kept, max_tokens=5))
            e.run_until_idle()
            outs.append((c1.token_ids, e.get_completion("s2", timeout=5).token_ids))
        assert outs[1] == outs[0], kept
        assert len(outs[1][0]) == 6  # no early stop: kept=5 is what the cache holds, kept=6 re-feeds the last token


# ---------------------------------------------------------------------------
# Scheduler behaviour (the assertions of the JAX package's engine tests)
# ---------------------------------------------------------------------------

def test_oversized_request_rejected(params):
    e = _port(params, max_slots=1, max_seq_len=64, length_buckets=(64,), patch_buckets=(0,))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        e.submit(TE.Request(request_id="big", token_ids=_prompt(1, 50)[0], images=[], max_tokens=60))
    assert e.queue.empty()


def test_submit_rejects_over_bucket_prompt(params):
    e = _port(params, max_slots=1, max_seq_len=256, length_buckets=(64,), patch_buckets=(0,))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        e.submit(TE.Request(request_id="big", token_ids=_prompt(1, 100)[0], images=[], max_tokens=8))


def test_submit_accepts_prefix_request_with_long_prompt(params):
    """The submit guard applies to the post-prefix CHUNK; on a prefix MISS the full
    prompt fails safely through admission containment, on the host, before a launch."""
    e = _port(params, max_slots=1, max_seq_len=512, length_buckets=(64,), patch_buckets=(0,))
    long_ids = [CFG.tokens.im_start] + [int(i) for i in np.random.default_rng(3).integers(1, 400, size=100)]
    e.submit(TE.Request(request_id="pfx", token_ids=long_ids, images=[], max_tokens=4, prefix_key="shared-sys",
                        prefix_len=80))
    e.run_until_idle()
    assert e.get_completion("pfx", timeout=5).finish_reason == "error"
    with pytest.raises(ValueError, match="largest prefill bucket"):
        e.submit(TE.Request(request_id="plain", token_ids=long_ids, images=[], max_tokens=4))
    assert not e.active.any() and all(s.request is None for s in e.slots)


def test_background_pump_writes_the_pool_from_its_own_thread(params):
    """The pool is made of inference tensors by the thread that built the engine; the
    pump thread may write them only because step() enters inference mode itself."""
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    assert e.cache.k[0].is_inference() and e.cur_tokens.is_inference()
    ids = _prompt(7, 6)[0]
    ref = _serve(TE, _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,),
                           patch_buckets=(0,)), [(ids, [])], max_tokens=6)[0]
    e.start()
    try:
        e.submit(TE.Request(request_id="bg", token_ids=ids, images=[], max_tokens=6))
        c = e.get_completion("bg", timeout=WAIT)
        assert c.token_ids == ref and len(c.token_ids) <= 6
    finally:
        e.stop()
    assert e._pump_thread is None


def test_cancel_prefix_no_slot_leak(params):
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    e.submit(TE.Request(request_id="cx0", token_ids=_prompt(20, 6)[0], images=[], max_tokens=8, hold_slot=True))
    e.submit(TE.Request(request_id="keep0", token_ids=_prompt(21, 7)[0], images=[], max_tokens=6))
    e.submit(TE.Request(request_id="cx1", token_ids=_prompt(22, 8)[0], images=[], max_tokens=8, hold_slot=True))
    e.step()  # admit + first decode chunk: cx0/keep0 now IN FLIGHT, cx1 queued
    assert e.active.any()
    e.cancel_prefix("cx", timeout=WAIT)
    assert not any(k.startswith("cx") for k in e.held)
    assert not any(k.startswith("cx") for k in e.results)
    e.run_until_idle()
    assert len(e.get_completion("keep0", timeout=1).token_ids) <= 6
    for i in range(2):  # no leak: two NEW hold_slot requests must both find free slots
        e.submit(TE.Request(request_id=f"n{i}", token_ids=_prompt(30 + i, 6)[0], images=[], max_tokens=4,
                            hold_slot=True))
    e.run_until_idle()
    assert sorted(e.held) == ["n0", "n1"]


def test_mixed_temperature_rows(params):
    """A greedy row and a sampled row in one batch: the greedy row's tokens are those
    of the row served alone; every token is in range; two engines with one seed agree
    on the sampled row too, and the draw does depend on the seed's stream."""
    ids = _prompt(5, 8)[0]
    kw = dict(max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))

    def run(seed):
        e = _port(params, seed=seed, **kw)
        e.submit(TE.Request(request_id="g", token_ids=ids, images=[], max_tokens=6, temperature=0.0))
        e.submit(TE.Request(request_id="t", token_ids=ids, images=[], max_tokens=6, temperature=1.5))
        e.run_until_idle()
        return e.get_completion("g", timeout=1).token_ids, e.get_completion("t", timeout=1).token_ids

    g0, t0 = run(0)
    assert all(0 <= x < CFG.text.vocab_size for x in g0 + t0)
    assert g0 == _serve(TE, _port(params, **kw), [(ids, [])], max_tokens=6)[0]
    assert run(0) == (g0, t0)
    draws = {tuple(run(seed)[1]) for seed in (1, 2, 3)}
    assert len(draws | {tuple(t0)}) > 1 and t0 != g0


def test_oversized_image_burst_splits(params):
    e = _port(params, max_slots=4, max_seq_len=128, decode_chunk=2, length_buckets=(64, 128), patch_buckets=(0, 32))
    e.admission_debounce_s = 0.0
    # each image = 16 patches; 3 of them > the 32-patch bucket -> must split
    prompts = [_prompt(10 + i, 6, grid=(1, 4, 4)) for i in range(3)]
    outs = _serve(TE, e, prompts, prefix="s", max_tokens=3)
    assert e.stats["prefills"] >= 2 and e.stats["prefill_rows"] == 3
    whole = _port(params, max_slots=4, max_seq_len=128, decode_chunk=2, length_buckets=(64, 128), patch_buckets=(0, 64))
    assert outs == _serve(TE, whole, prompts, prefix="s", max_tokens=3) and whole.stats["prefills"] == 1


def test_admission_failure_does_not_kill_pump(params):
    e = _port(params, max_slots=2, max_seq_len=512, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    e.start()
    try:
        e.submit(TE.Request(request_id="p0", token_ids=_prompt(11, 6)[0], images=[], max_tokens=4, hold_slot=True))
        assert e.get_completion("p0", timeout=WAIT).finish_reason in ("stop", "length")
        big_chunk = [int(i) for i in np.random.default_rng(0).integers(1, 400, size=80)]
        e.submit_continuation(TE.Continuation(request_id="c0", parent_request_id="p0", chunk_ids=big_chunk,
                                              images=[], kept_tokens=0, max_tokens=4))
        c = e.get_completion("c0", timeout=WAIT)
        assert c.finish_reason == "error" and c.token_ids == []
        assert e.stats.get("errors", 0) == 1
        assert e.stats.get("admission_retries", 0) == 1 and e.stats.get("pump_errors", 0) == 0
        assert "p0" not in e.held and not any(s.held for s in e.slots)
        e.submit(TE.Request(request_id="p1", token_ids=_prompt(12, 8)[0], images=[], max_tokens=4))
        assert e.get_completion("p1", timeout=WAIT).finish_reason in ("stop", "length")
    finally:
        e.stop()


def test_partial_batch_failure_does_not_rerun_committed_rows(params):
    e = _port(params, max_slots=3, max_seq_len=512, decode_chunk=2, length_buckets=(64,), patch_buckets=(0, 16))
    emissions = []
    e.on_tokens = lambda rid, toks: emissions.append(rid)
    e.start()
    try:
        e.submit(TE.Request(request_id="parent", token_ids=_prompt(21, 5)[0], images=[], max_tokens=3, hold_slot=True))
        assert e.get_completion("parent", timeout=WAIT).finish_reason in ("stop", "length")
        e.stop()  # stage the co-admission deterministically
        # two 16-patch image requests + a poison continuation: 32 patches exceed patch_buckets[-1] = 16, so
        # the batch splits; group [img1] COMMITS, then the group holding the poison raises on the host
        for rid, seed, n in (("img1", 22, 5), ("img2", 23, 7)):
            ids, imgs = _prompt(seed, n, grid=(1, 4, 4))
            e.submit(TE.Request(request_id=rid, token_ids=ids, images=imgs, max_tokens=3))
        e.submit_continuation(TE.Continuation(
            request_id="poison", parent_request_id="parent",
            chunk_ids=[int(i) for i in np.random.default_rng(0).integers(1, 400, size=80)],
            images=[], kept_tokens=0, max_tokens=3))
        e.start()
        cp, c1, c2 = (e.get_completion(rid, timeout=WAIT) for rid in ("poison", "img1", "img2"))
        assert cp.finish_reason == "error"
        assert c1.finish_reason in ("stop", "length") and c2.finish_reason in ("stop", "length")
        assert sum(1 for r in emissions if r == "img1") <= 1 + len(c1.token_ids)
        assert e.stats.get("admission_retries", 0) >= 1 and e.stats.get("errors", 0) == 1
        e.submit(TE.Request(request_id="after", token_ids=_prompt(23, 6)[0], images=[], max_tokens=3))
        assert e.get_completion("after", timeout=WAIT).finish_reason in ("stop", "length")
    finally:
        e.stop()


def test_a_contained_batch_failure_is_counted_even_when_every_retry_succeeds(params):
    """A routine that refuses a batch of two rows and takes each row alone: every
    request completes and stats["errors"] stays 0, so the refusal must show in
    stats["admission_retries"]."""
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    e.admission_debounce_s = 0.0
    pool_prefill = e._pool_prefill

    def refuses_two_rows(slot_idx, *a):
        if (slot_idx < e.max_slots).sum() > 1:
            raise ValueError("two live rows refused")
        return pool_prefill(slot_idx, *a)

    e._pool_prefill = refuses_two_rows
    prompts = [_prompt(40 + i, 6) for i in range(2)]
    outs = _serve(TE, e, prompts, prefix="r", max_tokens=4)
    del e._pool_prefill
    clean = _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    assert outs == _serve(TE, clean, prompts, prefix="r", max_tokens=4)
    assert e.stats.get("errors", 0) == 0 and e.stats["admission_retries"] == 1 and e.stats["prefills"] == 2
    assert "admission_retries" not in clean.stats and "pump_errors" not in clean.stats


def test_a_tick_that_raises_in_the_pump_is_counted_and_the_pump_serves_on(params):
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    decode = e._decode_steps_compact
    failed = []

    def fails_once(*a, **kw):
        if not failed:
            failed.append(True)
            raise RuntimeError("one decode chunk lost")
        return decode(*a, **kw)

    e._decode_steps_compact = fails_once
    e.start()
    try:
        e.submit(TE.Request(request_id="q", token_ids=_prompt(50, 6)[0], images=[], max_tokens=4))
        assert e.get_completion("q", timeout=WAIT).finish_reason in ("stop", "length")
    finally:
        e.stop()
    assert failed and e.stats["pump_errors"] == 1 and e.stats.get("errors", 0) == 0


def test_release_slot_frees_capacity(params):
    e = _port(params, max_slots=2, max_seq_len=512, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    e.submit(TE.Request(request_id="h", token_ids=_prompt(2)[0], images=[], max_tokens=3, hold_slot=True))
    e.run_until_idle()
    e.get_completion("h", timeout=5)
    assert "h" in e.held and sum(s.held for s in e.slots) == 1
    e.release_slot("h")
    assert "h" not in e.held and not any(s.held for s in e.slots)
    outs = _serve(TE, e, [(_prompt(3 + i)[0], []) for i in range(2)], max_tokens=3)
    assert all(outs) and e.stats["prefills"] == 2  # both fit at once: one batch after the holder's


def test_continuation_before_parent_finishes_defers(params):
    e = _port(params, max_slots=2, max_seq_len=512, decode_chunk=2, length_buckets=(64,), patch_buckets=(0,))
    e.submit(TE.Request(request_id="p", token_ids=_prompt(4, n_text=12)[0], images=[], max_tokens=8, hold_slot=True))
    e.submit_continuation(TE.Continuation(parent_request_id="p", request_id="p2", chunk_ids=[5, 6], images=[],
                                          kept_tokens=10**9, max_tokens=4))
    e.run_until_idle()
    c2 = e.get_completion("p2", timeout=5)
    assert c2.finish_reason in ("stop", "length") and len(c2.token_ids) <= 4
    assert not e.held and not e.active.any()


def test_on_tokens_streams_what_the_completion_holds(params):
    """The incremental hook: the first token from the prefill, then one call per decode
    chunk; its tokens concatenate to the completion's, stop token excluded."""
    e = _port(params, max_slots=2, max_seq_len=128, decode_chunk=3, length_buckets=(64,), patch_buckets=(0,))
    seen = {}
    e.on_tokens = lambda rid, toks: seen.setdefault(rid, []).append(list(toks))
    outs = _serve(TE, e, [_prompt(2, 9), _prompt(3, 12)], max_tokens=8)
    for i, out in enumerate(outs):
        calls = seen[f"r{i}"]
        assert [t for c in calls for t in c] == out
        assert len(calls[0]) == 1 and all(len(c) <= 3 for c in calls)
    assert e.latency_percentiles()["p50_latency_s"] is not None
    assert {"decode_device", "prefill_device", "prefill_host_prep"} <= set(e.stats_timing())


@pytest.mark.parametrize("seed", [0, 1])
def test_random_traffic_all_requests_resolve(params, seed):
    """A seeded random mix of plain requests, hold_slot episodes and continuations (some
    over-bucket), image requests and releases through the background pump: every id
    resolves, valid ones stop/length, invalid ones "error", nothing leaks, and the
    engine still serves afterwards."""
    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    e = _port(params, max_slots=3, max_seq_len=256, decode_chunk=2, length_buckets=(32, 64), patch_buckets=(0, 16))
    e.start()
    expected = {}  # request_id -> "ok" | "error"
    held_parents = []
    try:
        for i in range(14):
            kind = rng.integers(0, 10)
            rid = f"s{seed}-r{i}"
            ids = [tok.im_start] + [int(t) for t in rng.integers(1, 400, size=int(rng.integers(3, 20)))]
            if kind < 2:  # image request
                pv = rng.standard_normal((16, CFG.vision.patch_dim)).astype(np.float32)
                ids += [tok.vision_start] + [tok.image_pad] * (16 // CFG.vision.merge_unit) + [tok.vision_end]
                e.submit(TE.Request(request_id=rid, token_ids=ids, images=[(pv, (1, 4, 4))],
                                    max_tokens=int(rng.integers(2, 6))))
                expected[rid] = "ok"
            elif kind < 5 and len(held_parents) < 2:  # hold-slot episode starter (holders stay below max_slots)
                e.submit(TE.Request(request_id=rid, token_ids=ids, images=[], max_tokens=int(rng.integers(2, 6)),
                                    hold_slot=True))
                expected[rid] = "ok"
                held_parents.append(rid)
            elif kind < 7 and held_parents:  # continuation (maybe over-bucket)
                parent = held_parents.pop(0)
                c = e.get_completion(parent, timeout=WAIT)
                assert c.finish_reason in ("stop", "length"), (parent, c)
                expected.pop(parent)
                over = rng.integers(0, 2) == 1
                chunk = [int(t) for t in rng.integers(1, 400, size=100 if over else 5)]
                e.submit_continuation(TE.Continuation(request_id=rid, parent_request_id=parent, chunk_ids=chunk,
                                                      images=[], kept_tokens=1, max_tokens=3))
                expected[rid] = "error" if over else "ok"
            elif kind < 8 and held_parents:  # abandon a held episode
                parent = held_parents.pop(0)
                c = e.get_completion(parent, timeout=WAIT)
                assert c.finish_reason in ("stop", "length"), (parent, c)
                expected.pop(parent)
                e.release_slot(parent)
            else:  # plain request
                e.submit(TE.Request(request_id=rid, token_ids=ids, images=[], max_tokens=int(rng.integers(2, 6))))
                expected[rid] = "ok"
        for rid, want in expected.items():
            c = e.get_completion(rid, timeout=WAIT)
            assert (c.finish_reason in ("stop", "length")) if want == "ok" else (c.finish_reason == "error"), (rid, c)
        for parent in held_parents:
            e.release_slot(parent)
        e.stop()
        e.run_until_idle()
        assert not e.active.any() and not e.held
        assert all(s.request is None or s.held is False for s in e.slots)
        e.start()
        e.submit(TE.Request(request_id=f"s{seed}-post", token_ids=[tok.im_start, 5, 6], images=[], max_tokens=3))
        assert e.get_completion(f"s{seed}-post", timeout=WAIT).finish_reason in ("stop", "length")
    finally:
        e.stop()


# ---------------------------------------------------------------------------
# precompile and inert inputs
# ---------------------------------------------------------------------------

def _state(e):
    c = e.cache
    return [t.clone() for t in c.k + c.v + (c.kscale + c.vscale if c.quantized else [])
            + [c.length, e.cur_tokens, e.next_pos]]


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_inert_inputs_leave_the_engine_state_bit_for_bit_unchanged(params, cache_dtype):
    """What precompile leans on: a pool prefill whose rows all point past the pool
    (chunk_lens 0) and a compact decode chunk of padding rows change nothing at all; a
    full-width chunk with no active row leaves `length`, `next_pos` and every row's
    valid window [0, length) unchanged."""
    e = _port(params, max_slots=4, max_seq_len=64, decode_chunk=3, cache_dtype=cache_dtype, length_buckets=(32,),
              patch_buckets=(0,))
    for i in range(3):  # three held rows of unequal lengths and one idle row
        e.submit(TE.Request(request_id=f"h{i}", token_ids=_prompt(80 + i, 5 + 3 * i)[0], images=[], max_tokens=4,
                            hold_slot=True))
    e.run_until_idle()
    assert len(e.held) == 3 and e.cache.length.tolist()[:3] == [9, 12, 15]
    before = _state(e)
    with e._device_scope():
        for RB in (4,):
            e._pool_prefill(np.full((RB,), 4, np.int32), np.full((RB, 32), CFG.tokens.pad, np.int32),
                            np.zeros((RB,), np.int32), np.zeros((RB,), np.int32), np.ones((3, RB, 32), np.int32),
                            None, np.zeros((RB,), np.int32), np.zeros((RB,), np.float32))
        e._decode_steps_compact(np.full((2,), 4, np.int32), np.zeros((2,), bool), np.zeros((2,), np.float32),
                                n_steps=3)
    assert all(torch.equal(a, b) for a, b in zip(before, _state(e)))
    with e._device_scope():
        toks = e._decode_steps(np.zeros((4,), bool), np.zeros((4,), np.float32), n_steps=3)
    after = _state(e)
    assert toks.tolist() == [[CFG.tokens.pad] * 3] * 4
    assert torch.equal(before[-3], after[-3]) and torch.equal(before[-1], after[-1])  # length, next_pos
    n_cache = len(before) - 3
    for a, b in zip(before[:n_cache], after[:n_cache]):
        for row, n in enumerate(e.cache.length.tolist()):
            assert torch.equal(a[row, :, :n], b[row, :, :n])
    # the held rows are still what their continuations need
    e.submit_continuation(TE.Continuation(parent_request_id="h1", request_id="h1c", chunk_ids=[7, 8], images=[],
                                          kept_tokens=4, max_tokens=3))
    e.run_until_idle()
    fresh = _port(params, max_slots=4, max_seq_len=64, decode_chunk=3, cache_dtype=cache_dtype, length_buckets=(32,),
                  patch_buckets=(0,))
    fresh.submit(TE.Request(request_id="h1", token_ids=_prompt(81, 8)[0], images=[], max_tokens=4, hold_slot=True))
    fresh.run_until_idle()
    fresh.submit_continuation(TE.Continuation(parent_request_id="h1", request_id="h1c", chunk_ids=[7, 8], images=[],
                                              kept_tokens=4, max_tokens=3))
    fresh.run_until_idle()
    assert e.get_completion("h1c", timeout=1).token_ids == fresh.get_completion("h1c", timeout=1).token_ids


def test_precompile_walks_every_routine_and_restarts_from_clean_state(params):
    kw = dict(max_slots=8, max_seq_len=64, decode_chunk=2, length_buckets=(32, 64), patch_buckets=(0,))
    e = _port(params, **kw)
    seen = []
    e.precompile(progress=seen.append)
    assert seen == ["pool[4, 32]", "pool[8, 32]", "decode", "decode_compact[4]"]
    assert all(not bool(t.any()) for t in _state(e))
    assert not e.active.any() and not e.held and e._ppool is not None
    prompts = [_prompt(90 + i, 6) for i in range(3)]
    assert _serve(TE, e, prompts, max_tokens=5) == _serve(TE, _port(params, **kw), prompts, max_tokens=5)


# ---------------------------------------------------------------------------
# run_episodes_served
# ---------------------------------------------------------------------------

def test_run_episodes_served_matches_jax_package(params, monkeypatch):
    """Pipelined two-stage episodes on the engine (forced bbox, greedy, more episodes
    than slots, two questions per tile with image_keys so the prefix pool is used):
    the JAX package's EpisodeResults, latency aside."""
    box = lambda text, scale=1.0: [[50, 50, 120, 120]]  # noqa: E731
    monkeypatch.setattr(JEP, "extract_bboxes", box)
    monkeypatch.setattr(TEP, "extract_bboxes", box)
    proc = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)
    rng = np.random.default_rng(0)
    tiles = [Image.fromarray(rng.integers(0, 255, (700, 700, 3), dtype=np.uint8)) for _ in range(2)]
    questions = ["q1?", "q2?", "q3?", "q4?"]
    images = [tiles[i % 2] for i in range(4)]
    outs = []
    for (M, e), EP in zip(_engines(params, max_slots=2, max_seq_len=512, decode_chunk=2, length_buckets=(256, 512),
                                   patch_buckets=(0, 16, 64)), (JEP, TEP)):
        e.start()
        try:
            res = EP.run_episodes_served(
                e, proc, questions, images, max_new_tokens=5, stage2_max_tokens=4, temperature=0.0,
                prompt_fn=lambda q: PT.PREFIX + q + "\nGo.<|im_end|><|im_start|>assistant\n",
                image_keys=[f"tile{i % 2}" for i in range(4)])
        finally:
            e.stop()
        assert len(res) == 4 and all(r is not None and not r.error and r.latency_s > 0 for r in res)
        assert all(r.bbox == [50, 50, 120, 120] and r.stage2 != "" for r in res)
        assert e.stats["prefix_saves"] >= 1 and e.stats["completed"] == 8
        assert not e.held and not e.active.any() and e.on_completion is None
        outs.append([dataclasses.replace(r, latency_s=None).__dict__ for r in res])
    assert outs[1] == outs[0]
