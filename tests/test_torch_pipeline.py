"""The port's pair-pipelined wave runner (runtime/pipeline.py::run_paired_waves) on the
CPU, against the JAX package's runner and against the port's own sequential stages.

Both packages get the JAX package's tiny random parameters (fp32) and the same
host-prepared batches; decoding is greedy, so tokens must be identical. The cases are
those of tests/test_pipeline.py (zero waves, asymmetric budgets both ways, both edge
modes, a bad edge mode, the bootstrap skipping the dummy's tail, random budgets), plus
a shared prefix holder with prefix_grow_to of None, 0 and a bucket, an early stop in
both groups followed by a tail, the int8 KV cache, and per-group temperatures.
"""

import jax
import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.runtime import generate as JG
from zoomearth_tpu.runtime import pipeline as JP
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.runtime import pipeline as TP

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
B = 2


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _gens(params, cache_dtype="float32", max_cache_len=64):
    jp, tp = params
    return (JG.Generator(jp, CFG, max_cache_len=max_cache_len, cache_dtype=cache_dtype),
            TG.Generator(tp, CFG, max_cache_len=max_cache_len, cache_dtype=cache_dtype))


def _boom(*a, **kw):
    raise AssertionError("hook must not be called")


def _hooks():
    """Deterministic text-only two-stage hooks (host code shared by both packages)."""
    tok = CFG.tokens

    def build_stage1(w):
        rngw = np.random.default_rng(w)
        seqs = [[tok.im_start] + [int(t) for t in rngw.integers(1, 300, size=4 + b)] for b in range(B)]
        return TG.prepare_batch(CFG, seqs, [[] for _ in range(B)], length_buckets=(16,), patch_buckets=(0,))

    def build_stage2(w, out1, base_lengths, base_next):
        rngw = np.random.default_rng(100 + w)
        chunks = [[int(t) for t in rngw.integers(1, 300, size=3)] for _ in range(B)]
        keep = np.asarray([int(base_lengths[b]) + len(out1[b]) for b in range(B)], np.int32)
        starts = [int(base_next[b]) + len(out1[b]) for b in range(B)]
        return TG.prepare_continuation(CFG, chunks, [[] for _ in range(B)], starts, length_buckets=(16,)), keep, None

    return build_stage1, build_stage2


def _gen_cfgs(mod, n1, n2, t2=0.0, top_p2=1.0):
    return (mod.GenerationConfig(max_new_tokens=n1, temperature=0.0),
            mod.GenerationConfig(max_new_tokens=n2, temperature=t2, top_p=top_p2))


def _paired(run, gen, mod, n_waves, n1, n2, hooks=None, **kw):
    s1, s2 = hooks or _hooks()
    g1, g2 = _gen_cfgs(mod, n1, n2)
    got = {}
    run(gen, n_waves, s1, s2, gen1=g1, gen2=g2, seed=0,
        on_complete=lambda w, o1, o2: got.__setitem__(w, (o1, o2)), **kw)
    return [got[w] for w in range(n_waves)]


def _sequential(gen, n_waves, n1, n2, hooks=None):
    """The same episodes wave by wave through the port's composable stages, unpaired."""
    s1, s2 = hooks or _hooks()
    g1, g2 = _gen_cfgs(TG, n1, n2)
    out = []
    for w in range(n_waves):
        b1 = s1(w)
        logits1, cache1, attend1 = gen.run_prefill(b1, max_new=n1)
        toks, cache1 = gen.run_decode(logits1, cache1, b1.next_pos, g1, attend=attend1)
        out1 = gen.trim_generated(toks.numpy())
        chunk, keep, _ = s2(w, out1, np.asarray(b1.lengths), np.asarray(b1.next_pos))
        logits2, cache2, attend2 = gen.run_chunk_prefill(cache1, chunk, keep, max_new=n2)
        toks2, _ = gen.run_decode(logits2, cache2, chunk.next_pos, g2, attend=attend2)
        out.append((out1, gen.trim_generated(toks2.numpy())))
    return out


def test_zero_waves_returns_empty(params):
    _, tg = _gens(params)
    g1, g2 = _gen_cfgs(TG, 4, 4)
    assert TP.run_paired_waves(tg, 0, _boom, _boom, gen1=g1, gen2=g2) == []


def test_bad_edges_value(params):
    _, tg = _gens(params)
    g1, g2 = _gen_cfgs(TG, 2, 2)
    with pytest.raises(ValueError, match="edges"):
        TP.run_paired_waves(tg, 1, _boom, _boom, gen1=g1, gen2=g2, edges="nope")


@pytest.mark.parametrize("n1,n2,n_waves,edges", [
    (6, 4, 3, "dummy"), (7, 4, 3, "dummy"), (4, 7, 3, "dummy"),
    (6, 4, 3, "solo"), (4, 7, 2, "solo"), (5, 5, 1, "solo"),
])
def test_paired_matches_jax_runner_and_sequential(params, n1, n2, n_waves, edges):
    """Either stage may have the longer budget; tokens equal the JAX runner's and the
    port's unpaired stages under both edge modes."""
    jg, tg = _gens(params)
    out = _paired(TP.run_paired_waves, tg, TG, n_waves, n1, n2, edges=edges)
    assert out == _paired(JP.run_paired_waves, jg, JG, n_waves, n1, n2, edges=edges)
    assert out == _sequential(tg, n_waves, n1, n2)
    assert all(len(t) > 0 for o1, o2 in out for t in o1 + o2)


def test_results_returned_without_on_complete(params):
    _, tg = _gens(params)
    s1, s2 = _hooks()
    g1, g2 = _gen_cfgs(TG, 4, 3)
    res = TP.run_paired_waves(tg, 2, s1, s2, gen1=g1, gen2=g2)
    assert [r.wave for r in res] == [0, 1]
    assert [(r.out1, r.out2) for r in res] == _sequential(tg, 2, 4, 3)


def test_solo_edges_allocate_no_dummy_cache(params):
    _, tg = _gens(params)
    allocs = []
    orig = tg.new_cache
    tg.new_cache = lambda *a, **kw: (allocs.append(a), orig(*a, **kw))[1]
    _paired(TP.run_paired_waves, tg, TG, 2, 5, 3, edges="solo")
    # every stage-1 prefill allocates its cache; a dummy partner would add to them
    assert len(allocs) == 2


def test_bootstrap_skips_dummy_rest_tail(params):
    """With gen2 > gen1 the bootstrap wave's dummy partner runs no solo tail: one tail
    per REAL stage-2 group (waves 1..n-1 and the drain)."""
    _, tg = _gens(params)
    calls = []
    orig = tg.run_decode
    tg.run_decode = lambda *a, **kw: (calls.append(kw.get("done0")), orig(*a, **kw))[1]
    out = _paired(TP.run_paired_waves, tg, TG, 2, 3, 6)
    tg.run_decode = orig
    assert len(calls) == 2
    assert out == _sequential(tg, 2, 3, 6)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_paired_random_budget_combinations(params, seed):
    """Property: for ANY (gen1, gen2) budgets the runner's greedy tokens equal the
    unpaired stages' (off-by-ones in the joint-steps / solo-tail split)."""
    rng = np.random.default_rng(seed)
    n1, n2, n_waves = int(rng.integers(1, 9)), int(rng.integers(1, 9)), int(rng.integers(1, 4))
    _, tg = _gens(params)
    assert _paired(TP.run_paired_waves, tg, TG, n_waves, n1, n2) == _sequential(tg, n_waves, n1, n2)


def test_on_dispatch_called_before_each_prefill(params):
    _, tg = _gens(params)
    order = []
    orig = tg.run_prefill
    tg.run_prefill = lambda *a, **kw: (order.append("prefill"), orig(*a, **kw))[1]
    _paired(TP.run_paired_waves, tg, TG, 2, 3, 3, on_dispatch=lambda w: order.append(w))
    assert order == [0, "prefill", 1, "prefill"]


def test_unequal_temperatures_keep_group_a_greedy(params):
    """Per-stage sampling configs: stage 1 greedy stays equal to the unpaired greedy
    stages while stage 2 samples at its own temperature, and the same seed gives the
    same draws."""
    _, tg = _gens(params)
    s1, s2 = _hooks()
    g1, g2 = _gen_cfgs(TG, 5, 4, t2=0.9, top_p2=0.8)

    def run():
        got = {}
        TP.run_paired_waves(tg, 2, s1, s2, gen1=g1, gen2=g2, seed=7,
                            on_complete=lambda w, o1, o2: got.__setitem__(w, (o1, o2)))
        return got

    got, again = run(), run()
    ref = _sequential(tg, 2, 5, 4)
    for w in range(2):
        assert got[w][0] == ref[w][0]
        assert all(len(t) <= 4 for t in got[w][1])
    assert got == again


def test_pair_with_temperatures_0_and_t_equals_solo_greedy_for_group_a(params):
    """run_decode_pair with (0, t): group a draws nothing, so its tokens are the solo
    greedy decode's whatever group b samples."""
    _, tg = _gens(params)
    s1, _ = _hooks()
    ba, bb = s1(0), s1(1)
    ref = tg.generate(ba, TG.GenerationConfig(max_new_tokens=6))
    la, ca, aa = tg.run_prefill(ba, max_new=6)
    lb, cb, ab = tg.run_prefill(bb, max_new=6)
    buf_a, *_ = tg.run_decode_pair((la, ca, ba.next_pos, aa, None), (lb, cb, bb.next_pos, ab, None),
                                   steps=6, temperature=0.0, temperature_b=1.3, top_p_b=0.9, seed=5)
    assert tg.trim_generated(buf_a.numpy()) == ref


# ---------------------------------------------------------------------------
# Shared prefix holder
# ---------------------------------------------------------------------------

def _prefix_setup(params):
    """A [system] prefix cache from a small generator, and stage-1 hooks that return
    each wave's continuation chunk."""
    jg, tg = _gens(params, max_cache_len=64)
    jg_pfx, tg_pfx = _gens(params, max_cache_len=16)
    tok = CFG.tokens
    pfx = [tok.im_start, 5, 6, 7, 8, 9]
    pb = TG.prepare_batch(CFG, [pfx] * B, [[] for _ in range(B)], length_buckets=(16,), patch_buckets=(0,))
    _, jholder, _ = jg_pfx.run_prefill(pb, max_new=0)
    _, tholder, _ = tg_pfx.run_prefill(pb, max_new=0)
    keep = np.asarray(pb.lengths, np.int32)
    _, s2 = _hooks()

    def build_stage1(w):
        rngw = np.random.default_rng(w)
        chunks = [[int(t) for t in rngw.integers(1, 300, size=3 + b)] for b in range(B)]
        return TG.prepare_continuation(CFG, chunks, [[] for _ in range(B)], np.asarray(pb.next_pos),
                                       length_buckets=(16,))

    return jg, tg, jholder, tholder, keep, (build_stage1, s2)


@pytest.mark.parametrize("grow_to,rows", [(None, 64), (0, 16), (48, 48)])
def test_prefix_holder_grow_to(params, grow_to, rows):
    """Every wave's stage 1 chunk-prefills from one shared holder. prefix_grow_to None
    grows the stage-1 cache to the generator's max, a bucket to that bucket, and 0
    leaves the size to the stage's own need (the reference's `or` turns 0 into the
    max: the tokens are the same, the allocation is not). The holder's bytes are
    unchanged after three waves."""
    jg, tg, jholder, tholder, keep, hooks = _prefix_setup(params)
    snapshot = [t.clone() for t in tholder.k + tholder.v] + [tholder.length.clone()]
    sizes = []
    orig = tg.run_chunk_prefill

    def spy(cache, *a, **kw):
        out = orig(cache, *a, **kw)
        if cache is tholder:
            assert out[1] is not tholder
            sizes.append(out[1].max_len)
        return out

    tg.run_chunk_prefill = spy
    out = _paired(TP.run_paired_waves, tg, TG, 3, 5, 4, hooks, prefix=(tholder, keep), prefix_grow_to=grow_to)
    ref = _paired(JP.run_paired_waves, jg, JG, 3, 5, 4, hooks, prefix=(jholder, keep), prefix_grow_to=grow_to)
    assert out == ref
    assert sizes == [rows] * 3
    assert all(torch.equal(a, b) for a, b in zip(snapshot, tholder.k + tholder.v + [tholder.length]))


# ---------------------------------------------------------------------------
# Early stop, int8
# ---------------------------------------------------------------------------

def test_early_stop_in_both_groups_then_tail(params, monkeypatch):
    """Rows of both groups stop early inside the pair loop (every token id divisible
    by 3 is turned into the stop token, in both packages), then the longer stage's
    tail runs with done0. The JAX loop leaves as soon as both groups are done; the
    port's looks every DONE_CHECK_EVERY steps, its done rows writing pad meanwhile:
    the tokens are the same, and equal to the unpaired stages'."""
    import jax.numpy as jnp

    eos = CFG.tokens.eos
    t_greedy, j_greedy = TG.greedy, JG.greedy

    def stop_on_multiples(argmax, where):
        def pick(logits):
            tok = argmax(logits)
            return where(tok % 3 == 0, eos, tok)
        return pick

    monkeypatch.setattr(TG, "greedy", stop_on_multiples(t_greedy, lambda c, a, t: torch.where(c, torch.full_like(t, a), t)))
    monkeypatch.setattr(JG, "greedy", stop_on_multiples(j_greedy, jnp.where))
    jg, tg = _gens(params)
    out = _paired(TP.run_paired_waves, tg, TG, 3, 12, 20)
    assert out == _paired(JP.run_paired_waves, jg, JG, 3, 12, 20)
    assert out == _sequential(tg, 3, 12, 20)
    # the stops came early: whole waves finished inside the 12 joint steps, before the
    # port's second all-done check, so the stage-2 tail started with every row done
    assert any(all(len(t) < 8 for t in o1 + o2) for o1, o2 in out)
    assert any(len(t) > 0 for o1, o2 in out for t in o1 + o2)


@pytest.mark.parametrize("n1,n2", [(12, 20), (20, 12)])
def test_early_stop_of_one_row_then_tail_with_mixed_done(params, monkeypatch, n1, n2):
    """Row 0 of every group stops early inside the pair loop (its even token ids are
    turned into the stop token, in both packages) while row 1 never stops, so the loop
    runs all its joint steps and the longer stage's solo tail resumes with done0 mixed:
    one row done, one not. Tokens equal the JAX runner's and the unpaired stages'."""
    import jax.numpy as jnp

    eos = CFG.tokens.eos
    t_greedy, j_greedy = TG.greedy, JG.greedy

    def stop_row0_on_even(argmax, where, arange):
        def pick(logits):
            tok = argmax(logits)
            return where((tok % 2 == 0) & (arange(logits.shape[0]) == 0), eos, tok)
        return pick

    monkeypatch.setattr(TG, "greedy", stop_row0_on_even(
        t_greedy, lambda c, a, t: torch.where(c, torch.full_like(t, a), t), torch.arange))
    monkeypatch.setattr(JG, "greedy", stop_row0_on_even(j_greedy, jnp.where, jnp.arange))
    jg, tg = _gens(params)
    out = _paired(TP.run_paired_waves, tg, TG, 3, n1, n2)
    assert out == _paired(JP.run_paired_waves, jg, JG, 3, n1, n2)
    assert out == _sequential(tg, 3, n1, n2)
    steps, longer = min(n1, n2), 0 if n1 > n2 else 1
    # in some wave the longer stage's row 0 stopped inside the joint steps, and its row 1 ran into the tail
    assert any(len(o[longer][0]) < steps for o in out)
    assert all(len(o[longer][1]) == max(n1, n2) for o in out)


def test_early_stop_lengths_past_the_cache_end_are_dropped(params):
    """Rows that are done keep stepping until the loop's next all-done check, so a
    cache's length may run past its end: such a step's write is dropped (no live slot
    is overwritten) and the attention reads the clipped span."""
    _, tg = _gens(params, max_cache_len=16)
    s1, _ = _hooks()
    b = s1(0)
    logits, cache, attend = tg.run_prefill(b, max_new=0)
    with torch.inference_mode():
        cache.length.fill_(15)
    before = [t.clone() for t in cache.k + cache.v]
    done0 = np.ones((B,), bool)
    # steps 0..3: lengths 15, 16, 17, 18 -> the first write lands in slot 15, the others are dropped
    tg.run_decode_pair((logits, cache, b.next_pos, attend, None),
                       (torch.zeros_like(logits), tg.new_cache(B), np.zeros((B,), np.int32), None, done0),
                       steps=4)
    assert cache.length.tolist() == [19, 19]
    for old, new in zip(before, cache.k + cache.v):
        assert torch.equal(old[:, :, :15], new[:, :, :15])
        assert bool(torch.isfinite(new).all())


def test_paired_int8_cache_matches_sequential_and_jax(params):
    """The runner over int8 KV caches: equal to the port's unpaired int8 stages token
    for token, and to the JAX runner with cache_dtype="int8" (whose small-size chunk
    prefill reads a dequantized bf16 copy: near-ties may flip, so at least 90 % of the
    tokens must agree there)."""
    jg, tg = _gens(params, cache_dtype="int8")
    out = _paired(TP.run_paired_waves, tg, TG, 3, 6, 4)
    assert out == _sequential(tg, 3, 6, 4)
    ref = _paired(JP.run_paired_waves, jg, JG, 3, 6, 4)
    flat = lambda res: [t for o1, o2 in res for row in o1 + o2 for t in row]  # noqa: E731
    a, b = flat(out), flat(ref)
    assert len(a) == len(b)
    assert np.mean(np.asarray(a) == np.asarray(b)) >= 0.9
