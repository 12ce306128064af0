"""The captured decode programs (runtime/graphs.py) and the decode steps they capture.

On the CPU (every test but the `cuda` ones): the restructured decode of
`Generator.run_decode` / `run_decode_pair` (one step over fixed buffers with a device
step counter) gives the tokens and the cache of the eager loop it replaced bit for bit,
in fp32 at the tiny config, greedy and sampled with one torch.Generator, with done0,
early stops and the `length` rule; its greedy tokens equal the JAX package's
`run_decode` / `run_decode_pair`; the engine's full-width and compact chunks (the latter
over the persistent staging rows) equal the chunks they replaced; the engine drops its
graphs on reset_state() and on a params assignment that moves a leaf, and keeps them
over the same tensors and over reseed(); and the launch tally
of ops/_cuda.py adds a capture's launches at each replay, while a raw capture counts
nothing (capture simulated by monkeypatching torch.cuda.is_current_stream_capturing).

Marked `cuda` (skipped where torch.cuda.is_available() is false; on a machine with an
NVIDIA GPU and nvcc: python -m pytest --noconftest -m cuda tests/test_torch_graphs.py):
captured decode against the same step functions run eagerly on the card, token for
token (solo, pair, the engine's full-width and compact chunks; fp32 and bf16; bf16 and
int8 caches; greedy and sampled: a registered generator draws in the replays what the
eager steps draw), launches after N replays N times one step's, and an engine whose
`params` are rebound after a capture decoding on the new tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu_torch.models.params import map_tree, params_from_numpy
from zoomearth_tpu_torch.models.vlm import embed_tokens, vlm_forward
from zoomearth_tpu_torch.models.decoder import decoder_forward_pair, logits_from_hidden
from zoomearth_tpu_torch.ops import _cuda
from zoomearth_tpu_torch.ops import flash_decode as K3
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.runtime.graphs import StepGraphs
from zoomearth_tpu_torch.serve import engine as TE

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
L = CFG.text.num_hidden_layers


@pytest.fixture(scope="module")
def params():
    """The JAX package's tiny random parameters and the port's copy of them (JAX is
    imported here, not at the top: the card runs this file's `cuda` tests without it)."""
    import jax

    from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params

    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(seeds, n_text=(6, 9, 4), length_buckets=(32,)):
    tok = CFG.tokens
    seqs = [[tok.im_start] + [int(t) for t in np.random.default_rng(s).integers(1, 400, size=n)]
            for s, n in zip(seeds, n_text)]
    return TG.prepare_batch(CFG, seqs, [[] for _ in seqs], length_buckets=length_buckets, patch_buckets=(0,))


def _cache_state(cache):
    return [t.clone() for t in cache.k + cache.v + (cache.kscale + cache.vscale if cache.quantized else [])
            + [cache.length]]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The eager loops that the step functions replaced (the decode of the port before the
# captured programs), kept here as the reference of the restructured decode
# ---------------------------------------------------------------------------

def _old_state(g, B, max_new, done0):
    tokens = torch.full((B, max_new), g.cfg.tokens.pad, dtype=torch.int64, device=g.device)
    done = (torch.zeros((B,), dtype=torch.bool, device=g.device) if done0 is None
            else torch.as_tensor(done0, dtype=torch.bool, device=g.device))
    return tokens, done


@torch.inference_mode()
def _old_run_decode(g, first_logits, cache, next_pos, gen, *, seed=0, attend=None, done0=None):
    B = first_logits.shape[0]
    rng = torch.Generator(device=g.device).manual_seed(seed) if gen.temperature > 0.0 else None
    tokens, done = _old_state(g, B, gen.max_new_tokens, done0)
    pos = g._tensor(next_pos, torch.int64)
    logits = first_logits
    for step in range(gen.max_new_tokens):
        if step % TG.DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        tok, done = g._pick(logits, done, rng, gen.temperature, gen.top_p)
        tokens[:, step] = tok
        pos3 = pos[None, :, None].expand(3, B, 1)
        logits, cache = vlm_forward(g.params, g.cfg, tok[:, None], pos3, attn_positions=cache.length[:, None],
                                    cache=cache, attend_len=attend)
        logits = logits[:, 0]
        pos = pos + 1
    return tokens, cache


@torch.inference_mode()
def _old_run_decode_pair(g, a, b, *, steps, temperature=0.0, top_p=1.0, seed=0, temperature_b=None, top_p_b=None):
    logits_a, cache_a, pos_a, attend_a, done0_a = a
    logits_b, cache_b, pos_b, attend_b, done0_b = b
    Ba, Bb = logits_a.shape[0], logits_b.shape[0]
    temp_b = temperature if temperature_b is None else temperature_b
    tp_b = top_p if top_p_b is None else top_p_b
    rng = None
    if temperature > 0.0 or temp_b > 0.0:
        rng = torch.Generator(device=g.device).manual_seed(seed)
    buf_a, done_a = _old_state(g, Ba, steps, done0_a)
    buf_b, done_b = _old_state(g, Bb, steps, done0_b)
    pos = torch.cat([g._tensor(pos_a, torch.int64), g._tensor(pos_b, torch.int64)])
    logits = torch.cat([logits_a, logits_b])
    text = g.params["text"]
    for step in range(steps):
        if step % TG.DONE_CHECK_EVERY == 0 and bool((done_a.all() & done_b.all())):
            break
        tok_a, done_a = g._pick(logits[:Ba], done_a, rng, temperature, top_p)
        tok_b, done_b = g._pick(logits[Ba:], done_b, rng, temp_b, tp_b)
        buf_a[:, step] = tok_a
        buf_b[:, step] = tok_b
        tok = torch.cat([tok_a, tok_b])
        pos3 = pos[None, :, None].expand(3, Ba + Bb, 1)
        hidden, cache_a, cache_b = decoder_forward_pair(text, g.cfg.text, embed_tokens(g.params, tok[:, None]), pos3,
                                                        cache_a, cache_b, attend_a, attend_b)
        logits = logits_from_hidden(text, g.cfg.text, hidden)[:, 0]
        pos = pos + 1
    return buf_a, done_a, logits[:Ba], cache_a, buf_b, done_b, logits[Ba:], cache_b


# ---------------------------------------------------------------------------
# Generator: the restructured decode against the eager loop it replaced
# ---------------------------------------------------------------------------

SOLO_CASES = {
    "greedy": dict(gen=TG.GenerationConfig(max_new_tokens=11, temperature=0.0)),
    "sampled": dict(gen=TG.GenerationConfig(max_new_tokens=11, temperature=0.8), seed=5),
    "sampled top-p": dict(gen=TG.GenerationConfig(max_new_tokens=9, temperature=1.3, top_p=0.7), seed=2),
    "done0": dict(gen=TG.GenerationConfig(max_new_tokens=10, temperature=0.0), done0=np.array([False, True, False])),
    "all done": dict(gen=TG.GenerationConfig(max_new_tokens=10, temperature=0.0), done0=np.array([True] * 3)),
    "early stop": dict(gen=TG.GenerationConfig(max_new_tokens=20, temperature=0.0), stop_at=2),
}


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", list(SOLO_CASES))
def test_run_decode_equals_the_eager_loop_it_replaced(params, case, cache_dtype):
    """Tokens and every cache tensor (length included) bit for bit. "early stop": the
    stop set is the tokens of every row at step 2, so each row stops there and the loop
    leaves at the next all-done check (step 8), with `length` 8 steps past the prompt."""
    kw = dict(SOLO_CASES[case])
    stop_at = kw.pop("stop_at", None)
    g = TG.Generator(params[1], CFG, max_cache_len=64, cache_dtype=cache_dtype)
    b = _batch((1, 2, 3))
    logits, cache, attend = g.run_prefill(b, max_new=kw["gen"].max_new_tokens)
    if stop_at is not None:
        first, _ = g.run_decode(logits, cache.clone(), b.next_pos, kw["gen"], attend=attend)
        g._stop = first[:, stop_at].clone()
    ref_tokens, ref_cache = _old_run_decode(g, logits, cache.clone(), b.next_pos, attend=attend, **kw)
    steps0 = g.decode_steps["solo"]
    tokens, out_cache = g.run_decode(logits, cache.clone(), b.next_pos, attend=attend, **kw)
    assert torch.equal(tokens, ref_tokens)
    assert _same(_cache_state(out_cache), _cache_state(ref_cache))
    taken = g.decode_steps["solo"] - steps0
    if stop_at is not None:
        assert bool((tokens[:, stop_at + 1:] == CFG.tokens.pad).all()) and taken == TG.DONE_CHECK_EVERY
        assert out_cache.length.tolist() == (np.asarray(b.lengths) + TG.DONE_CHECK_EVERY).tolist()
    elif case == "all done":
        assert taken == 0 and bool((tokens == CFG.tokens.pad).all())
    else:
        assert taken == kw["gen"].max_new_tokens
    assert g.graphs.keys() == []  # the call's step is released at its end


PAIR_CASES = {
    "greedy": dict(steps=9),
    "sampled": dict(steps=9, temperature=0.7, temperature_b=1.1, top_p_b=0.8, seed=3),
    "b greedy, a sampled": dict(steps=6, temperature=0.9, temperature_b=0.0, seed=1),
    "done0 b": dict(steps=10, done0_b=np.array([True, False, False])),
    "early stop": dict(steps=20, stop_at=1),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_run_decode_pair_equals_the_eager_loop_it_replaced(params, case):
    """Both groups' tokens, done masks, next logits and caches bit for bit; the groups
    then resume solo as the pipeline resumes them."""
    kw = dict(PAIR_CASES[case])
    stop_at = kw.pop("stop_at", None)
    done0_b = kw.pop("done0_b", None)
    g = TG.Generator(params[1], CFG, max_cache_len=64)
    ba, bb = _batch((4, 5, 6)), _batch((7, 8, 9), n_text=(3, 12, 7))
    la, ca, aa = g.run_prefill(ba, max_new=kw["steps"])
    lb, cb, ab = g.run_prefill(bb, max_new=kw["steps"])

    def groups():
        return (la, ca.clone(), ba.next_pos, aa, None), (lb, cb.clone(), bb.next_pos, ab, done0_b)

    if stop_at is not None:
        first = g.run_decode_pair(*groups(), steps=kw["steps"])
        g._stop = torch.cat([first[0][:, stop_at], first[4][:, stop_at]])
    ref = _old_run_decode_pair(g, *groups(), **kw)
    out = g.run_decode_pair(*groups(), **kw)
    for i in (0, 1, 2, 4, 5, 6):
        assert torch.equal(out[i], ref[i]), i
    for i in (3, 7):
        assert _same(_cache_state(out[i]), _cache_state(ref[i])), i
    if stop_at is not None:
        assert bool(out[1].all() & out[5].all()) and out[3].length.tolist() == (
            np.asarray(ba.lengths) + TG.DONE_CHECK_EVERY).tolist()
    # group b resumes solo from the pair's state in both versions
    rest = TG.GenerationConfig(max_new_tokens=4, temperature=0.0)
    r_new, _ = g.run_decode(out[6], out[7], np.asarray(bb.next_pos) + kw["steps"], rest, attend=ab, done0=out[5])
    r_old, _ = _old_run_decode(g, ref[6], ref[7], np.asarray(bb.next_pos) + kw["steps"], rest, attend=ab,
                               done0=ref[5])
    assert torch.equal(r_new, r_old)


def test_greedy_decode_equals_the_jax_decode_loops(params):
    """run_decode and run_decode_pair against the JAX package's while-loop programs
    (_decode_loop, _decode_loop_pair) on the same prefills: the same greedy tokens."""
    import jax

    from zoomearth_tpu.runtime import generate as JG

    jg = JG.Generator(params[0], CFG, max_cache_len=64, cache_dtype="float32")
    tg = TG.Generator(params[1], CFG, max_cache_len=64, cache_dtype="float32")
    gen = TG.GenerationConfig(max_new_tokens=10, temperature=0.0)
    jgen = JG.GenerationConfig(max_new_tokens=10, temperature=0.0)
    ba, bb = _batch((11, 12, 13)), _batch((14, 15, 16), n_text=(8, 2, 5))
    done0 = np.array([False, True, False])
    jl, jc, ja = jg.run_prefill(ba, max_new=10)
    tl, tc, ta = tg.run_prefill(ba, max_new=10)
    assert ja == ta
    jt, _ = jg.run_decode(jl, jc, ba.next_pos, jgen, attend=ja, done0=jax.numpy.asarray(done0))
    tt, _ = tg.run_decode(tl, tc, ba.next_pos, gen, attend=ta, done0=done0)
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
    groups = []
    for g in (jg, tg):
        (la, ca, aa), (lb, cb, ab) = g.run_prefill(ba, max_new=6), g.run_prefill(bb, max_new=6)
        groups.append(((la, ca, ba.next_pos, aa, None), (lb, cb, bb.next_pos, ab, None)))
    jout = jg.run_decode_pair(*groups[0], steps=6)
    tout = tg.run_decode_pair(*groups[1], steps=6)
    for i in (0, 1, 4, 5):
        np.testing.assert_array_equal(np.asarray(tout[i]), np.asarray(jout[i]))


def test_step_graphs_on_the_cpu_run_every_step_eagerly():
    calls = []
    graphs = StepGraphs("cpu")
    for _ in range(3):
        graphs.run("k", lambda: calls.append(1))
    assert len(calls) == 3 and graphs.keys() == ["k"] and graphs.held == 0 and graphs.captures == 0
    graphs.release("k")
    assert graphs.keys() == []
    graphs.run("a", lambda: None)
    graphs.run("b", lambda: None)
    graphs.drop()
    assert graphs.keys() == []


# ---------------------------------------------------------------------------
# The launch tally
# ---------------------------------------------------------------------------

def test_a_capture_tallies_its_launches_and_each_replay_adds_them(monkeypatch):
    def wrapper():
        pass

    wrapper.launches, wrapper.int8_launches, wrapper.variants = 0, 0, {"mma": 0, "fma": 0}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with _cuda.recording() as tally:
        for _ in range(3):
            _cuda.count_launch(wrapper, "mma")
        _cuda.count_launch(wrapper, "fma", int8=True)
    assert (wrapper.launches, wrapper.int8_launches, wrapper.variants) == (0, 0, {"mma": 0, "fma": 0})
    assert dict(tally) == {(wrapper, "mma", False): 3, (wrapper, "fma", True): 1}
    _cuda.count_launch(wrapper, "mma")  # a raw capture, outside any recording: counts nothing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    for _ in range(5):  # five replays
        _cuda.add_tally(tally)
    assert (wrapper.launches, wrapper.int8_launches, wrapper.variants) == (20, 5, {"mma": 15, "fma": 5})
    _cuda.count_launch(wrapper, "mma")  # an eager launch
    assert wrapper.launches == 21 and wrapper.variants["mma"] == 16


def test_recording_is_per_thread_and_nests(monkeypatch):
    import threading

    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    seen = []
    with _cuda.recording() as outer:
        with _cuda.recording() as inner:
            _cuda.count_launch(wrapper)
        _cuda.count_launch(wrapper)
        t = threading.Thread(target=lambda: (_cuda.count_launch(wrapper), seen.append(True)))
        t.start()
        t.join(timeout=10)
    assert seen and not t.is_alive()
    assert sum(inner.values()) == 1 and sum(outer.values()) == 1 and wrapper.launches == 0


# ---------------------------------------------------------------------------
# The engine: chunks over static buffers and staging rows against the chunks they replaced
# ---------------------------------------------------------------------------

def _old_sample(e, logits, temps, rng):
    tok = torch.argmax(logits, dim=-1)
    if not (temps > 0.0).any():
        return tok
    t = e._tensor(temps, torch.float32)
    greedy_row = t <= 0.0
    scaled = torch.where(greedy_row[:, None], 0.0, logits.float() / t.clamp(min=1e-4)[:, None])
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=rng)[:, 0]
    return torch.where(greedy_row, tok, sampled)


def _old_decode_loop(e, cache, cur, pos, active, temps, n_steps, attend_len, rng):
    B = cur.shape[0]
    act = e._tensor(active, torch.bool)
    inc, inc_pos = act.to(torch.int32), act.to(pos.dtype)
    pad = torch.full_like(cur, CFG.tokens.pad)
    tokens = torch.empty((B, n_steps), dtype=torch.int64)
    for step in range(n_steps):
        pos3 = pos[None, :, None].expand(3, B, 1)
        logits, _ = vlm_forward(e.params, e.cfg, cur[:, None], pos3, attn_positions=cache.length[:, None],
                                cache=cache, update_cache_len=False, attend_len=attend_len)
        cache.length.add_(inc)
        tok = torch.where(act, _old_sample(e, logits[:, 0], temps, rng), pad)
        tokens[:, step] = tok
        cur.copy_(tok)
        pos.add_(inc_pos)
    return tokens


def _old_compact(e, pool, cur_all, pos_all, slot_idx, active, temps, n_steps, attend_len, rng):
    cidx = e._tensor(np.clip(slot_idx, 0, e.max_slots - 1), torch.int64)
    g = e._gather_rows(pool, cidx, pool.length[cidx])
    cur, pos = cur_all[cidx], pos_all[cidx]
    tokens = _old_decode_loop(e, g, cur, pos, active, temps, n_steps, attend_len, rng)
    written = e._scatter_rows(pool, g, slot_idx)
    if written is not None:
        rows, slots = written
        cur_all.index_copy_(0, slots, cur.index_select(0, rows))
        pos_all.index_copy_(0, slots, pos.index_select(0, rows))
    return tokens


def _busy_engine(params, cache_dtype, temperature):
    """An engine of 4 slots with 3 live rows of unequal lengths after its first tick."""
    e = TE.ServingEngine(params[1], CFG, max_slots=4, max_seq_len=64, decode_chunk=3, cache_dtype=cache_dtype,
                         length_buckets=(32,), patch_buckets=(0,), seed=4)
    b = _batch((21, 22, 23), n_text=(5, 11, 8))
    for i in range(3):
        ids = [int(t) for t in b.input_ids[i, :b.lengths[i]]]
        e.submit(TE.Request(request_id=f"r{i}", token_ids=ids, images=[], max_tokens=30,
                            temperature=temperature if i != 1 else 0.0))
    e.step()
    assert e.active.tolist() == [True, True, True, False]
    return e


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("form", ["full", "compact"])
def test_engine_chunks_equal_the_chunks_they_replaced(params, form, cache_dtype, temperature):
    """Two chunks (attend span 32, then the full span) from one state: the tokens, the
    pool (length included), cur_tokens, next_pos and the generator's state bit for bit
    those of the eager chunks the engine ran before its graphs, the compact one over a
    fresh gathered copy of the rows."""
    e = _busy_engine(params, cache_dtype, temperature)
    ref = e.cache.clone()
    ref_cur, ref_pos = e.cur_tokens.clone(), e.next_pos.clone()
    rng = torch.Generator().manual_seed(0)
    rng.set_state(e._rng.get_state())
    temps = np.array([temperature, 0.0, temperature, 0.0], np.float32)
    with e._device_scope():
        for attend in (32, None):
            if form == "full":
                active = e.active.copy()
                out = e._decode_steps(active, temps, n_steps=3, attend_len=attend)
                want = _old_decode_loop(e, ref, ref_cur, ref_pos, active, temps, 3, attend, rng)
            else:
                slot_idx, active = np.array([0, 2], np.int32), np.array([True, True])
                out = e._decode_steps_compact(slot_idx, active, temps[[0, 2]], n_steps=3, attend_len=attend)
                want = _old_compact(e, ref, ref_cur, ref_pos, slot_idx, active, temps[[0, 2]], 3, attend, rng)
            assert torch.equal(out, want)
            assert _same(_cache_state(e.cache), _cache_state(ref))
            assert torch.equal(e.cur_tokens, ref_cur) and torch.equal(e.next_pos, ref_pos)
            assert torch.equal(e._rng.get_state(), rng.get_state())
    assert ("full" if form == "full" else "compact") in {k[0] for k in e.graphs.keys()}
    if form == "compact":
        assert list(e._staging) == [2] and e.staging_bytes() == sum(
            t.numel() * t.element_size() for t in _cache_state(e._staging[2].cache))


def test_the_engine_drops_its_graphs_on_reset_and_on_moved_params(params):
    """reset_state() reallocates the pool, and a params assignment that moves a leaf
    hands the chunks other addresses: both drop every key. Handing over the same
    tensors (GRPO's handoff of weights updated in place) and reseed(), which reseeds the
    registered generator in place, keep them."""
    e = _busy_engine(params, "float32", 0.5)

    def chunk():
        with e._device_scope():
            e._decode_steps(np.ones(4, bool), np.full(4, 0.5, np.float32), n_steps=2)
        assert e.graphs.keys()

    chunk()
    e.reset_state()
    assert e.graphs.keys() == [] and not e.active.any()
    chunk()
    e.params = e.params
    assert e.graphs.keys()
    e.params = map_tree(torch.clone, e.params)
    assert e.graphs.keys() == []
    chunk()
    e.reseed(11)
    assert e.graphs.keys()
    assert torch.equal(e._rng.get_state(), torch.Generator().manual_seed(11).get_state())


# ---------------------------------------------------------------------------
# On the card: captured against eager
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest --noconftest -m cuda tests/test_torch_graphs.py)")
    _cuda.lib()
    return torch.device("cuda")


def _eager(monkeypatch, graphs):
    """Make `graphs` run every step eagerly: the same step functions, no capture."""
    monkeypatch.setattr(graphs, "run", lambda key, fn, generators=(): fn())


def _card_params(dtype):
    from zoomearth_tpu_torch.models.params import init_vlm_params

    cfg = dataclasses.replace(CFG, dtype=dtype)
    p = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    return cfg, map_tree(lambda t: t.to("cuda").to(getattr(torch, dtype)), p)


CARD_CASES = [("float32", "float32", 0.0), ("float32", "float32", 0.8), ("bfloat16", "bfloat16", 0.0),
              ("bfloat16", "int8", 0.0), ("bfloat16", "int8", 0.9), ("float32", "int8", 0.8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache_dtype,temperature", CARD_CASES)
def test_captured_solo_and_pair_decode_equal_eager_on_card(dev, monkeypatch, dtype, cache_dtype, temperature):
    cfg, p = _card_params(dtype)
    gen = TG.GenerationConfig(max_new_tokens=12, temperature=temperature, top_p=0.9 if temperature else 1.0)
    ba, bb = _batch((31, 32, 33)), _batch((34, 35, 36), n_text=(3, 10, 6))

    def run(captured):
        g = TG.Generator(p, cfg, max_cache_len=64, cache_dtype=cache_dtype)
        if not captured:
            _eager(monkeypatch, g.graphs)
        la, ca, aa = g.run_prefill(ba, max_new=12)
        lb, cb, ab = g.run_prefill(bb, max_new=12)
        n = (K3.decode_attention_cuda.launches, K3.decode_attention_cuda.int8_launches)
        solo, cs = g.run_decode(la, ca.clone(), ba.next_pos, gen, seed=3, attend=aa)
        pair = g.run_decode_pair((la, ca, ba.next_pos, aa, None), (lb, cb, bb.next_pos, ab, None), steps=9,
                                 temperature=temperature, temperature_b=temperature / 2, seed=4)
        torch.cuda.synchronize()
        ran = (K3.decode_attention_cuda.launches - n[0], K3.decode_attention_cuda.int8_launches - n[1])
        steps = g.decode_steps["solo"] + 2 * g.decode_steps["pair"]
        assert ran[0] == L * steps and ran[1] == (ran[0] if cache_dtype == "int8" else 0), (ran, steps)
        assert g.graphs.captures == (2 if captured else 0) and g.graphs.held == 0
        return [solo, *pair[:3], *pair[4:7]], _cache_state(cs) + _cache_state(pair[3]) + _cache_state(pair[7])

    eager_out, eager_caches = run(False)
    out, caches = run(True)
    for a, b in zip(out, eager_out):
        assert torch.equal(a, b)
    assert _same(caches, eager_caches)


@pytest.mark.cuda
def test_launches_after_n_replays_are_n_times_one_steps(dev):
    cfg, p = _card_params("float32")
    g = TG.Generator(p, cfg, max_cache_len=64)
    b = _batch((41, 42, 43))
    g._stop = torch.tensor([-1, -2], device="cuda")  # no stop token: every call takes all its steps
    for n in (2, 5, 9):
        logits, cache, attend = g.run_prefill(b, max_new=n)
        before = K3.decode_attention_cuda.launches
        g.run_decode(logits, cache, b.next_pos, TG.GenerationConfig(max_new_tokens=n), attend=attend)
        torch.cuda.synchronize()
        assert K3.decode_attention_cuda.launches - before == n * L  # one eager step, n - 1 replays


def _engine_traffic_run(p, cfg, cache_dtype, temperature, monkeypatch=None):
    e = TE.ServingEngine(p, cfg, max_slots=4, max_seq_len=128, decode_chunk=3, cache_dtype=cache_dtype,
                         length_buckets=(32, 64), patch_buckets=(0,), seed=9)
    e.decode_attend_buckets = (32, 64)
    if monkeypatch is not None:
        _eager(monkeypatch, e.graphs)
    b = _batch(tuple(range(50, 56)), n_text=(5, 11, 8, 3, 9, 14))
    for rows in ((0, 1, 2, 3, 4), (5, 0)):  # then, reseeded over the held graphs, two rows more
        for i in rows:
            ids = [int(t) for t in b.input_ids[i, :b.lengths[i]]]
            e.submit(TE.Request(request_id=f"r{i}-{len(rows)}", token_ids=ids, images=[],
                                max_tokens=(20, 7, 13, 4, 16, 10)[i], temperature=temperature if i % 2 == 0 else 0.0))
        e.run_until_idle()
        e.reseed(7)
    toks = {rid: e.get_completion(rid, timeout=5).token_ids for rid in list(e.results)}
    assert e.stats["decode_device_row_steps"] < 4 * e.stats["decode_steps"]  # compact chunks ran
    return toks, e


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache_dtype,temperature", CARD_CASES)
def test_captured_engine_chunks_equal_eager_on_card(dev, monkeypatch, dtype, cache_dtype, temperature):
    """Rows join and leave, so full-width and compact chunks (several attend spans)
    run; every key's first chunk is eager and the rest replay; a reseed between two
    bursts restarts the draws of the graphs held."""
    cfg, p = _card_params(dtype)
    n = K3.decode_attention_cuda.launches
    toks, e = _engine_traffic_run(p, cfg, cache_dtype, temperature)
    assert K3.decode_attention_cuda.launches - n == L * e.stats["decode_steps"]
    assert e.graphs.captures > 0 and e.graphs.held == e.graphs.captures
    with monkeypatch.context() as m:
        eager, _ = _engine_traffic_run(p, cfg, cache_dtype, temperature, m)
    assert toks == eager


@pytest.mark.cuda
def test_engine_chunk_after_params_rebound_reads_the_new_tensors(dev):
    """A captured full-width chunk, then params rebound to a tree whose embedding is
    zero (tied head: every logit 0, every greedy token 0): the next chunks emit 0s,
    eagerly, then captured and replayed on the new tensors."""
    cfg, p = _card_params("float32")
    e = TE.ServingEngine(p, cfg, max_slots=2, max_seq_len=64, decode_chunk=2, cache_dtype="float32",
                         length_buckets=(32,), patch_buckets=(0,))
    active, temps = np.ones(2, bool), np.zeros(2, np.float32)

    def chunk():
        with e._device_scope():
            return e._decode_steps(active, temps, n_steps=2).cpu()

    before = [chunk() for _ in range(3)]
    assert e.graphs.held == 1 and not all(bool((t == 0).all()) for t in before), before
    zero = dict(p, text=dict(p["text"], embed={"weight": torch.zeros_like(p["text"]["embed"]["weight"])}))
    e.params = zero
    assert e.graphs.held == 0
    for _ in range(3):
        toks = chunk()
        assert bool((toks == 0).all()), toks
    assert e.graphs.held == 1
