"""The port's tracer (zoomearth_tpu_torch/utils/profiling.py) and the spans and counters
the program keeps in it.

On the CPU: off, the tracer records nothing, creates no CUDA event and hands out one
shared no-op span; two tiny-config `run_episodes_pipelined` runs, tracer off and on,
give the same episodes, and the traced one holds every span of the episode's host
preparation and of the Generator, each nested in its caller's, the host preparation
outside the device calls but for the stage 1 built ahead; `image.resize_src_px`
counts the source pixels of the resizes that resample and nothing else; `stop()` keeps
the records and `start()` clears them; counters and spans from many threads lose
nothing; `trace(dir)` writes the tracer's spans into the Chrome trace, placed among the
profiler's own events.

Marked `cuda` (skipped where torch.cuda.is_available() is false; on the card: python -m
pytest --noconftest -m cuda tests/test_torch_tracing.py): off, no CUDA event is made;
on, a device span gives a device interval inside its host interval; a span and a count
inside a function captured into a CUDA graph record no event; a captured decode's
`graph.capture`, `graph.step` and `decode` spans, the steps inside the decode call on
the device clock.

This file imports no JAX: its card tests run on a machine without it.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu_torch.agent import episode as EP
from zoomearth_tpu_torch.agent import prompts as PT
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.image.geometry import resize_image
from zoomearth_tpu_torch.models.params import init_vlm_params
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.utils import profiling as PF
from zoomearth_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
HOST_PREP = ("image.resize", "image.crop", "processor.preprocess", "text.tokenize", "text.decode", "batch.pack")
# each span's callers' spans: it must lie inside one of them, on the same thread
PARENTS = {
    "image.crop": {"episode.stage2_inputs"},
    "episode.prep_pool": {"episode.stage1_inputs", "episode.stage2_inputs"},
    "text.tokenize": {"episode.stage1_inputs", "episode.stage2_inputs"},
    "batch.pack": {"episode.stage1_inputs", "episode.stage2_inputs"},
    "vision": {"prefill", "chunk_prefill"},
    "graph.step": {"decode"},
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test leaves the process-wide tracer off."""
    tracer.stop()
    yield
    tracer.stop()


# spans the preparation pool's threads open: each lies inside a pooled section in time
POOLED = ("image.resize", "processor.preprocess")


def _inside(child, parents, same_thread=True):
    name, a, b, ident = child
    return any(a >= pa and b <= pb and (ident == pi or not same_thread) for _, pa, pb, pi in parents)


def _tiles(n, seed, sizes):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in sizes[:n]]


TILE_SIZES = [(600, 600), (700, 520), (512, 300), (800, 640), (600, 610), (640, 900)]


@pytest.fixture(scope="module")
def episodes():
    """Three waves of 2 episodes through run_episodes_pipelined, tracer off and then on:
    (results off, results on, the traced spans, counters and device intervals, tiles)."""
    params = init_vlm_params(CFG, torch.Generator().manual_seed(0))
    processor = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)
    tiles = _tiles(6, 3, TILE_SIZES)
    waves = [([f"what is at site {w}{i}?" for i in range(2)], tiles[2 * w:2 * w + 2]) for w in range(3)]
    g1, g2 = TG.GenerationConfig(max_new_tokens=7), TG.GenerationConfig(max_new_tokens=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EP, "_usable_cores", lambda: 4)  # the pool's width on every machine
        mp.setattr(PT, "stage1_prompt", lambda q: PT.PREFIX + q + "\nAnswer.<|im_end|><|im_start|>assistant\n")
        mp.setattr(EP, "extract_bboxes", lambda text, scale=1.0: [[100, 100, 260, 220]])

        def run():
            gen = TG.Generator(params, CFG, max_cache_len=512, cache_dtype="float32")
            out = EP.run_episodes_pipelined(gen, processor, waves, gen=g1, stage2_gen=g2)
            return [[r.__dict__ for r in wave] for wave in out], dict(gen.decode_steps)

        off = run()
        tracer.start()
        try:
            on = run()
        finally:
            tracer.stop()
    return off, on, list(tracer.spans), dict(tracer.counters), list(tracer.device), tiles


def test_off_the_tracer_records_nothing_and_makes_no_event(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    assert not tracer.on
    a, b = tracer.span("image.resize"), tracer.span("decode", device=True)
    assert a is b  # the one shared no-op span
    with a:
        with b:
            tracer.count("image.resize_src_px", 25_000_000)
    resize_image(Image.new("RGB", (900, 600)), 512)
    assert tracer.spans == [] and tracer.counters == {} and tracer.device == [] and made == []


def test_pipelined_episodes_are_the_same_with_the_tracer_on(episodes):
    off, on, spans, _, _, _ = episodes
    assert on == off
    assert all(not r["error"] and r["bbox"] for wave in on[0] for r in wave)
    assert spans


def test_the_tracer_records_every_span_nested_in_its_callers(episodes):
    _, (_, steps), spans, _, device, _ = episodes
    names = {n for n, _, _, _ in spans}
    assert names == set(HOST_PREP) | set(PARENTS) | {"episode.stage1_inputs", "episode.stage2_inputs", "prefill",
                                                     "chunk_prefill", "decode", "episode.stage1_wait"}
    assert device == []  # on the CPU a device span is a host span only
    by = {n: [s for s in spans if s[0] == n] for n in names}
    for child, parents in PARENTS.items():
        outside = [s for s in by[child] if not _inside(s, [p for n in parents for p in by[n]])]
        assert not outside, (child, outside[:3])
    # a wave's two tiles and two crops are prepared on the pool's threads, inside its sections
    for child in POOLED:
        outside = [s for s in by[child] if not _inside(s, by["episode.prep_pool"], same_thread=False)]
        assert not outside and {s[3] for s in by[child]}.isdisjoint({s[3] for s in by["episode.prep_pool"]}), child
    assert len(by["episode.prep_pool"]) == 6
    # text.decode: in the stage-2 preparation, and once a wave where its episodes complete
    top = [s for s in by["text.decode"] if not _inside(s, by["episode.stage2_inputs"])]
    assert len(top) == 3 and len(by["text.decode"]) > 3
    assert len(by["episode.stage1_inputs"]) == len(by["episode.stage2_inputs"]) == 3
    assert len(by["prefill"]) == 3 and len(by["chunk_prefill"]) == 3
    assert len(by["graph.step"]) == sum(steps.values())  # one run of the step a decode step
    # the host preparation lies outside the device calls, but for waves 1 and 2's stage 1, built ahead on the
    # prefetch thread while the device runs the wave before
    device_calls = by["prefill"] + by["chunk_prefill"] + by["decode"]
    caller = by["prefill"][0][3]
    ahead = [s for s in by["episode.stage1_inputs"] if s[3] != caller]
    assert len(ahead) == 2 and len(by["episode.stage1_wait"]) == 2
    assert all(s[3] == caller for s in by["episode.stage1_wait"] + by["episode.stage2_inputs"])
    assert not [s for n in HOST_PREP for s in by[n]
                if _inside(s, device_calls, same_thread=False) and not _inside(s, ahead, same_thread=False)]


def test_the_resize_counter_is_the_source_pixels_of_the_resamples(episodes):
    _, _, spans, counters, _, tiles = episodes
    # stage 1 shrinks each tile to 512 px (a 512 x 300 tile is left as it is); the crops are 512 px windows
    resized = [t for t in tiles if max(t.size) > 512]
    assert counters == {"image.resize_src_px": sum(t.width * t.height for t in resized), "episode.prep_pooled": 12,
                        "episode.stage1_prefetched": 2}
    assert sum(n == "image.resize" for n, _, _, _ in spans) == len(resized) == 5
    # the rule on its own: (size, max_size, min_side) -> resampled?
    cases = [((900, 600), 512, None, True), ((300, 200), 512, None, False), ((512, 512), 512, None, False),
             ((1000, 100), 512, 30, True), ((1000, 20), 512, 30, False)]
    tracer.start()
    for size, max_size, min_side, _ in cases:
        resize_image(Image.new("RGB", size), max_size, min_side)
    tracer.stop()
    want = sum(w * h for (w, h), _, _, real in cases if real)
    assert tracer.counters["image.resize_src_px"] == want == 900 * 600 + 1000 * 100
    assert sum(n == "image.resize" for n, _, _, _ in tracer.spans) == 2


def test_stop_keeps_the_records_and_start_clears_them():
    tracer.start()
    with tracer.span("batch.pack"):
        tracer.count("image.resize_src_px", 7)
    tracer.count("image.resize_src_px", 5)
    open_span = tracer.span("text.decode")
    open_span.__enter__()
    tracer.stop()
    open_span.__exit__(None, None, None)  # closed after stop(): not kept
    assert [s[0] for s in tracer.spans] == ["batch.pack"] and tracer.counters == {"image.resize_src_px": 12}
    tracer.count("image.resize_src_px", 100)  # off: not counted
    assert tracer.counters == {"image.resize_src_px": 12}
    tracer.start()
    assert tracer.spans == [] and tracer.counters == {} and tracer.device == []
    tracer.count("image.resize_src_px", 1)
    assert tracer.counters == {"image.resize_src_px": 1}


def test_counts_and_spans_from_many_threads_lose_nothing():
    n_threads, n = 12, 3000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    alive = threading.Barrier(n_threads)  # no thread ends before all have recorded: their ids stay distinct
    tracer.start()
    try:
        def work():
            for _ in range(n):
                tracer.count("c", 1)
            for _ in range(50):
                with tracer.span("s"):
                    pass
            alive.wait(timeout=60)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        tracer.stop()
    assert tracer.counters == {"c": n_threads * n}
    assert len(tracer.spans) == 50 * n_threads
    assert len({ident for _, _, _, ident in tracer.spans}) == n_threads


def test_a_cpu_trace_holds_the_tracers_spans_among_the_profilers_events(tmp_path):
    with PF.trace(str(tmp_path)):
        with PF.annotate("region"):
            time.sleep(0.005)
            with tracer.span("batch.pack"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.02)
            time.sleep(0.005)
    assert not tracer.on  # the trace turned it on for its block only
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    region = next(e for e in events if e.get("name") == "region" and e.get("ph") == "X")
    span = next(e for e in events if e.get("name") == "batch.pack" and e.get("cat") == "tracer")
    threads = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert threads[span["tid"]].startswith("host (tracer)") and "device (CUDA events)" in threads.values()
    # placed on the profiler's clock (microseconds): inside the region that encloses it, after its start and
    # ending before its end, at least as long as its own sleep (a loaded machine only stretches the sleeps)
    assert region["ts"] < span["ts"] and span["ts"] + span["dur"] < region["ts"] + region["dur"]
    assert 20000 <= span["dur"] < region["dur"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest --noconftest -m cuda tests/test_torch_tracing.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_on_the_card(dev, monkeypatch):
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    made = []
    event = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: (made.append(1), event(*a, **k))[1])
    with tracer.span("decode", device=True):
        x @ x
    tracer.count("c", 1)
    assert made == [] and tracer.spans == [] and tracer.counters == {}
    tracer.start()
    with tracer.span("decode", device=True):
        for _ in range(20):
            x = torch.tanh(x @ x)
    tracer.stop()
    assert len(made) == 3  # the origin and one pair
    ((_, ha, hb, _),), ((name, da, db),) = tracer.spans, tracer.device
    assert name == "decode" and db > da
    # the device's interval starts after the host opened the span and ends after the device's work: not
    # before the host closed it (the host waits for nothing inside)
    assert ha - 1e-3 <= da and db >= hb - 1e-3


@pytest.mark.cuda
def test_no_event_is_recorded_during_a_capture(dev):
    x = torch.randn(256, 256, device=dev)
    y = torch.empty_like(x)

    def step():
        tracer.count("c", 1)
        with tracer.span("inside", device=True):
            y.copy_(x @ x)

    step()  # eager warm-up on a side stream, as a capture needs
    torch.cuda.synchronize()
    tracer.start()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    g.replay()
    tracer.stop()
    assert tracer.device == []  # the host span and the count are kept, no event was recorded
    assert [s[0] for s in tracer.spans] == ["inside"] and tracer.counters == {"c": 1}
    assert torch.allclose(y, x @ x)


@pytest.mark.cuda
def test_a_captured_decode_is_traced_on_the_device_clock(dev):
    gen = TG.Generator(init_vlm_params(CFG, device=dev), CFG, max_cache_len=64, cache_dtype="float32")
    gen._stop = torch.tensor([-1, -2], device=dev)  # no stop token: every call takes all its steps
    rng = np.random.default_rng(5)
    b = TG.prepare_batch(CFG, [[CFG.tokens.im_start] + [int(t) for t in rng.integers(1, 400, size=n)]
                               for n in (6, 9)], [[], []], length_buckets=(32,), patch_buckets=(0,))
    logits, cache, attend = gen.run_prefill(b, max_new=10)
    tracer.start()
    gen.run_decode(logits, cache, b.next_pos, TG.GenerationConfig(max_new_tokens=10), attend=attend)
    tracer.stop()
    host = {n: [s for s in tracer.spans if s[0] == n] for n in ("decode", "graph.step", "graph.capture")}
    device = {n: [s for s in tracer.device if s[0] == n] for n in ("decode", "graph.step")}
    assert len(host["graph.capture"]) == 1 and len(host["decode"]) == 1 and len(host["graph.step"]) == 10
    assert len(device["decode"]) == 1 and len(device["graph.step"]) == 10  # the eager step and 9 replays
    (_, da, db), steps = device["decode"][0], device["graph.step"]
    assert all(da <= a < b <= db for _, a, b in steps)
    assert all(steps[i][2] <= steps[i + 1][1] for i in range(9))  # one after the other on one stream
