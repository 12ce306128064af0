"""The next wave's stage 1 built ahead on the episode host's prefetch thread
(agent/episode.py::run_episodes_pipelined).

On the tiny config on the CPU, over three and four lazy waves of two rows: each wave's
stage-1 batch reaches the runner array for array as `_stage1_inputs` builds it for that
wave, and the served tokens and episodes equal those of one call a wave. Wave 1's loader
and build start after wave 0's stage 1 is built, wave w+1's after wave w-1's stage 2 has
returned, on the prefetch thread, with no more than two waves' images loaded ahead of the
last finished stage 2. A loader that raises makes the call raise its exception; a runner
that raises while a build is running leaves it finished. With the tracer on,
`episode.stage1_prefetched` counts the waves built ahead and `episode.stage1_wait` is
opened once for each on the calling thread; off, nothing is recorded. One wave builds
nothing ahead and makes no prefetch thread. Order is read from a sequence of events,
never from a clock.

This file imports no JAX.
"""

import itertools
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu_torch.agent import episode as EP
from zoomearth_tpu_torch.agent import prompts as PT
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import init_vlm_params
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.runtime import pipeline as PL
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
ROWS = 2
STAGE1_MAX = 512
G1, G2 = TG.GenerationConfig(max_new_tokens=5), TG.GenerationConfig(max_new_tokens=3)


@pytest.fixture(autouse=True)
def tracer_cleared():
    """Every test leaves the process-wide tracer off and empty, as a new process has it."""
    tracer.stop()
    yield
    tracer.start()
    tracer.stop()


@pytest.fixture(autouse=True)
def host(monkeypatch):
    """A short stage-1 prompt, one bbox a row, and the preparation pool's width on every machine."""
    monkeypatch.setattr(PT, "stage1_prompt", lambda q: PT.PREFIX + q + "\nAnswer.<|im_end|><|im_start|>assistant\n")
    monkeypatch.setattr(EP, "extract_bboxes", lambda text, scale=1.0: [[60, 40, 300, 260]])
    monkeypatch.setattr(EP, "_usable_cores", lambda: 3)


@pytest.fixture(scope="module")
def model():
    params = init_vlm_params(CFG, torch.Generator().manual_seed(0))
    return params, Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)


def _wave(w):
    """Wave w's questions (each names its wave) and tiles, of sizes that differ wave to wave."""
    rng = np.random.default_rng([23, w])
    tiles = [Image.fromarray(rng.integers(0, 255, (520 + 40 * w + 30 * i, 600 + 20 * i, 3), dtype=np.uint8))
             for i in range(ROWS)]
    return [f"wave {w}: what is at site {i}?" for i in range(ROWS)], tiles


def _wave_of(questions):
    return int(questions[0].split(":")[0].split()[1])


class Events:
    """An ordered log of (event, wave, thread name) from every thread; the index is the order."""

    def __init__(self):
        self.log, self._lock, self._seq = [], threading.Lock(), itertools.count()
        self.loading = threading.Event()

    def add(self, what, w):
        with self._lock:
            self.log.append((next(self._seq), what, w, threading.current_thread().name))

    def at(self, what, w):
        (hit,) = [e for e in self.log if e[1:3] == (what, w)]
        return hit


def _recorded(monkeypatch, n_waves, raise_at=None, slow_at=None):
    """Lazy loaders for n_waves waves and the events of the loaders, `_stage1_inputs` and
    `_stage2_continuation`. The loader of wave `raise_at` raises; that of `slow_at` sets
    `ev.loading` and then waits a little, so a runner that raises meanwhile finds its
    build running."""
    ev = Events()

    def loader(w):
        def load():
            ev.add("load", w)
            if w == raise_at:
                raise LoaderFault(w)
            if w == slow_at:
                ev.loading.set()
                time.sleep(0.3)
            return _wave(w)
        return load

    def wrap(name):
        fn = getattr(EP, name)

        def recorded(generator, processor, questions, *a, **kw):
            w = _wave_of(questions)
            ev.add(name + ".start", w)
            out = fn(generator, processor, questions, *a, **kw)
            ev.add(name + ".end", w)
            return out

        monkeypatch.setattr(EP, name, recorded)

    wrap("_stage1_inputs")
    wrap("_stage2_continuation")
    return [loader(w) for w in range(n_waves)], ev


class LoaderFault(RuntimeError):
    pass


def _run(params, processor, waves):
    """(episodes, served token rows in read-back order) of one run_episodes_pipelined call."""
    gen = TG.Generator(params, CFG, max_cache_len=512, cache_dtype="float32")
    served = []
    gen.trim_generated = lambda buf, _fn=gen.trim_generated: (served.append(_fn(buf)), served[-1])[1]
    out = EP.run_episodes_pipelined(gen, processor, waves, gen=G1, stage2_gen=G2)
    return [[r.__dict__ for r in wave] for wave in out], served


def _batch_arrays(batch):
    out = {
        "input_ids": batch.input_ids, "lengths": batch.lengths, "position_ids": batch.position_ids,
        "next_pos": batch.next_pos, "pixel_values": batch.pixel_values,
    }
    out.update({f"meta.{k}": v for k, v in batch.vision_meta.items()})
    return out


@pytest.mark.parametrize("n_waves", [3, 4])
def test_each_wave_reaches_the_runner_as_built_and_serves_the_tokens_of_one_call_a_wave(model, monkeypatch, n_waves):
    params, processor = model
    runner, handed = PL.run_paired_waves, []

    def recording_runner(gen, n, build_stage1, *a, **kw):
        def build(w):
            handed.append(build_stage1(w))
            return handed[-1]

        return runner(gen, n, build, *a, **kw)

    monkeypatch.setattr(PL, "run_paired_waves", recording_runner)
    waves, _ = _recorded(monkeypatch, n_waves)
    episodes, served = _run(params, processor, waves)
    assert len(handed) == n_waves
    for w, batch in enumerate(handed):
        want = EP._stage1_inputs(types.SimpleNamespace(cfg=CFG), processor, *_wave(w), STAGE1_MAX)[-1]
        got, ref = _batch_arrays(batch), _batch_arrays(want)
        assert got.keys() == ref.keys()
        for k in got:
            x, y = np.asarray(got[k]), np.asarray(ref[k])
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (w, k)
    one_each = [_run(params, processor, [_wave(w)]) for w in range(n_waves)]
    assert episodes == [e for ep, _ in one_each for e in ep]
    assert served == [rows for _, s in one_each for rows in s] and len(served) == 2 * n_waves
    assert all(not r["error"] and r["bbox"] for wave in episodes for r in wave)


@pytest.mark.parametrize("n_waves", [3, 4])
def test_the_next_wave_is_loaded_and_built_after_the_stage2_before_it_on_the_prefetch_thread(
        model, monkeypatch, n_waves):
    params, processor = model
    waves, ev = _recorded(monkeypatch, n_waves)
    _run(params, processor, waves)
    caller = threading.current_thread().name
    assert ev.at("load", 0)[3] == ev.at("_stage1_inputs.start", 0)[3] == caller
    for w in range(1, n_waves):
        load, start = ev.at("load", w), ev.at("_stage1_inputs.start", w)
        after = ev.at("_stage1_inputs.end", 0) if w == 1 else ev.at("_stage2_continuation.end", w - 2)
        assert after[0] < load[0] < start[0], w
        assert load[3].startswith("episode-stage1") and start[3] == load[3], w
        # the runner takes wave w's batch before it prepares wave w-1's stage 2
        assert ev.at("_stage1_inputs.end", w)[0] < ev.at("_stage2_continuation.start", w - 1)[0]
    for e in ev.log:
        if e[1] == "load":  # waves loaded, less those whose stage 2 has finished: alive images
            finished = sum(1 for f in ev.log if f[1] == "_stage2_continuation.end" and f[0] < e[0])
            assert e[2] + 1 - finished <= 2, e
    assert all(e[3] == caller for e in ev.log if e[1].startswith("_stage2_continuation"))


@pytest.mark.parametrize("n_waves", [3, 4])
def test_a_loader_that_raises_is_raised_from_the_call_and_leaves_no_build_running(model, monkeypatch, n_waves):
    params, processor = model
    waves, ev = _recorded(monkeypatch, n_waves, raise_at=2)
    with pytest.raises(LoaderFault) as err:
        _run(params, processor, waves)
    assert err.value.args == (2,)
    assert [e[1:3] for e in ev.log if e[2] >= 2] == [("load", 2)]
    # every build that started has ended
    assert sorted(e[2] for e in ev.log if e[1] == "_stage1_inputs.start") == [0, 1]
    assert sorted(e[2] for e in ev.log if e[1] == "_stage1_inputs.end") == [0, 1]


def test_a_runner_that_raises_waits_for_the_build_it_started(model, monkeypatch):
    params, processor = model
    waves, ev = _recorded(monkeypatch, 4, slow_at=2)
    runner = PL.run_paired_waves

    def failing_runner(gen, n, build_stage1, build_stage2, **kw):
        def stage2_then_fault(w, *a):
            build_stage2(w, *a)  # submits wave 2's build
            assert ev.loading.wait(timeout=30)  # which has started on the prefetch thread
            raise LoaderFault("runner")

        return runner(gen, n, build_stage1, stage2_then_fault, **kw)

    monkeypatch.setattr(PL, "run_paired_waves", failing_runner)
    with pytest.raises(LoaderFault, match="runner"):
        _run(params, processor, waves)
    # wave 2's build had started on the prefetch thread and ran to its end before the call left
    assert [e[1] for e in ev.log if e[2] == 2] == ["load", "_stage1_inputs.start", "_stage1_inputs.end"]
    assert not [e for e in ev.log if e[2] == 3]


@pytest.mark.parametrize("n_waves", [3, 4])
def test_the_tracer_counts_the_waves_built_ahead_and_the_waits_for_them(model, monkeypatch, n_waves):
    params, processor = model
    caller = threading.get_ident()
    off = _run(params, processor, [_wave(w) for w in range(n_waves)])
    assert tracer.spans == [] and tracer.counters == {}
    tracer.start()
    try:
        on = _run(params, processor, [_wave(w) for w in range(n_waves)])
    finally:
        tracer.stop()
    assert on == off
    assert tracer.counters["episode.stage1_prefetched"] == n_waves - 1
    waits = [s for s in tracer.spans if s[0] == "episode.stage1_wait"]
    builds = [s for s in tracer.spans if s[0] == "episode.stage1_inputs"]
    assert len(waits) == n_waves - 1 and all(s[3] == caller for s in waits)
    assert len(builds) == n_waves and sum(s[3] != caller for s in builds) == n_waves - 1


def test_one_wave_builds_nothing_ahead(model, monkeypatch):
    params, processor = model
    monkeypatch.setattr(EP, "_prefetch", None)
    waves, ev = _recorded(monkeypatch, 1)
    tracer.start()
    try:
        _run(params, processor, waves)
    finally:
        tracer.stop()
    assert EP._prefetch is None
    assert {e[3] for e in ev.log} == {threading.current_thread().name}
    assert "episode.stage1_prefetched" not in tracer.counters
    assert not [s for s in tracer.spans if s[0] == "episode.stage1_wait"]
