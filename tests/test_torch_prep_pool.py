"""A wave's per-image preparation on the episode host's pool of threads
(agent/episode.py::_prep_map, `_stage1_inputs`, `_stage2_continuation`).

On the tiny config on the CPU, at pool widths 1, 3 and 8: stage 1 over a wave that mixes
shared and distinct tile objects of several sizes (one not square, one under the stage-1
size) and stage 2 over bboxes handed out one by one from an iterator, as the benchmark
hands them, give the prepared inputs of a row-by-row reconstruction, array for array,
each row with its own bbox's crop. A wave of one image, or one usable core, prepares
inline: no pool is made and no other thread runs a task. With the tracer on, the pooled
path counts the serial path's source pixels and reused rows, and `episode.prep_pooled`
counts the images prepared on the pool. Many callers at once share the one pool and lose
no count. No assertion reads a clock.

This file imports no JAX.
"""

import sys
import threading
import types

import numpy as np
import pytest
from PIL import Image

from zoomearth_tpu_torch.agent import episode as EP
from zoomearth_tpu_torch.agent import prompts as PT
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.image.geometry import cut_image, resize_image
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.runtime.families import family
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.utils.profiling import tracer

CFG = VLMConfig.tiny()
GEN = types.SimpleNamespace(cfg=CFG)  # the two functions read only the generator's config
# (w, h): over 512 px in both sides, taller than wide, wide and short, and one under the stage-1 size
TILE_SIZES = [(900, 600), (700, 1000), (1200, 400), (300, 200), (640, 560)]
ROWS = [0, 1, 0, 2, 3, 1, 4, 2, 0, 3, 5]  # 5: a copy of tile 0, a distinct object of the same pixels
STAGE1_MAX, CROP_MIN, CROP_MAX = 512, 128, 192
# a row's stage-1 bbox, or none (an inert row); sides 60-400 px, so crops of several sizes
BOXES = [[40, 60, 300, 280], [], [100, 500, 500, 900], [600, 10, 1000, 300], [20, 20, 80, 90], [0, 0, 640, 700],
         [], [300, 100, 700, 380], [10, 400, 200, 590], [150, 20, 290, 190], [500, 200, 880, 560]]


@pytest.fixture(autouse=True)
def tracer_cleared():
    """Every test leaves the process-wide tracer off and empty, as a new process has it."""
    tracer.stop()
    yield
    tracer.start()
    tracer.stop()


@pytest.fixture(autouse=True)
def short_prompt(monkeypatch):
    monkeypatch.setattr(PT, "stage1_prompt", lambda q: PT.PREFIX + q + "\nAnswer.<|im_end|><|im_start|>assistant\n")


@pytest.fixture(scope="module")
def wave():
    processor = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=16 * 28 * 28)
    rng = np.random.default_rng(21)
    tiles = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in TILE_SIZES]
    tiles.append(tiles[0].copy())
    questions = [f"what is at site {i}?" for i in range(len(ROWS))]
    return processor, questions, [tiles[k] for k in ROWS]


@pytest.fixture
def width(monkeypatch):
    """Sets the usable cores the pool's width follows; records the thread of every resize."""
    threads = []

    def resize(img, *a, **kw):
        threads.append(threading.current_thread())
        return resize_image(img, *a, **kw)

    monkeypatch.setattr(EP, "resize_image", resize)

    def set_width(n):
        monkeypatch.setattr(EP, "_usable_cores", lambda: n)
        return threads

    return set_width


def _out_tokens(tk, n):
    """Stage-1 completions of several lengths, some with an answer after the reasoning."""
    texts = [f"look at {i} " * (1 + i % 3) + ("<answer>yes</answer>" if i % 2 else "") for i in range(n)]
    return [tk.encode(t) for t in texts]


def _bbox_iterator(monkeypatch):
    """The benchmark's way: each call of extract_bboxes takes the next row's bbox."""
    boxes = iter(BOXES)
    monkeypatch.setattr(EP, "extract_bboxes", lambda text, scale=1.0: [b for b in [next(boxes)] if b])


def _serial_stage1(processor, questions, images):
    """Row by row: each row shrinks and preprocesses its own image."""
    tk = processor.tokenizer
    texts = [PT.stage1_prompt(q) for q in questions]
    smalls = [resize_image(im, STAGE1_MAX) for im in images]
    scales = [max(im.size) / max(s.size) for im, s in zip(images, smalls)]
    encoded = []
    for text, small in zip(texts, smalls):
        prepped = processor.preprocess_images([small])
        encoded.append((processor.expand_image_pads(tk.encode(text), [prepped[0][1]]), prepped))
    batch = TG.prepare_batch(CFG, [ids for ids, _ in encoded], [ims for _, ims in encoded])
    return texts, smalls, scales, encoded, batch


def _serial_stage2(processor, images, encoded, batch, out_tokens):
    """Row by row: each row with a bbox crops, shrinks and preprocesses its own window."""
    tk = processor.tokenizer
    n = len(images)
    chunks, imgs, keep, start, s2_idx = [[CFG.tokens.pad]] * n, [[] for _ in range(n)], [0] * n, [0] * n, []
    for i, box in enumerate(BOXES):
        keep[i], start[i] = len(encoded[i][0]), int(batch.next_pos[i])
        if not box:
            continue
        s2_idx.append(i)
        crop = resize_image(cut_image(images[i], box, CROP_MIN), CROP_MAX)
        imgs[i] = processor.preprocess_images([crop])
        pre_text = tk.decode(out_tokens[i], skip_special_tokens=False).split("<answer>")[0]
        kept, residual = EP.split_kept_tokens(tk, out_tokens[i], pre_text)
        chunks[i] = (tk.encode(residual) if residual else []) + processor.expand_image_pads(
            tk.encode(family(CFG).prompts()[1]), [imgs[i][0][1]])
        keep[i] += len(kept)
        start[i] += len(kept)
    inert = np.ones((n,), bool)
    inert[s2_idx] = False
    return TG.prepare_continuation(CFG, chunks, imgs, start), np.asarray(keep, np.int32), inert, s2_idx, imgs


def _batch_arrays(batch):
    out = {
        "input_ids": batch.input_ids, "lengths": batch.lengths, "position_ids": batch.position_ids,
        "next_pos": batch.next_pos, "pixel_values": batch.pixel_values,
    }
    out.update({f"meta.{k}": v for k, v in batch.vision_meta.items()})
    return out


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _assert_same_images(got, want):
    assert len(got) == len(want)
    for (pv, grid), (pv_w, grid_w) in zip(got, want):
        assert grid == grid_w and pv.dtype == pv_w.dtype and np.array_equal(pv, pv_w)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_stage1_on_the_pool_prepares_the_row_by_row_inputs(wave, width, n):
    processor, questions, images = wave
    threads = width(n)
    texts, resized, scales, encoded, batch = EP._stage1_inputs(GEN, processor, questions, images, STAGE1_MAX)
    texts_w, smalls, scales_w, encoded_w, batch_w = _serial_stage1(processor, questions, images)
    assert texts == texts_w and scales == scales_w and len(set(scales)) == len(TILE_SIZES)
    assert [(s.size, s.tobytes()) for s in resized] == [(s.size, s.tobytes()) for s in smalls]
    assert [ids for ids, _ in encoded] == [ids for ids, _ in encoded_w]
    for (_, got), (_, want) in zip(encoded, encoded_w):
        _assert_same_images(got, want)
    _assert_same_arrays(_batch_arrays(batch), _batch_arrays(batch_w))
    # each of the 6 distinct objects is shrunk once, on the pool's threads where the width allows
    assert len(threads) == len(TILE_SIZES) + 1
    pooled = [t for t in threads if t is not threading.current_thread()]
    assert len(pooled) == (0 if n == 1 else len(threads))
    assert all(t.name.startswith("episode-prep") for t in pooled)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_stage2_on_the_pool_gives_each_row_its_own_bboxs_crop(wave, width, monkeypatch, n):
    processor, questions, images = wave
    threads = width(n)
    texts, resized, scales, encoded, batch = EP._stage1_inputs(GEN, processor, questions, images, STAGE1_MAX)
    out_tokens = _out_tokens(processor.tokenizer, len(ROWS))
    _bbox_iterator(monkeypatch)
    del threads[:]
    results, bc, keep, inert, s2_idx = EP._stage2_continuation(
        GEN, processor, questions, images, texts, resized, scales, encoded, batch, out_tokens, CROP_MIN, CROP_MAX)
    bc_w, keep_w, inert_w, s2_idx_w, crops_w = _serial_stage2(processor, images, encoded, batch, out_tokens)
    assert s2_idx == s2_idx_w == [i for i, b in enumerate(BOXES) if b]
    assert np.array_equal(keep, keep_w) and keep.dtype == keep_w.dtype and np.array_equal(inert, inert_w)
    _assert_same_arrays(_batch_arrays(bc), _batch_arrays(bc_w))
    assert [r.bbox for r in results] == [b or None for b in BOXES]
    assert [r.error for r in results] == [not b for b in BOXES]
    # the crops differ row to row, so a row given another row's crop would show in the patches
    crops = [crops_w[i][0][0] for i in s2_idx]
    assert len({(pv.shape, pv.tobytes()) for pv in crops}) == len(s2_idx)
    assert len(threads) == len(s2_idx)
    assert all(t is not threading.current_thread() for t in threads) == (n > 1)


def test_one_image_or_one_core_prepares_inline_and_starts_no_thread(wave, width, monkeypatch):
    processor, questions, images = wave
    monkeypatch.setattr(EP, "_pool", None)
    threads = width(8)
    one = [images[0]] * len(images)  # every row shows one tile: one task
    got = EP._stage1_inputs(GEN, processor, questions, one, STAGE1_MAX)
    want = _serial_stage1(processor, questions, one)
    _assert_same_arrays(_batch_arrays(got[4]), _batch_arrays(want[4]))
    assert got[2] == want[2] and len(threads) == 1
    threads = width(1)
    del threads[:]
    texts, resized, scales, encoded, batch = EP._stage1_inputs(GEN, processor, questions, images, STAGE1_MAX)
    _assert_same_arrays(_batch_arrays(batch), _batch_arrays(_serial_stage1(processor, questions, images)[4]))
    _bbox_iterator(monkeypatch)
    out_tokens = _out_tokens(processor.tokenizer, len(ROWS))
    bc = EP._stage2_continuation(GEN, processor, questions, images, texts, resized, scales, encoded, batch,
                                 out_tokens, CROP_MIN, CROP_MAX)[1]
    _assert_same_arrays(_batch_arrays(bc), _batch_arrays(_serial_stage2(processor, images, encoded, batch,
                                                                        out_tokens)[0]))
    assert len(threads) == len(TILE_SIZES) + 1 + sum(map(bool, BOXES))
    assert all(t is threading.current_thread() for t in threads)
    assert EP._pool is None  # no executor was made, so no pool thread started


def _traced_wave(processor, questions, images, monkeypatch):
    tracer.start()
    try:
        texts, resized, scales, encoded, batch = EP._stage1_inputs(GEN, processor, questions, images, STAGE1_MAX)
        _bbox_iterator(monkeypatch)
        EP._stage2_continuation(GEN, processor, questions, images, texts, resized, scales, encoded, batch,
                                _out_tokens(processor.tokenizer, len(ROWS)), CROP_MIN, CROP_MAX)
    finally:
        tracer.stop()
    return [n for n, _, _, _ in tracer.spans], dict(tracer.counters)


def test_the_pooled_path_counts_what_the_serial_one_does_and_the_images_it_pooled(wave, width, monkeypatch):
    processor, questions, images = wave
    width(1)
    names_1, serial = _traced_wave(processor, questions, images, monkeypatch)
    width(8)
    names_8, pooled = _traced_wave(processor, questions, images, monkeypatch)
    n_distinct, n_crops = len(TILE_SIZES) + 1, sum(map(bool, BOXES))
    assert serial["episode.stage1_images_reused"] == len(ROWS) - n_distinct
    assert "episode.prep_pooled" not in serial and names_1.count("episode.prep_pool") == 0
    assert pooled == dict(serial, **{"episode.prep_pooled": n_distinct + n_crops})
    assert names_8.count("episode.prep_pool") == 2
    for name in ("image.resize", "processor.preprocess", "image.crop", "text.tokenize", "batch.pack"):
        assert names_8.count(name) == names_1.count(name), name


def test_many_callers_share_one_pool_and_lose_no_count(monkeypatch):
    monkeypatch.setattr(EP, "_pool", None)
    monkeypatch.setattr(EP, "_usable_cores", lambda: 3)
    n_callers, n_items = 12, 7
    got = [None] * n_callers
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracer.start()
    try:
        def call(c):
            got[c] = EP._prep_map(lambda x: (c, x * x), list(range(n_items)))

        callers = [threading.Thread(target=call, args=(c,)) for c in range(n_callers)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        tracer.stop()
    assert got == [[(c, x * x) for x in range(n_items)] for c in range(n_callers)]
    assert tracer.counters == {"episode.prep_pooled": n_callers * n_items}
    assert [n for n, _, _, _ in tracer.spans] == ["episode.prep_pool"] * n_callers
    assert EP._pool is not None and EP._pool._max_workers == 3
