"""Stage-1 preparation shares each distinct image of a wave (agent/episode.py::_stage1_inputs).

Rows that show one image object share its shrink, scale and patches. On the tiny config
on the CPU: a wave whose 7 rows show 3 tile objects of different sizes and a wave whose
rows each get a copy give the same prepared batch, array for array, and both equal the
row-by-row preparation (`processor.encode` of each row's own shrink); through
`run_episodes_pipelined` and `run_episodes` in both stage-2 modes they give the same
episodes. With the tracer on, the shared wave resamples and patchifies 3 times, counts
the 3 tiles' source pixels, 4 reused rows and 3 images prepared on the pool; the copied
wave counts no reuse and 7 pooled images.

This file imports no JAX.
"""

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
from zoomearth_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
TILE_SIZES = [(900, 600), (700, 1000), (640, 560)]  # each over 512 px, each its own scale
ROWS = [0, 1, 0, 2, 1, 0, 2]  # the tile each row shows: 7 rows, 3 tiles, 4 reuses
STAGE1_MAX = 512


@pytest.fixture(autouse=True)
def tracer_cleared():
    """Every test leaves the process-wide tracer off and empty, as a new process has it:
    a later test file in the same worker may assert that it holds no records."""
    tracer.stop()
    yield
    tracer.start()  # start() clears the records
    tracer.stop()


@pytest.fixture(autouse=True)
def short_prompts(monkeypatch):
    """A stage-1 prompt the byte-level tokenizer keeps short, and a bbox that follows
    the row's scale where the program parses one."""
    monkeypatch.setattr(PT, "stage1_prompt", lambda q: PT.PREFIX + q + "\nAnswer.<|im_end|><|im_start|>assistant\n")
    monkeypatch.setattr(EP, "extract_bboxes", lambda text, scale=1.0: [[int(40 * scale), 60, 300, 280]])


@pytest.fixture(scope="module")
def setup():
    params = init_vlm_params(CFG, torch.Generator().manual_seed(0))
    processor = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=16 * 28 * 28)
    rng = np.random.default_rng(19)
    tiles = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in TILE_SIZES]
    return params, processor, tiles


def _waves(tiles, n_waves=1):
    """(shared, copied) waves of 7 rows each: the same questions, tile objects shared or copied."""
    shared, copied = [], []
    for w in range(n_waves):
        questions = [f"what is at site {w}{i}?" for i in range(len(ROWS))]
        shared.append((questions, [tiles[k] for k in ROWS]))
        copied.append((questions, [tiles[k].copy() for k in ROWS]))
    return shared, copied


def _generator(params):
    return TG.Generator(params, CFG, max_cache_len=512, cache_dtype="float32")


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


def test_a_shared_wave_prepares_the_batch_of_a_copied_wave_and_of_row_by_row(setup):
    params, processor, tiles = setup
    (shared,), (copied,) = _waves(tiles)
    gen = _generator(params)
    out_s = EP._stage1_inputs(gen, processor, *shared, STAGE1_MAX)
    out_c = EP._stage1_inputs(gen, processor, *copied, STAGE1_MAX)
    # the row-by-row preparation: each row shrinks and encodes its own image
    questions, images = copied
    texts = [PT.stage1_prompt(q) for q in questions]
    smalls = [resize_image(im, STAGE1_MAX) for im in images]
    encoded = [processor.encode(t, [s]) for t, s in zip(texts, smalls)]
    ref = TG.prepare_batch(CFG, [ids for ids, _ in encoded], [ims for _, ims in encoded])
    for texts_x, resized, scales, enc, batch in (out_s, out_c):
        assert texts_x == texts
        assert scales == [max(im.size) / max(s.size) for im, s in zip(images, smalls)]
        assert len(set(scales)) == len(TILE_SIZES)
        assert [np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(resized, smalls)] == [True] * len(ROWS)
        assert [ids for ids, _ in enc] == [ids for ids, _ in encoded]
        for (_, got), (_, want) in zip(enc, encoded):
            assert len(got) == 1 and got[0][1] == want[0][1] and np.array_equal(got[0][0], want[0][0])
        _assert_same_arrays(_batch_arrays(batch), _batch_arrays(ref))
    # rows about one tile hold the one shrink and its patches; copied rows hold their own
    _, resized_s, _, enc_s, _ = out_s
    _, resized_c, _, enc_c, _ = out_c
    assert resized_s[0] is resized_s[2] is resized_s[5] and resized_s[1] is resized_s[4]
    assert enc_s[3][1][0] is enc_s[6][1][0] and enc_s[0][1] is not enc_s[2][1]
    assert len({id(r) for r in resized_c}) == len(ROWS)


def _run(mode, params, processor, waves):
    g1, g2 = TG.GenerationConfig(max_new_tokens=6), TG.GenerationConfig(max_new_tokens=4)
    gen = _generator(params)
    if mode == "pipelined":
        out = EP.run_episodes_pipelined(gen, processor, waves, gen=g1, stage2_gen=g2)
    else:
        out = [EP.run_episodes(gen, processor, q, ims, gen=g1, stage2_gen=g2, reuse_cache=(mode == "reuse"))
               for q, ims in waves]
    return [[r.__dict__ for r in wave] for wave in out]


@pytest.mark.parametrize("mode", ["pipelined", "reuse", "sequential"])
def test_a_shared_wave_serves_the_episodes_of_a_copied_wave(setup, mode):
    params, processor, tiles = setup
    shared, copied = _waves(tiles, n_waves=2 if mode == "pipelined" else 1)
    got, want = _run(mode, params, processor, shared), _run(mode, params, processor, copied)
    assert got == want
    assert all(not r["error"] and r["bbox"] for wave in got for r in wave)
    # each tile's rows project their bbox with that tile's own scale
    assert len({r["bbox"][0] for r in got[0]}) == len(TILE_SIZES)


def _traced_stage1(gen, processor, wave):
    tracer.start()
    try:
        EP._stage1_inputs(gen, processor, *wave, STAGE1_MAX)
    finally:
        tracer.stop()
    names = [n for n, _, _, _ in tracer.spans]
    return names, dict(tracer.counters)


def test_a_shared_wave_resamples_and_patchifies_each_tile_once_and_counts_the_reuses(setup, monkeypatch):
    params, processor, tiles = setup
    monkeypatch.setattr(EP, "_usable_cores", lambda: 4)  # the preparation pool's width on every machine
    (shared,), (copied,) = _waves(tiles)
    gen = _generator(params)
    names, counters = _traced_stage1(gen, processor, shared)
    assert names.count("image.resize") == names.count("processor.preprocess") == len(TILE_SIZES)
    assert names.count("text.tokenize") == len(ROWS) and names.count("batch.pack") == 1
    assert counters == {"image.resize_src_px": sum(w * h for w, h in TILE_SIZES), "episode.stage1_images_reused": 4,
                        "episode.prep_pooled": len(TILE_SIZES)}
    names, counters = _traced_stage1(gen, processor, copied)
    assert names.count("image.resize") == names.count("processor.preprocess") == len(ROWS)
    assert counters == {"image.resize_src_px": sum(TILE_SIZES[k][0] * TILE_SIZES[k][1] for k in ROWS),
                        "episode.prep_pooled": len(ROWS)}
