"""The port's host-side copies are EXACTLY the JAX package's (vision metadata, M-RoPE
ids, batch packing, buckets, and the framework-free host modules it keeps its own
copy of: config, tokenizer, prompts, processor, image geometry and preprocessing with
the native library, the LRS-GRO reader, the CLI's yaml parsing), its HF loader reads
what the JAX package exports, and the port imports neither JAX nor the JAX package."""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from PIL import Image

from zoomearth_tpu import config as JC
from zoomearth_tpu import native as JN
from zoomearth_tpu import tokenizer as JT
from zoomearth_tpu.agent import processor as JPR
from zoomearth_tpu.agent import prompts as JP
from zoomearth_tpu.cli import config as JCC
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.eval import client as JCL
from zoomearth_tpu.image import geometry as JGEO
from zoomearth_tpu.image import loader as JL
from zoomearth_tpu.image import preprocess as JPP
from zoomearth_tpu.models import rope as JR
from zoomearth_tpu.models import vit as JV
from zoomearth_tpu.models.params import export_hf_state_dict, init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.runtime import generate as JG
from zoomearth_tpu.serve import server as JSV
from zoomearth_tpu.train import data as JD
from zoomearth_tpu_torch import config as TC
from zoomearth_tpu_torch import native as TN
from zoomearth_tpu_torch import tokenizer as TT
from zoomearth_tpu_torch.agent import processor as TPR
from zoomearth_tpu_torch.agent import prompts as TP
from zoomearth_tpu_torch.cli import config as TCC
from zoomearth_tpu_torch.eval import client as TCL
from zoomearth_tpu_torch.image import geometry as TGEO
from zoomearth_tpu_torch.image import loader as TL
from zoomearth_tpu_torch.image import preprocess as TPP
from zoomearth_tpu_torch.models import rope as TR
from zoomearth_tpu_torch.models import vit as TV
from zoomearth_tpu_torch.models.params import load_hf_checkpoint, params_from_numpy, tree_leaves
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.serve import server as TSV
from zoomearth_tpu_torch.train import data as TD

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
CFG3B = VLMConfig.qwen2_5_vl_3b()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("vcfg,grids,pad_to,win_mode", [
    (CFG.vision, [(1, 8, 8), (1, 4, 8)], 0, None),
    (CFG.vision, [(1, 6, 6)], 64, None),
    (CFG3B.vision, [(1, 36, 36)], 0, 0),  # one 512 px image, unpadded
    (CFG3B.vision, [(1, 36, 36)] * 8, 10368, 1),  # stage-1 batch of 8, padded bucket
    (CFG3B.vision, [(1, 32, 32)] * 2, 2048, 2),  # uniform 448 px windows
    (CFG3B.vision, [(1, 36, 36), (1, 20, 28)], 2304, None),
])
def test_vision_metadata_equals_reference(vcfg, grids, pad_to, win_mode):
    ref = JV.vision_metadata(grids, vcfg, pad_to=pad_to)
    out = TV.vision_metadata(grids, vcfg, pad_to=pad_to)
    if win_mode is not None:
        assert ref.win_mode == win_mode
    for f in ("perm", "inv_perm_merged", "seg_window", "seg_full", "pos_ids", "num_patches",
              "win_mode", "win_gidx", "win_valid", "win_sidx"):
        a, b = getattr(out, f), getattr(ref, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            _assert_same(np.asarray(a) if isinstance(b, np.ndarray) else a, b)
    idx, wid = TV.window_index(grids, vcfg)
    ridx, rwid = JV.window_index(grids, vcfg)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(wid, rwid)


def _ids(rng, grids, tok, n_text=(3, 5)):
    ids = [tok.im_start] + list(rng.integers(1, 400, n_text[0]))
    for t, h, w in grids:
        ids += [tok.vision_start] + [tok.image_pad] * (t * h * w // 4) + [tok.vision_end]
        ids += list(rng.integers(1, 400, n_text[1]))
    return [int(i) for i in ids]


def test_mrope_position_ids_equal_reference():
    rng = np.random.default_rng(0)
    tok = CFG.tokens
    for grids in ([(1, 4, 4)], [(1, 4, 6), (1, 2, 2)], [(2, 4, 4)], []):
        ids = np.asarray(_ids(rng, grids, tok))
        for mask in (None, (np.arange(len(ids)) < len(ids) - 2).astype(np.int32)):
            _assert_same(TR.mrope_position_ids(ids, grids, image_pad_id=tok.image_pad, attention_mask=mask),
                         JR.mrope_position_ids(ids, grids, image_pad_id=tok.image_pad, attention_mask=mask))
        _assert_same(TR.mrope_chunk_position_ids(ids, grids, 17, image_pad_id=tok.image_pad),
                     JR.mrope_chunk_position_ids(ids, grids, 17, image_pad_id=tok.image_pad))
        np.testing.assert_array_equal(TR.vision_pos_ids(grids or [(1, 2, 2)]),
                                      JR.vision_pos_ids(grids or [(1, 2, 2)]))
    batch = np.stack([np.asarray(_ids(rng, [(1, 4, 4)], tok)) for _ in range(3)])
    out = TR.mrope_position_ids_batch(batch, [[(1, 4, 4)]] * 3, image_pad_id=tok.image_pad)
    ref = JR.mrope_position_ids_batch(batch, [[(1, 4, 4)]] * 3, image_pad_id=tok.image_pad)
    for a, b in zip(out, ref):
        _assert_same(a, b)


def _images(rng, grids):
    return [(rng.integers(0, 256, (t * h * w, CFG.vision.patch_dim)).astype(np.uint8), (t, h, w))
            for t, h, w in grids]


def _batch_fields(b):
    return {"input_ids": b.input_ids, "lengths": b.lengths, "position_ids": b.position_ids,
            "next_pos": b.next_pos, "pixel_values": b.pixel_values, "vision_meta": b.vision_meta}


def test_prepare_batch_and_continuation_equal_reference():
    rng = np.random.default_rng(1)
    tok = CFG.tokens
    grids = [[(1, 4, 4)], [(1, 4, 6)], []]
    seqs = [_ids(rng, g, tok, (3, 2 + i)) for i, g in enumerate(grids)]
    imgs = [_images(rng, g) for g in grids]
    for kw in ({}, {"length_buckets": (64,), "patch_buckets": (64,)}):
        _assert_same(_batch_fields(TG.prepare_batch(CFG, seqs, imgs, **kw)),
                     _batch_fields(JG.prepare_batch(CFG, seqs, imgs, **kw)))
        chunks = [[tok.vision_start] + [tok.image_pad] * 4 + [tok.vision_end], [tok.pad], [7, 8, 9]]
        cimgs = [_images(rng, [(1, 4, 4)]), [], []]
        starts = [40, 12, 33]
        _assert_same(_batch_fields(TG.prepare_continuation(CFG, chunks, cimgs, starts, **kw)),
                     _batch_fields(JG.prepare_continuation(CFG, chunks, cimgs, starts, **kw)))


def test_buckets_equal_reference():
    assert TG.DEFAULT_LENGTH_BUCKETS == JG.DEFAULT_LENGTH_BUCKETS
    assert TG.DEFAULT_CACHE_BUCKETS == JG.DEFAULT_CACHE_BUCKETS
    assert TG.DEFAULT_PATCH_BUCKETS == JG.DEFAULT_PATCH_BUCKETS
    for n in (1, 128, 129, 700, 2048):
        assert TG.bucket(n, TG.DEFAULT_LENGTH_BUCKETS) == JG.bucket(n, JG.DEFAULT_LENGTH_BUCKETS)
    with pytest.raises(ValueError):
        TG.bucket(5000, TG.DEFAULT_LENGTH_BUCKETS)
    assert TG.GenerationConfig() == TG.GenerationConfig(**JG.GenerationConfig().__dict__)


def test_load_hf_checkpoint_reads_reference_export(tmp_path):
    """The JAX package's HF export, saved as safetensors, loads into the same tree
    that params_from_numpy builds from the JAX params."""
    from safetensors.numpy import save_file

    jp = jax_init_vlm_params(jax.random.key(2), CFG)
    state = export_hf_state_dict(jp, CFG)
    half = len(state) // 2
    keys = sorted(state)
    save_file({k: state[k] for k in keys[:half]}, str(tmp_path / "a.safetensors"))
    save_file({k: state[k] for k in keys[half:]}, str(tmp_path / "b.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: ("a" if i < half else "b") + ".safetensors"
                                  for i, k in enumerate(keys)}}, f)
    loaded = load_hf_checkpoint(str(tmp_path), CFG, dtype=torch.float32)
    ref = params_from_numpy(jax.tree.map(np.asarray, jp))
    for a, b in zip(tree_leaves(loaded), tree_leaves(ref)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The port's own copies of the framework-free host modules
# ---------------------------------------------------------------------------

def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("cls,factory", [("VLMConfig", "tiny"), ("VLMConfig", "qwen2_5_vl_3b"),
                                         ("InternVLVLMConfig", "tiny")])
def test_config_equals_reference_field_for_field(cls, factory):
    ours, ref = getattr(getattr(TC, cls), factory)(), getattr(getattr(JC, cls), factory)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for part in ("text", "vision", "tokens"):
        a, b = getattr(ours, part), getattr(ref, part)
        assert type(a).__name__ == type(b).__name__
        assert [(f.name, f.default) for f in dataclasses.fields(a)] == [(f.name, f.default) for f in dataclasses.fields(b)]
    assert ours.vision.patch_dim == ref.vision.patch_dim and ours.text.head_dim == ref.text.head_dim


def test_config_from_hf_dir_equals_reference(tmp_path):
    hf = {"vocab_size": 1000, "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 3,
          "num_attention_heads": 8, "num_key_value_heads": 2, "rope_theta": 10000.0, "tie_word_embeddings": False,
          "rope_scaling": {"mrope_section": [4, 2, 2], "type": "mrope"}, "image_token_id": 77,
          "vision_config": {"depth": 4, "hidden_size": 64, "intermediate_size": 128, "num_heads": 4,
                            "out_hidden_size": 128, "window_size": 56, "fullatt_block_indexes": [1, 3]}}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    assert dataclasses.asdict(TC.VLMConfig.from_hf_dir(str(tmp_path))) == \
        dataclasses.asdict(JC.VLMConfig.from_hf_dir(str(tmp_path)))


@pytest.mark.parametrize("h,w", [(30, 40), (224, 224), (500, 333), (1000, 37), (5000, 4000), (28, 2000)])
def test_smart_resize_and_token_count_equal_reference(h, w):
    for kw in ({}, {"max_pixels": 512 * 512}, {"min_pixels": 56 * 56, "max_pixels": 28 * 28 * 16}):
        try:
            ref = JPP.smart_resize(h, w, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                TPP.smart_resize(h, w, **kw)
            continue
        assert TPP.smart_resize(h, w, **kw) == ref
        grid = (1, ref[0] // 14, ref[1] // 14)
        assert TPP.num_vision_tokens(grid) == JPP.num_vision_tokens(grid)
    np.testing.assert_array_equal(TPP.IMAGE_MEAN, JPP.IMAGE_MEAN)
    np.testing.assert_array_equal(TPP.IMAGE_STD, JPP.IMAGE_STD)
    assert (TPP.DEFAULT_MIN_PIXELS, TPP.DEFAULT_MAX_PIXELS) == (JPP.DEFAULT_MIN_PIXELS, JPP.DEFAULT_MAX_PIXELS)


@pytest.mark.parametrize("fn", ["preprocess_image", "preprocess_image_fast", "preprocess_image_u8"])
@pytest.mark.parametrize("h,w,max_pixels", [(64, 96, None), (300, 200, 128 * 128), (57, 113, None)])
def test_preprocess_equals_reference(fn, h, w, max_pixels):
    """The numpy path, the native normalize+patchify path and the raw-byte path (the
    port's native library is its own build of its own copy of image_ops.cpp)."""
    img = _image(np.random.default_rng(h * w), h, w)
    kw = {} if max_pixels is None else {"max_pixels": max_pixels}
    for image in (img, Image.fromarray(img)):
        out, grid = getattr(TPP, fn)(image, **kw)
        ref, ref_grid = getattr(JPP, fn)(image, **kw)
        assert grid == ref_grid and out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    if fn == "preprocess_image_u8":
        out, grid = TPP.preprocess_image_u8(img, compact=True, **kw)
        ref, ref_grid = JPP.preprocess_image_u8(img, compact=True, **kw)
        assert grid == ref_grid
        np.testing.assert_array_equal(out, ref)
    flat, thw = TPP.preprocess_images([img, img[: h // 2]], **kw)
    rflat, rthw = JPP.preprocess_images([img, img[: h // 2]], **kw)
    np.testing.assert_array_equal(flat, rflat)
    np.testing.assert_array_equal(thw, rthw)


def test_native_library_builds_into_the_build_directory_and_equals_reference():
    """The port's native image library: built from its own source into <repo>/build/
    (never beside the source), same answers as the reference's."""
    assert TN.available() == JN.available()
    if not TN.available():
        pytest.skip(f"no working g++: {TN.build_error()}")
    path = TN._lib_path()
    assert os.path.exists(path) and os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert not [f for f in os.listdir(os.path.dirname(TN.__file__)) if f.endswith(".so")]
    rng = np.random.default_rng(3)
    img = _image(rng, 140, 196)
    np.testing.assert_array_equal(TN.resize_bicubic(img, 84, 112), JN.resize_bicubic(img, 84, 112))
    np.testing.assert_array_equal(TN.crop(img, (-5, 10, 120, 500)), JN.crop(img, (-5, 10, 120, 500)))
    np.testing.assert_array_equal(TN.patchify_u8(img), JN.patchify_u8(img))
    np.testing.assert_array_equal(TN.patchify_u8(img, temporal=1), JN.patchify_u8(img, temporal=1))
    np.testing.assert_array_equal(TN.normalize_patchify(img, TPP.IMAGE_MEAN, TPP.IMAGE_STD),
                                  JN.normalize_patchify(img, JPP.IMAGE_MEAN, JPP.IMAGE_STD))


_TEXTS = [
    'I look. [{"bbox_2d": [10, 20, 300, 400], "label": "ship"}] <answer>two</answer>',
    '<think>hm</think>[{"bbox_2d": [1.5, 2, 3, 4]}, {"bbox_2d": [5,6,7,8], "label": "x"}]',
    '{"bbox_2d": [10, 20, 30]} <answer> yes </answer><answer>no</answer>',
    '"bbox_2d": [a, b, c, d]', "no box here", "", '<answer>\nmulti\nline\n</answer>',
    '```json\n[{"bbox_2d": [100, 100, 50, 50], "label": "inverted"}]\n```',
]


@pytest.mark.parametrize("text", _TEXTS)
def test_text_extraction_equals_reference(text):
    for scale in (1.0, 2.5, 0.3):
        assert TGEO.extract_bboxes(text, scale) == JGEO.extract_bboxes(text, scale)
        assert TGEO.extract_bbox(text, scale) == JGEO.extract_bbox(text, scale)
    assert TGEO.extract_answer(text) == JGEO.extract_answer(text)
    assert TGEO.extract_think(text) == JGEO.extract_think(text)
    assert TGEO.parse_bbox_json(text) == JGEO.parse_bbox_json(text)


@pytest.mark.parametrize("bbox", [[10, 20, 300, 400], [0, 0, 50, 50], [900, 700, 1000, 800], [-20, -5, 2000, 90],
                                  [400, 300, 410, 305], [10.7, 20.2, 600.9, 700.5]])
def test_geometry_equals_reference(bbox):
    rng = np.random.default_rng(int(abs(bbox[0])) + 1)
    for w, h in ((1000, 800), (300, 200), (640, 1500)):
        assert TGEO.crop_window(bbox, w, h) == JGEO.crop_window(bbox, w, h)
        assert TGEO.crop_window(bbox, w, h, min_size=128) == JGEO.crop_window(bbox, w, h, min_size=128)
        for max_size, min_side in ((512, None), (1024, 28), (100, 56)):
            assert TGEO.resize_scale(w, h, max_size, min_side) == JGEO.resize_scale(w, h, max_size, min_side)
            assert TGEO.resized_size(w, h, max_size, min_side) == JGEO.resized_size(w, h, max_size, min_side)
        img = Image.fromarray(_image(rng, h, w))
        np.testing.assert_array_equal(np.asarray(TGEO.cut_image(img, bbox)), np.asarray(JGEO.cut_image(img, bbox)))
        np.testing.assert_array_equal(np.asarray(TGEO.resize_image(img, 256)), np.asarray(JGEO.resize_image(img, 256)))
        ours, ref = TGEO.resize_image_with_scale(img, 200), JGEO.resize_image_with_scale(img, 200)
        assert ours[1:] == ref[1:]
        np.testing.assert_array_equal(np.asarray(ours[0]), np.asarray(ref[0]))
    other = [bbox[0] + 30, bbox[1] - 10, bbox[2] + 100, bbox[3] + 5]
    assert TGEO.box_iou(bbox, other) == JGEO.box_iou(bbox, other)
    assert TGEO.center_distance(bbox, other) == JGEO.center_distance(bbox, other)


def test_prompts_equal_reference():
    for name in ("VISION_TOKENS", "PREFIX", "INSTRUCTION", "INSTRUCTION_EVAL", "TEXT_SYSTEM_PROMPT"):
        assert getattr(TP, name) == getattr(JP, name), name
    q = "How many ships are docked at the northern pier?"
    for fn in ("stage1_prompt", "rl_prompt", "text_rl_prompt"):
        assert getattr(TP, fn)(q) == getattr(JP, fn)(q), fn
    s1 = 'thinking [{"bbox_2d": [1, 2, 3, 4]}]<answer>3</answer> trailing'
    assert TP.stage2_prompt(TP.stage1_prompt(q), s1) == JP.stage2_prompt(JP.stage1_prompt(q), s1)


@pytest.mark.parametrize("text", [
    "plain ascii", "<|im_start|>user\nhi<|im_end|>", "<|vision_start|><|image_pad|><|vision_end|> what?",
    "unicode: \u00e9\u4e2d\U0001f6f0 mixed <|im_end|> tail", "", "<|image_pad|><|image_pad|>", "<|not_a_token|>"])
def test_fake_tokenizer_round_trips_equal_reference(text):
    ours, ref = TT.FakeTokenizer(TC.VLMConfig.tiny().tokens), JT.FakeTokenizer(JC.VLMConfig.tiny().tokens)
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    for skip in (True, False):
        assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)
    assert ours.decode(ids, skip_special_tokens=False) == text
    for token in ("<|im_end|>", "<|image_pad|>", "<|vision_start|>"):
        assert ours.token_id(token) == ref.token_id(token)


@pytest.mark.parametrize("compact", [False, True])
def test_processor_equals_reference_on_both_stages(compact):
    """Token ids, patches and grids for a stage-1 prompt (one resized tile) and a
    stage-2 prompt (the tile and the crop)."""
    rng = np.random.default_rng(11)
    tile, crop = Image.fromarray(_image(rng, 320, 448)), Image.fromarray(_image(rng, 200, 150))
    ours = TPR.Processor(TT.FakeTokenizer(TC.VLMConfig.tiny().tokens), TC.VLMConfig.tiny(), max_pixels=256 * 256,
                         compact_patches=compact)
    ref = JPR.Processor(JT.FakeTokenizer(JC.VLMConfig.tiny().tokens), JC.VLMConfig.tiny(), max_pixels=256 * 256,
                        compact_patches=compact)
    assert TPR.IGNORE_INDEX == JPR.IGNORE_INDEX
    p1 = TP.stage1_prompt("what is at the pier?")
    p2 = TP.stage2_prompt(p1, 'see [{"bbox_2d": [10, 10, 90, 90]}]<answer>x</answer>')
    for prompt, images in ((p1, [tile]), (p2, [tile, crop])):
        _assert_same(ours.encode(prompt, images), ref.encode(prompt, images))
    _assert_same(ours.encode_with_labels(p1, "<answer>a boat</answer>", [tile]),
                 ref.encode_with_labels(p1, "<answer>a boat</answer>", [tile]))
    grids = [(1, 4, 6), (1, 2, 2)]
    pad = TC.VLMConfig.tiny().tokens.image_pad
    assert ours.expand_image_pads([5, pad, 6, pad], grids) == ref.expand_image_pads([5, pad, 6, pad], grids)


def test_lrs_gro_reader_and_batched_equal_reference(tmp_path):
    rng = np.random.default_rng(5)
    rows = [{"question_id": i, "image_name": f"sub/dir/tile{i}.png", "category": "cat", "question": f"q{i}?",
             "higher_level": "perception", "ground_truth": "ship", "bbox": [int(x) for x in rng.integers(0, 900, 4)],
             "type": "object", "split": "test"} for i in range(7)]
    rows.append({"question_id": "bare"})  # every other field takes its default
    for name in ("a.jsonl", "b.jsonl"):
        with open(tmp_path / name, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    paths, folders = [str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")], ["/img/a", "/img/b"]
    ours, ref = TD.load_lrs_gro_jsonl(paths, folders), JD.load_lrs_gro_jsonl(paths, folders)
    assert len(ours) == 16 and [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in ref]
    assert [f.name for f in dataclasses.fields(TD.LRSGROSample)] == [f.name for f in dataclasses.fields(JD.LRSGROSample)]
    for n, drop in ((3, False), (3, True), (16, False), (20, True)):
        assert [[s.question_id for s in b] for b in TD.batched(ours, n, drop_last=drop)] == \
            [[s.question_id for s in b] for b in JD.batched(ref, n, drop_last=drop)]


def test_parse_with_yaml_equals_reference(tmp_path):
    def parser():
        p = argparse.ArgumentParser()
        p.add_argument("--model_name", required=True)
        p.add_argument("--batch_size", type=int, default=8)
        p.add_argument("--temperature", type=float, default=0.01)
        return p

    with open(tmp_path / "c.yaml", "w") as f:
        f.write("model_name: from_yaml\nbatch_size: 4\n")
    for argv in (["--model_name", "m"], ["--config", str(tmp_path / "c.yaml")],
                 ["--config", str(tmp_path / "c.yaml"), "--batch_size", "2", "--temperature", "0.5"]):
        assert vars(TCC.parse_with_yaml(parser(), argv)) == vars(JCC.parse_with_yaml(parser(), argv))
    with open(tmp_path / "bad.yaml", "w") as f:
        f.write("no_such_key: 1\n")
    for mod in (TCC, JCC):
        with pytest.raises(SystemExit, match="unknown config keys"):
            mod.parse_with_yaml(parser(), ["--config", str(tmp_path / "bad.yaml")])


# ---------------------------------------------------------------------------
# image/loader.py: TileImage, PrefetchLoader
# ---------------------------------------------------------------------------

def _tile(seed, h=90, w=130):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("source", ["array", "pil", "strided"])
def test_tile_image_crop_resize_size_equal_reference(source):
    arr = _tile(1)
    src = {"array": arr, "pil": Image.fromarray(arr), "strided": np.asfortranarray(arr)}[source]
    t, j = TL.TileImage(src), JL.TileImage(src)
    assert t.size == j.size == (130, 90) and (t.width, t.height) == (j.width, j.height)
    assert t.array.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(t.array, j.array)
    for box in ((0, 0, 130, 90), (10, 5, 77, 60), (3.7, 2.2, 50.9, 41.0), (120, 80, 130, 90)):
        tc, jc = t.crop(box), j.crop(box)
        np.testing.assert_array_equal(tc.array, jc.array)
        assert tc.size == jc.size
        x1, y1, x2, y2 = (int(v) for v in box)
        np.testing.assert_array_equal(tc.array, np.asarray(Image.fromarray(arr).crop((x1, y1, x2, y2))))
    for size in ((64, 48), (200, 31), (1, 1)):
        np.testing.assert_array_equal(t.resize(size).array, j.resize(size).array)
        assert t.resize(size).size == size
    assert t.convert("RGB") is t
    np.testing.assert_array_equal(np.asarray(t.to_pil()), np.asarray(j.to_pil()))
    with pytest.raises(AssertionError):
        t.convert("L")


def test_tile_image_crop_without_the_native_library(monkeypatch):
    arr = _tile(2)
    with_native = TL.TileImage(arr).crop((4, 6, 90, 70)).array
    monkeypatch.setattr(TN, "available", lambda: False)
    np.testing.assert_array_equal(TL.TileImage(arr).crop((4, 6, 90, 70)).array, with_native)


def test_tile_image_goes_through_the_geometry_helpers():
    """A TileImage stands in for a PIL image in resize_image / cut_image (the episode's crop)."""
    arr = _tile(3, 300, 400)
    t, j, pil = TL.TileImage(arr), JL.TileImage(arr), Image.fromarray(arr)
    np.testing.assert_array_equal(TGEO.resize_image(t, 128).array, JGEO.resize_image(j, 128).array)
    np.testing.assert_array_equal(TGEO.resize_image(t, 128).array, np.asarray(TGEO.resize_image(pil, 128)))
    box = [100, 90, 180, 150]
    np.testing.assert_array_equal(TGEO.cut_image(t, box, 64).array, JGEO.cut_image(j, box, 64).array)
    np.testing.assert_array_equal(TGEO.cut_image(t, box, 64).array, np.asarray(TGEO.cut_image(pil, box, 64)))


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_loader_order_depth_and_exception_position(depth):
    def fn(i):
        if i == 3:
            raise ValueError(f"item {i}")
        return i * i

    for mod in (TL, JL):
        assert list(mod.PrefetchLoader(range(6), lambda i: i * i, depth=depth)) == [0, 1, 4, 9, 16, 25]
        assert list(mod.PrefetchLoader([], fn, depth=depth)) == []
        loader = mod.PrefetchLoader(range(6), fn, depth=depth)
        assert loader.q.maxsize == depth
        got = []
        with pytest.raises(ValueError, match="item 3"):
            for v in loader:
                got.append(v)
        assert got == [0, 1, 4]  # the exception surfaces at the failing item's position


def test_prefetch_loader_runs_ahead_of_the_consumer():
    import threading

    started = []
    gate = threading.Event()

    def fn(i):
        started.append(i)
        if i == 0:
            gate.wait(5)
        return i

    it = iter(TL.PrefetchLoader(range(4), fn, depth=2))
    gate.set()
    assert next(it) == 0
    assert list(it) == [1, 2, 3] and started == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# serve/server.py and eval/client.py: the endpoint's and the client's host functions
# ---------------------------------------------------------------------------

def _chat_image(seed, mode="RGB", h=48, w=72):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)).convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
def test_data_url_encode_and_decode_equal_reference(mode):
    image = _chat_image(5, mode)
    url = TCL.encode_data_url(image)
    assert url == JCL.encode_data_url(image)
    back, ref = TSV._decode_data_url(url), JSV._decode_data_url(url)
    assert (back.mode, back.size) == (ref.mode, ref.size) == ("RGB", (72, 48))
    assert back.tobytes() == ref.tobytes()
    for mod in (TSV, JSV):
        with pytest.raises(ValueError, match="only base64 data URLs"):
            mod._decode_data_url("file:///tmp/x.png")


@pytest.mark.parametrize("seed", range(4))
def test_render_chat_equals_reference_on_random_conversations(seed):
    """Random conversations: with or without a system message, string and list
    contents, text and image items in any order, unknown item types, a trailing
    assistant partial."""
    rng = np.random.default_rng(seed)
    url = TCL.encode_data_url(_chat_image(seed, h=20, w=24))
    messages = [{"role": "system", "content": "be brief"}] if seed % 2 else []
    for turn in range(int(rng.integers(1, 5))):
        items = []
        for _ in range(int(rng.integers(0, 4))):
            kind = int(rng.integers(0, 3))
            items.append({"type": "text", "text": f"t{int(rng.integers(100))}"} if kind == 0 else
                         {"type": "image_url", "image_url": {"url": url}} if kind == 1 else {"type": "audio"})
        role = "user" if turn % 2 == 0 else "assistant"
        messages.append({"role": role, "content": items if rng.integers(2) else f"plain {turn}"})
    if seed >= 2:
        messages.append({"role": "assistant", "content": [{"type": "text", "text": "<think>so"},
                                                          {"type": "image_url", "image_url": {"url": url}}]})
    text, images, cont = TSV.render_chat(messages)
    ref_text, ref_images, ref_cont = JSV.render_chat(messages)
    assert (text, cont) == (ref_text, ref_cont) and cont == (messages[-1]["role"] == "assistant")
    assert [i.tobytes() for i in images] == [i.tobytes() for i in ref_images]
    assert text.count(TSV.VISION_TOKENS) == len(images)
    assert (TSV.VISION_TOKENS, TSV.DEFAULT_SYSTEM) == (JSV.VISION_TOKENS, JSV.DEFAULT_SYSTEM)


class _CannedClient:
    """Stands in for ChatClient: records the calls, answers from a list (an exception
    in the list is raised)."""

    def __init__(self, answers):
        self.answers, self.calls = list(answers), []

    def create(self, messages, **kw):
        self.calls.append((json.loads(json.dumps(messages)), kw))
        out = self.answers.pop(0)
        if isinstance(out, Exception):
            raise out
        return out


@pytest.mark.parametrize("answers", [
    ['<think>look</think>{"bbox_2d": [10,12,40,44]}<answer>car</answer>', "<answer>ship</answer>"],
    ["<answer>no box here</answer>"],
    [RuntimeError("stage one failed")],
    ['{"bbox_2d": [10,12,40,44]}', RuntimeError("stage two failed")],
], ids=["two-stage", "no-bbox", "stage-1-error", "stage-2-error"])
@pytest.mark.parametrize("replicate", [False, True], ids=["fixed", "reference-bugs"])
def test_process_item_record_and_messages_equal_reference(answers, replicate):
    """process_item over a canned client: the record (keys in order, values) and the
    messages sent (data URLs included) equal the reference's."""
    sample = TD.LRSGROSample(question_id="7", image_name="tile.png", category="cat", question="what is there?",
                             higher_level="perception", ground_truth="car", bbox=[1, 2, 3, 4], type="object",
                             image_path="tile.png")
    tile = _chat_image(9, h=900, w=1200)
    recs, calls = [], []
    for mod in (TCL, JCL):
        client = _CannedClient(answers)
        recs.append(mod.process_item(sample, client, image_loader=lambda s: tile, max_size=256, max_tokens=32,
                                     temperature=0.5, replicate_reference_bugs=replicate))
        calls.append(client.calls)
    assert list(recs[0]) == list(recs[1]) and recs[0] == recs[1]
    assert calls[0] == calls[1] and len(calls[0]) == (2 if len(answers) == 2 else 1)
    assert recs[0]["error"] == (len(answers) == 1) and (recs[0]["bbox"] not in ("", [])) == (len(answers) == 2) and recs[0]["prompt"] == sample.question + TP.INSTRUCTION_EVAL
    assert all(kw == {"max_tokens": 32, "temperature": 0.5} for _, kw in calls[0])


def test_chat_client_parses_its_base_url_as_the_reference_does():
    for url in ("http://127.0.0.1:8123", "http://localhost", "http://example.invalid:9/v1"):
        t, j = TCL.ChatClient(url, model="m", timeout=3.0), JCL.ChatClient(url, model="m", timeout=3.0)
        assert (t.host, t.port, t.model, t.timeout) == (j.host, j.port, j.model, j.timeout)


def test_port_imports_no_jax():
    """No file of the port (nor chip_smoke.py) imports the JAX package, and importing
    every module of the port pulls in neither jax nor zoomearth_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import zoomearth_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, 'zoomearth_tpu_torch.')]\n"
        "assert len(mods) >= 30, mods\n"
        "new = {'serve.engine', 'serve.episodes', 'serve.server', 'eval.client', 'ops.quant', 'cli.serve',\n"
        "       'train.sft', 'train.sft_loop', 'train.checkpoints', 'train.callbacks', 'utils.metrics_sinks',\n"
        "       'cli.train_sft', 'rewards.detection', 'rewards.generic', 'rewards.internvl', 'rewards.llm_judge',\n"
        "       'rewards.registry', 'rewards.zoomearth', 'utils.mathcheck', 'train.grpo', 'train.lora',\n"
        "       'cli.train_grpo', 'image.anyres', 'models.internvit', 'models.internvl', 'train.rec',\n"
        "       'train.datagen', 'cli.generate', 'eval.benchmarks', 'cli.run_benchmarks', 'utils.profiling',\n"
        "       'parallel.mesh', 'parallel.multihost', 'parallel.collectives', 'parallel.launch', 'parallel.dryrun'}\n"
        "assert {'zoomearth_tpu_torch.' + m for m in new} <= set(mods), mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'zoomearth_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    pkg = os.path.join(REPO, "zoomearth_tpu_torch")
    files = [os.path.join(d, f) for d, _, names in os.walk(pkg) for f in names if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "torch_parallel_worker.py"),
              os.path.join(REPO, "tests", "torch_tensor_worker.py")]
    importers = sorted(os.path.relpath(f, REPO) for f in files
                       if re.search(r"^\s*(from|import) (zoomearth_tpu|jax)[. \n]", open(f).read(), re.M))
    assert importers == [], importers
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the reward modules and mathcheck (the port's own copies)
# ---------------------------------------------------------------------------

from zoomearth_tpu.rewards import detection as JDET  # noqa: E402
from zoomearth_tpu.rewards import generic as JGEN  # noqa: E402
from zoomearth_tpu.rewards import internvl as JIVL  # noqa: E402
from zoomearth_tpu.rewards import llm_judge as JLLM  # noqa: E402
from zoomearth_tpu.rewards import zoomearth as JZE  # noqa: E402
from zoomearth_tpu.train import lora as JLORA  # noqa: E402
from zoomearth_tpu.utils import mathcheck as JMATH  # noqa: E402
from zoomearth_tpu_torch.rewards import detection as TDET  # noqa: E402
from zoomearth_tpu_torch.rewards import generic as TGEN  # noqa: E402
from zoomearth_tpu_torch.rewards import internvl as TIVL  # noqa: E402
from zoomearth_tpu_torch.rewards import llm_judge as TLLM  # noqa: E402
from zoomearth_tpu_torch.rewards import zoomearth as TZE  # noqa: E402
from zoomearth_tpu_torch.utils import mathcheck as TMATH  # noqa: E402

_BOX_TEXTS = _TEXTS + [
    '<think>a</think>[{"bbox_2d": [1.5, 2.5, 300.25, 400]}]', '{"bbox_2d" : [ 7 , 8 , 9 , 10 ]}',
    '<think >spaced</think > <answer>\n x \n</answer>', '"bbox_2d": [1e3, 2, 3, 4]',
]
_BOXES = [[10, 20, 300, 400], [0, 0, 50, 50], [900, 700, 1000, 800], [-20, -5, 2000, 90], [100, 100, 50, 50],
          [4990, 4990, 5000, 5000], [90, 40, 110, 60], [1.5, 2.5, 3, 4], [10, 20, 30]]


@pytest.mark.parametrize("pair", [(TZE, JZE), (TDET, JDET), (TGEN, JGEN), (TIVL, JIVL), (TLLM, JLLM),
                                  (TMATH, JMATH)], ids=lambda p: p[1].__name__.rsplit(".", 1)[-1])
def test_reward_module_copies_have_the_references_names_and_constants(pair):
    ours, theirs = pair
    names = {n for n, v in vars(theirs).items() if not n.startswith("__") and not isinstance(v, type(sys))}
    assert names <= set(vars(ours)), names - set(vars(ours))
    for n in names:
        v = getattr(theirs, n)
        if isinstance(v, (str, int, float, tuple)):
            assert getattr(ours, n) == v, n
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(ours, n), v)


@pytest.mark.parametrize("text", _BOX_TEXTS)
def test_region_guided_helpers_equal_reference(text):
    assert TZE.extract_bboxes_float(text) == JZE.extract_bboxes_float(text)
    for tag in ("think", "answer", "bbox"):
        assert TZE.extract_tag(text, tag) == JZE.extract_tag(text, tag)
    assert TDET.clean_text(text) == JDET.clean_text(text)
    assert TDET.parse_json_boxes(text) == JDET.parse_json_boxes(text)
    assert TGEN.extract_choice(text) == JGEN.extract_choice(text)
    assert TGEN._answer_of(text) == JGEN._answer_of(text)


def test_box_geometry_of_the_rewards_equals_reference():
    for a in _BOXES:
        if len(a) == 4:
            assert TZE.get_crop_area(a) == JZE.get_crop_area(a)
            assert TZE.get_crop_area(a, 128) == JZE.get_crop_area(a, 128)
        for b in _BOXES:
            assert TZE.crop_iou(a, b) == JZE.crop_iou(a, b)
            if len(a) == len(b) == 4:
                assert TDET.iou_inclusive(a, b) == JDET.iou_inclusive(a, b)
                assert TIVL._iou(a, b) == JIVL._iou(a, b)
    for x in (0.0, 0.5, -2.0, 30.0):
        assert TZE._tanh(x) == JZE._tanh(x)
    preds = [{"bbox_2d": b, "label": lab} for b, lab in zip(_BOXES[:6], "aabbab")]
    gts = [{"bbox_2d": b, "label": lab} for b, lab in zip(_BOXES[1:5], "abab")]
    for st in (0, 1):
        assert TDET.calculate_map(preds, gts, st) == JDET.calculate_map(preds, gts, st)


@pytest.mark.parametrize("a,b", [("3", "3"), ("\\boxed{3}", "3"), ("\\frac{1}{2}", "1/2"), ("0.5", "\\frac12"),
                                 ("\\sqrt2", "\\sqrt{2}"), ("10\\text{ cm}", "10"), ("\\dfrac{3}{4}", "\\frac{3}{4}"),
                                 ("\\left(1,2\\right)", "(1,2)"), ("x = 5", "5"), ("", "1"), ("\\fbox{7}", "7")])
def test_mathcheck_equals_reference(a, b):
    for f in ("compute_score", "is_equiv"):
        assert getattr(TMATH, f)(a, b) == getattr(JMATH, f)(a, b), f
    for f in ("strip_string", "last_boxed_only_string", "_fix_fracs", "_fix_a_slash_b", "_fix_sqrt",
              "_remove_right_units"):
        assert getattr(TMATH, f)(a) == getattr(JMATH, f)(a), f


def test_llm_judge_equals_reference_with_a_stub_client_and_without_an_endpoint(monkeypatch):
    """The judge's exact-match fallback (no endpoint configured, or a failing client)
    and its parse of a client's answer; with JUDGE_BASE_URL the port builds its own
    ChatClient (constructing it opens no connection)."""
    class Stub:
        def __init__(self, reply):
            self.reply, self.seen = reply, []

        def create(self, messages, **kw):
            self.seen.append((messages, kw))
            if isinstance(self.reply, Exception):
                raise self.reply
            return self.reply

    monkeypatch.delenv("JUDGE_BASE_URL", raising=False)
    monkeypatch.delenv("OPENAI_API_BASE", raising=False)
    assert TLLM._default_client() is None and JLLM._default_client() is None
    for content, sol in (("<answer>car</answer>", "<answer>car</answer>"), ("a ship", "<answer>boat</answer>"),
                         ("<answer>x</answer><answer> y </answer>", "y")):
        assert TLLM.llm_reward(content, sol) == JLLM.llm_reward(content, sol)
        for reply in (" 1.0 ", "0.0", "maybe", RuntimeError("down")):
            ours, theirs = Stub(reply), Stub(reply)
            assert TLLM.llm_reward(content, sol, client=ours) == JLLM.llm_reward(content, sol, client=theirs)
            assert ours.seen == theirs.seen
    monkeypatch.setenv("JUDGE_BASE_URL", "http://127.0.0.1:9")
    client = TLLM._default_client()
    assert isinstance(client, TCL.ChatClient) and client.model == "qwen2.5:7b" and client.port == 9


def test_params_from_numpy_carries_lora_and_int8_trees_both_ways():
    """A LoRA tree of the JAX package ({"w", "a", "b", "s"} leaves with a 0-d s) and
    an int8 tree ({"q", "s"}) come across leaf for leaf, in structure, dtype and value,
    and go back to the same numpy arrays."""
    from zoomearth_tpu.ops.quant import quantize_decoder_int8
    from zoomearth_tpu_torch.models.params import map_tree
    from zoomearth_tpu_torch.ops.quant import qdot

    jp = JLORA.apply_lora(jax_init_vlm_params(jax.random.key(0), CFG), jax.random.key(1), r=4, alpha=8.0)
    ours = params_from_numpy(jax.tree.map(np.asarray, jp))
    wq = ours["text"]["layers"][0]["attn"]["wq"]
    assert set(wq) == {"w", "a", "b", "s"} and wq["s"].dim() == 0 and float(wq["s"]) == 2.0
    for tree in (jp, quantize_decoder_int8(jax_init_vlm_params(jax.random.key(2), CFG))):
        ours = params_from_numpy(jax.tree.map(np.asarray, tree))
        theirs = jax.tree.leaves(tree)
        back = jax.tree.leaves(map_tree(lambda t: t.numpy(), ours))
        assert len(back) == len(theirs)
        for a, b in zip(back, theirs):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == (np.int8 if b.dtype == np.int8 else np.float32)
            np.testing.assert_array_equal(a, b)
    x = torch.randn(3, CFG.text.hidden_size, generator=torch.Generator().manual_seed(0))
    wq = params_from_numpy(jax.tree.map(np.asarray, jp))["text"]["layers"][0]["attn"]["wq"]
    torch.testing.assert_close(qdot(x, wq), x @ wq["w"] + (x @ wq["a"]) @ wq["b"] * wq["s"])
