"""The plain reference agrees with the port on the tiny configurations (fp32, CPU),
layer group by layer group: the vision tower, and the decoder's logits."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.families import qwen2_5_vl as fam_qwen
from portbench.harness.weights import make_weights
from portbench.reference import image as I
from portbench.reference import qwen2_5_vl as R

from .helpers import DATA

TOL = 2e-4


def tile(seed, px=150):
    from portbench.drivers.lrsgro_episodes import make_tile

    return make_tile(np.random.default_rng(seed), px, 10)


@pytest.fixture(scope="module")
def qwen():
    cfg = json.loads((DATA / "qwen2_5_vl_tiny.json").read_text())
    W = make_weights(fam_qwen.leaves(cfg), 2 ** 31 + 1, "cpu", torch.float32)
    return cfg, W, fam_qwen.program_config(cfg), fam_qwen.program_tree(W, cfg)


@pytest.mark.parametrize("size", [(150, 150), (200, 90)])
def test_qwen_vision_tower(qwen, size):
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.models.vit import meta_to_device, vision_metadata
    from zoomearth_tpu_torch.models.vlm import compute_vision_embeds
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    cfg, W, pcfg, params = qwen
    img = tile(3).resize(size)
    (pv, grid), = Processor(FakeTokenizer(pcfg.tokens), pcfg).preprocess_images([img])
    meta = vision_metadata([grid], pcfg.vision)
    d = {k: getattr(meta, k) for k in ("perm", "inv_perm_merged", "seg_window", "seg_full", "pos_ids")}
    port = compute_vision_embeds(params, pcfg, torch.as_tensor(pv), meta_to_device(d, "cpu"))
    patches, g = I.qwen_patches(img)
    assert tuple(g) == tuple(grid)
    ref = R.vision_forward(W, cfg, patches, g, R.Precision())
    assert ref.shape == port.shape
    assert float((ref - port.float()).abs().max()) < TOL


def test_qwen_decoder_logits(qwen):
    from zoomearth_tpu_torch.models.vlm import vlm_forward

    cfg, W, pcfg, params = qwen
    ids = list(np.random.default_rng(0).integers(32, 288, 40))
    pos = R.rope_index(ids, [], cfg["image_token_id"], 2)
    port, _ = vlm_forward(params, pcfg, torch.tensor([ids]), torch.as_tensor(pos)[:, None])
    ref = R.decoder_logits(W, cfg, R.embed(W, ids, [], cfg["image_token_id"]), pos, range(40), R.Precision())
    assert float((ref - port[0]).abs().max()) < TOL


def test_the_fp8_control_moves_the_logits(qwen):
    cfg, W, _, _ = qwen
    ids = list(range(40, 80))
    pos = R.rope_index(ids, [], cfg["image_token_id"], 2)
    x = R.embed(W, ids, [], cfg["image_token_id"])
    a = R.decoder_logits(W, cfg, x, pos, range(40), R.Precision("fp32"))
    b = R.decoder_logits(W, cfg, x, pos, range(40), R.Precision("fp8"))
    assert float((a - b).abs().max()) > 10 * TOL
