"""The frozen yardstick: each kernel's work() copy and the model-FLOP counts against
counts made by hand at two shapes."""

from __future__ import annotations

import json

import torch

from portbench.work import attention as W
from portbench.work import model_flops as F

from .helpers import DATA


def test_segment_work_by_hand():
    # segments of 3 and 2 rows: 4 D H (9 + 4) flops; q, k, v, out once each
    assert W.segment_work(torch.tensor([0, 0, 0, 1, 1]), 2, 4, 2) == (4 * 4 * 2 * 13, 4 * 5 * 2 * 4 * 2)
    assert W.segment_work(torch.tensor([0] * 8), 16, 80, 2) == (4 * 80 * 16 * 64, 4 * 8 * 16 * 80 * 2)
    # backward: five products a live pair, q k v o dO read and dq dk dv written, lse read
    assert W.segment_work_bwd(torch.tensor([0, 0, 1]), 2, 4, 2) == (10 * 4 * 2 * 5, 8 * 3 * 2 * 4 * 2 + 4 * 3 * 2)


def test_causal_work_by_hand():
    # one row, queries at 0, 1, 2 over 3 live keys: 1 + 2 + 3 pairs; 3 k/v rows read
    assert W.causal_work(torch.tensor([[0, 1, 2]]), torch.tensor([3]), 2, 1, 4, 4, 2) == \
        (4 * 4 * 2 * 6, 2 * 3 * 2 * 4 * 2 + 2 * 3 * 1 * 4 * 2)
    # a chunk at positions 5, 6 over a cache of 7: 6 + 7 pairs; int8 keys with fp32 scales
    assert W.causal_work(torch.tensor([[5, 6]]), torch.tensor([7]), 4, 2, 8, 16, 2, 1) == \
        (4 * 8 * 4 * 13, 2 * 2 * 4 * 8 * 2 + 2 * 7 * 2 * 8 * 1 + 2 * 7 * 2 * 4)
    assert W.causal_work_bwd(torch.tensor([[0, 1]]), torch.tensor([2]), 2, 1, 4, 4, 2) == \
        (10 * 4 * 2 * 3, 4 * 4 * 4 * 2 + 4 * 4 + 4 * 2 * 1 * 4 * 2)


def test_decode_work_by_hand():
    # rows of 3 and 5 live slots, the second clipped to T = 4: 7 slots read
    assert W.decode_work(torch.tensor([3, 5]), 4, 2, 1, 4, 2) == (4 * 4 * 2 * 7, 7 * 1 * 4 * 2 * 2 + 2 * 2 * 2 * 4 * 2)
    # two steps stacked: 2 + 3 slots, int8 cache with fp32 scales
    assert W.decode_work(torch.tensor([2, 3]), 8, 16, 2, 128, 1) == \
        (4 * 128 * 16 * 5, 5 * 2 * 128 * 2 + 2 * 2 * 16 * 128 * 2 + 2 * 5 * 2 * 4)


def test_model_flops_by_hand():
    cfg = json.loads((DATA / "qwen2_5_vl_tiny.json").read_text())
    # per layer: q and o 64 x 64, k and v 64 x 32, three MLP products 64 x 128 = 36864 weights
    assert F.decoder_pass(cfg, 3, 2, 1) == 2 * 36864 * 2 * 3 + 4 * 16 * 4 * 2 * (3 * 2 + 6) + 2 * 64 * 512
    assert F.decode_steps(cfg, 2, 5) == 2 * 36864 * 2 * 2 + 4 * 16 * 4 * 2 * (6 + 7) + 2 * 64 * 512 * 2
    # ViT over a 4 x 4 patch grid: one window of 16 patches, one full block, 3 windowed
    patch_embed = 2 * 16 * 1176 * 32
    blocks = 2 * 16 * 4 * (4 * 32 * 32 + 3 * 32 * 64)
    attn = 4 * 8 * 4 * (16 * 16 * 4)
    merger = 2 * 4 * (128 * 128 + 128 * 64)
    assert F.qwen_vit(cfg, (1, 4, 4)) == patch_embed + blocks + attn + merger
    # an 8 x 4 grid: two windows of 16 patches, the full block sees 32
    assert F.qwen_vit(cfg, (1, 8, 4)) == 2 * patch_embed + 2 * blocks + 4 * 8 * 4 * (32 * 32 + 3 * 2 * 256) + 2 * merger

