"""The reference side of one two-stage ZoomEarth episode on Kimi-VL, worked out from
the benchmark's inputs (tile, question, bbox, the traffic file's prompt and sizes) and
judged against the program's served tokens: zoom_episode.py's sequences with Kimi-VL's
chat markers, MoonViT's patches and plain sequential positions.

Stage 1: the tile shrunk to its longest side, the prompt with its image tokens, then
the served stage-1 tokens. Stage 2 continues the same sequence: the stage-1 tokens
kept (those whose text precedes any <answer>), the rest of that text, the crop around
the bbox as a second image, then the served stage-2 tokens. One causal pass over the
whole sequence gives the reference's logits at every served position (two passes
where a stage-1 token was not kept).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import image as I
from . import kimi_vl as R
from . import text as T


def sequences(cfg: dict, traffic: dict, tile, question: str, bbox, out1: List[int], out2: List[int],
              pixels: bool = True):
    """(stage-1 ids, stage-2 ids before its served tokens, the two images as (patches,
    grid), kept count). pixels=False works out the grids from the sizes alone and
    gives no patches."""
    tok = T.ByteTokenizer(R.specials(cfg))
    v = cfg["vision_config"]
    pad = cfg["special_token_ids"]["media_pad"]
    factor = v["patch_size"] * v["merge_kernel_size"][0]

    def expand(ids, grid):
        n = grid[1] * grid[2] // 4
        i = ids.index(pad)
        return ids[:i] + [pad] * n + ids[i + 1:]

    def prepared(img, size):
        if pixels:
            return R.patches(img, v["patch_size"], factor)
        hb, wb = I.qwen_grid_size(size[1], size[0], factor)
        return None, (1, hb // v["patch_size"], wb // v["patch_size"])

    w, h = tile.size
    small = I.cap_longest_side(tile, traffic["stage1_max_size"]) if pixels else None
    p1, g1 = prepared(small, I.capped_size(w, h, traffic["stage1_max_size"]))
    ids1 = expand(tok.encode(R.PREFIX + question + traffic["instruction"]), g1)
    pre = tok.decode(out1, skip_special_tokens=False).split("<answer>")[0]
    kept, residual = T.kept_tokens(tok, out1, pre)
    box = I.crop_box(bbox, w, h, traffic["crop_min_size"])
    crop = I.cap_longest_side(tile.crop(box), traffic["crop_max_size"]) if pixels else None
    p2, g2 = prepared(crop, I.capped_size(box[2] - box[0], box[3] - box[1], traffic["crop_max_size"]))
    chunk = (tok.encode(residual) if residual else []) + expand(tok.encode(R.VISION_TOKENS), g2)
    return ids1, ids1 + list(kept) + chunk, [(p1, g1), (p2, g2)], len(kept)


def flops(cfg, traffic, tile, question, bbox, out1, out2) -> int:
    """Model FLOPs of the live work of one episode (portbench/work/kimi_vl.py)."""
    from ..work import kimi_vl as F

    ids1, ids2, images, kept = sequences(cfg, traffic, tile, question, bbox, out1, out2, pixels=False)
    chunk = len(ids2) - len(ids1) - kept
    return F.eval_question(cfg, len(ids1), len(out1), kept, chunk, len(out2), images[0][1], images[1][1])


def _pass(W, cfg, ids, images, rows, prec):
    embeds = [R.vision_forward(W, cfg, p, g, prec) for p, g in images]
    x = R.embed(W, ids, embeds, cfg["special_token_ids"]["media_pad"])
    return R.decoder_logits(W, cfg, x, rows, prec)


@torch.no_grad()
def logits(W, cfg, traffic, tile, question, bbox, out1, out2, prec: R.Precision):
    """(reference logits at the served stage-1 positions, at the stage-2 positions)."""
    ids1, ids2, images, kept = sequences(cfg, traffic, tile, question, bbox, out1, out2)
    rows1 = list(range(len(ids1) - 1, len(ids1) - 1 + len(out1)))
    rows2 = list(range(len(ids2) - 1, len(ids2) - 1 + len(out2)))
    full = ids2 + list(out2)
    if kept == len(out1):
        both = _pass(W, cfg, full, images, rows1 + rows2, prec)
        return both[:len(rows1)], both[len(rows1):]
    l1 = _pass(W, cfg, ids1 + list(out1), images[:1], rows1, prec)
    return l1, _pass(W, cfg, full, images, rows2, prec)


def gaps(W, cfg, traffic, tile, question, bbox, out1, out2, control: Optional[str] = None):
    """(each served token's gap below the fp32 reference's best, and with a control:
    the gap of the token the control's precision puts first at each position), as
    numpy arrays over both stages."""
    R.set_fp32()
    ref1, ref2 = logits(W, cfg, traffic, tile, question, bbox, out1, out2, R.Precision("fp32"))
    g = np.concatenate([_gaps(ref1, out1), _gaps(ref2, out2)])
    c = None
    if control is not None:
        low1, low2 = logits(W, cfg, traffic, tile, question, bbox, out1, out2, R.Precision(control))
        c = np.concatenate([_gaps(ref1, low1.argmax(-1).tolist()), _gaps(ref2, low2.argmax(-1).tolist())])
    return g, c


def _gaps(ref: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    if len(tokens) == 0:
        return np.zeros(0)
    return R.logit_gaps(ref, tokens).cpu().numpy()
