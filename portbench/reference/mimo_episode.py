"""The reference side of one two-stage ZoomEarth episode on MiMo-V2.5, worked out from
the benchmark's inputs (tile, question, bbox, the traffic file's prompt and sizes) and
judged against the program's served tokens: zoom_episode.py's sequences (ChatML's
markers, the Qwen2.5-VL tower's patches) with plain sequential positions, and the image
embeddings placed by the prompt's layout.

Stage 1: the tile shrunk to its longest side, the prompt with its image tokens, then
the served stage-1 tokens. Stage 2 continues the same sequence: the stage-1 tokens kept
(those whose text precedes any <answer>), the rest of that text, the crop around the
bbox as a second image, then the served stage-2 tokens. One causal pass over the whole
sequence gives the reference's logits at every served position (two passes where a
stage-1 token was not kept).

Routing (reference/mimo_v2.py's `Routing`): each pass can be told the choices another
computation made at each routed layer for the same tokens, which the fp32 reference
takes where they lie within the margin of its own k-th best score.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import image as I
from . import mimo_v2 as R
from . import text as T

SPECIAL_STRINGS = {"image_pad": "<|image_pad|>", "video_pad": "<|video_pad|>", "vision_start": "<|vision_start|>",
                   "vision_end": "<|vision_end|>", "im_start": "<|im_start|>", "im_end": "<|im_end|>",
                   "endoftext": "<|endoftext|>"}


def specials(cfg: dict):
    return {s: int(cfg["special_token_ids"][k]) for k, s in SPECIAL_STRINGS.items()}


def sequences(cfg: dict, traffic: dict, tile, question: str, bbox, out1: List[int], out2: List[int],
              pixels: bool = True):
    """(stage-1 ids, stage-2 ids before its served tokens, the two images as (patches,
    grid), kept count, the two images' first token indices). pixels=False works out the
    grids from the sizes alone and gives no patches."""
    tok = T.ByteTokenizer(specials(cfg))
    v = cfg["vision_config"]
    merge = v["spatial_merge_size"]
    pad = cfg["special_token_ids"]["image_pad"]
    factor = v["patch_size"] * merge

    def expand(ids, grid):
        n = grid[1] * grid[2] // (merge * merge)
        i = ids.index(pad)
        return ids[:i] + [pad] * n + ids[i + 1:], i

    def prepared(img, size):
        if pixels:
            return I.qwen_patches(img, v["patch_size"], v["temporal_patch_size"], merge)
        hb, wb = I.qwen_grid_size(size[1], size[0], factor)
        return None, (1, hb // v["patch_size"], wb // v["patch_size"])

    w, h = tile.size
    small = I.cap_longest_side(tile, traffic["stage1_max_size"]) if pixels else None
    p1, g1 = prepared(small, I.capped_size(w, h, traffic["stage1_max_size"]))
    ids1, start1 = expand(tok.encode(T.ZOOM_PREFIX + question + traffic["instruction"]), g1)
    pre = tok.decode(out1, skip_special_tokens=False).split("<answer>")[0]
    kept, residual = T.kept_tokens(tok, out1, pre)
    box = I.crop_box(bbox, w, h, traffic["crop_min_size"])
    crop = I.cap_longest_side(tile.crop(box), traffic["crop_max_size"]) if pixels else None
    p2, g2 = prepared(crop, I.capped_size(box[2] - box[0], box[3] - box[1], traffic["crop_max_size"]))
    text = tok.encode(residual) if residual else []
    image, at = expand(tok.encode(T.VISION_TOKENS), g2)
    chunk = text + image
    start2 = len(ids1) + len(kept) + len(text) + at
    return ids1, ids1 + list(kept) + chunk, [(p1, g1), (p2, g2)], len(kept), [start1, start2]


def flops(cfg, traffic, tile, question, bbox, out1, out2) -> int:
    """Model FLOPs of the live work of one episode (portbench/work/mimo_v2.py)."""
    from ..work import mimo_v2 as F

    ids1, ids2, images, kept, _ = sequences(cfg, traffic, tile, question, bbox, out1, out2, pixels=False)
    chunk = len(ids2) - len(ids1) - kept
    return F.eval_question(cfg, len(ids1), len(out1), kept, chunk, len(out2), images[0][1], images[1][1])


class Pass:
    """One causal pass the check makes: the sequence, its images' embeddings and first
    token indices, and the rows whose logits it keeps."""

    def __init__(self, ids: Sequence[int], embeds: List[torch.Tensor], starts: Sequence[int], rows: Sequence[int]):
        self.ids, self.embeds, self.starts, self.rows = list(ids), embeds, list(starts), list(rows)


def passes(W, cfg, traffic, tile, question, bbox, out1, out2, prec: R.Precision) -> List[Pass]:
    """The passes of one episode's check (one, or two where a stage-1 token was not
    kept), with the images' embeddings in `prec`."""
    ids1, ids2, images, kept, starts = sequences(cfg, traffic, tile, question, bbox, out1, out2)
    embeds = [R.vision_forward(W, cfg, p, g, prec) for p, g in images]
    rows1 = list(range(len(ids1) - 1, len(ids1) - 1 + len(out1)))
    rows2 = list(range(len(ids2) - 1, len(ids2) - 1 + len(out2)))
    full = ids2 + list(out2)
    if kept == len(out1):
        return [Pass(full, embeds, starts, rows1 + rows2)]
    return [Pass(ids1 + list(out1), embeds[:1], starts[:1], rows1), Pass(full, embeds, starts, rows2)]


def run(W, cfg, ps: List[Pass], prec: R.Precision, routings: List[R.Routing]):
    """The passes' logits at their rows, concatenated (stage 1's rows, then stage 2's)."""
    with torch.no_grad():
        return torch.cat([R.decoder_logits(W, cfg, R.embed(W, p.ids, p.embeds, p.starts), p.rows, prec, r)
                          for p, r in zip(ps, routings)])


def gaps(W, cfg, traffic, tile, question, bbox, out1, out2, program_routing: Callable, margin: float,
         control: Optional[str] = None):
    """(each served token's gap below the fp32 reference's best, the routing record of the
    reference's passes, and with a control: the gap of the token the control's precision
    puts first at each position, judged by the fp32 reference that follows the control's
    routing, with that routing record). program_routing(pass) -> the program's choices at
    each routed layer of that pass (the driver's teacher-forced program pass)."""
    R.set_fp32()
    fp32 = R.Precision("fp32")
    ps = passes(W, cfg, traffic, tile, question, bbox, out1, out2, fp32)
    routings = [R.Routing(program_routing(p), margin) for p in ps]
    ref = run(W, cfg, ps, fp32, routings)
    served = list(out1) + list(out2)
    g = _gaps(ref, served)
    if control is None:
        return g, routings, None, None
    low = R.Precision(control)
    lps = passes(W, cfg, traffic, tile, question, bbox, out1, out2, low)
    own = [R.Routing() for _ in lps]
    picks = run(W, cfg, lps, low, own).argmax(-1).tolist()
    followed = [R.Routing(r.chosen, margin) for r in own]
    ref_c = run(W, cfg, ps, fp32, followed)
    return g, routings, _gaps(ref_c, picks), followed


def _gaps(ref: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    if len(tokens) == 0:
        return np.zeros(0)
    return R.logit_gaps(ref, tokens).cpu().numpy()
