"""Image preparation as the reference works it out: PIL resizes and crops, and the
Qwen2-VL image processor's arithmetic in numpy (their published
defaults), from the raw tile the benchmark made.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def capped_size(w: int, h: int, max_size: int) -> Tuple[int, int]:
    """(w, h) after ZoomEarth's resize_image: shrunk so the longest side is max_size."""
    scale = max_size / max(w, h)
    return (int(w * scale), int(h * scale)) if scale < 1 else (w, h)


def cap_longest_side(image, max_size: int):
    """ZoomEarth's resize_image: shrink (bicubic) so the longest side is max_size."""
    from PIL import Image

    size = capped_size(*image.size, max_size)
    return image.resize(size, Image.BICUBIC) if size != image.size else image


def crop_box(bbox, img_w: int, img_h: int, min_size: int = 512) -> Tuple[int, int, int, int]:
    """ZoomEarth's cut_image window: a box smaller than min_size on a side becomes the
    min_size square centred on it, moved inside the image."""
    x1, y1, x2, y2 = (int(v) for v in bbox)
    if x2 - x1 >= min_size and y2 - y1 >= min_size:
        return x1, y1, x2, y2
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    nx1, ny1 = cx - min_size // 2, cy - min_size // 2
    nx2, ny2 = nx1 + min_size, ny1 + min_size
    if nx1 < 0:
        nx2, nx1 = nx2 - nx1, 0
    if ny1 < 0:
        ny2, ny1 = ny2 - ny1, 0
    if nx2 > img_w:
        nx1, nx2 = nx1 - (nx2 - img_w), img_w
    if ny2 > img_h:
        ny1, ny2 = ny1 - (ny2 - img_h), img_h
    nx1, ny1 = max(0, nx1), max(0, ny1)
    return nx1, ny1, min(img_w, nx1 + min_size), min(img_h, ny1 + min_size)


def qwen_grid_size(h: int, w: int, factor: int = 28, min_pixels: int = 56 * 56,
                   max_pixels: int = 28 * 28 * 128 * 128) -> Tuple[int, int]:
    """The Qwen2-VL processor's smart resize: sides rounded to the factor, the area
    kept within [min_pixels, max_pixels]."""
    hb, wb = round(h / factor) * factor, round(w / factor) * factor
    if hb * wb > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        hb, wb = math.floor(h / beta / factor) * factor, math.floor(w / beta / factor) * factor
    elif hb * wb < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        hb, wb = math.ceil(h * beta / factor) * factor, math.ceil(w * beta / factor) * factor
    return hb, wb


def qwen_patches(image, patch: int = 14, temporal: int = 2, merge: int = 2, min_pixels: int = 56 * 56,
                 max_pixels: int = 28 * 28 * 128 * 128) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(patches (N, 3 * temporal * patch^2) float32, grid (1, gh, gw)): the image resized
    to its grid, CLIP-normalized, repeated over the temporal patch, and cut into
    patches in the order (row of merge blocks, column of merge blocks, row in block,
    column in block), each flattened as (channel, time, y, x)."""
    from PIL import Image

    arr = np.asarray(image.convert("RGB"))
    h, w = arr.shape[:2]
    hb, wb = qwen_grid_size(h, w, patch * merge, min_pixels, max_pixels)
    if (hb, wb) != (h, w):
        arr = np.asarray(Image.fromarray(arr).resize((wb, hb), Image.BICUBIC))
    x = (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD  # (H, W, C)
    gh, gw = hb // patch, wb // patch
    x = x.reshape(gh // merge, merge, patch, gw // merge, merge, patch, 3)
    x = x.transpose(0, 3, 1, 4, 6, 2, 5)  # (bh, bw, mh, mw, C, py, px)
    x = np.repeat(x[..., None, :, :], temporal, axis=-3)  # (..., C, T, py, px)
    return np.ascontiguousarray(x.reshape(gh * gw, 3 * temporal * patch * patch)), (1, gh, gw)

