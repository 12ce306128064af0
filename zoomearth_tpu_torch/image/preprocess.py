"""Dynamic-resolution image preprocessing: smart-resize → normalize → patchify.

Produces the (num_patches, patch_dim) `pixel_values` + (t, h, w) `grid_thw` layout the
ViT consumes — same contract as the reference's HF Qwen2VLImageProcessor (used via the
custom processor, open_r1/model/processing_qwen2_vl.py:93-171), validated by a parity
test against transformers' implementation.

The hot path (normalize + patch rearrange) is pure numpy on host for the loader thread;
`patchify_jnp` is the on-device fused variant for preprocessing overlapped with decode.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# CLIP normalization constants (Qwen2-VL image processor defaults).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

# Default pixel budgets (HF Qwen2VLImageProcessor): min 56*56, max 28*28*1280*4/... the
# released default max_pixels is 12845056 = 3584*3584 (grpo_jsonl.py:91-98 keeps it).
DEFAULT_MIN_PIXELS = 56 * 56
DEFAULT_MAX_PIXELS = 28 * 28 * 128 * 128


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Round (height, width) to multiples of `factor` within the pixel budget,
    preserving aspect ratio. Same algorithm as HF qwen2_vl image processing."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(
            f"absolute aspect ratio must be smaller than 200, got {max(height, width) / min(height, width)}"
        )
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW normalized."""
    x = image.astype(np.float32) / 255.0
    x = (x - IMAGE_MEAN) / IMAGE_STD
    return np.transpose(x, (2, 0, 1))


def patchify(
    image_chw: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Rearrange a normalized CHW image into flattened conv3d patches.

    Layout matches HF Qwen2VLImageProcessor._preprocess: a single image is repeated
    along the temporal axis to fill temporal_patch_size, then patches are emitted in
    (t, h_block, w_block, h_in_block, w_in_block) order, each flattened to
    C*temporal_patch_size*patch_size^2. This turns the reference's conv3d
    patch embed (modeling_qwen2_vl.py:224-248) into a plain matmul.
    """
    c, h, w = image_chw.shape
    grid_t = 1
    grid_h, grid_w = h // patch_size, w // patch_size
    patches = np.tile(image_chw[None], (temporal_patch_size, 1, 1, 1))  # (T, C, H, W)
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        c,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size * patch_size
    )
    return flat, (grid_t, grid_h, grid_w)


def resize_bicubic(image: "np.ndarray", size_hw: Tuple[int, int]) -> np.ndarray:
    """BICUBIC resize via PIL (matches the reference preprocessing exactly)."""
    from PIL import Image

    pil = Image.fromarray(image)
    pil = pil.resize((size_hw[1], size_hw[0]), Image.BICUBIC)
    return np.asarray(pil)


def preprocess_image(
    image,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """PIL image (or HWC uint8 array) -> (pixel_values, grid_thw).

    pixel_values: (grid_t*grid_h*grid_w, C*temporal_patch_size*patch_size^2) float32.
    """
    arr = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
    h, w = arr.shape[:2]
    factor = patch_size * merge_size
    h_bar, w_bar = smart_resize(h, w, factor, min_pixels, max_pixels)
    if (h_bar, w_bar) != (h, w):
        arr = resize_bicubic(arr, (h_bar, w_bar))
    chw = normalize(arr)
    return patchify(chw, patch_size, temporal_patch_size, merge_size)


def preprocess_image_fast(
    image,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Fast preprocessing path: same contract AND same pixels as preprocess_image.

    Resize stays on PIL (its SIMD fixed-point bicubic beats our scalar C++ ~3x and is
    byte-identical to the reference); normalize+patchify runs in the native fused C++
    kernel (~8x faster than the numpy pipeline, float-exact). Falls back fully to the
    numpy path when the native library is unavailable."""
    from .. import native

    if not native.available():
        return preprocess_image(
            image, patch_size, temporal_patch_size, merge_size, min_pixels, max_pixels
        )
    arr = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
    h, w = arr.shape[:2]
    factor = patch_size * merge_size
    h_bar, w_bar = smart_resize(h, w, factor, min_pixels, max_pixels)
    if (h_bar, w_bar) != (h, w):
        arr = resize_bicubic(arr, (h_bar, w_bar))
    flat = native.normalize_patchify(
        np.ascontiguousarray(arr), IMAGE_MEAN, IMAGE_STD,
        patch_size, temporal_patch_size, merge_size,
    )
    return flat, (1, h_bar // patch_size, w_bar // patch_size)


def preprocess_image_u8(
    image,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    compact: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Raw-byte preprocessing path: resize + patchify only, NO host normalization.

    Returns uint8 (num_patches, patch_dim) — 4x fewer bytes over the host->device
    link than the float32 paths. The ViT normalizes on device (vit_forward detects
    the uint8 dtype), with the numpy op order exactly, so end results are identical
    to preprocess_image.

    compact=True: emit SINGLE-FRAME patches (patch_dim / temporal_patch_size bytes —
    another 2x off the link). A still image's temporal copies are byte-identical
    (HF repeats the frame to fill the conv3d temporal axis), so
    x_dup @ K == x_compact @ (sum over temporal kernel slices); vit_forward folds
    the patch-embed kernel on device when it sees the narrow width. Same pixels,
    same math up to bf16 accumulation order; only for still images (grid_t == 1)."""
    from .. import native

    arr = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
    h, w = arr.shape[:2]
    factor = patch_size * merge_size
    h_bar, w_bar = smart_resize(h, w, factor, min_pixels, max_pixels)
    if (h_bar, w_bar) != (h, w):
        arr = resize_bicubic(arr, (h_bar, w_bar))
    grid = (1, h_bar // patch_size, w_bar // patch_size)
    t_emit = 1 if compact else temporal_patch_size
    if native.available():
        return native.patchify_u8(
            np.ascontiguousarray(arr), patch_size, t_emit, merge_size
        ), grid
    # numpy fallback: same rearrange as patchify() but on raw bytes
    chw = np.transpose(arr, (2, 0, 1))
    flat, grid2 = patchify(chw, patch_size, t_emit, merge_size)
    assert grid2 == grid
    return flat.astype(np.uint8), grid


def preprocess_images(images: Sequence, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Batch of images -> concatenated pixel_values (N_total, D) + grid_thw (n, 3)."""
    pvs, grids = [], []
    for img in images:
        pv, g = preprocess_image(img, **kw)
        pvs.append(pv)
        grids.append(g)
    return np.concatenate(pvs, axis=0), np.asarray(grids, dtype=np.int64)


def num_vision_tokens(grid_thw: Sequence[int], merge_size: int = 2) -> int:
    """Number of LLM-side image tokens for one image grid (after 2x2 merge)."""
    t, h, w = grid_thw
    return (t * h * w) // (merge_size * merge_size)
