"""InternVL-style "anyres" dynamic tiling (the port's own copy of
zoomearth_tpu/image/anyres.py; numpy/PIL host code, held equal to it by
tests/test_torch_internvl.py).

Splits an arbitrary-resolution image into up to max_num fixed-size tiles matching the
closest aspect ratio (reference vlm_modules/internvl_module.py:280-341), optionally
appending a global thumbnail: the InternVL family's alternative to Qwen's smart-resize.
Pure geometry + numpy normalization; the InternViT tower is models/internvit.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    """Reference internvl_module.py:291-304 (ties broken by area threshold)."""
    best_ratio_diff = float("inf")
    best_ratio = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_ratio_diff:
            best_ratio_diff = diff
            best_ratio = ratio
        elif diff == best_ratio_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best_ratio = ratio
    return best_ratio


def dynamic_preprocess(
    image,
    min_num: int = 1,
    max_num: int = 12,
    image_size: int = 448,
    use_thumbnail: bool = False,
) -> List:
    """Tile a PIL image into blocks of (image_size x image_size) (reference :306-341)."""
    orig_width, orig_height = image.size
    aspect_ratio = orig_width / orig_height
    target_ratios = sorted(
        {
            (i, j)
            for n in range(min_num, max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if min_num <= i * j <= max_num
        },
        key=lambda x: x[0] * x[1],
    )
    ar = find_closest_aspect_ratio(aspect_ratio, target_ratios, orig_width, orig_height, image_size)
    target_width = image_size * ar[0]
    target_height = image_size * ar[1]
    blocks = ar[0] * ar[1]
    resized = image.resize((target_width, target_height))
    tiles = []
    cols = target_width // image_size
    for i in range(blocks):
        box = (
            (i % cols) * image_size,
            (i // cols) * image_size,
            ((i % cols) + 1) * image_size,
            ((i // cols) + 1) * image_size,
        )
        tiles.append(resized.crop(box))
    assert len(tiles) == blocks
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles


def normalize_imagenet(image) -> np.ndarray:
    """PIL tile -> float32 CHW with ImageNet normalization (build_transform semantics)."""
    arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(arr, (2, 0, 1))


def load_image_anyres(image, input_size: int = 448, max_num: int = 12, use_thumbnail: bool = True) -> np.ndarray:
    """Full InternVL pixel pipeline: tiles -> (n_tiles, 3, S, S) float32
    (reference _load_image, internvl_module.py:127-133)."""
    from PIL import Image

    tiles = dynamic_preprocess(image, max_num=max_num, image_size=input_size, use_thumbnail=use_thumbnail)
    resized = [t.resize((input_size, input_size), Image.BICUBIC) if t.size != (input_size, input_size) else t for t in tiles]
    return np.stack([normalize_imagenet(t) for t in resized])
