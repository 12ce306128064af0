"""Image/bbox geometry for the active-perception loop.

ONE implementation of the crop/resize/bbox-parse helpers that the reference duplicates
five times (cut_image: demo.py:30-70, infer.py:41-76, infer_vllm.py:71-106, SFT.py:83-125,
customized_funcs.py:37-74; resize_image: demo.py:86, infer.py:78, customized_funcs.py:76).
Exact reference semantics are preserved because eval parity and the region-IoU reward
depend on them (e.g. the IoU reward compares *crop windows*, not raw boxes).

Box math is pure (tuple-in/tuple-out) so it can be unit-tested and reused by the jnp
reward path; PIL-touching wrappers live at the bottom.
"""

from __future__ import annotations

import json
import re
from typing import Optional, Sequence, Tuple

from ..utils.profiling import tracer

Box = Tuple[int, int, int, int]


def crop_window(bbox: Sequence[float], img_w: int, img_h: int, min_size: int = 512) -> Box:
    """The crop window `cut_image` would extract for `bbox` on an (img_w, img_h) image.

    Reference: src/demo.py:30-70. Boxes smaller than min_size on either side are expanded
    to a min_size square centred on the box (shifted to stay inside the image); larger
    boxes are cropped as-is. PIL-crop semantics: out-of-bounds coords are NOT clamped in
    the large-box branch (PIL pads), we clamp only where the reference does.
    """
    x1, y1, x2, y2 = (int(v) for v in bbox)
    width, height = x2 - x1, y2 - y1
    if width < min_size or height < min_size:
        center_x = (x1 + x2) // 2
        center_y = (y1 + y2) // 2
        new_x1 = center_x - min_size // 2
        new_y1 = center_y - min_size // 2
        new_x2 = new_x1 + min_size
        new_y2 = new_y1 + min_size
        if new_x1 < 0:
            new_x2 += -new_x1
            new_x1 = 0
        if new_y1 < 0:
            new_y2 += -new_y1
            new_y1 = 0
        if new_x2 > img_w:
            new_x1 -= new_x2 - img_w
            new_x2 = img_w
        if new_y2 > img_h:
            new_y1 -= new_y2 - img_h
            new_y2 = img_h
        new_x1 = max(0, new_x1)
        new_y1 = max(0, new_y1)
        new_x2 = min(img_w, new_x1 + min_size)
        new_y2 = min(img_h, new_y1 + min_size)
        return (int(new_x1), int(new_y1), int(new_x2), int(new_y2))
    return (x1, y1, x2, y2)


def resize_scale(w: int, h: int, max_size: int, min_side: Optional[int] = None) -> float:
    """Scale factor applied by `resize_image`.

    Reference: demo.py:86-93 (no floor), customized_funcs.py:76-85 (min-side floor of 30px).
    Returns the multiplicative factor f; the resized size is (int(w*f), int(h*f)) if f < 1,
    else unchanged.
    """
    scale = max_size / max(w, h)
    if min_side is not None:
        scale = max(min_side / min(w, h), scale)
    return scale


def resized_size(w: int, h: int, max_size: int, min_side: Optional[int] = None) -> Tuple[int, int]:
    scale = resize_scale(w, h, max_size, min_side)
    if scale < 1:
        return int(w * scale), int(h * scale)
    return w, h


_BBOX_RE = re.compile(r'"bbox_2d"\s*:\s*\[(.*?)\]', re.DOTALL)
_ANSWER_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.DOTALL)
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def extract_bboxes(text: str, scale: float = 1.0) -> list:
    """All `"bbox_2d": [x1,y1,x2,y2]` boxes in `text`, scaled by `scale`.

    Reference: demo.py:72-84 (int parse; non-int coords are skipped).
    """
    bboxes = []
    for m in _BBOX_RE.findall(text):
        try:
            nums = [int(x.strip()) for x in m.split(",")]
        except ValueError:
            continue
        bboxes.append([n * scale for n in nums])
    return bboxes


def extract_bbox(text: str, scale: float = 1.0) -> Optional[list]:
    """First bbox in `text` or None (the agent loop uses only the first: demo.py:137-140)."""
    boxes = extract_bboxes(text, scale)
    return boxes[0] if boxes else None


def extract_answer(text: str) -> Optional[str]:
    """Contents of the first <answer>...</answer> tag (infer.py:34-39)."""
    m = _ANSWER_RE.search(text)
    return m.group(1) if m else None


def extract_think(text: str) -> Optional[str]:
    m = _THINK_RE.search(text)
    return m.group(1) if m else None


def parse_bbox_json(text: str) -> Optional[list]:
    """Robust bbox parse: try strict JSON object first, fall back to regex."""
    for candidate in re.findall(r"\{[^{}]*\}", text):
        try:
            obj = json.loads(candidate)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "bbox_2d" in obj:
            box = obj["bbox_2d"]
            if isinstance(box, list) and len(box) == 4:
                return box
    return extract_bbox(text)


def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """Plain IoU of two xyxy boxes (customized_funcs.py:164-183)."""
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    area_a = max(0.0, ax2 - ax1) * max(0.0, ay2 - ay1)
    area_b = max(0.0, bx2 - bx1) * max(0.0, by2 - by1)
    union = area_a + area_b - inter
    if union <= 0:
        return 0.0
    return inter / union


def center_distance(a: Sequence[float], b: Sequence[float]) -> float:
    ax = (a[0] + a[2]) / 2.0
    ay = (a[1] + a[3]) / 2.0
    bx = (b[0] + b[2]) / 2.0
    by = (b[1] + b[3]) / 2.0
    return ((ax - bx) ** 2 + (ay - by) ** 2) ** 0.5


# ---------------------------------------------------------------------------
# PIL wrappers (host-side; the device path never sees PIL)
# ---------------------------------------------------------------------------

def cut_image(image, bbox: Sequence[float], min_size: int = 512):
    """Crop `image` to the (possibly expanded) window around bbox. Reference demo.py:30-70."""
    with tracer.span("image.crop"):
        return image.crop(crop_window(bbox, image.width, image.height, min_size))


def resize_image(image, max_size: int = 1024, min_side: Optional[int] = None):
    """Cap the longest side at max_size (BICUBIC). Reference demo.py:86-93. A resample is
    traced as `image.resize` and counts its source pixels in `image.resize_src_px`."""
    from PIL import Image

    w, h = image.size
    scale = resize_scale(w, h, max_size, min_side)
    if scale < 1:
        with tracer.span("image.resize"):
            image = image.resize((int(w * scale), int(h * scale)), Image.BICUBIC)
        tracer.count("image.resize_src_px", w * h)
    return image


def resize_image_with_scale(image, max_size: int = 512):
    """Resize + return the bbox back-projection factor 1/scale.

    Reference infer.py:78-85 returns 1/scale even when no resize happened (scale >= 1);
    we keep that behavior for eval parity — it only triggers on images already smaller
    than max_size.
    """
    from PIL import Image

    w, h = image.size
    scale = max_size / max(w, h)
    if scale < 1:
        image = image.resize((int(w * scale), int(h * scale)), Image.BICUBIC)
    return image, 1.0 / scale
