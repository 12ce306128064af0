"""The port's own copy of zoomearth_tpu/rewards/zoomearth.py (host code, held equal to it by
tests/test_torch_host.py).

The ZoomEarth "Region-Guided" reward set: format / bbox(IoU+distance) / answer.

Exact reference semantics (customized_funcs.py): reward callables take parallel lists
of stage-1/stage-2 completions plus dataset columns in kwargs and return list[float]
(the VLMGRPOTrainer contract, grpo_trainer.py:692-717). DEBUG_MODE/LOG_PATH debug logs
are kept — the reference uses them as its de-facto regression harness (SURVEY.md §4).
"""

from __future__ import annotations

import math
import os
import re
from datetime import datetime
from typing import List, Optional, Sequence

from ..image.geometry import extract_bboxes as _extract_bbox_strings  # int-parse variant
from .wordnet_compat import correctness


def extract_bboxes_float(completion: str) -> List[List[float]]:
    """Reference customized_funcs.py:21-32 — float parse (the demo/eval variant parses
    ints; the reward variant floats)."""
    pattern = r'"bbox_2d"\s*:\s*\[(.*?)\]'
    out = []
    for m in re.findall(pattern, completion, re.DOTALL):
        try:
            out.append([float(x.strip()) for x in m.split(",")])
        except ValueError:
            continue
    return out


def extract_tag(text: str, tag: str, default=None):
    safe = re.escape(tag)
    m = re.compile(rf"<{safe}\s*>\s*(.*?)\s*</{safe}\s*>", re.S).search(text or "")
    return m.group(1).strip() if m else default


def _tanh(x: float) -> float:
    return 2.0 / (1.0 + math.exp(-2.0 * x)) - 1.0


def _fix_order(box):
    x1, y1, x2, y2 = box
    return [min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)]


def get_crop_area(bbox, min_size: int = 512):
    """Expand a small box to the min_size crop window WITHOUT right/bottom image
    clamping (customized_funcs.py:144-162 — distinct from cut_image's clamped window;
    the reward compares crop areas in unbounded coordinates).

    Order matters near the top/left edges: x2/y2 are computed from the UNCLAMPED
    origin and only then is x1/y1 clamped to 0 — so a box centered < min_size/2 from
    an edge yields a window ending at center + min_size/2, not clamped_x1 + min_size
    (customized_funcs.py:150-160)."""
    x1, y1, x2, y2 = map(int, bbox)
    width, height = x2 - x1, y2 - y1
    if width < min_size or height < min_size:
        center_x = (x1 + x2) // 2
        center_y = (y1 + y2) // 2
        new_x1 = center_x - min_size // 2
        new_y1 = center_y - min_size // 2
        new_x2 = new_x1 + min_size
        new_y2 = new_y1 + min_size
        return [int(max(0, new_x1)), int(max(0, new_y1)), int(new_x2), int(new_y2)]
    return bbox


def crop_iou(box_a, box_b) -> float:
    """IoU of the two crop areas (customized_funcs.py:164-183)."""
    if len(box_b) != 4 or len(box_a) != 4:
        return 0
    x1a, y1a, x2a, y2a = _fix_order(get_crop_area(box_a))
    x1b, y1b, x2b, y2b = _fix_order(get_crop_area(box_b))
    iw = max(0.0, min(x2a, x2b) - max(x1a, x1b))
    ih = max(0.0, min(y2a, y2b) - max(y1a, y1b))
    inter = iw * ih
    area_a = max(0.0, x2a - x1a) * max(0.0, y2a - y1a)
    area_b = max(0.0, x2b - x1b) * max(0.0, y2b - y1b)
    union = area_a + area_b - inter
    return 0.0 if union == 0 else inter / union


def _debug_log(name: str, lines: Sequence[str]):
    if os.getenv("DEBUG_MODE") == "true":
        log_path = os.getenv("LOG_PATH", "debug")
        stamp = datetime.now().strftime("%d-%H-%M-%S-%f")
        with open(f"{log_path}_{name}.txt", "a", encoding="utf-8") as f:
            f.write(f"------------- {stamp} {lines[0]} -------------\n")
            for line in lines[1:]:
                f.write(line + "\n")


def format_reward(completion1: Sequence[str], completion2: Sequence[str], **kwargs) -> List[float]:
    """Stage-aware tag check (customized_funcs.py:229-262): cut episodes need <think> in
    both stages + bbox in stage 1 + <answer> in stage 2; uncut need <think>+<answer> in
    stage 1."""
    rewards = []
    for i, (c1, c2) in enumerate(zip(completion1, completion2)):
        cut = c2 != ""
        if cut:
            ok = (
                extract_tag(c1, "think")
                and extract_tag(c2, "think")
                and extract_tag(c2, "answer")
                and extract_bboxes_float(c1) != []
            )
        else:
            ok = extract_tag(c1, "think") and extract_tag(c1, "answer")
        r = 1.0 if ok else 0.0
        _debug_log("format", [f"format reward: {r}",
                              f"problem: {kwargs.get('question', [None]*len(completion1))[i]}",
                              f"Completion1: {c1}", f"Completion2: {c2}"])
        rewards.append(r)
    return rewards


def bbox_reward(completion1: Sequence[str], completion2: Sequence[str] = (), **kwargs) -> List[float]:
    """Region-Guided localization reward (customized_funcs.py:265-321):
    IoU of crop areas + tanh(200/center-distance); exact list match = 2.0; no bbox = 0.

    Reference quirks kept: predicted bbox scaled by `scale`, reference bbox by
    `scale/2` (the stage-1 image is model-space at half the annotation scale)."""
    rewards = []
    bboxes_ref = kwargs.get("bbox")
    scales = kwargs.get("scale")
    for i, c1 in enumerate(completion1):
        r = 0.0
        boxes = extract_bboxes_float(c1)
        if boxes:
            box = boxes[0]
            ref = bboxes_ref[i]
            if len(box) != 4 or len(ref) != 4:
                r = 0.0
            elif box == ref:
                r = 2.0
            else:
                ref_scaled = [p * scales[i] / 2 for p in ref]
                box_scaled = [p * scales[i] for p in box]
                cx, cy = (box_scaled[0] + box_scaled[2]) / 2.0, (box_scaled[1] + box_scaled[3]) / 2.0
                rx, ry = (ref_scaled[0] + ref_scaled[2]) / 2.0, (ref_scaled[1] + ref_scaled[3]) / 2.0
                distance = ((rx - cx) ** 2 + (ry - cy) ** 2) ** 0.5 + 1e-6
                r = float(crop_iou(box_scaled, ref_scaled) + _tanh(200.0 / distance))
        _debug_log("bbox", [f"Bbox reward: {r}",
                            f"problem: {kwargs.get('question', [None]*len(completion1))[i]}",
                            f"Completion: {c1}"])
        rewards.append(r)
    return rewards


def answer_reward(completion1: Sequence[str], completion2: Sequence[str], **kwargs) -> List[float]:
    """WordNet-degree correctness of the final <answer> — stage 2 when a crop happened,
    stage 1 otherwise (customized_funcs.py:324-353)."""
    rewards = []
    gts = kwargs.get("ground_truth")
    for i, (c1, c2) in enumerate(zip(completion1, completion2)):
        cut = c2 != ""
        answer = extract_tag(c2 if cut else c1, "answer")
        r = float(correctness(answer, gts[i]))
        _debug_log("answer", [f"answer reward: {r}",
                              f"problem: {kwargs.get('question', [None]*len(completion1))[i]}",
                              f"Completion1: {c1}", f"Completion2: {c2}",
                              f"Solution: {gts[i]}"])
        rewards.append(r)
    return rewards
