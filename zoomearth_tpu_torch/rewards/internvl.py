"""The port's own copy of zoomearth_tpu/rewards/internvl.py (host code, held equal to it by
tests/test_torch_host.py).

InternVL-module rewards (reference vlm_modules/internvl_module.py:157-240):
REC format check + SOFT IoU (the raw IoU value, unlike the Qwen REC module's
thresholded variant). Same callable contract as the other reward modules."""

from __future__ import annotations

import json
import re
from typing import List, Sequence

from .zoomearth import _debug_log

_FORMAT_PATTERN = r"<think>.*?</think>\s*<answer>.*?\[\d+,\s*\d+,\s*\d+,\s*\d+\].*?</answer>"
_ANSWER_TAG = r"<answer>(.*?)</answer>"
_BBOX_PATTERN = r"\[(\d+),\s*(\d+),\s*(\d+),\s*(\d+)]"


def _iou(box1, box2) -> float:
    """Reference soft IoU with the inclusive-pixel quirk kept
    (internvl_module.py:184-196: -1 on the max corner, +1 on the extent)."""
    inter_x1 = max(box1[0], box2[0])
    inter_y1 = max(box1[1], box2[1])
    inter_x2 = min(box1[2] - 1, box2[2] - 1)
    inter_y2 = min(box1[3] - 1, box2[3] - 1)
    if inter_x1 < inter_x2 and inter_y1 < inter_y2:
        inter = (inter_x2 - inter_x1 + 1) * (inter_y2 - inter_y1 + 1)
    else:
        inter = 0
    union = (
        (box1[2] - box1[0]) * (box1[3] - box1[1])
        + (box2[2] - box2[0]) * (box2[3] - box2[1])
        - inter
    )
    return float(inter) / union


def internvl_format_reward(completion1: Sequence[str], completion2: Sequence[str] = (), **kwargs) -> List[float]:
    """<think>...</think><answer>...[x1,y1,x2,y2]...</answer> format gate
    (internvl_module.py:159-178)."""
    rewards = []
    for c in completion1:
        ok = re.search(_FORMAT_PATTERN, c or "", re.DOTALL) is not None
        r = 1.0 if ok else 0.0
        _debug_log("internvl_format", [f"Format reward: {r}", f"Content: {c}"])
        rewards.append(r)
    return rewards


def internvl_iou_reward(completion1: Sequence[str], completion2: Sequence[str] = (), **kwargs) -> List[float]:
    """Soft IoU of the predicted <answer> bbox vs the solution's <answer> bbox
    (internvl_module.py:180-240). `solution` entries carry <answer>[x1,y1,x2,y2]</answer>."""
    solutions = kwargs.get("solution") or kwargs.get("ground_truth")
    rewards = []
    for i, c in enumerate(completion1):
        reward = 0.0
        # Ground-truth parsing stays OUTSIDE the try (reference internvl_module.py
        # parses the solution before the guarded block): a malformed solution is a
        # dataset bug that must raise, not silently zero every reward.
        sol_txt = re.findall(_ANSWER_TAG, solutions[i], re.DOTALL)[-1]
        sol = json.loads(sol_txt.strip())
        try:
            m = re.search(_ANSWER_TAG, c or "", re.DOTALL)
            if m:
                bm = re.search(_BBOX_PATTERN, m.group(1).strip())
                if bm:
                    bbox = [int(bm.group(j)) for j in range(1, 5)]
                    reward = _iou(bbox, sol)
        except Exception:
            pass
        _debug_log("internvl_iou", [f"IoU reward: {reward}",
                                    f"Content: {c}", f"Solution: {solutions[i]}"])
        rewards.append(float(reward))
    return rewards
