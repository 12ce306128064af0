"""The port's own copy of zoomearth_tpu/rewards/detection.py (host code, held equal to it by
tests/test_torch_host.py).

Detection rewards: single-image COCO mAP, od/odLength, weighted-sum detection_score.

Port of the reference's detection reward family (grpo_jsonl.py:240-565). The reference
evaluates a SINGLE synthetic image through a vendored pure-python pycocotools
(utils/pycocotools, 930 LoC); here the COCO AP protocol is computed directly in numpy
for the one-image case — same matching rules (per-category greedy best-IoU match at
each threshold, 101-point interpolated AP over IoU .5:.95) without the vendored copy.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def clean_text(text: str, exclude_chars=("\n", "\r")) -> str:
    """grpo_jsonl.py:759-780: take last <answer> block, normalize newlines to spaces."""
    matches = re.findall(r"<answer>(.*?)</answer>", text, re.DOTALL)
    if matches:
        text = matches[-1]
    for ch in exclude_chars:
        if ch in ("\n", "\r"):
            text = re.sub(r"(?<=\s)" + re.escape(ch), "", text)
            text = re.sub(r"(?<!\s)" + re.escape(ch), " ", text)
        else:
            text = text.replace(ch, " ")
    return text.strip().rstrip(".")


def parse_json_boxes(text: str) -> List[Dict]:
    """Parse the last ```json ...``` block into a list of {"bbox_2d", "label"} dicts."""
    matches = re.findall(r"```json(.*?)```", text, re.DOTALL)
    if not matches:
        return []
    try:
        data = json.loads(matches[-1].strip())
        return list(data)
    except Exception:
        return []


def iou_inclusive(box1, box2) -> float:
    """The reference's pixel-inclusive IoU (grpo_jsonl.py:420-431): +1 on intersection
    extents, plain areas for union."""
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
    return float(inter) / union if union else 0.0


def _coco_iou_xyxy(a, b) -> float:
    """Standard COCO bbox IoU (xywh semantics on xyxy-converted boxes, no +1)."""
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    iw = min(ax2, bx2) - max(ax1, bx1)
    ih = min(ay2, by2) - max(ay1, by1)
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0


_RECALL_GRID = np.linspace(0.0, 1.0, 101)
_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def _ap_single_category(pred: List[Sequence[float]], gt: List[Sequence[float]], thr: float) -> float:
    """COCO AP for one category/one image at one IoU threshold (all scores equal, so
    detection order is the listed order — matches COCOeval with score=1.0)."""
    if not gt:
        return np.nan  # category absent from gt: excluded from the mean
    if not pred:
        return 0.0
    matched_gt = set()
    tp = np.zeros(len(pred))
    for d, box in enumerate(pred):
        best, best_j = thr, -1  # COCO: must exceed threshold
        for j, g in enumerate(gt):
            if j in matched_gt:
                continue
            i = _coco_iou_xyxy(box, g)
            if i >= best:
                best, best_j = i, j
        if best_j >= 0:
            matched_gt.add(best_j)
            tp[d] = 1
    cum_tp = np.cumsum(tp)
    recall = cum_tp / len(gt)
    precision = cum_tp / (np.arange(len(pred)) + 1)
    # monotone precision envelope + 101-point interpolation (COCOeval.accumulate)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, _RECALL_GRID, side="left")
    q = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(q.mean())


def calculate_map(pred_boxes: List[Dict], gt_boxes: List[Dict], score_type: int = 0) -> float:
    """Single-image mAP over the gt's categories (reference calculate_map,
    grpo_jsonl.py:240-297). score_type 0 = mAP@[.5:.95], 1 = mAP@.5. Predictions with
    labels unseen in gt are dropped (the reference's cats2id KeyError => except: pass)."""
    cats = []
    for g in gt_boxes:
        if g["label"] not in cats:
            cats.append(g["label"])
    if not cats:
        return 0.0
    preds_by_cat = {c: [] for c in cats}
    for p in pred_boxes:
        try:
            if p["label"] in preds_by_cat:
                preds_by_cat[p["label"]].append(p["bbox_2d"])
        except (KeyError, TypeError):
            continue
    if not any(preds_by_cat.values()):
        return 0.0
    gts_by_cat = {c: [g["bbox_2d"] for g in gt_boxes if g["label"] == c] for c in cats}
    thresholds = _IOU_THRESHOLDS if score_type == 0 else np.asarray([0.5])
    aps = []
    for c in cats:
        for t in thresholds:
            ap = _ap_single_category(preds_by_cat[c], gts_by_cat[c], float(t))
            if not np.isnan(ap):
                aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def map_reward(content: str, sol: str, length_reward: bool = False, score_type: int = 0, **kwargs) -> float:
    """grpo_jsonl.py:299-352: mAP between the last ```json``` blocks of content/sol."""
    gt = parse_json_boxes(sol)
    pred = parse_json_boxes(content)
    if pred and gt:
        reward = calculate_map(pred, gt, score_type=score_type)
    elif not pred and not gt:
        reward = 1.0
    else:
        reward = 0.0
    if length_reward:
        length_score = 1.0 if len(gt) >= len(pred) else len(gt) / len(pred)
        return reward * length_score
    return reward


def od_reward(content: str, sol: str, score_type: int = 0, **kwargs) -> float:
    """grpo_jsonl.py:353-387: mAP on <answer> blocks with the None/None special case."""
    sol_m = re.search(r"<answer>(.*?)</answer>", sol, re.DOTALL)
    ground_truth = sol_m.group(1).strip() if sol_m else None
    content_m = re.findall(r"<answer>(.*?)</answer>", content, re.DOTALL)
    student = content_m[-1].strip() if content_m else None
    if student is None:
        return 0.0
    if ground_truth == "None" and student == "None":
        return 1.0
    return map_reward(student, ground_truth or "", score_type=score_type)


def od_length_reward(content: str, sol: str, **kwargs) -> float:
    """grpo_jsonl.py:389-418: od_reward with over-prediction length penalty."""
    sol_m = re.search(r"<answer>(.*?)</answer>", sol, re.DOTALL)
    ground_truth = sol_m.group(1).strip() if sol_m else None
    content_m = re.findall(r"<answer>(.*?)</answer>", content, re.DOTALL)
    student = content_m[-1].strip() if content_m else None
    if student is None:
        return 0.0
    if ground_truth == "None" and student == "None":
        return 1.0
    return map_reward(student, ground_truth or "", length_reward=True, score_type=0)


def detection_score(
    content: str,
    sol: str,
    iou_threshold: float = 0.5,
    alpha: float = 0.7,
    beta: float = 0.0,
    gamma: float = 0.3,
) -> float:
    """Weighted-sum detection score with greedy IoU matching (grpo_jsonl.py:433-565):
    alpha*position(avg matched IoU) + beta*label + gamma*completeness, normalized."""
    pred_boxes = parse_json_boxes(clean_text(content))
    gt_boxes = parse_json_boxes(clean_text(sol))
    if len(gt_boxes) == 0:
        return 1.0 if not pred_boxes else 0.0
    if len(pred_boxes) == 0:
        return 0.0
    iou_matrix = [
        [
            (lambda p, g: iou_inclusive(p, g) if p and g else 0.0)(
                pred.get("bbox_2d"), gt.get("bbox_2d")
            )
            for gt in gt_boxes
        ]
        for pred in pred_boxes
    ]
    matches = []
    unmatched_preds = list(range(len(pred_boxes)))
    unmatched_gts = list(range(len(gt_boxes)))
    while unmatched_preds and unmatched_gts:
        max_iou, mp, mg = -1.0, -1, -1
        for pi in unmatched_preds:
            for gi in unmatched_gts:
                if iou_matrix[pi][gi] > max_iou:
                    max_iou, mp, mg = iou_matrix[pi][gi], pi, gi
        if max_iou < iou_threshold:
            break
        pred_label = str(pred_boxes[mp].get("label", "")).lower()
        gt_label = str(gt_boxes[mg].get("label", "")).lower()
        label_correct = pred_label == gt_label
        matches.append({"iou": max_iou if label_correct else 0, "label_correct": label_correct})
        unmatched_preds.remove(mp)
        unmatched_gts.remove(mg)
    position = sum(m["iou"] for m in matches) / len(gt_boxes) if matches else 0.0
    label = sum(1.0 for m in matches if m["label_correct"]) / len(gt_boxes) if matches else 0.0
    miss = len(unmatched_gts) / len(gt_boxes)
    false_alarm = len(unmatched_preds) / len(pred_boxes)
    completeness = 1.0 - (miss + false_alarm) / 2.0
    return (alpha * position + beta * label + gamma * completeness) / (alpha + beta + gamma)


def weighted_sum_reward(content: str, sol: str, **kwargs) -> float:
    """The accu_reward_method='weighted_sum' dispatch branch (grpo_jsonl.py:845-856)."""
    c = clean_text(content)
    s = clean_text(sol)
    if s == "none":
        return 1.0 if c == "none" else 0.0
    return detection_score(content, sol)
