"""REC (referring-expression-comprehension) task support (the port's own copy of
zoomearth_tpu/train/rec.py, held equal to it by tests/test_torch_internvl.py): yaml
multi-dataset sampling, REC prompt/rewards — the reference's legacy grpo_rec.py entry surface.

- load_yaml_datasets: the LazySupervisedDataset sampling semantics (grpo_rec.py:92-160):
  yaml lists {json_path, sampling_strategy: first|end|random[:N|:P%]} entries over
  .json/.jsonl files with fields problem / solution / image.
- rec_format_reward / rec_iou_reward: the task rewards from
  vlm_modules/qwen_module.py:119-224 (bbox-in-answer format fullmatch; IoU of the
  model-space bbox rescaled to image space via grid_thw).
- rec_prompt: the REC question template.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import re
from typing import Dict, List, Optional, Sequence

from ..rewards.detection import iou_inclusive

REC_QUESTION_TEMPLATE = (
    "{Question} First output the thinking process in <think> </think> tags and then "
    "output the final answer in <answer> </answer> tags. Output the final answer in "
    "JSON format."
)


def rec_prompt(question: str) -> str:
    return REC_QUESTION_TEMPLATE.format(Question=question)


@dataclasses.dataclass
class RECSample:
    problem: str
    solution: str  # usually '<answer>[x1, y1, x2, y2]</answer>' or raw json list
    image: Optional[str] = None  # relative path under image_root
    image_path: Optional[str] = None


def load_yaml_datasets(data_path: str, image_root: str = "", seed: Optional[int] = None) -> List[RECSample]:
    """Load a yaml dataset spec with per-dataset sampling (grpo_rec.py:99-148)."""
    import yaml

    if not data_path.endswith(".yaml"):
        raise ValueError(f"Unsupported file type: {data_path}")
    rng = random.Random(seed)
    out: List[RECSample] = []
    with open(data_path) as f:
        spec = yaml.safe_load(f)
    for entry in spec.get("datasets", []):
        json_path = entry.get("json_path")
        strategy = entry.get("sampling_strategy", "all")
        if json_path.endswith(".jsonl"):
            with open(json_path) as jf:
                rows = [json.loads(line) for line in jf if line.strip()]
        elif json_path.endswith(".json"):
            with open(json_path) as jf:
                rows = json.load(jf)
        else:
            raise ValueError(f"Unsupported file type: {json_path}")
        number = None
        if ":" in strategy:
            strategy, num_s = strategy.split(":")
            if "%" in num_s:
                number = math.ceil(int(num_s.split("%")[0]) * len(rows) / 100)
            else:
                number = int(num_s)
        if strategy == "first" and number is not None:
            rows = rows[:number]
        elif strategy == "end" and number is not None:
            rows = rows[-number:]
        elif strategy == "random" and number is not None:
            rows = list(rows)
            rng.shuffle(rows)
            rows = rows[:number]
        for r in rows:
            out.append(
                RECSample(
                    problem=r.get("problem", ""),
                    solution=r.get("solution", ""),
                    image=r.get("image"),
                    image_path=os.path.join(image_root, r["image"]) if r.get("image") else None,
                )
            )
    return out


_REC_FORMAT_RE = re.compile(
    r"<think>.*?</think>\s*<answer>.*?\{.*\[\d+,\s*\d+,\s*\d+,\s*\d+\].*\}.*?</answer>",
    re.DOTALL,
)
_ANSWER_TAG_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_BBOX_RE = re.compile(r"\[(\d+),\s*(\d+),\s*(\d+),\s*(\d+)]")


def rec_format_reward(completions: Sequence[str], **kwargs) -> List[float]:
    """Bbox-bearing think/answer format check (qwen_module.py:119-137)."""
    return [1.0 if _REC_FORMAT_RE.search(c) else 0.0 for c in completions]


def resize_bbox(bbox, input_height, input_width, image_height, image_width):
    """Model-space (grid) bbox -> original-image pixels (qwen_module.py:156-162)."""
    return [
        bbox[0] / input_width * image_width,
        bbox[1] / input_height * image_height,
        bbox[2] / input_width * image_width,
        bbox[3] / input_height * image_height,
    ]


def rec_iou_reward(
    completions: Sequence[str],
    solution: Sequence[str],
    *,
    image_grid_thw: Sequence[Sequence[int]],
    image_sizes: Sequence[Sequence[int]],  # (width, height) per sample
    patch_size: int = 14,
    **kwargs,
) -> List[float]:
    """IoU of the predicted bbox (rescaled from model space) vs the solution bbox
    (qwen_module.py:140-224). image_sizes replaces the reference's per-call PIL open."""
    rewards = []
    for i, (content, sol) in enumerate(zip(completions, solution)):
        reward = 0.0
        try:
            grid = image_grid_thw[i]
            image_width, image_height = image_sizes[i]
            input_height = int(grid[1] * patch_size)
            input_width = int(grid[2] * patch_size)
            sol_text = _ANSWER_TAG_RE.findall(sol)[-1]
            sol_box = json.loads(sol_text.strip())
            m = _ANSWER_TAG_RE.search(content)
            if m:
                bm = _BBOX_RE.search(m.group(1).strip())
                if bm:
                    bbox = [int(bm.group(j)) for j in range(1, 5)]
                    bbox = resize_bbox(bbox, input_height, input_width, image_height, image_width)
                    reward = iou_inclusive(bbox, sol_box)
        except Exception:
            pass
        rewards.append(float(reward))
    return rewards
