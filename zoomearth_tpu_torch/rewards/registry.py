"""The port's own copy of zoomearth_tpu/rewards/registry.py (host code, held equal to it by
tests/test_torch_host.py).

Reward registry: name -> callable, mirroring grpo_jsonl.py:902-906 plus the generic
library. Callables follow the VLMGRPOTrainer contract:
fn(completion1: list[str], completion2: list[str], **dataset_columns) -> list[float].
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from . import generic
from .internvl import internvl_format_reward, internvl_iou_reward
from .zoomearth import answer_reward, bbox_reward, format_reward


def _stage_agnostic(batch_fn):
    """Adapt a completions-only reward to the two-stage signature (uses the final
    completion: stage 2 when present else stage 1)."""

    def wrapped(completion1: Sequence[str], completion2: Sequence[str], **kwargs) -> List[float]:
        finals = [c2 if c2 != "" else c1 for c1, c2 in zip(completion1, completion2)]
        return batch_fn(finals, **kwargs)

    return wrapped


REWARD_REGISTRY: Dict[str, Callable] = {
    # ZoomEarth Region-Guided set (reference registry grpo_jsonl.py:902-906)
    "answer": answer_reward,
    "iou": bbox_reward,
    "format": format_reward,
    # generic library
    "accuracy": _stage_agnostic(
        lambda finals, **kw: generic.accuracy_reward(
            finals,
            kw.pop("solution", None) or kw.get("ground_truth", [""] * len(finals)),
            **kw,
        )
    ),
    "think_answer_format": _stage_agnostic(
        lambda finals, **kw: generic.think_answer_format_reward(finals, **kw)
    ),
    "repetition": _stage_agnostic(
        lambda finals, **kw: [generic.repetition_penalty_reward(c) for c in finals]
    ),
    # InternVL module (vlm_modules/internvl_module.py select_reward_func)
    "internvl_format": internvl_format_reward,
    "internvl_iou": internvl_iou_reward,
}


def get_reward_funcs(names: Sequence[str]) -> List[Callable]:
    missing = [n for n in names if n not in REWARD_REGISTRY]
    if missing:
        raise KeyError(f"unknown reward(s) {missing}; available: {sorted(REWARD_REGISTRY)}")
    return [REWARD_REGISTRY[n] for n in names]
