"""The numbers a served cell's check compares, from the per-token logit gaps of the
sampled questions (how far each served token's logit lies below the reference's best):
the widest gap, and the mean over every compared token. A cell's limits file names the
ones it compares; every other is reported as a reading. The same numbers judge the
control when it stands in the program's place."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def gap_numbers(per_question: List[np.ndarray]) -> Dict[str, float]:
    every = np.concatenate([np.asarray(g, np.float64) for g in per_question]) if per_question else np.zeros(0)
    if every.size == 0:
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    return {"max_logit_gap": float(every.max()), "mean_logit_gap": float(every.mean())}


def logit_gap_checks(limits: Dict[str, float], gaps: List[np.ndarray], missing: int):
    """(checks, readings) of one side's gaps. No limits file: the widest gap, held to 0."""
    numbers = gap_numbers(gaps)
    checks = {"missing_questions": {"value": missing, "limit": 0}}
    for name, limit in (limits or {"max_logit_gap": 0.0}).items():
        checks[name] = {"value": numbers[name], "limit": limit}
    return checks, dict(numbers, max_per_question=[float(np.max(g)) if len(g) else 0.0 for g in gaps])
