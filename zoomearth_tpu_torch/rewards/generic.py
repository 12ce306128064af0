"""The port's own copy of zoomearth_tpu/rewards/generic.py (host code, held equal to it by
tests/test_torch_host.py).

Generic reusable reward library (subset of the reference's grpo_jsonl.py registry
worth keeping per SURVEY.md §7.2 step 8): accuracy dispatch, MCQ, yes/no, fuzzy string,
think/answer format, cosine length scaling, n-gram repetition penalty.

Single-completion rewards here take (content, sol) -> float; `accuracy_reward` is the
dispatching batch wrapper matching grpo_jsonl.py:828-881.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence


def extract_choice(text: str) -> Optional[str]:
    """Find a standalone MCQ letter A-H (grpo_jsonl extract_choice semantics)."""
    m = re.search(r"\b([A-H])\b", text.strip().upper())
    return m.group(1) if m else None


def _answer_of(text: str) -> str:
    m = re.search(r"<answer>(.*?)</answer>", text, re.DOTALL)
    return m.group(1).strip() if m else text.strip()


def mcq_reward(content: str, sol: str, **kwargs) -> float:
    """grpo_jsonl.py:199-215."""
    sol_m = re.search(r"<answer>(.*?)</answer>", sol)
    ground_truth = sol_m.group(1).strip() if sol_m else sol.strip()
    has_choice = extract_choice(ground_truth)
    correct_choice = has_choice.upper() if has_choice else sol.strip()
    student_choice = extract_choice(_answer_of(content))
    return 1.0 if (student_choice and student_choice == correct_choice) else 0.0


def yes_no_reward(content: str, sol: str, **kwargs) -> float:
    """grpo_jsonl.py:218-237."""
    content, sol = content.lower(), sol.lower()
    sol_m = re.search(r"<answer>(.*?)</answer>", sol)
    ground_truth = sol_m.group(1).strip() if sol_m else sol.strip()
    student_answer = _answer_of(content)
    g = re.search(r"(yes|no)", ground_truth)
    s = re.search(r"(yes|no)", student_answer)
    return 1.0 if (g.group(1) if g else "") == (s.group(1) if s else "") else 0.0


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def fuzzy_ratio(a: str, b: str) -> float:
    if not a and not b:
        return 1.0
    denom = max(len(a), len(b))
    return 1.0 - _levenshtein(a, b) / denom if denom else 0.0


def default_accuracy_reward(content: str, sol: str, **kwargs) -> float:
    """Numeric-equality then normalized-string then fuzzy matching (the non-symbolic
    tail of grpo_jsonl's default path; math-verify symbolic checking is applied first
    when the solution parses as a number/expression)."""
    ans = _answer_of(content).lower().strip().rstrip(".")
    gt = _answer_of(sol).lower().strip().rstrip(".")
    if not gt:
        return 0.0
    try:
        if abs(float(ans) - float(gt)) < 1e-6:
            return 1.0
    except ValueError:
        pass
    if ans == gt:
        return 1.0
    ratio = fuzzy_ratio(ans, gt)
    return ratio if ratio > 0.5 else 0.0


def _math_reward(content: str, sol: str, **kwargs) -> float:
    from ..utils.mathcheck import compute_score

    return compute_score(_answer_of(content), _answer_of(sol))


def _detection_methods():
    from . import detection as D

    return {
        "map": lambda c, s, **kw: D.map_reward(c, s),
        "od_ap": D.od_reward,
        "od_ap50": lambda c, s, **kw: D.od_reward(c, s, score_type=1),
        "odLength": D.od_length_reward,
        "weighted_sum": D.weighted_sum_reward,
        "all_match": lambda c, s, **kw: 1.0 if _answer_of(c).strip() == _answer_of(s).strip() else 0.0,
    }


def _llm_reward(content, sol, **kwargs):
    from .llm_judge import llm_reward

    return llm_reward(content, sol, **kwargs)


_ACCURACY_METHODS = {
    "mcq": mcq_reward,
    "yes_no": yes_no_reward,
    "math": _math_reward,
    "llm": _llm_reward,
    "default": default_accuracy_reward,
}
_ACCURACY_METHODS.update(_detection_methods())


def accuracy_reward(completions: Sequence[str], solution: Sequence[str], **kwargs) -> List[float]:
    """Batch dispatch by per-sample accu_reward_method (grpo_jsonl.py:828-881)."""
    methods = kwargs.get("accu_reward_method") or ["default"] * len(completions)
    out = []
    for content, sol, method in zip(completions, solution, methods):
        fn = _ACCURACY_METHODS.get(method, default_accuracy_reward)
        out.append(float(fn(content, sol)))
    return out


def think_answer_format_reward(completions: Sequence[str], **kwargs) -> List[float]:
    """Full-match <think>...</think><answer>...</answer> (grpo_jsonl.py:884-899)."""
    pattern = r"<think>.*?</think>\s*<answer>.*?</answer>"
    return [1.0 if re.fullmatch(pattern, c, re.DOTALL) else 0.0 for c in completions]


def cosine_length_reward(
    content: str,
    gen_len: int,
    acc_reward: float = 1.0,
    *,
    cosine_max_len: int = 1024,
    **kwargs,
) -> float:
    """Length-scaled reward (arXiv:2502.03373; grpo_jsonl.py:567-592). NOTE the
    reference overwrites acc_reward=1.0 unconditionally (SURVEY.md §2.6) — we take the
    caller's value and default to 1.0 for drop-in equivalence."""
    if acc_reward >= 0.7:
        # correct: short answers get up to 1.0, saturating down to 0.5 at max length
        min_value, max_value = 0.5, 1.0
    else:
        # wrong: 0.0 at zero length down to -0.5 at max length
        min_value, max_value = -0.5, 0.0
    return max_value - (max_value - min_value) * (1 - math.cos(gen_len * math.pi / cosine_max_len)) / 2


def repetition_penalty_reward(content: str, *, ngram: int = 3, max_penalty: float = -1.0, **kwargs) -> float:
    """N-gram repetition penalty (grpo_jsonl.py:594-712, simplified core): penalty
    proportional to the fraction of repeated n-grams."""
    if not content:
        return 0.0
    words = content.lower().split()
    if len(words) < ngram:
        return 0.0
    grams = [tuple(words[i : i + ngram]) for i in range(len(words) - ngram + 1)]
    unique = len(set(grams))
    frac_repeated = 1.0 - unique / len(grams)
    return max_penalty * frac_repeated
