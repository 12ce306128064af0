"""LRS-GRO evaluator: exact-or-synonym accuracy, per-type and overall, stage-1 -> stage-2
(port of eval/score.py; a copy, host code only).

Equivalent of reference src/eval/eval.py:44-152 with the same decision rule
(normalized exact match OR WordNet path-similarity >= 0.8; answer2 falls back to
answer1 when stage 2 was skipped) but returning a structured metrics dict in addition
to the printed report.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from ..rewards.wordnet_compat import are_synonyms, wordnet_available


def is_correct(gt: str, answer: Optional[str]) -> bool:
    gt = (gt or "").lower()
    if answer is None:
        return False
    answer = answer.lower().strip()
    return gt == answer or are_synonyms(gt, answer)


def evaluate_dataset(items: Iterable[dict], verbose: bool = True) -> Dict:
    """items: result records with ground_truth / answer1 / answer2 / type (infer schema).

    Returns {"overall_acc1", "overall_acc2", "per_type", "n", "fixed", "regressed"}.
    """
    items = list(items)
    total1 = total2 = 0
    type_c1: Dict[str, int] = defaultdict(int)
    type_c2: Dict[str, int] = defaultdict(int)
    type_n: Dict[str, int] = defaultdict(int)
    fixed: List[dict] = []
    regressed: List[dict] = []

    for item in items:
        gt = (item.get("ground_truth") or "").lower()
        a1 = item.get("answer1")
        a2 = item.get("answer2")
        if a2 is None:
            a2 = a1  # reference eval.py:66-68: stage-2 falls back to stage-1
        ok1 = is_correct(gt, a1)
        ok2 = is_correct(gt, a2)
        if ok1 and not ok2:
            regressed.append(item)
        if ok2 and not ok1:
            fixed.append(item)
        total1 += ok1
        total2 += ok2
        t = item.get("type", "unknown")
        type_n[t] += 1
        type_c1[t] += ok1
        type_c2[t] += ok2

    n = len(items)
    metrics = {
        "n": n,
        "overall_acc1": total1 / n if n else 0.0,
        "overall_acc2": total2 / n if n else 0.0,
        "per_type": {
            t: {
                "n": type_n[t],
                "acc1": type_c1[t] / type_n[t],
                "acc2": type_c2[t] / type_n[t],
            }
            for t in sorted(type_n)
        },
        "fixed": len(fixed),
        "regressed": len(regressed),
        "wordnet_backend": wordnet_available(),
    }
    if verbose:
        print("\n--- Evaluation Results ---")
        print(f"Total Correct (stage 1): {total1}")
        print(f"Total Correct (stage 2): {total2}")
        print(f"Total Samples: {n}")
        print("-" * 25)
        print("Type-wise Accuracies:")
        for t, m in metrics["per_type"].items():
            print(f"{t:<15}: {m['acc1'] * 100:.2f}% -> {m['acc2'] * 100:.2f}%")
        print("-" * 25)
        print(f"Overall Accuracy (OA, stage 1): {metrics['overall_acc1'] * 100:.2f}%")
        print(f"Overall Accuracy (OA, stage 2): {metrics['overall_acc2'] * 100:.2f}%")
        if not metrics["wordnet_backend"]:
            print("NOTE: WordNet corpus unavailable — fallback synonym backend in use.")
    return metrics


def evaluation_metrics(data_path: str, verbose: bool = True) -> Dict:
    """Score a results jsonl file (reference eval.py:132-152)."""
    with open(data_path) as f:
        data = [json.loads(line) for line in f if line.strip()]
    return evaluate_dataset(data, verbose=verbose)
