"""The port's own copy of zoomearth_tpu/rewards/llm_judge.py (host code, held equal to it by
tests/test_torch_host.py).

LLM-judge reward: score answer similarity via any OpenAI-compatible endpoint.

Port of the reference's llm_reward/evaluate_answer_similarity (grpo_jsonl.py:49-52,
164-197). Endpoint configured via JUDGE_BASE_URL / JUDGE_MODEL env (the reference uses
OPENAI_API_BASE with a local qwen2.5:7b). In a zero-egress environment this can point
at our own serve.server hosting a judge model; without an endpoint the reward falls
back to exact matching (the reference's own exception fallback).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

JUDGE_SYSTEM = (
    "You are a evaluation expert. First, analyze the student's response to identify "
    "and extract their final answer. Then, compare the extracted answer with the "
    "correct solution. Output ONLY '1.0' if the extracted answer matches the correct "
    "solution in meaning, or '0.0' if the student's response does not contain a clear "
    "or correct answer. No other output is allowed."
)


def _default_client():
    base = os.environ.get("JUDGE_BASE_URL") or os.environ.get("OPENAI_API_BASE")
    if not base:
        return None
    from ..eval.client import ChatClient

    return ChatClient(base, model=os.environ.get("JUDGE_MODEL", "qwen2.5:7b"))


def evaluate_answer_similarity(student_answer: str, ground_truth: str, client=None) -> float:
    """1.0/0.0 via the judge; exact-match fallback on any failure (reference :189-197)."""
    if client is None:
        client = _default_client()
    if client is not None:
        try:
            result = client.create(
                [
                    {"role": "user", "content": JUDGE_SYSTEM},
                    {"role": "user", "content": (
                        f"Student's response: {student_answer}\nCorrect solution: "
                        f"{ground_truth}\nOutput only 1.0 or 0.0:"
                    )},
                ],
                temperature=0.0,
                max_tokens=8,
            ).strip()
            return float(result)
        except Exception:
            pass
    return 1.0 if student_answer == ground_truth else 0.0


def llm_reward(content: str, sol: str, client=None, **kwargs) -> float:
    """Answer-tag extraction then judge scoring (grpo_jsonl.py:190-197)."""
    sol_match = re.search(r"<answer>(.*?)</answer>", sol)
    ground_truth = sol_match.group(1).strip() if sol_match else sol.strip()
    content_matches = re.findall(r"<answer>(.*?)</answer>", content, re.DOTALL)
    student_answer = content_matches[-1].strip() if content_matches else content.strip()
    return evaluate_answer_similarity(student_answer, ground_truth, client=client)
