"""The port's own copy of zoomearth_tpu/utils/mathcheck.py (host code, held equal to it by
tests/test_torch_host.py).

MATH answer equivalence (port of reference utils/math.py:1-219 semantics).

compute_score: exact match -> symbolic verify (math_verify, gated: not installed in
this image) -> \\boxed extraction + Hendrycks-MATH string normalization equivalence.
"""

from __future__ import annotations

from typing import Optional


def remove_boxed(s: str) -> str:
    if "\\boxed " in s:
        left = "\\boxed "
        assert s[: len(left)] == left
        return s[len(left):]
    left = "\\boxed{"
    assert s[: len(left)] == left
    assert s[-1] == "}"
    return s[len(left):-1]


def last_boxed_only_string(string: str) -> Optional[str]:
    idx = string.rfind("\\boxed")
    if "\\boxed " in string:
        return "\\boxed " + string.split("\\boxed ")[-1].split("$")[0]
    if idx < 0:
        idx = string.rfind("\\fbox")
        if idx < 0:
            return None
    i = idx
    right_brace_idx = None
    num_left_braces_open = 0
    while i < len(string):
        if string[i] == "{":
            num_left_braces_open += 1
        if string[i] == "}":
            num_left_braces_open -= 1
            if num_left_braces_open == 0:
                right_brace_idx = i
                break
        i += 1
    return string[idx: right_brace_idx + 1] if right_brace_idx is not None else None


def _fix_fracs(string: str) -> str:
    substrs = string.split("\\frac")
    new_str = substrs[0]
    if len(substrs) > 1:
        for substr in substrs[1:]:
            new_str += "\\frac"
            if substr and substr[0] == "{":
                new_str += substr
            else:
                if len(substr) < 2:
                    return string
                a, b = substr[0], substr[1]
                if b != "{":
                    new_str += "{" + a + "}{" + b + "}" + substr[2:]
                else:
                    new_str += "{" + a + "}" + substr[1:]
    return new_str


def _fix_a_slash_b(string: str) -> str:
    if len(string.split("/")) != 2:
        return string
    a, b = string.split("/")
    try:
        ia, ib = int(a), int(b)
        if string == f"{ia}/{ib}":
            return "\\frac{" + str(ia) + "}{" + str(ib) + "}"
        return string
    except ValueError:
        return string


def _remove_right_units(string: str) -> str:
    if "\\text{ " in string:
        splits = string.split("\\text{ ")
        return splits[0]
    return string


def _fix_sqrt(string: str) -> str:
    if "\\sqrt" not in string:
        return string
    splits = string.split("\\sqrt")
    new_string = splits[0]
    for split in splits[1:]:
        if split and split[0] != "{":
            new_string += "\\sqrt{" + split[0] + "}" + split[1:]
        else:
            new_string += "\\sqrt" + split
    return new_string


def strip_string(string: str) -> str:
    """Hendrycks-MATH normalization (lm-eval-harness variant the reference vendors)."""
    string = string.replace("\n", "")
    string = string.replace("\\!", "")
    string = string.replace("\\\\", "\\")
    string = string.replace("tfrac", "frac").replace("dfrac", "frac")
    string = string.replace("\\left", "").replace("\\right", "")
    string = string.replace("^{\\circ}", "").replace("^\\circ", "")
    string = string.replace("\\$", "")
    string = _remove_right_units(string)
    string = string.replace("\\%", "").replace("%", "")
    string = string.replace(" .", " 0.")
    string = string.replace("{.", "{0.")
    if not string:
        return string
    if string[0] == ".":
        string = "0" + string
    if len(string.split("=")) == 2:
        string = string.split("=")[-1]
    string = _fix_sqrt(string)
    string = string.replace(" ", "")
    string = _fix_fracs(string)
    if string == "0.5":
        string = "\\frac{1}{2}"
    string = _fix_a_slash_b(string)
    return string


def is_equiv(str1: Optional[str], str2: Optional[str]) -> bool:
    if str1 is None and str2 is None:
        return True
    if str1 is None or str2 is None:
        return False
    try:
        return strip_string(str1) == strip_string(str2)
    except Exception:
        return str1 == str2


def _symbolic_verify(solution_str: str, ground_truth: str) -> Optional[bool]:
    """math_verify symbolic check, None when the package is unavailable."""
    try:
        from math_verify import parse, verify
    except ImportError:
        return None
    try:
        return float(verify(parse(solution_str), parse(ground_truth))) > 0
    except Exception:
        return False


def compute_score(solution_str: str, ground_truth: str) -> float:
    """Reference utils/math.py:2-22."""
    if solution_str == ground_truth:
        return 1.0
    sym = _symbolic_verify(solution_str, ground_truth)
    if sym:
        return 1.0
    try:
        answer = solution_str
        boxed = last_boxed_only_string(solution_str)
        if boxed is not None:
            answer = remove_boxed(boxed)
        if is_equiv(answer, ground_truth):
            return 1.0
    except Exception:
        pass
    return 0.0
