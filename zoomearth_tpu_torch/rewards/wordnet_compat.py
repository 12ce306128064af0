"""Synonym scoring backend (port of rewards/wordnet_compat.py; a copy, host code
only): NLTK WordNet when the corpus is installed, otherwise a deterministic fallback
so reward/eval paths work in hermetic environments.

Reference semantics (customized_funcs.py:94-107, eval.py:29-42):
- lemmatize both words (WordNetLemmatizer; fallback: plural stripping)
- best path_similarity over all synset pairs
- synonyms_degree: best if best < 0.8 else 1  (fractional partial credit)
- are_synonyms: best >= 0.8

The fallback cannot reproduce WordNet's graph distances; it gives 1.0 for exact
lemma matches / built-in remote-sensing synonym pairs and 0.0 otherwise, and
`wordnet_available()` lets callers report which backend scored a run.
"""

from __future__ import annotations

import functools

# Small domain synonym table for the fallback backend (LRS-GRO answer vocabulary is
# remote-sensing objects); grouped words count as synonyms (degree 1.0).
_FALLBACK_SYNONYMS = [
    {"car", "auto", "automobile", "vehicle", "sedan"},
    {"truck", "lorry"},
    {"ship", "vessel", "boat"},
    {"plane", "airplane", "aircraft", "aeroplane", "jet"},
    {"house", "building", "home"},
    {"road", "street", "highway"},
    {"parking lot", "car park", "parking"},
    {"sports field", "playground", "field"},
    {"storage tank", "tank"},
    {"dock", "pier", "wharf", "harbor", "harbour", "port"},
    {"railway", "railroad", "rail", "train track"},
    {"bridge", "overpass", "viaduct"},
    {"forest", "woods", "woodland"},
    {"lake", "pond"},
    {"football field", "soccer field"},
]


@functools.lru_cache(maxsize=1)
def wordnet_available() -> bool:
    try:
        from nltk.corpus import wordnet as wn

        wn.synsets("car")
        return True
    except Exception:
        return False


def _fallback_lemmatize(word: str) -> str:
    for suffix in ("ies", "es", "s"):
        if word.endswith(suffix) and len(word) > len(suffix) + 2:
            if suffix == "ies":
                return word[: -len(suffix)] + "y"
            if suffix == "es" and word.endswith(("ses", "xes", "zes", "ches", "shes")):
                return word[: -len(suffix)]
            if suffix == "s" and not word.endswith(("ss", "us", "is")):
                return word[:-1]
    return word


def _lemmatize(word: str) -> str:
    if wordnet_available():
        try:
            from nltk.stem import WordNetLemmatizer

            return WordNetLemmatizer().lemmatize(word)
        except Exception:
            pass
    return _fallback_lemmatize(word)


def _best_path_similarity(w1: str, w2: str) -> float:
    from nltk.corpus import wordnet as wn

    best = 0.0
    for s1 in wn.synsets(w1):
        for s2 in wn.synsets(w2):
            sim = s1.path_similarity(s2)
            if sim is not None and sim > best:
                best = sim
    return best


def _fallback_degree(w1: str, w2: str) -> float:
    if w1 == w2:
        return 1.0
    for group in _FALLBACK_SYNONYMS:
        if w1 in group and w2 in group:
            return 1.0
    return 0.0


def synonyms_degree(word1: str, word2: str):
    """Reference customized_funcs.py:99-107: best similarity, saturating to 1 at 0.8.

    Returns False on backend errors (matches the reference's broad except)."""
    w1, w2 = _lemmatize(word1.lower()), _lemmatize(word2.lower())
    if wordnet_available():
        try:
            best = _best_path_similarity(w1, w2)
        except Exception:
            return False
        return best if best < 0.8 else 1
    return _fallback_degree(w1, w2)


def are_synonyms(word1: str, word2: str) -> bool:
    """Reference eval.py:29-42: True iff best path similarity >= 0.8."""
    w1, w2 = _lemmatize(word1.lower()), _lemmatize(word2.lower())
    if wordnet_available():
        try:
            return _best_path_similarity(w1, w2) >= 0.8
        except Exception:
            return False
    return _fallback_degree(w1, w2) >= 0.8


def correctness(answer, gt) -> float:
    """Reference customized_funcs.py:109-120: exact (normalized) match = 1, else degree."""
    if answer is None:
        answer = ""
    answer = answer.strip().lower().rstrip(".")
    gt = (gt or "").strip().lower().rstrip(".")
    if not gt:
        return 0
    if answer == gt:
        return 1
    return synonyms_degree(gt, answer) or 0.0
