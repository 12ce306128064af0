"""The port's scorer (rewards/wordnet_compat.py, eval/score.py, cli/eval.py) against
the JAX package's on the CPU: host code copied whole, held to exact equality. The
WordNet corpus is on neither machine, so both packages score through the fallback
synonym backend, as tests/test_eval.py does.
"""

import json

import numpy as np
import pytest

from zoomearth_tpu.cli import eval as JCLI
from zoomearth_tpu.eval import score as JS
from zoomearth_tpu.rewards import wordnet_compat as JW
from zoomearth_tpu_torch.cli import eval as TCLI
from zoomearth_tpu_torch.eval import score as TS
from zoomearth_tpu_torch.rewards import wordnet_compat as TW

WORDS = ["car", "cars", "automobile", "ship", "boats", "vessel", "bridge", "viaduct", "lake", "pond", "forests",
         "woods", "parking lot", "car park", "tank", "storage tank", "buses", "boxes", "churches", "cities", "glass",
         "bus", "analysis", "dog", "", "Ship", "harbour."]
TYPES = ["global", "object", "region"]


def _items(seed, n=40):
    """Seeded result records: answers drawn from WORDS (some None), in the infer schema's keys."""
    rng = np.random.default_rng(seed)
    pick = lambda: None if rng.random() < 0.15 else WORDS[int(rng.integers(len(WORDS)))]  # noqa: E731
    return [{"question_id": str(i), "ground_truth": WORDS[int(rng.integers(len(WORDS)))], "answer1": pick(),
             "answer2": pick(), "type": TYPES[int(rng.integers(len(TYPES)))]} for i in range(n)]


def test_wordnet_backend_is_the_fallback_in_both_packages():
    assert TW.wordnet_available() is JW.wordnet_available() is False


@pytest.mark.parametrize("fn", ["synonyms_degree", "are_synonyms", "correctness", "_fallback_lemmatize"])
def test_wordnet_compat_functions_equal_reference(fn):
    for a in WORDS:
        if fn == "_fallback_lemmatize":
            assert TW._fallback_lemmatize(a) == JW._fallback_lemmatize(a), a
            continue
        for b in WORDS:
            got, want = getattr(TW, fn)(a, b), getattr(JW, fn)(a, b)
            assert got == want and type(got) is type(want), (fn, a, b)
    if fn == "correctness":
        assert TW.correctness(None, "car") == JW.correctness(None, "car") == 0.0
        assert TW.correctness("Car.", " car") == 1


def test_is_correct_equals_reference():
    for gt in WORDS:
        for ans in WORDS + [None, " Car ", "SHIP"]:
            assert TS.is_correct(gt, ans) is JS.is_correct(gt, ans), (gt, ans)
    assert TS.is_correct("Ship", "ship") and not TS.is_correct("ship", "bridge") and TS.is_correct("car", "automobile")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_dataset_equals_reference(seed):
    items = _items(seed)
    got, want = TS.evaluate_dataset(items, verbose=False), JS.evaluate_dataset(items, verbose=False)
    assert got == want
    assert got["n"] == 40 and set(got["per_type"]) <= set(TYPES) and got["wordnet_backend"] is False
    assert 0 < got["overall_acc2"] < 1  # the seeded answers are neither all right nor all wrong


def test_evaluate_dataset_fallbacks_and_empty():
    m = TS.evaluate_dataset([{"ground_truth": "car", "answer1": "car", "answer2": None, "type": "global"}], verbose=False)
    assert m["overall_acc1"] == m["overall_acc2"] == 1.0  # stage 2 falls back to stage 1
    items = [{"ground_truth": "ship", "answer1": "dog", "answer2": "ship", "type": "object"},
             {"ground_truth": "lake", "answer1": "lake", "answer2": "dog", "type": "object"}, {"ground_truth": "x"}]
    m = TS.evaluate_dataset(items, verbose=False)
    assert (m["fixed"], m["regressed"], m["per_type"]["unknown"]["n"]) == (1, 1, 1)
    assert TS.evaluate_dataset([], verbose=False) == JS.evaluate_dataset([], verbose=False)


def test_evaluation_metrics_and_report_equal_reference(tmp_path, capsys):
    path = tmp_path / "results.jsonl"
    with open(path, "w") as f:
        for it in _items(7, n=25):
            f.write(json.dumps(it) + "\n")
        f.write("\n")  # blank lines are skipped
    got = TS.evaluation_metrics(str(path), verbose=True)
    ours = capsys.readouterr().out
    want = JS.evaluation_metrics(str(path), verbose=True)
    assert got == want and ours == capsys.readouterr().out
    assert "Overall Accuracy (OA, stage 2)" in ours and "fallback synonym backend" in ours


def test_cli_eval_writes_the_reference_json(tmp_path, capsys):
    path = tmp_path / "results.jsonl"
    with open(path, "w") as f:
        for it in _items(9, n=30):
            f.write(json.dumps(it) + "\n")
    TCLI.main(["--results_file", str(path), "--json_out", str(tmp_path / "torch.json")])
    JCLI.main(["--results_file", str(path), "--json_out", str(tmp_path / "jax.json")])
    assert open(tmp_path / "torch.json").read() == open(tmp_path / "jax.json").read()
    assert json.load(open(tmp_path / "torch.json"))["n"] == 30
    TCLI.main(["--results_file", str(path)])  # no --json_out: the report only
    assert "Total Samples: 30" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        TCLI.main([])
