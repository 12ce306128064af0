"""Each traffic driver end to end on the tiny configurations through the port's plain
CPU paths: the result line's shape, a correct run, and a planted fault that the
check catches."""

from __future__ import annotations

import json

import pytest

from .helpers import CELLS, EVAL, bench_root, run

E2E = {"tiny.lrsgro": "questions_per_s"}
HOST = {"tiny.lrsgro": "host_prep_share.eval"}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_prints_one_result_line(tmp_path, cell, trace):
    result, out, err = run(bench_root(tmp_path), cell, trace=trace)
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    names = set(line["metrics"])
    if trace:
        assert HOST[cell] in names
        assert cell not in EVAL or "decode_step_ms.eval" in names
        # device numbers are never written from a CPU run
        assert not {n for n in names if n.split(".")[0] in ("vision_share", "attn_roofline", "idle_share", "mfu",
                                                             "peak_mem_gib")}
    else:
        assert names == {E2E[cell], "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    # every number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "(limit " in t for t in tail)


@pytest.mark.parametrize("cell", EVAL)
@pytest.mark.parametrize("number", ["max_logit_gap", "mean_logit_gap"])
def test_an_altered_token_makes_the_run_incorrect(tmp_path, cell, number):
    bench = bench_root(tmp_path)
    (tmp_path / f"portbench/cells/{cell}.json").write_text(json.dumps({"limits": {number: 1e-3}}))
    result, _, _ = run(bench, cell, fault="token")
    assert result["correct"] is False
    assert set(result["checks"]) == {"missing_questions", number}
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


@pytest.mark.parametrize("cell", EVAL)
def test_the_fp8_control_in_the_programs_place_makes_the_run_incorrect(tmp_path, cell):
    """The control is judged by the cell's own limits, not merely printed beside them."""
    result, out, err = run(bench_root(tmp_path), cell, control="fp8")
    assert result["correct"] is False and result["control"] == "fp8"
    assert result["checks"]["max_logit_gap"]["value"] > result["checks"]["max_logit_gap"]["limit"]
    assert result["program"]["max_logit_gap"] <= result["checks"]["max_logit_gap"]["limit"]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False
    assert "check max_logit_gap" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_same_seed_gives_the_same_inputs(tmp_path, cell):
    """Inputs hang on the seed and their index alone, so a window of another length
    (it follows the warm-up's time) holds the same first questions and tiles."""
    import numpy as np
    import torch

    from portbench.harness.core import Cell
    from portbench.harness.spans import Spans

    bench = bench_root(tmp_path)

    def inputs(seed):
        d = Cell(bench, cell).driver().Driver(Cell(bench, cell), seed=seed, device=torch.device("cpu"),
                                             spans=Spans(False))
        items = d.questions(7, 0)
        d.tiles = {}
        d.add_tiles(n for _, n, _ in items)
        return [(s.question, n, b) for s, n, b in items], [np.asarray(t) for t in d.tiles.values()]

    a, ta = inputs(2 ** 31 + 11)
    b, tb = inputs(2 ** 31 + 11)
    c, _ = inputs(2 ** 31 + 12)
    assert a == b and a != c
    assert all((x == y).all() for x, y in zip(ta, tb))


def test_a_cell_made_of_new_files_runs_without_an_edit(tmp_path):
    """A new traffic mix (data only) and a new per-layer metric (a reader file) beside a
    BENCHMARK.json the harness has not seen."""
    bench = bench_root(tmp_path, extra_metrics=("questions_in_window.test",))
    spec = json.loads(bench.read_text())
    mix = json.loads((tmp_path / "portbench/traffic/lrsgro_tiny.json").read_text())
    mix["stage2_new_tokens"] = 2
    (tmp_path / "portbench/traffic/lrsgro_short2.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": "tiny.short2", "config": "qwen2_5_vl_tiny", "traffic": "lrsgro_short2",
                              "chips": 1, "why": "test only"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.lrsgro" in m.get("workloads", ()):
            m["workloads"].append("tiny.short2")
    bench.write_text(json.dumps(spec))
    (tmp_path / "portbench/cells/tiny.short2.json").write_text('{"limits": {"max_logit_gap": 0.001}}')
    (tmp_path / "portbench/metrics/questions_in_window.test.py").write_text(
        "def read(ctx):\n    return float(ctx.run.attempted)\n")
    result, _, _ = run(bench, "tiny.short2", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["questions_in_window.test"]["value"] == result["attempted"]


def test_the_warm_up_tiles_give_the_windows_shapes():
    """The cell's warm-up wave runs on smaller tiles: each stage's image grid and prompt
    length come out as the window's 5000 px tiles give them."""
    from portbench.harness.core import PACKAGE, load_json
    from portbench.reference.zoom_episode import sequences

    class Size:
        def __init__(self, px):
            self.size = (px, px)

    cfg = load_json(PACKAGE / "configs" / "qwen2_5_vl_3b.json")
    t = load_json(PACKAGE / "traffic" / "lrsgro_pipelined.json")
    assert t["warmup_tile_px"] < t["tile_px"]

    def shapes(px, bbox):
        ids1, ids2, images, kept = sequences(cfg, t, Size(px), "q" * t["question_bytes"], bbox, [40] * 5, [41] * 3,
                                             pixels=False)
        return len(ids1), len(ids2), [g for _, g in images], kept

    for side in t["bbox_side_px"]:
        bbox = [7, 9, 7 + side, 9 + side]
        assert shapes(t["warmup_tile_px"], bbox) == shapes(t["tile_px"], bbox)
