"""On the card: each served cell's check, with its control (the reference in fp8) in the
program's place and judged by the cell's own limits, at a size a test run can hold (the
cell's configuration cut to 6 decoder layers and 8 vision blocks, small waves), and
with a token altered where the program produces it. Both have to read correct false.
The cells' own sizes were read with `run.py --control fp8` (PERF.md)."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest

from portbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"qwen3b.lrsgro_pipelined": {"batch": 8, "stage1_new_tokens": 32, "stage2_new_tokens": 24}}


def small_root(tmp: Path, cell: str) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    cfg["num_hidden_layers"], cfg["vision_config"]["depth"] = 6, 8
    cfg["vision_config"]["fullatt_block_indexes"] = [3, 7]
    traffic = json.loads((ROOT / f"portbench/traffic/{w['traffic']}.json").read_text())
    traffic.update(CELLS[cell], check_questions=8)
    for sub in ("configs", "traffic", "cells"):
        (tmp / "portbench" / sub).mkdir(parents=True)
    (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / f"portbench/traffic/{w['traffic']}.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / f"portbench/cells/{cell}.json", tmp / f"portbench/cells/{cell}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp / "BENCHMARK.json"


def run(bench, cell, **kw):
    args = core.parse_args(["--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0",
                            "--benchmark", str(bench)])
    return core.run_cell(args, out=io.StringIO(), err=io.StringIO(), **kw)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check's control runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_fp8_control_fails_the_check_on_the_card(tmp_path, cell, card):
    r = run(small_root(tmp_path, cell), cell, control="fp8")
    assert r["correct"] is False
    for name in set(r["checks"]) - {"missing_questions"}:
        assert r["checks"][name]["value"] > 2 * r["program"][name]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_altered_token_fails_the_check_on_the_card(tmp_path, cell, card):
    r = run(small_root(tmp_path, cell), cell, fault="token")
    assert r["correct"] is False
