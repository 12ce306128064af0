"""The Kimi-VL driver (portbench/drivers/lrsgro_episodes_kimivl.py) end to end on a tiny
Kimi-VL configuration through the port's plain CPU paths: a correct run, a token
altered where the program produces it, and the fp8 control in the program's place,
judged by the cell's limits; the traced run's metrics and the program tracer's MoE and
MLA spans and counters. Its data lives in tests/data (kimi_vl_tiny.json,
lrsgro_tiny_kimivl.json)."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny.kimivl"
METRICS = ("host_prep_share.eval", "decode_step_ms.eval", "mla_roofline.eval", "moe_roofline.eval")


def bench_root(tmp: Path, limits=None) -> Path:
    """tmp/BENCHMARK.json with the one tiny Kimi-VL cell and its files."""
    for sub in ("configs", "traffic", "cells"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy(DATA / "kimi_vl_tiny.json", tmp / "portbench/configs/kimi_vl_tiny.json")
    shutil.copy(DATA / "lrsgro_tiny_kimivl.json", tmp / "portbench/traffic/lrsgro_tiny_kimivl.json")
    (tmp / f"portbench/cells/{CELL}.json").write_text(json.dumps({"limits": limits or {"max_logit_gap": 1e-3}}))
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
        "configs": [{"name": "kimi_vl_tiny", "source": "test only", "file": "portbench/configs/kimi_vl_tiny.json",
                     "reduced": [], "why": "test only"}],
        "workloads": [{"name": CELL, "config": "kimi_vl_tiny", "traffic": "lrsgro_tiny_kimivl", "chips": 1,
                       "why": "test only"}],
        "end_to_end": [{"name": "questions_per_s", "unit": "questions/s", "better": "higher", "bound": 0.1,
                        "source": "host_clock", "workloads": [CELL]},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": m, "unit": "%", "better": "lower", "source": "program_span", "layer": "test",
                       "moves": "questions_per_s", "workloads": [CELL]} for m in METRICS],
    }
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run(bench: Path, *, trace: int = 0, fault=None, control=None, seed: int = 2 ** 31 + 11):
    from portbench.harness import core

    args = core.parse_args(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace),
                            "--benchmark", str(bench)])
    out, err = io.StringIO(), io.StringIO()
    return core.run_cell(args, require_cuda=False, fault=fault, control=control, out=out, err=err), out.getvalue()


def test_a_sound_run_is_correct(tmp_path):
    result, out = run(bench_root(tmp_path))
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"questions_per_s", "setup_s"}
    assert result["checks"]["max_logit_gap"]["value"] <= 1e-4


def test_an_altered_token_makes_the_run_incorrect(tmp_path):
    result, _ = run(bench_root(tmp_path), fault="token")
    assert result["correct"] is False
    assert result["checks"]["max_logit_gap"]["value"] > result["checks"]["max_logit_gap"]["limit"]


def test_the_fp8_control_in_the_programs_place_makes_the_run_incorrect(tmp_path):
    result, _ = run(bench_root(tmp_path), control="fp8")
    assert result["correct"] is False and result["control"] == "fp8"
    assert result["checks"]["max_logit_gap"]["value"] > result["checks"]["max_logit_gap"]["limit"]
    assert result["program"]["max_logit_gap"] <= result["checks"]["max_logit_gap"]["limit"]


def test_a_traced_run_reports_the_program_tracers_moe_and_mla_spans(tmp_path):
    """On the CPU no device metric is written; the host metrics are, and the program's
    tracer reports the MoE and MLA spans and counters of the window."""
    result, _ = run(bench_root(tmp_path), trace=1)
    assert result["correct"] is True
    assert {"host_prep_share.eval", "decode_step_ms.eval"} <= set(result["metrics"])
    assert not {"mla_roofline.eval", "moe_roofline.eval"} & set(result["metrics"])
    tr = result["readings"]["tracer"]
    assert {"moe.route", "moe.experts", "mla.expand"} <= set(tr["spans"])
    assert tr["counters"]["moe.tokens_routed"] > 0 and tr["counters"]["moe.experts_touched"] > 0


@pytest.mark.parametrize("kernel", ["K5", "K2", "MoE", "K1"])
def test_the_recorders_bounds_read_each_kimi_kernel(kernel):
    """The recorder's bounds come from the frozen work counts of portbench/work/kimi_vl.py,
    at the live widths: K1 at MoonViT's head width 72 where it ran at 80, K2's shared
    k_r once a slot."""
    import torch

    from portbench.drivers.lrsgro_episodes_kimivl import KimiLaunchRecorder
    from portbench.work import attention as A
    from portbench.work import kimi_vl as K

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs/kimi_vl_a3b.json").read_text())
    rec = KimiLaunchRecorder(timeline=None, cfg=cfg)
    seg = torch.arange(2, dtype=torch.int32).repeat_interleave(1296)
    args = {"K5": (torch.tensor([1000, 500]), 1536, 16, 576),
            "K2": (torch.arange(64)[None], torch.tensor([64]), 16, 16, 192, 128, 128, 2, 2),
            "MoE": (torch.tensor([3, 3, 10], dtype=torch.int32), 2048, 1408),
            "K1": (seg, 16, 80, 2)}[kernel]
    rec.records.append((kernel, args))
    f, b = {"K5": lambda: K.mla_decode_work(args[0], 1536, 16, 576, 512),
            "K2": lambda: K.mla_prefill_work(args[0], args[1], 16, 16, 192, 128, 128, 64),
            "MoE": lambda: K.grouped_work(args[0], 2048, 1408),
            "K1": lambda: A.segment_work(seg, 16, 72, 2)}[kernel]()
    assert rec.bounds(1e12, 1e9)[kernel] == pytest.approx(max(f / 1e12, b / 1e9))
    if kernel == "K5":
        assert f == 16 * 1500 * 1088 * 2 and b == 1500 * 576 * 2 + 2 * 2 * 16 * 1088
    if kernel == "K2":  # 64 queries and 64 slots: q and out per head, k_n and v per head, k_r once
        assert f == 2 * 16 * 320 * (64 * 65 // 2) and b == 2 * (64 * 16 * 320 + 64 * (16 * 256 + 64))
    if kernel == "MoE":
        assert b == 2 * (2 * 2048 * 1408 + 10 * (2048 + 1408))  # two touched experts' weights
    if kernel == "K1":
        assert f == 4 * 72 * 16 * 2 * 1296 ** 2 and b == 4 * 2592 * 16 * 72 * 2
