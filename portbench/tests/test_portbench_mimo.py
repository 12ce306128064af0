"""The MiMo-V2.5 driver (portbench/drivers/lrsgro_episodes_mimo.py) end to end on a tiny
MiMo-V2.5 configuration (both attention kinds, a window of 8 with sinks, 16 routed
experts of which this device holds 8) through the port's plain CPU paths: a correct run,
a token altered where the program produces it, and the fp8 control in the program's
place, judged by the cell's limits; the traced run's metrics and the program tracer's
window and expert spans and counters; the recorder's bounds for each new kernel form;
the reference against the program. Its data lives in tests/data (mimo_v2_tiny.json,
lrsgro_tiny_mimo.json)."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny.mimo"
METRICS = ("host_prep_share.eval", "decode_step_ms.eval", "moe_roofline.eval", "swa_roofline.eval",
           "gqa16_roofline.eval", "mla_roofline.eval")
# fp32 on both sides: the served tokens' gaps are rounding (1e-6); fp8 moves them by tenths
LIMITS = {"max_logit_gap": 1e-3, "routes_outside_margin": 0}


def bench_root(tmp: Path, limits=None, margin: float = 0.02) -> Path:
    """tmp/BENCHMARK.json with the one tiny MiMo-V2.5 cell and its files."""
    for sub in ("configs", "traffic", "cells"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy(DATA / "mimo_v2_tiny.json", tmp / "portbench/configs/mimo_v2_tiny.json")
    shutil.copy(DATA / "lrsgro_tiny_mimo.json", tmp / "portbench/traffic/lrsgro_tiny_mimo.json")
    (tmp / f"portbench/cells/{CELL}.json").write_text(json.dumps({"limits": dict(limits or LIMITS,
                                                                             route_margin=margin)}))
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
        "configs": [{"name": "mimo_v2_tiny", "source": "test only", "file": "portbench/configs/mimo_v2_tiny.json",
                     "reduced": [], "why": "test only"}],
        "workloads": [{"name": CELL, "config": "mimo_v2_tiny", "traffic": "lrsgro_tiny_mimo", "chips": 1,
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


def run(bench: Path, *, trace: int = 0, fault=None, control=None, seed: int = 2 ** 31 + 13):
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
    assert result["checks"]["routes_outside_margin"] == {"value": 0, "limit": 0}
    assert result["readings"]["route_margin"] == 0.02


# the widest gap, or the mean gap as the cell's file holds it (both of fp32 rounding here)
GAP_LIMITS = [("max_logit_gap", 1e-3), ("mean_logit_gap", 1e-4)]


@pytest.mark.parametrize("gap,limit", GAP_LIMITS)
def test_an_altered_token_makes_the_run_incorrect(tmp_path, gap, limit):
    result, _ = run(bench_root(tmp_path, limits={gap: limit, "routes_outside_margin": 0}), fault="token")
    assert result["correct"] is False
    assert result["checks"][gap]["value"] > result["checks"][gap]["limit"]


@pytest.mark.parametrize("gap,limit", GAP_LIMITS)
def test_the_fp8_control_in_the_programs_place_makes_the_run_incorrect(tmp_path, gap, limit):
    result, _ = run(bench_root(tmp_path, limits={gap: limit, "routes_outside_margin": 0}), control="fp8")
    assert result["correct"] is False and result["control"] == "fp8"
    assert result["checks"][gap]["value"] > result["checks"][gap]["limit"]
    assert result["program"][gap] <= result["checks"][gap]["limit"]


def test_choices_outside_the_margin_make_the_run_incorrect(tmp_path):
    """A margin of -1 follows no choice that differs: the fp8 control's own routing,
    which differs from fp32's somewhere, is then counted outside and fails by itself."""
    result, _ = run(bench_root(tmp_path, limits={"max_logit_gap": 1e9, "routes_outside_margin": 0}, margin=-1.0),
                    control="fp8")
    assert result["correct"] is False
    assert result["checks"]["routes_outside_margin"]["value"] > 0


def test_a_held_range_fault_in_the_decode_steps_alone_makes_the_run_incorrect(tmp_path, monkeypatch):
    """A planted routing fault in the served decode steps only: each held pick is served
    by the next held expert's weights. The teacher-forced pass whose choices the
    reference follows runs the whole sequence at once and never meets it, so the routing
    count stays 0; the served tokens' mean gap, at the cell's form of the limits, fails
    the run."""
    from zoomearth_tpu_torch.models import moe

    forward = moe.moe_forward

    def faulty(p, cfg, x):
        if x.dim() == 3 and x.shape[1] == 1:  # a decode step: one new token a row
            p = dict(p, **{name: p[name].roll(1, 0) for name in ("wg", "wu", "wd")})
        return forward(p, cfg, x)

    monkeypatch.setattr(moe, "moe_forward", faulty)
    result, _ = run(bench_root(tmp_path, limits={"mean_logit_gap": 1e-4, "routes_outside_margin": 0}))
    assert result["correct"] is False
    assert result["checks"]["mean_logit_gap"]["value"] > 1e-4
    assert result["checks"]["routes_outside_margin"]["value"] == 0


def test_a_traced_run_reports_the_program_tracers_window_and_expert_spans(tmp_path):
    """On the CPU no device metric is written; the host metrics are, and the program's
    tracer reports the window layers' span and keys, and the held and absent picks."""
    result, _ = run(bench_root(tmp_path), trace=1)
    assert result["correct"] is True
    assert {"host_prep_share.eval", "decode_step_ms.eval"} <= set(result["metrics"])
    assert not {"moe_roofline.eval", "swa_roofline.eval", "gqa16_roofline.eval", "mla_roofline.eval"} & set(
        result["metrics"])
    tr = result["readings"]["tracer"]
    assert {"moe.route", "moe.experts", "attn.window"} <= set(tr["spans"])
    c = tr["counters"]
    assert c["attn.window_keys"] > 0 and c["moe.tokens_routed"] > 0 and c["moe.experts_touched"] > 0
    assert c["moe.picks_held"] > 0 and c["moe.picks_elsewhere"] > 0
    assert c["moe.picks_held"] + c["moe.picks_elsewhere"] == 4 * c["moe.tokens_routed"]  # top 4


@pytest.mark.parametrize("kernel", ["SWA-prefill", "SWA-decode", "GQA16", "K2", "MoE"])
def test_the_recorders_bounds_read_each_new_kernel_form(kernel):
    """The recorder's bounds come from the frozen work counts of portbench/work/mimo_v2.py:
    a window layer's K2 over the keys inside its band, K6 over the window's slots or all
    of a global layer's, the held experts' grouped products."""
    import torch

    from portbench.drivers.lrsgro_episodes_mimo import MiMoLaunchRecorder
    from portbench.work import mimo_v2 as M

    from portbench.work import kimi_vl as K

    rec = MiMoLaunchRecorder(timeline=None)
    name, form, args = {
        "SWA-prefill": ("SWA", "attention", (torch.arange(300)[None], torch.tensor([300]), 64, 8, 192, 128, 300, 128)),
        "SWA-decode": ("SWA", "decode", (torch.tensor([1000, 50]), 1280, 64, 8, 192, 128, 128)),
        "GQA16": ("GQA16", "decode", (torch.tensor([1000, 50]), 1280, 64, 4, 192, 128, 0)),
        "K2": ("K2", "attention", (torch.arange(300)[None], torch.tensor([300]), 64, 4, 192, 128, 300, 0)),
        "MoE": ("MoE", "grouped", (torch.tensor([3, 3, 10], dtype=torch.int32), 4096, 2048)),
    }[kernel]
    rec.records.append((name, (form,) + args))
    if kernel == "SWA-prefill":  # 300 queries: keys 1..128 for the first 128, then 128 each
        f, b = M.attention_work(*args)
        assert f == 2 * 64 * 320 * (128 * 129 // 2 + 172 * 128) and b == 2 * (300 * 64 * 320 + 300 * 8 * 320)
    elif kernel == "K2":
        f, b = M.attention_work(*args)
        assert f == 2 * 64 * 320 * (300 * 301 // 2)
    elif kernel == "MoE":
        f, b = K.grouped_work(*args)
        assert b == 2 * (2 * 4096 * 2048 + 10 * (4096 + 2048))  # two touched experts' weights
    else:
        f, b = M.decode_work(*args)
        live = 128 + 50 if kernel == "SWA-decode" else 1050
        Hkv = args[3]
        assert f == 2 * 64 * 320 * live and b == 2 * (live * Hkv * 320 + 2 * 64 * 320)
    assert rec.bounds(1e12, 1e9)[name] == pytest.approx(max(f / 1e12, b / 1e9))


def test_model_flops_count_the_window_and_the_held_share():
    """A window layer's pairs stop at its window; a routed layer counts k x held / router
    width experts a token (1 of 8 here, as in the cell)."""
    from portbench.work import mimo_v2 as M

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs/mimo_v2_5.json").read_text())
    assert M._pairs(300, 0, 128) == 128 * 129 // 2 + 172 * 128 and M._pairs(1, 999, 128) == 128
    one = dict(cfg, num_hidden_layers=2)  # a dense global layer and a routed window layer
    E, V = 4096, cfg["vocab_size"]
    attn_g = E * (64 * 192 + 4 * 320) + 64 * 128 * E
    attn_w = E * (64 * 192 + 8 * 320) + 64 * 128 * E
    per_token = attn_g + 3 * E * 16384 + attn_w + E * 256 + 1 * 3 * E * 2048
    assert M.decoder_pass(one, 1, 999, 1) == 2 * per_token + 2 * 64 * 320 * (1000 + 128) + 2 * E * V
