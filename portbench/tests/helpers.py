"""A benchmark directory the harness has not seen: a BENCHMARK.json of test-only
cells over the tiny configurations in tests/data, written into a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"

CELLS = {"tiny.lrsgro": ("qwen2_5_vl_tiny", "lrsgro_tiny")}
EVAL = ["tiny.lrsgro"]
EVAL_METRICS = ("host_prep_share.eval", "decode_step_ms.eval", "vision_share.eval", "attn_roofline.eval",
                "idle_share.eval", "mfu.eval", "peak_mem_gib.eval")
LIMITS = {"tiny.lrsgro": {"max_logit_gap": 1e-3}}


def bench_root(tmp: Path, extra_metrics=()) -> Path:
    """Writes tmp/BENCHMARK.json and the tiny cells' files; returns the file's path."""
    for sub in ("configs", "traffic", "cells", "metrics"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    configs, workloads = {}, []
    for cell, (config, traffic) in CELLS.items():
        shutil.copy(DATA / f"{config}.json", tmp / "portbench" / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json", tmp / "portbench" / "traffic" / f"{traffic}.json")
        (tmp / "portbench" / "cells" / f"{cell}.json").write_text(json.dumps({"limits": LIMITS[cell]}))
        configs[config] = {"name": config, "source": "test only", "file": f"portbench/configs/{config}.json",
                           "reduced": [], "why": "test only"}
        workloads.append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "test only"})
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
        "configs": list(configs.values()), "workloads": workloads,
        "end_to_end": [{"name": "questions_per_s", "unit": "questions/s", "better": "higher", "bound": 0.1,
                        "source": "host_clock", "workloads": EVAL},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": m, "unit": "%", "better": "lower", "source": "program_span", "layer": "test",
                       "moves": "questions_per_s", "workloads": list(EVAL)} for m in EVAL_METRICS + tuple(extra_metrics)],
    }
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run(bench: Path, cell: str, *, trace: int = 0, seed: int = 2 ** 31 + 5, fault=None, control=None):
    import io

    from portbench.harness import core

    args = core.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace),
                            "--benchmark", str(bench)])
    out, err = io.StringIO(), io.StringIO()
    result = core.run_cell(args, require_cuda=False, fault=fault, control=control, out=out, err=err)
    return result, out.getvalue(), err.getvalue()
