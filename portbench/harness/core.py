"""One run of one cell: find its parts by name, set up, measure, check, print one line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by the names in BENCHMARK.json:

- its configuration, the JSON file that `configs[].file` names; the file's `family`
  picks the adapter in `portbench/families/<family>.py`, which builds the program's
  config and parameter tree from the file and names the plain reference;
- its traffic mix, `portbench/traffic/<traffic>.json`, a data file whose `driver`
  picks the generator in `portbench/drivers/<driver>.py`, which builds the inputs from
  the seed, drives the program's entry over the window and checks what it produced;
- its limits, `portbench/cells/<cell>.json`: each compared number's limit and the
  readings it was set from;
- each per-layer metric, a reader in `portbench/metrics/<metric>.py`.

Files are looked up beside the BENCHMARK.json in use first and in this package second,
so a cell made of new files needs no edit to any file here.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

PACKAGE = Path(__file__).resolve().parents[1]  # portbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "zoomearth_tpu")  # top-level module names, compared whole
H100_BF16_FLOPS = 989e12  # dense bf16, SXM, 700 W (NVIDIA's data sheet)
H100_HBM_BYTES = 3.35e12


class RunError(RuntimeError):
    """A run that cannot report: the message goes to stderr and the exit code is 2."""


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux /proc), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + start / ticks
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_file(root: Path, rel: str) -> Path:
    """`rel` beside the benchmark file in use, else in this package."""
    for base in (root, PACKAGE.parent):
        p = base / rel
        if p.is_file():
            return p
    raise RunError(f"no file {rel} under {root} or {PACKAGE.parent}")


def load_module_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as BENCHMARK.json and its files describe it."""

    def __init__(self, bench_path: Path, workload: str):
        self.root = bench_path.parent
        bench = load_json(bench_path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise RunError(f"no workload {workload!r} in {bench_path}")
        self.spec = cells[workload]
        self.name = workload
        self.chips = int(self.spec["chips"])
        config = next(c for c in bench["configs"] if c["name"] == self.spec["config"])
        self.config = load_json(find_file(self.root, config["file"]))
        self.traffic = load_json(find_file(self.root, f"portbench/traffic/{self.spec['traffic']}.json"))
        limits = self.root / f"portbench/cells/{workload}.json"
        if not limits.is_file():
            limits = PACKAGE / "cells" / f"{workload}.json"
        self.limits = load_json(limits)["limits"] if limits.is_file() else {}

        def listed(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if listed(m)]
        self.per_layer = [m for m in bench["per_layer"] if listed(m)]

    def family(self):
        return importlib.import_module(f"portbench.families.{self.config['family']}")

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str) -> Callable:
        path = find_file(self.root, f"portbench/metrics/{metric}.py")
        return load_module_file(path, "portbench_metric_" + metric.replace(".", "_")).read


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def metric_line(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def run_cell(args, *, require_cuda: bool = True, fault: Optional[str] = None,
             control: Optional[str] = None, out=sys.stdout, err=sys.stderr) -> dict:
    """One run; returns the result line's object (also printed as the last stdout line).
    require_cuda=False runs on the CPU (the tests' tiny cells); fault plants one of the
    driver's faults into the timed path (the tests of the check); control puts the
    reference in that precision in the program's place for the check, which judges it
    by the cell's limits, so a sound control run reads correct false (the program's own
    readings are printed beside, under "program")."""
    started = process_start_time()
    cell = Cell(Path(args.benchmark), args.workload)
    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} CUDA device(s); "
                           f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                           f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    from .spans import Spans

    spans = Spans(enabled=bool(args.trace))
    if args.trace:
        from .trace import EventTimeline

        spans.timeline = EventTimeline(device)
    run = cell.driver().Driver(cell, seed=int(args.seed), device=device, spans=spans, fault=fault)
    run.setup(float(args.seconds))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if spans.timeline is not None:
        spans.timeline.start()
    setup_s = time.time() - started
    with spans.span("window"):
        window = run.measure()  # (t0, t1) on time.perf_counter, the device's work waited for
    trace = spans.timeline.stop() if spans.timeline is not None else None
    window_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    dev = device_info(device, cell.chips)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package loaded in the run: {found}")
    run.release()  # the program's state goes before the reference runs
    checks = run.check(control=control)

    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.attempted, "failed": run.failed}
    if args.trace:
        ctx = Context(cell, run, spans, trace, window, window_peak, device)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = metric_line(value, m["unit"])
        if trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
            result["breakdown"] = trace.breakdown(spans)
    else:
        values = dict(run.end_to_end(window))
        values["setup_s"] = setup_s
        metrics = {m["name"]: metric_line(values[m["name"]], m["unit"]) for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    if getattr(run, "readings", None):
        result["readings"] = run.readings
    if control is not None:
        result["control"] = control
        result["program"] = run.program_readings
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package loaded in the run: {found}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    print(json.dumps(result), file=out)
    out.flush()
    return result


class Context:
    """What a per-layer metric's reader reads: the cell, the driver's counts and
    records, the benchmark's spans, the device trace (None where none was taken),
    the window (t0, t1) and the peak allocated in it."""

    def __init__(self, cell, run, spans, trace, window, window_peak, device):
        self.cell, self.run, self.spans, self.trace = cell, run, spans, trace
        self.window, self.window_peak, self.device = window, window_peak, device

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--benchmark", default="BENCHMARK.json", help="the benchmark file (default: ./BENCHMARK.json)")
    p.add_argument("--control", default=None,
                   help="judge the check's control, the reference in this precision (fp8), in the program's place; "
                        "not part of a benchmark run")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        run_cell(args, control=args.control)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    return 0
