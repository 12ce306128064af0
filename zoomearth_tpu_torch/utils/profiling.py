"""Tracing/profiling: torch.profiler trace capture + per-phase step timers (port of
utils/profiling.py).

The reference has essentially no profiling (SURVEY.md §5.1 — tqdm only, HF FLOPs
estimate disabled). Here: `trace(dir)` wraps a block in a torch.profiler trace written
as a Chrome trace (chrome://tracing, Perfetto), `annotate(name)` names a region inside
it, and `PhaseTimer` accumulates wall-time per pipeline phase (prefill / decode / crop
/ reward — the north-star breakdown).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block (host ops, and the CUDA
    device's kernels when one is in use) and write it to
    `<log_dir>/trace-<pid>-<ns>.json` as a Chrome trace. Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a torch.profiler trace."""
    import torch

    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Accumulate wall-clock per phase; thread-safe enough for the loader pattern
    (each phase is timed on one thread)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        """Time the enclosed block. sync: wait for the CUDA device at its end, so that
        device work launched in the phase is attributed to it (nothing to wait for when
        no CUDA device is in use)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                import torch

                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(self.counts[name], 1), 4),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
