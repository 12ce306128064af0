"""The device timeline of a traced run (`--trace 1`), from CUDA events.

The profiler on the card records the host's CUDA runtime calls but no device activity
(CUPTI's kernel records never arrive there), so the device side is timed with CUDA
events on the stream the program runs on, paired as intervals:

- each graph replay (`runtime.graphs.CapturedStep.replay`, the decode steps): the
  graph's kernels run back to back, so the interval is busy time;
- each decode call's first step, which runs eagerly (the graph is captured at the
  second; a capture runs nothing on the device, so its host time is rightly idle);
- each eager launch of K1, K2 and K3 (every K1 and K2 launch; K3 in the first, eager
  step of each decode call): that kernel's device time;
- each benchmark span the driver names as device work (the vision tower, the
  prefills): busy time.

Busy time is the union of replays, eager steps and device spans. Every kernel of the
model's work lies inside one of them; outside stay only small copies and the decode
loop's all-done checks. Waits for the host inside an eager step or a span count as
busy. So the busy time is an upper bound and the idle share a lower one.

A timestamp is an event's elapsed time from the window's first event, recorded after
a synchronize, so device time and host time (perf_counter from the window's start)
share an origin to within a launch.
"""

from __future__ import annotations

import collections
import time
from typing import List, Tuple


class EventTimeline:
    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = device
        self.cuda = device.type == "cuda"
        self._events = []  # (kind, name, start event, end event)
        self.t0_host = None

    def _event(self):
        e = self._torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        if self.cuda:
            self._torch.cuda.synchronize(self.device)
            self._origin = self._event()
        self.t0_host = time.perf_counter()

    def timing(self) -> bool:
        """Whether intervals are timed now: on CUDA, outside a graph capture."""
        return self.cuda and self.t0_host is not None and not self._torch.cuda.is_current_stream_capturing()

    def begin(self, kind: str, name: str):
        """Opens an interval; returns a token for `end` (None where nothing is timed)."""
        return (kind, name, self._event()) if self.timing() else None

    def end(self, token):
        if token is not None:
            self._events.append((token[0], token[1], token[2], self._event()))

    def stop(self) -> "Timeline":
        if self.cuda:
            self._torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0_host
        ivs = [(kind, name, self._origin.elapsed_time(a) / 1e3, self._origin.elapsed_time(b) / 1e3)
               for kind, name, a, b in self._events]
        return Timeline(ivs, window_s, self.t0_host)


class Timeline:
    """Device intervals (kind, name, start s, end s) from the window's origin; kind is
    "replay", "eager", "span" or "kernel"."""

    def __init__(self, intervals, window_s: float, t0_host: float):
        self.intervals = intervals
        self.window_s = window_s
        self.t0_host = t0_host

    def union(self, pick=None) -> List[Tuple[float, float]]:
        if pick is None:
            pick = lambda k, n: k in ("replay", "eager", "span")  # noqa: E731 (kernels lie inside these)
        ivs = sorted((max(a, 0.0), min(b, self.window_s)) for k, n, a, b in self.intervals if pick(k, n))
        merged: List[List[float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union())

    def seconds(self, pick) -> float:
        return sum(b - a for a, b in self.union(pick))

    def gaps(self, spans) -> List[Tuple[float, str]]:
        """Idle stretches of the device: (seconds, the benchmark span open on the host at its middle)."""
        out, prev = [], 0.0
        for a, b in self.union() + [(self.window_s, self.window_s)]:
            if a > prev:
                out.append((a - prev, spans.open_at(self.t0_host + (prev + a) / 2) or "none"))
            prev = max(prev, b)
        return out

    def breakdown(self, spans) -> dict:
        by = collections.Counter()
        by["graph replays (decode steps)"] = self.seconds(lambda k, n: k == "replay")
        for kind, name in {(k, n) for k, n, _, _ in self.intervals if k != "replay"}:
            by[name] = self.seconds(lambda k, n: k == kind and n == name)
        gaps = sorted(self.gaps(spans), reverse=True)[:10]
        return {"device_ops": [[n, s] for n, s in by.most_common(10) if s > 0],
                "idle_gaps": [[n, s] for s, n in gaps]}
