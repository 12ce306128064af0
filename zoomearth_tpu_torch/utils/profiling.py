"""The port's tracing: one process-wide tracer of named spans and counters, and a
Chrome trace that holds what it recorded beside torch.profiler's events.

`tracer` is off by default. Off, `tracer.span(name)` hands out one shared no-op
context manager and `tracer.count(name, n)` returns at once: one attribute check and
no allocation, so the program's spans stay in place when nobody traces. `start()` turns
it on with no records and every counter at zero; `stop()` turns it off and keeps the
records until the next `start()`. On, it keeps:

- `spans`: each span's host interval, (name, start, end, thread id) on
  time.perf_counter, appended as the span closes (an inner span before its caller);
- `counters`: each counter's sum since `start()`;
- `device`: for each span opened with device=True on a CUDA device, (name, start, end)
  of the pair of CUDA events recorded around it on the current stream. `stop()` waits
  for the device and puts each pair on the host's perf_counter seconds through an
  origin event recorded right after a synchronize at `start()`, so the host spans, the
  device intervals and any other perf_counter timeline share one clock, to within a
  launch.

While the current stream is being captured into a CUDA graph no event is recorded (it
would become part of the graph); the host interval is kept. On the CPU, or where CUDA
was not initialized at `start()`, device spans are host spans only.

Each span and counter is named for the metric it serves (PERF.md §3). `trace(dir)`
writes a torch.profiler Chrome trace with the tracer on for its block, its spans on a
host track and its device intervals on a "device (CUDA events)" track: the device's
timeline even where the profiler's CUPTI records hold no device activity (PERF.md §3).
`annotate(name)` names a region of the profiler's own trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Tuple


class _Off:
    """The one span handed out while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "device", "start", "event", "run")

    def __init__(self, tracer: "Tracer", name: str, device: bool):
        self.tracer, self.name, self.device, self.run = tracer, name, device, tracer._run

    def __enter__(self):
        self.event = self.tracer._event() if self.device else None
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        end = time.perf_counter()
        tr = self.tracer
        if tr.on and tr._run == self.run:  # not a span left open across stop() / start()
            if self.event is not None:
                last = tr._event()
                if last is not None:
                    tr._pending.append((self.name, self.event, last))
            tr.spans.append((self.name, self.start, end, threading.get_ident()))
        return False


class Tracer:
    """See the module docstring. One instance, `tracer`, serves the process."""

    def __init__(self):
        self.on = False
        self.spans: List[Tuple[str, float, float, int]] = []
        self.device: List[Tuple[str, float, float]] = []
        self.counters: Dict[str, int] = {}
        self._pending = []  # (name, start event, end event) until stop()
        self._origin = None  # (CUDA origin event, its device index, its perf_counter time)
        self._lock = threading.Lock()
        self._run = 0

    def span(self, name: str, device: bool = False):
        """A context manager timing its block as `name`; with device=True, also the
        device work the block enqueues on the current stream."""
        if not self.on:
            return _OFF
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def start(self) -> None:
        import torch

        self.stop()
        self.spans, self.device, self.counters, self._pending = [], [], {}, []
        self._run += 1
        self._origin = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            self._origin = (origin, torch.cuda.current_device(), time.perf_counter())
        self.on = True

    def stop(self) -> None:
        """Turn the tracer off; its device intervals are resolved (a synchronize)."""
        if not self.on:
            return
        self.on = False
        if self._origin is not None:
            import torch

            origin, _, t0 = self._origin
            torch.cuda.synchronize()
            self.device = [(n, t0 + origin.elapsed_time(a) / 1e3, t0 + origin.elapsed_time(b) / 1e3)
                           for n, a, b in self._pending]
        self._pending = []

    def _event(self):
        """A timing event recorded on the current stream, or None: no CUDA origin, another
        device than the origin's, or a stream being captured."""
        if self._origin is None:
            return None
        import torch

        if torch.cuda.current_device() != self._origin[1] or torch.cuda.is_current_stream_capturing():
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e


tracer = Tracer()

_ANCHOR = "zoomearth_tpu_torch.tracer.anchor"
_DEVICE_TID = 2 ** 31 - 1  # the tracer's tracks in the trace: ids no OS thread takes


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block (host ops, and the CUDA
    device's kernels where CUPTI delivers them) with the tracer on, and write both to
    `<log_dir>/trace-<pid>-<ns>.json` as one Chrome trace (chrome://tracing, Perfetto).
    The tracer starts from empty records for the block and is off after it. Yields the
    profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracer.start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(2):  # the first entry warms the profiler's path up, the second places the tracer
                before = time.perf_counter()
                with torch.profiler.record_function(_ANCHOR):
                    anchor = (before + time.perf_counter()) / 2
            yield prof
    finally:
        tracer.stop()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _tracer_events(doc["traceEvents"], anchor)
    with open(path, "w") as f:
        json.dump(doc, f)


def _tracer_events(events, anchor: float) -> list:
    """The tracer's records as Chrome trace events, placed by the last anchor region
    (opened at perf_counter `anchor`) in the profiler's own events."""
    base = max(e["ts"] for e in events if e.get("name") == _ANCHOR)

    def us(t):
        return base + (t - anchor) * 1e6

    pid = os.getpid()
    threads = {}
    for _, _, _, ident in tracer.spans:
        threads.setdefault(ident, _DEVICE_TID - 1 - len(threads))
    out = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": f"host (tracer) {ident}"}}
           for ident, tid in threads.items()]
    out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": _DEVICE_TID,
                "args": {"name": "device (CUDA events)"}})
    out += [{"name": n, "cat": "tracer", "ph": "X", "pid": pid, "tid": threads[ident], "ts": us(a),
             "dur": (b - a) * 1e6} for n, a, b, ident in tracer.spans]
    out += [{"name": n, "cat": "tracer", "ph": "X", "pid": pid, "tid": _DEVICE_TID, "ts": us(a),
             "dur": (b - a) * 1e6} for n, a, b in tracer.device]
    return out


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a torch.profiler trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
