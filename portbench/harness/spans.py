"""The benchmark's own spans, recorded around the calls it makes into the program
(the program has none of its own yet).

A span is (name, start, end) on time.perf_counter, kept in memory. A span whose name
is in `device_spans` is also an interval of the device timeline (harness/trace.py).
With tracing off, `wrap` leaves the program untouched: the end-to-end metrics are
measured without instrumentation.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import List, Tuple


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: List[Tuple[str, float, float]] = []
        self.timeline = None  # the device timeline of a traced window
        self.device_spans = set()  # span names timed on it
        self._patched = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        tl = self.timeline
        token = tl.begin("span", name) if tl is not None and name in self.device_spans else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if token is not None:
                tl.end(token)
            self.records.append((name, t0, time.perf_counter()))

    def open_at(self, t: float) -> str:
        """The innermost span open at perf_counter time t ('' for none)."""
        open_ = [(b - a, n) for n, a, b in self.records if a <= t < b and n != "window"]
        return min(open_)[1] if open_ else ""

    def wrap(self, owner, attr: str, name: str):
        """Replace owner.attr by a function that runs it inside span `name` (tracing
        on only); `unwrap` puts every replaced attribute back."""
        if not self.enabled:
            return
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self._patched.append((owner, attr, owner.__dict__.get(attr, None) if hasattr(owner, "__dict__") else None))
        setattr(owner, attr, spanned)

    def unwrap(self):
        for owner, attr, old in reversed(self._patched):
            if old is None:
                try:
                    delattr(owner, attr)
                except AttributeError:
                    pass
            else:
                setattr(owner, attr, old)
        self._patched.clear()

    def total(self, names, t0: float, t1: float) -> float:
        """Seconds in [t0, t1] covered by any span named in `names` (overlaps counted once)."""
        ivs = sorted((max(a, t0), min(b, t1)) for n, a, b in self.records if n in names and b > t0 and a < t1)
        covered, end = 0.0, t0
        for a, b in ivs:
            if b > end:
                covered += b - max(a, end)
                end = b
        return covered
