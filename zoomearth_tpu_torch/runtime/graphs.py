"""Captured decode steps: the port's counterpart of the reference's compiled decode
programs (the `jax.jit` caches around runtime/generate.py's `_decode_loop` and
`_decode_loop_pair`, and serve/engine.py's `_get_decode_fn` / `_get_decode_compact_fn`).

The reference traces each decode loop once per shape key and runs it as one XLA
program. PyTorch runs eagerly: a decode step of the 3B model is ~900 small kernels
issued from Python, and the host sets the pace. Here the step function that runs
eagerly is captured once into a `torch.cuda.CUDAGraph` over static device buffers and
replayed:

- `StepGraphs` is one owner's captured steps, by key, over one private memory pool
  (graphs replayed in turn share it). `run(key, fn)` runs `fn` eagerly on the CPU,
  always. On CUDA a key's first run is eager: the warm-up that capture needs, and a
  real step, so capture costs no extra step. Its second run captures the step and
  replays it, and every later run replays. A failed capture raises: there is no
  eager fallback, no switch and no size threshold.
- `CapturedStep` is one graph: the step's kernels, the `torch.Generator`s it draws
  from (registered with the graph, so each replay draws what the eager step would
  draw next), and the launch tally recorded during its capture, which every replay
  adds to the kernels' counts (`ops._cuda.count_launch`).

What a captured step reads must be a device tensor at a fixed address: a host array
copied in during capture would replay the bytes of the capture forever, and nothing
in the step may wait for the host (a capture that does raises). The callers copy host
inputs into static buffers before each run, outside the graph, and keep their
all-done checks outside too. A graph holds addresses, not tensors: the owner drops a
key (`release`, `drop`) before the buffers its step reads die or are replaced.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from ..ops import _cuda


class CapturedStep:
    """`fn` captured into one CUDA graph on the current device: capture runs nothing,
    so `fn` must have run eagerly on the same buffers first. `capture_s` is the host
    time of the capture and the graph's instantiation."""

    def __init__(self, fn: Callable[[], None], *, pool, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        t0 = time.perf_counter()
        # torch.cuda.graph would also synchronize and empty the allocator's cache at every
        # capture; the capture is made here on a side stream, as torch.cuda.graph makes it.
        # "thread_local": another thread's CUDA calls (a server's handlers, the pump's
        # caller) do not invalidate this thread's capture; a sync on this thread does.
        stream.wait_stream(torch.cuda.current_stream())
        with _cuda.recording() as tally, torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:  # noqa: BLE001 (the capture is invalid already; fn's error is the one raised)
                    pass
                raise
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        self.tally = tally

    def replay(self) -> None:
        """Run the captured step on the current stream and count its launches."""
        self.graph.replay()
        _cuda.add_tally(self.tally)


class StepGraphs:
    """One owner's captured steps by key (see the module docstring). `captures` and
    `capture_s` add up every capture made; `held` is the number of graphs that replay."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._steps: Dict[Hashable, Optional[CapturedStep]] = {}  # None: the key ran once, eagerly
        # Graphs no key replays any more, kept until the next capture: a private pool lives
        # as long as one graph captured into it does, and a pool whose last graph has died
        # cannot take another capture.
        self._retired = []
        self._pool = None
        self._stream = None
        self.captures = 0
        self.capture_s = 0.0

    def run(self, key: Hashable, fn: Callable[[], None], generators: Sequence[torch.Generator] = ()) -> None:
        """One run of the step `key`: `fn()` eagerly on the CPU and at the key's first
        run on CUDA, then captured (`fn` of the second run, over the same buffers as the
        first) and replayed."""
        step = self._steps.get(key)
        if step is None:
            if key not in self._steps or self.device.type != "cuda":
                self._steps[key] = None
                fn()
                return
            step = self._steps[key] = self._capture(fn, generators)
        step.replay()

    def release(self, key: Hashable) -> None:
        """Stop replaying `key`: the buffers its step reads are about to die."""
        step = self._steps.pop(key, None)
        if step is not None:
            self._retired.append(step)

    def drop(self) -> None:
        """Stop replaying every key (the next run of each is eager again). May be called
        from another thread than the one that runs the steps (an engine's `params`)."""
        steps = list(self._steps.values())  # one C call: no other thread runs in between
        self._steps.clear()
        self._retired.extend(s for s in steps if s is not None)

    def keys(self):
        return list(self._steps)

    @property
    def held(self) -> int:
        return sum(s is not None for s in list(self._steps.values()))

    def _capture(self, fn, generators) -> CapturedStep:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        step = CapturedStep(fn, pool=self._pool, stream=self._stream, generators=generators)
        self._retired.clear()
        self.captures += 1
        self.capture_s += step.capture_s
        return step
