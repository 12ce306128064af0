"""Time several functions in turns on the card, so noise lands on all of them alike.

Timing a kernel alone and then its plain version alone puts host noise and clock
state on one side only. `in_turns` alternates the calls instead: round r calls the
functions in the order given when r is even and in reverse when r is odd, so two
functions run a, b, b, a, a, b, ... Every function gets the same warm-up and the
same number of timed runs. The ordering takes a `timer` callable and knows nothing
of CUDA; `cuda_timer` is the one the card uses (CUDA events around one call).

CUDA events around one call time what a caller waits for, the host's launch path
included: a wrapper's Python and a few small launches take tens of microseconds,
which a short kernel cannot hide. `time_in_turns` also takes the device's own time:
each function is captured several times over in one CUDA graph, and the replays
are timed in turns.

Every timed call finds the L2 cache cold, as a decode step finds each layer's
cache: `flush_l2` writes a buffer of 2.5x the H100's 50 MB L2 before it. Per call,
the flush runs and is waited for before the start event. On the device, each call
in a graph follows its own flush, a graph of the flushes alone is timed in the same
turns, and its time is taken off. A written flush leaves the L2 full of modified
lines, which the timed call's reads push out to device memory as they come in;
`flush_l2_by_reading` reads the buffer instead and leaves lines that are dropped for
nothing. `time_in_turns(fns, flush=...)` takes either.
"""

from __future__ import annotations

from statistics import median
from typing import Callable, Sequence

RUNS, WARMUP = 10, 2
GRAPH_MS = 4.0  # a graph holds as many calls as fill about this much of the slowest function
MAX_REPS = 20
L2_FLUSH_BYTES = 128 << 20
PLAIN = " (plain version)"  # the entry points name a kernel's plain version: the kernel's case + PLAIN

_flush_buf = None


def in_turns(fns: Sequence[Callable[[], object]], timer: Callable[[Callable[[], object]], float], *,
             runs: int = RUNS, warmup: int = WARMUP) -> list[list[float]]:
    """Call each of `fns` `warmup` times untimed, then `runs` times through
    `timer(fn) -> ms`, in turns. Returns one list of times per function."""
    times: list[list[float]] = [[] for _ in fns]
    for r in range(warmup + runs):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            if r < warmup:
                fns[i]()
            else:
                times[i].append(timer(fns[i]))
    return times


def medians_in_turns(fns, timer, *, runs: int = RUNS, warmup: int = WARMUP) -> list[float]:
    """Median ms of each function, timed in turns."""
    return [median(t) for t in in_turns(fns, timer, runs=runs, warmup=warmup)]


def flush_l2() -> None:
    """Evict the L2 cache: zero a buffer of L2_FLUSH_BYTES on the current CUDA device."""
    import torch

    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def flush_l2_by_reading() -> None:
    """Evict the L2 cache with lines that need no write-back: read the flush buffer
    (one reduction over L2_FLUSH_BYTES on the current CUDA device)."""
    import torch

    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _flush_buf.view(torch.int32).max()


def cuda_timer(fn, flush=flush_l2) -> float:
    """ms of one call of fn on the current CUDA stream, L2 cold (events, synchronized)."""
    import torch

    flush()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_graph(fn, reps: int, flush=flush_l2):
    """`reps` back-to-back calls of fn, each after an L2 flush, captured in one CUDA
    graph after one warm-up call on a side stream. fn must not synchronize with the host."""
    import torch

    flush()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            flush()
            fn()
    return graph


def time_in_turns(fns, flush=flush_l2):
    """(ms per call with CUDA events around each call, device ms per call from CUDA
    graph replays less the flushes), each the median of RUNS in turns, L2 cold
    (`flush` before every call: flush_l2, or flush_l2_by_reading)."""
    ms = medians_in_turns(fns, lambda fn: cuda_timer(fn, flush))
    reps = max(1, min(MAX_REPS, int(GRAPH_MS / max(ms))))
    graphs = [cuda_graph(fn, reps, flush) for fn in [lambda: None, *fns]]
    flush_ms, *dev = medians_in_turns([g.replay for g in graphs], lambda replay: cuda_timer(replay, flush))
    return ms, [(t - flush_ms) / reps for t in dev]
