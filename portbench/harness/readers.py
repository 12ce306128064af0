"""Readers shared by the per-layer metrics (each metric's file in portbench/metrics/
picks one). A reader returns None where its run has nothing to read: no device trace,
no span or launch of its kind in the window."""

from __future__ import annotations

from .core import H100_BF16_FLOPS, H100_HBM_BYTES


def host_share(ctx, prefix: str = "host."):
    names = {n for n, _, _ in ctx.spans.records if n.startswith(prefix)}
    if not names:
        return None
    return 100.0 * ctx.spans.total(names, *ctx.window) / ctx.window_s


def span_ms_per(ctx, span: str, count: str):
    steps = getattr(ctx.run, count, 0)
    total = ctx.spans.total({span}, *ctx.window)
    return 1000.0 * total / steps if steps and total > 0 else None


def device_share_of_span(ctx, span: str):
    tr = ctx.trace
    if tr is None:
        return None
    total = tr.busy_s
    part = tr.seconds(lambda k, n: k == "span" and n == span)
    return 100.0 * part / total if total > 0 and part > 0 else None


def idle_share(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or ctx.device.type != "cuda":
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s


def roofline(ctx, kernels):
    """Summed bound time of the kernels' timed launches in the window over their
    summed device time, in %."""
    tr, rec = ctx.trace, getattr(ctx.run, "recorder", None)
    if tr is None or rec is None:
        return None
    device = tr.seconds(lambda k, n: k == "kernel" and n in kernels)
    if device <= 0:
        return None
    bounds = rec.bounds(H100_BF16_FLOPS, H100_HBM_BYTES)
    return 100.0 * sum(bounds[k] for k in kernels) / device


def mfu(ctx):
    flops = ctx.run.model_flops() if hasattr(ctx.run, "model_flops") else None
    if not flops or ctx.device.type != "cuda":
        return None
    return 100.0 * flops / (ctx.window_s * H100_BF16_FLOPS)


def peak_gib(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.window_peak / 2 ** 30
