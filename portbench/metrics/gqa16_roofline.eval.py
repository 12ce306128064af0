"""The global layers' decode launches (K6 at 16 heads a KV head, in each decode call's first, eager step): their summed bound time (frozen work in portbench/work/mimo_v2.py, 989 TFLOP/s or 3.35 TB/s) over their summed device time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, ("GQA16",))
