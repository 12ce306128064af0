"""The grouped expert products' eager launches: their summed bound time (frozen work in portbench/work/kimi_vl.py: the touched experts' weights, 3 products per routed token; 989 TFLOP/s or 3.35 TB/s) over their summed device time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, ("MoE",))
