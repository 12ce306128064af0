"""The window layers' attention launches (K2 with the band and the sinks in the prefills, K6 with the window in each decode call's first, eager step): their summed bound time (frozen work in portbench/work/mimo_v2.py over the keys inside the window, 989 TFLOP/s or 3.35 TB/s) over their summed device time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, ("SWA",))
