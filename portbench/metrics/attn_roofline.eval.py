"""K1, K2 and K3: their launches' summed bound time (frozen work() at each launch's shapes, 989 TFLOP/s or 3.35 TB/s) over their summed device time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, ("K1", "K2", "K3"))
