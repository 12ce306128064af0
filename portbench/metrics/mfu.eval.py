"""Model FLOPs of the questions the window completed (frozen counts, live tokens and patches) over window seconds x 989 TFLOP/s, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx)
