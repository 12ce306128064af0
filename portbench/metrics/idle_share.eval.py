"""Share of the traced window with no device activity, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
