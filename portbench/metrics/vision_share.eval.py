"""Share of the window's device kernel time launched from inside the vision tower (the benchmark's vision span), in %."""

from portbench.harness import readers


def read(ctx):
    return readers.device_share_of_span(ctx, "vision")
