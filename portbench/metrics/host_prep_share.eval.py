"""Share of the window's wall time the host spends preparing episodes (resize, crop, tile, tokenize, patchify, pack): the benchmark's host.* spans, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.host_share(ctx)
