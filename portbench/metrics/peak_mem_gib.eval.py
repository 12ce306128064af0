"""torch.cuda.max_memory_allocated() over the window, GiB."""

from portbench.harness import readers


def read(ctx):
    return readers.peak_gib(ctx)
