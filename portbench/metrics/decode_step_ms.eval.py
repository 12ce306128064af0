"""Wall ms inside the Generator's decode calls per decode step the calls took (pair and solo steps alike)."""

from portbench.harness import readers


def read(ctx):
    return readers.span_ms_per(ctx, "decode", "decode_steps")
