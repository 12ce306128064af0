"""K5's launches and K2's at key width 192 and value width 128 (latent attention's decode and expanded prefill): their summed bound time (frozen work in portbench/work/kimi_vl.py, 989 TFLOP/s or 3.35 TB/s) over their summed device time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, ("K5", "K2"))
