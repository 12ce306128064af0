"""Random weights from the seed, made on the device in one draw.

A family lists its leaves as (name, shape, kind): "dense" (in, out) matrices scaled by
sqrt(2 / (in + out)), "embed" rows scaled by 0.02, "bias" at 0.02, "norm" scales at
1 + 0.1 N(0, 1) ("norm:<c>": c times that), "const:<x>" filled with x. All of them are views of one buffer in
the type they are served in, filled by one `torch.randn` from a `torch.Generator` on
the device seeded with the run's seed: the same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

Leaf = Tuple[str, Sequence[int], str]


def make_weights(leaves: List[Leaf], seed: int, device, dtype) -> Dict:
    import torch

    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out = {}
    off = 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        t = buf[off:off + n].view(*shape)
        off += n
        if kind == "dense":
            t.mul_(math.sqrt(2.0 / (shape[0] + shape[-1])))
        elif kind == "embed":
            t.mul_(0.02)
        elif kind == "bias":
            t.mul_(0.02)
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        elif kind.startswith("norm:"):  # c (1 + 0.1 N(0, 1))
            c = float(kind[5:])
            t.mul_(0.1 * c).add_(c)
        elif kind.startswith("const:"):
            t.fill_(float(kind[6:]))
        else:
            raise ValueError(f"unknown leaf kind {kind!r} for {name}")
        out[name] = t
    return out

