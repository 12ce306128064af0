"""Prefetching host tile loader (port of image/loader.py; a copy, host code only):
overlap host preprocessing with device compute.

PrefetchLoader runs a worker thread that computes item n+1 (PIL decode, resize, crop,
patchify — all GIL-releasing C code) while the consumer blocks on device work for item
n. `TileImage` wraps a full-resolution tile as numpy so repeated crops skip PIL decode.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np


class TileImage:
    """A full-res tile held as a numpy array with PIL-compatible crop/size accessors.

    Native crops are byte-identical to PIL crops (tests) but skip per-crop decode."""

    def __init__(self, array_or_pil):
        if hasattr(array_or_pil, "convert"):
            self.array = np.asarray(array_or_pil.convert("RGB"))
        else:
            self.array = np.ascontiguousarray(array_or_pil)

    @property
    def width(self) -> int:
        return self.array.shape[1]

    @property
    def height(self) -> int:
        return self.array.shape[0]

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def crop(self, box) -> "TileImage":
        from .. import native

        if native.available():
            return TileImage(native.crop(self.array, box))
        x1, y1, x2, y2 = (int(v) for v in box)
        return TileImage(self.array[y1:y2, x1:x2])

    def resize(self, size_wh, _resample=None) -> "TileImage":
        # PIL's SIMD bicubic wins over scalar C++ and matches the reference exactly
        from PIL import Image

        return TileImage(np.asarray(Image.fromarray(self.array).resize(size_wh, Image.BICUBIC)))

    def convert(self, mode: str) -> "TileImage":
        assert mode == "RGB"
        return self

    def to_pil(self):
        from PIL import Image

        return Image.fromarray(self.array)


class PrefetchLoader:
    """Iterate `fn(item)` over `items` with `depth` items computed ahead in a worker
    thread. Exceptions propagate to the consumer at the failing item's position."""

    def __init__(self, items: Iterable, fn: Callable, depth: int = 2):
        self.items = list(items)
        self.fn = fn
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        for item in self.items:
            try:
                self.q.put((self.fn(item), None))
            except Exception as e:  # surfaced on the consumer side
                self.q.put((None, e))
        self.q.put(StopIteration)

    def __iter__(self) -> Iterator:
        while True:
            got = self.q.get()
            if got is StopIteration:
                return
            result, err = got
            if err is not None:
                raise err
            yield result
