"""ctypes bindings for the native host image pipeline (image_ops.cpp).

Builds the shared library at first use (g++, into `<repo>/build/native/`, which
.gitignore lists, under a name keyed by a hash of the source; when no compiler is
available callers check `available()` and take their numpy path, as in the reference).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "image_ops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_lock = threading.Lock()
_lib = None
_build_error = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libimage_ops_{digest}.so")


def _build():
    """The library's path, built if this source is not built yet (written under a
    temporary name and renamed, so no process loads a half-written file); None
    without a working g++."""
    global _build_error
    path = _lib_path()
    if os.path.exists(path):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, path)
        return path
    except (subprocess.CalledProcessError, OSError) as e:
        _build_error = getattr(e, "stderr", None) or str(e)
        return None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i = ctypes.c_int
        lib.resize_bicubic_u8.argtypes = [u8p, i, i, u8p, i, i]
        lib.crop_u8.argtypes = [u8p, i, i, i, i, i, i, u8p]
        lib.normalize_patchify.argtypes = [u8p, i, i, f32p, f32p, i, i, i, f32p]
        lib.patchify_u8.argtypes = [u8p, i, i, i, i, i, u8p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def build_error():
    return _build_error


def resize_bicubic(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 HWC -> uint8 (oh, ow, 3), PIL-BICUBIC-compatible (float-precision)."""
    lib = _load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    out = np.empty((oh, ow, 3), np.uint8)
    lib.resize_bicubic_u8(image, h, w, out, oh, ow)
    return out


def crop(image: np.ndarray, box) -> np.ndarray:
    lib = _load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    x1, y1, x2, y2 = (int(v) for v in box)
    h, w = image.shape[:2]
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(w, x2), min(h, y2)
    out = np.empty((y2 - y1, x2 - x1, 3), np.uint8)
    lib.crop_u8(image, h, w, x1, y1, x2, y2, out)
    return out


def patchify_u8(
    image: np.ndarray, patch: int = 14, temporal: int = 2, merge: int = 2
) -> np.ndarray:
    """uint8 HWC (h, w, 3) -> uint8 (grid_h*grid_w, 3*temporal*patch**2): patchify
    WITHOUT normalization (normalization happens on device, see vit_forward)."""
    lib = _load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    grid_h, grid_w = h // patch, w // patch
    out = np.empty((grid_h * grid_w, 3 * temporal * patch * patch), np.uint8)
    lib.patchify_u8(image, h, w, patch, temporal, merge, out)
    return out


def normalize_patchify(
    image: np.ndarray, mean: np.ndarray, std: np.ndarray,
    patch: int = 14, temporal: int = 2, merge: int = 2,
) -> np.ndarray:
    """uint8 HWC (h, w, 3) -> float32 (grid_h*grid_w, 3*temporal*patch**2), exact
    layout/math of image.preprocess.patchify(normalize(...))."""
    lib = _load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    grid_h, grid_w = h // patch, w // patch
    out = np.empty((grid_h * grid_w, 3 * temporal * patch * patch), np.float32)
    lib.normalize_patchify(
        image, h, w,
        np.ascontiguousarray(mean, np.float32), np.ascontiguousarray(std, np.float32),
        patch, temporal, merge, out,
    )
    return out
