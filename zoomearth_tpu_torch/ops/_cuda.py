"""Build and load the hand-written Hopper kernels (csrc/*.cu) as one shared library.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles each source to an object, one
`nvcc` per source all started together, and links them into a shared library with
a plain C interface, which ctypes loads. The build runs at first use,
into `<repo>/build/kernels/` (listed in .gitignore), under a file name keyed by a
hash of the sources and flags, so a checkout builds its own kernels and an edit
rebuilds them. Nothing here runs at import time: the CPU tests import every module
of the package on a machine without nvcc.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("common.cuh", "flash_mma.cuh", "flash_policy.cuh", "decode_split.cuh", "flash_bwd.cuh", "flash_segment.cu",
           "flash_causal.cu", "flash_segment_bwd.cu", "flash_causal_bwd.cu", "flash_decode.cu", "paged_decode.cu",
           "probe_stream.cu", "probe_bigmm.cu", "split_merge.cu", "flash_mla_decode.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzt_kernels_{h.hexdigest()[:16]}.so"


def compile_library(path: Path, csrc: Path = CSRC) -> None:
    """Compile the sources under `csrc` into the shared library `path`: one nvcc per
    source, all at once, then one link. The library is linked in a temporary
    directory and renamed into place, so concurrent builders never load a
    half-written file. The compiler's output (ptxas register and spill counts) is
    kept beside it as `<library>.log`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as work:
        units = [s for s in SOURCES if s.endswith(".cu")]
        objs = [os.path.join(work, s[:-3] + ".o") for s in units]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(csrc / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(units, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{s} ({p.returncode}):\n{log[-4000:]}" for s, p, log in zip(units, procs, logs) if p.returncode]
        tmp = os.path.join(work, "lib.so")
        if not failed:
            link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode:
                failed.append(f"link ({link.returncode}):\n{logs[-1][-4000:]}")
        Path(str(path) + ".log").write_text("".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, path)


def build() -> Path:
    """Compile the kernels unless this exact source set is already built."""
    path = library_path()
    if not path.exists():
        compile_library(path)
    return path


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "zt_flash_segment": [_P] * 7 + [_I] * 3 + [_L] * 6 + [_F, _I, _P, _P],
    "zt_flash_segment_variant": [_I, _I],
    "zt_flash_causal_variant": [_I, _I, _I],
    "zt_flash_causal": [_P] * 8 + [_I] * 6 + [_L] * 11 + [_F, _I, _I, _P, _P],
    "zt_flash_bwd_variant": [_I, _I],
    "zt_flash_segment_bwd": [_P] * 13 + [_I] * 3 + [_L] * 6 + [_F, _I, _P],
    "zt_flash_causal_bwd": [_P] * 14 + [_I] * 8 + [_L] * 15 + [_F, _I, _P],
    "zt_flash_decode": [_P] * 8 + [_I] * 7 + [_L] * 10 + [_F, _I, _I, _P],
    "zt_flash_mla_decode": [_P] * 5 + [_I] * 4 + [_L] * 4 + [_F, _P],
    "zt_flash_causal_mla": [_P] * 6 + [_I] * 7 + [_L] * 9 + [_F, _P],
    "zt_decode_split_tile": [],
    "zt_paged_decode": [_P] * 7 + [_I] * 8 + [_L] * 4 + [_F, _I, _P],
    "zt_probe_stream": [_P] * 4 + [_I] * 7 + [_I, _I, _P],
    "zt_probe_bigmm": [_P] * 7 + [_I] * 8 + [_F, _P],
}


def load_library(path: Path) -> ctypes.CDLL:
    """Load a kernel library and declare the C signatures of the entry points it has
    (a library built from an older tree's sources may lack the newer ones)."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    handle.zt_error_string.argtypes = [ctypes.c_int]
    handle.zt_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load_library(build())
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a failed or refused launch."""
    if rc != 0:
        msg = lib().zt_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed with code {rc}: {msg}")


def count_launch(wrapper, variant: str | None = None, int8: bool = False) -> None:
    """Add one to `wrapper.launches` (and to `wrapper.variants[variant]`, where the
    kernel has variants; to `wrapper.int8_launches`, where the launch read int8 K/V)
    for the kernel it has just launched, so that a count is of kernel runs.

    A call made while a CUDA graph is being captured launches nothing. Under a
    `recording()` (a runtime.graphs.CapturedStep capturing its step) it goes to that
    capture's tally instead, which each replay adds to the counts (`add_tally`). Under
    a raw `torch.cuda.graph` capture (the timing harness) it is not counted, nor are
    that graph's replays."""
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[(wrapper, variant, int8)] += 1
        return
    _add_launches(wrapper, 1, variant, int8)


def _add_launches(wrapper, n: int, variant: str | None, int8: bool) -> None:
    wrapper.launches += n
    if variant is not None:
        wrapper.variants[variant] += n
    if int8:
        wrapper.int8_launches += n


_capturing = threading.local()  # .tally: the Counter of the capture this thread is recording, if any


@contextlib.contextmanager
def recording():
    """Collect, as a Counter of (wrapper, variant, int8) -> launches, the calls that
    count_launch sees on this thread while a stream captures: one captured step's
    launches, which `add_tally` adds to the counts at each replay."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = collections.Counter()
    try:
        yield tally
    finally:
        _capturing.tally = outer


def add_tally(tally) -> None:
    """Count the launches of one replay of a captured step (its `recording()` tally)."""
    for (wrapper, variant, int8), n in tally.items():
        _add_launches(wrapper, n, variant, int8)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def dtype_code(t: torch.Tensor, name: str, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (expected one of {allowed})")
    return DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device (got {t.device})")
        if t.stride(-1) != 1 and t.dim() > 1:
            raise ValueError(f"{name}: last dim must have unit stride (strides {t.stride()})")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous from a 16-byte aligned base: as it is where it already is, else a
    copy (an operand a kernel reads in 16-byte vectors, such as a gradient handed
    down by autograd, which may be a view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_aligned16(name: str, *tensors) -> None:
    """Raise unless each tensor's base address and every stride but the last are whole
    16-byte multiples: a kernel that copies 16-byte vectors refuses other views."""
    for t in tensors:
        item = t.element_size()
        if t.data_ptr() % 16 or any((x * item) % 16 for x in (t.shape[-1], *t.stride()[:-1])):
            raise ValueError(f"{name}: rows and strides must be whole 16-byte multiples from a 16-byte aligned "
                             f"base (the kernel copies 16-byte vectors; shape {tuple(t.shape)}, strides "
                             f"{t.stride()}, offset {t.storage_offset()})")


def scale_views(name: str, ks, vs):
    """The int8 caches' per-token scales (B, Hkv, T) as the kernels read them: fp32,
    unit stride on T, and one set of strides for both. A view that already is all of
    that (a cache's own fp32 scales, or their [:, :, :attend_len] prefix) goes in as it
    is; anything else is converted and copied."""
    if ks is None or vs is None:
        raise ValueError(f"{name}: int8 k/v need ks and vs scales")
    if all(s.dtype == torch.float32 and s.stride(-1) == 1 for s in (ks, vs)) and ks.stride() == vs.stride():
        return ks, vs
    return ks.float().contiguous(), vs.float().contiguous()
