"""Time builds of K1 and K2 against each other on the card, in turns in one call
(scripts/decode_variants.py does the same for K3, K4 and P1).

A variant is a label, a directory of kernel sources and extra nvcc flags: the
checkout's own csrc with -DZT_FM_WGMMA=0 (mma.sync at every head dim), -DZT_FM_BKV /
-DZT_FM_STAGES (the flash core's tile and ring depth), -DZT_FM_K1_L1 / -DZT_FM_K2_L1
(tile copies cached in L1 or not), or an older tree's csrc (the design before). Each is compiled into its own library under build/variants/ and called
through the kernels' C entry points at the main path's shapes (K1: S=10368 H=16 D=80
with 8 segments and a pad tail, on fused-qkv views; K2: prefill B=8 S=512 T=4096,
chunk B=8 S=384 T=1280 at ragged keep_len, the same with int8 K/V), checked against
the plain version (tolerance 2e-2: bf16 roundings of outputs below 2; a variant that
disagrees is marked WRONG and the exit code is 1) and timed with scripts/timing.py (median of 10 in turns, L2 cold, per call and on the device).

    python -m zoomearth_tpu_torch.scripts.flash_variants [label=dir[:flag,flag...] ...]

With no arguments: the checkout's defaults against its other tile and ring settings.
`dir` is relative to the repository root; "csrc" is the checkout's own.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import flash_attention as K1
from ..ops import flash_causal as K2
from .timing import time_in_turns

REPO = Path(__file__).resolve().parents[2]
TOL_BF16 = 2e-2
DEFAULT = ["default=csrc", "mma_sync=csrc:-DZT_FM_WGMMA=0", "stages2=csrc:-DZT_FM_STAGES=2",
           "l1_swapped=csrc:-DZT_FM_K1_L1=1,-DZT_FM_K2_L1=0", "mma_sync_bkv32=csrc:-DZT_FM_WGMMA=0,-DZT_FM_BKV=32",
           "mma_sync_bkv128=csrc:-DZT_FM_WGMMA=0,-DZT_FM_BKV=128"]
UNITS = ("flash_segment.cu", "flash_causal.cu")
ENTRY_POINTS = ("zt_flash_segment", "zt_flash_causal")


def compile_variant(spec: str, units, entry_points):
    """Build one variant `label=dir[:flag,flag...]` of the kernel sources `units` into
    build/variants/<label>.so and load it with `entry_points` declared. Returns
    (label, library, its path)."""
    label, _, rest = spec.partition("=")
    d, _, flags = rest.partition(":")
    csrc = _cuda.CSRC if d == "csrc" else REPO / d
    path = REPO / "build" / "variants" / f"{label}.so"
    _cuda.compile_library(path, csrc, tuple(f for f in flags.split(",") if f), units)
    return label, _cuda.load_library(path, entry_points), path


def build_variant(spec: str):
    label, lib, path = compile_variant(spec, UNITS, ENTRY_POINTS)
    # an older tree has no variant query: its kernels are the 64-row ones
    rows = {}
    for name, args in (("zt_flash_segment_variant", (1, 80)), ("zt_flash_causal_variant", (1, 1, 128))):
        rows[name] = getattr(lib, name)(*args) if hasattr(lib, name) else 64
    regs, entry = [], ""
    for ln in Path(str(path) + ".log").read_text().splitlines():  # ptxas: the main path's instantiations
        if "Compiling entry function" in ln:
            entry = ln
        elif "Used" in ln and ("causal_mma_kernelILi128E13" in entry or "segment_mma_kernelILi80" in entry):
            regs.append(ln.split(":", 1)[1].strip())
    print(f"built {label}: rows per block K1 {rows['zt_flash_segment_variant']}, K2 "
          f"{rows['zt_flash_causal_variant']}; {' | '.join(regs)}", flush=True)
    return label, lib, rows


def k1_call(lib, rows, q, k, v, seg):
    S, H, D = q.shape
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    first, last = K1.segment_kv_ranges(seg, rows)
    rc = lib.zt_flash_segment(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(seg), _cuda.ptr(first),
                              _cuda.ptr(last), _cuda.ptr(out), S, H, D, q.stride(0), q.stride(1), k.stride(0),
                              k.stride(1), v.stride(0), v.stride(1), D**-0.5, 1, _cuda.stream(q.device))
    if rc:
        raise RuntimeError(f"zt_flash_segment: {rc}")
    return out


def k2_call(lib, q, k, v, pos, kvl, ks=None, vs=None):
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    rc = lib.zt_flash_causal(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(ks), _cuda.ptr(vs), _cuda.ptr(pos),
                             _cuda.ptr(kvl), _cuda.ptr(out), B, S, H, Hkv, T, D, q.stride(0), q.stride(1), q.stride(2),
                             k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
                             ks.stride(0) if ks is not None else 0, ks.stride(1) if ks is not None else 0,
                             D**-0.5, 1, 2 if k.dtype == torch.int8 else 1, _cuda.stream(q.device))
    if rc:
        raise RuntimeError(f"zt_flash_causal: {rc}")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    variants = [build_variant(spec) for spec in (argv or DEFAULT)]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    S, H, D = 10368, 16, 80
    runs = [1296] * 7 + [800]
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                    + [torch.full((S - sum(runs),), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
    qkv = randn(S, 3, H, D)
    q1, k1, v1 = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    B, H, Hkv, D = 8, 16, 2, 128
    qa, ka, va = randn(B, 512, H, D), randn(B, Hkv, 4096, D), randn(B, Hkv, 4096, D)
    pos_a = torch.arange(512, device=dev, dtype=torch.int32)[None].expand(B, 512).contiguous()
    kvl_a = torch.full((B,), 512, device=dev, dtype=torch.int32)
    qb, kb, vb = randn(B, 384, H, D), randn(B, Hkv, 1280, D), randn(B, Hkv, 1280, D)
    keep = torch.tensor([500, 896, 640, 513, 777, 720, 600, 896], device=dev, dtype=torch.int32)
    pos_b = (keep[:, None] + torch.arange(384, device=dev, dtype=torch.int32)[None]).contiguous()
    kvl_b = keep + 384
    k8 = torch.randint(-127, 128, kb.shape, generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, kb.shape, generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand((B, Hkv, 1280), generator=g, device=dev) * 0.02 + 0.005
    vs = torch.rand((B, Hkv, 1280), generator=g, device=dev) * 0.02 + 0.005
    cases = {
        "K1 segment S=10368 H=16 D=80": (
            lambda lib, rows: k1_call(lib, rows["zt_flash_segment_variant"], q1, k1, v1, seg),
            lambda: K1.flash_segment_attention_plain(q1, k1, v1, seg)),
        "K2 prefill B=8 S=512 T=4096": (
            lambda lib, rows: k2_call(lib, qa, ka, va, pos_a, kvl_a),
            lambda: K2.flash_causal_attention_plain(qa, ka, va, pos_a, kvl_a)),
        "K2 chunk B=8 S=384 T=1280 ragged keep": (
            lambda lib, rows: k2_call(lib, qb, kb, vb, pos_b, kvl_b),
            lambda: K2.flash_causal_attention_plain(qb, kb, vb, pos_b, kvl_b)),
        "K2 chunk int8 K/V": (
            lambda lib, rows: k2_call(lib, qb, k8, v8, pos_b, kvl_b, ks, vs),
            lambda: K2.flash_causal_attention_plain(qb, k8, v8, pos_b, kvl_b, ks, vs)),
    }
    wrong = False
    for name, (call, plain) in cases.items():
        ref = plain().float()
        fns = []
        errs = []
        for label, lib, rows in variants:
            errs.append((call(lib, rows).float() - ref).abs().max().item())
            fns.append(lambda lib=lib, rows=rows: call(lib, rows))
        ms, devms = time_in_turns(fns)
        for (label, _, _), err, t, d in zip(variants, errs, ms, devms):
            verdict = "" if err <= TOL_BF16 else " | WRONG"
            print(f"{name} [{label}]: max_abs_err {err:.3e} (tol {TOL_BF16}){verdict} | {t:.4f} ms per call, {d:.4f} ms "
                  f"device | L2 cold, in turns | {card}", flush=True)
            wrong |= err > TOL_BF16 or err != err
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
