"""Time builds of K3, K4 and P1 against each other on the card, in turns in one call
(scripts/flash_variants.py does the same for K1 and K2).

    python -m zoomearth_tpu_torch.scripts.decode_variants [--flush=read] [--p1-rows=B] \\
        [label=dir[:flag,flag...][@k3+k4+p1] ...]

A variant is a label, a directory of kernel sources, extra nvcc flags and, after an
`@`, the kernels it is timed at (k3, k4, p1 joined by `+`; all three when left out).
`dir` is relative to the repository root; "csrc" is the checkout's own. Flags:

- csrc/probe_stream.cu (P1): -DZT_P1_COPY=0|1|2 (bulk asynchronous copies, cp.async,
  __ldg), -DZT_P1_TILE (bytes of k and of v per tile), -DZT_P1_STAGES,
  -DZT_P1_BLOCKS_PER_SM, -DZT_P1_SKIP=1|2|4 (parts left out: the staged bytes never
  read, no out, no memset).
- csrc/decode_split.cuh (K3 and K4): -DZT_DS_SKIP=1|2|4 (no logits, no softmax step,
  no p @ v; 7: copies and barriers only).

A build with a _SKIP flag gives wrong answers by design and is timed, not checked. An
older tree's sources (`git archive <commit> zoomearth_tpu_torch/csrc | tar -x -C
build/parent`) whose K4 and P1 take the first design's arguments are called as that
tree's wrappers called them. With no arguments: the checkout's build against P1's
other copies, tiles, ring depths and block counts and its builds with parts left out.

Each variant is compiled into its own library under build/variants/ and checked
against the plain version first (K3 and K4, bf16 and int8: 2e-2, bf16 roundings of
outputs below 2; P1: out one bf16 step, sums 1e-6 of the summed magnitudes; a variant
that disagrees is marked WRONG and the exit code is 1). Outputs are also compared bit
for bit with the first variant's. Then, per case, all variants are timed with
scripts/timing.py (median of 10 in turns, L2 cold, per call and on the device): K3 at
the main path's four decode cases (B=8), K4 at the four cells of
scripts/paged_256_test.py with K3 on the same k/v laid out contiguously, P1 at the
probe's shape (--p1-rows=B: at B rows instead of 32, a longer stream). Each row
carries the case's bound (the wrappers' work()) and the share of it reached.
--flush=read evicts the L2 before every timed call by reading a buffer, not by
writing one (scripts/timing.py): the timed reads then push no modified lines out.
"""

from __future__ import annotations

import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda
from ..ops import flash_decode as K3
from ..ops import paged_attention as K4
from . import paged_256_test as PT
from . import probe_attn as PA
from .flash_variants import compile_variant
from .timing import flush_l2, flush_l2_by_reading, time_in_turns

TOL_BF16 = 2e-2
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16 tensor-core rate, HBM rate
UNITS = {"k3": ("flash_decode.cu", "split_merge.cu"), "k4": ("flash_decode.cu", "paged_decode.cu", "split_merge.cu"),
         "p1": ("probe_stream.cu",)}
DEFAULT = ["default=csrc",
           "p1_cp_async=csrc:-DZT_P1_COPY=1@p1",
           "p1_ldg=csrc:-DZT_P1_COPY=2,-DZT_P1_TILE=32768,-DZT_P1_BLOCKS_PER_SM=4@p1",
           "p1_tile16k=csrc:-DZT_P1_TILE=16384@p1", "p1_tile32k_3st=csrc:-DZT_P1_TILE=32768,-DZT_P1_STAGES=3@p1",
           "p1_stages2=csrc:-DZT_P1_STAGES=2@p1", "p1_stages6=csrc:-DZT_P1_STAGES=6@p1",
           "p1_1block=csrc:-DZT_P1_BLOCKS_PER_SM=1@p1", "p1_3blocks=csrc:-DZT_P1_BLOCKS_PER_SM=3@p1",
           "p1_copies_only=csrc:-DZT_P1_SKIP=1@p1", "p1_no_out=csrc:-DZT_P1_SKIP=2@p1",
           "p1_no_memset=csrc:-DZT_P1_SKIP=4@p1"]
_P, _I, _L, _F = _cuda._P, _cuda._I, _cuda._L, _cuda._F
FIRST_DESIGN = {  # the entry points of K4 and P1 before they were redesigned
    "zt_paged_decode": [_P] * 7 + [_I] * 5 + [_L] * 4 + [_F, _I, _P],
    "zt_probe_stream": [_P] * 5 + [_I] * 7 + [_I, _I, _P],
}


class Variant:
    def __init__(self, spec: str):
        spec, _, kernels = spec.partition("@")
        self.kernels = tuple(kernels.split("+")) if kernels else ("k3", "k4", "p1")
        units = tuple(dict.fromkeys(u for k in self.kernels for u in UNITS[k]))
        self.label, self.lib, path = compile_variant(spec, units, ())
        # a tree from before the shared split pass has neither query, and its K4 and P1
        # take the first design's arguments
        queries = ("zt_decode_split_tile", "zt_probe_stream_plan")
        self.first_design = not any(hasattr(self.lib, name) for name in queries)
        declared = _cuda._SIGNATURES | (FIRST_DESIGN if self.first_design else {})
        for name, argtypes in declared.items():
            if hasattr(self.lib, name):
                getattr(self.lib, name).argtypes = argtypes
        self.parts_left_out = "_SKIP=" in spec
        plan = ""
        if hasattr(self.lib, "zt_probe_stream_plan"):
            copy, tile, stages, blocks, skip = (self.lib.zt_probe_stream_plan(i) for i in range(5))
            plan = f" P1 copy {copy}, tile {tile} B, {stages} stages, {blocks} blocks an SM, skip {skip} |"
        log = Path(str(path) + ".log").read_text().splitlines()
        regs = sorted({ln.split(":", 1)[1].split(",")[0].strip() for ln in log if "Used" in ln})
        design = " first design of K4/P1 |" if self.first_design else ""
        print(f"built {self.label} for {'+'.join(self.kernels)}:{design}{plan} {regs}", flush=True)

    @contextmanager
    def bound(self):
        """The wrappers of ops/ and scripts/probe_attn.py launch this variant's kernels."""
        old, _cuda._lib = _cuda._lib, self.lib
        try:
            yield
        finally:
            _cuda._lib = old

    def k3(self, q, k, v, kvl, ks=None, vs=None):
        with self.bound():
            return K3.decode_attention_cuda(q, k, v, kvl, ks, vs)

    def k4(self, q, kpool, vpool, bt, lens, page):
        if not self.first_design:
            with self.bound():
                return K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=page)
        B, H, D = q.shape
        lens = K4._live_lengths(lens, bt, page).contiguous()
        npages = K4.page_counts(lens, page).contiguous()
        out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
        rc = self.lib.zt_paged_decode(_cuda.ptr(q), _cuda.ptr(kpool), _cuda.ptr(vpool), _cuda.ptr(bt),
                                      _cuda.ptr(npages), _cuda.ptr(lens), _cuda.ptr(out), B, H, kpool.shape[1], page, D,
                                      bt.stride(0), kpool.stride(0), kpool.stride(1), kpool.stride(2), D**-0.5,
                                      _cuda.DTYPE_CODES[q.dtype], _cuda.stream(q.device))
        if rc:
            raise RuntimeError(f"zt_paged_decode: {rc}")
        return out

    def p1(self, q, k, v, chunk=PA.CHUNK, rb=4):
        if not self.first_design:
            with self.bound():
                return PA.stream_only_cuda(q, k, v, chunk=chunk, rb=rb)
        B, _, H, D = q.shape
        acc = torch.zeros((B // rb, 64, D), dtype=torch.float32, device=q.device)
        sums = torch.zeros((B // rb,), dtype=torch.float32, device=q.device)
        out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
        code = _cuda.DTYPE_CODES[k.dtype]
        rc = self.lib.zt_probe_stream(_cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(acc), _cuda.ptr(sums), _cuda.ptr(out), B, H,
                                      k.shape[1], k.shape[2], D, rb, chunk, code, _cuda.DTYPE_CODES[q.dtype],
                                      _cuda.stream(q.device))
        if rc:
            raise RuntimeError(f"zt_probe_stream: {rc}")
        return out[:, None], sums


def err(a, b):
    return (a.float() - b.float()).abs().max().item()


class Report:
    """Times cases in turns and prints one row per variant; `wrong` turns true when a
    checked variant disagrees with the plain version."""

    def __init__(self, card, flush):
        self.card, self.flush, self.wrong = card, flush, False
        self.flushed = "read" if flush is flush_l2_by_reading else "written"

    def case(self, name, variants, call, ref, work, check=None):
        """`call(variant)` runs the case; `check(out)` -> (ok, note) replaces the default
        comparison of the output with `ref` to TOL_BF16."""
        outs = [call(v) for v in variants]
        ms, dev = time_in_turns([lambda v=v: call(v) for v in variants], self.flush)
        flops, nbytes = work
        bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        for v, out, t, d in zip(variants, outs, ms, dev):
            if v.parts_left_out:
                verdict = "parts left out, not checked"
            else:
                ok, verdict = check(out) if check else (err(out, ref) <= TOL_BF16,
                                                        f"max_abs_err {err(out, ref):.3e} (tol {TOL_BF16})")
                if torch.is_tensor(out) and torch.is_tensor(outs[0]):
                    verdict += f" | bit for bit [{variants[0].label}]'s: {torch.equal(out, outs[0])}"
                if not ok:
                    verdict += " | WRONG"
                    self.wrong = True
            print(f"{name} [{v.label}]: {verdict} | {t:.4f} ms per call, {d:.4f} ms device | bound {bound:.5f} ms, "
                  f"share {bound / d:.3f}, {nbytes / d / 1e6:.1f} GB/s of the bytes it must move | L2 cold "
                  f"({self.flushed} flush), in turns | {self.card}", flush=True)


def k3_cases(dev):
    """The main path's four decode cases: B = 8, H = 16, Hkv = 2, D = 128, ragged kv_len."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    B, H, Hkv, D = 8, 16, 2, 128
    q = randn(B, 1, H, D)
    for T in (1280, 4096):
        k, v = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        kvl = torch.tensor([1, T, T // 2, 700, 1000, T - 1, 3, 512], device=dev)
        yield f"K3 decode B=8 T={T}", (q, k, v, kvl), K3.work(kvl, T, H, Hkv, D, 2)
        if T == 1280:
            k8 = torch.randint(-127, 128, k.shape, generator=g, device=dev, dtype=torch.int8)
            v8 = torch.randint(-127, 128, k.shape, generator=g, device=dev, dtype=torch.int8)
            ks = (torch.rand((B, Hkv, T), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16)
            vs = (torch.rand((B, Hkv, T), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16)
            yield "K3 decode int8 T=1280", (q, k8, v8, kvl, ks, vs), K3.work(kvl, T, H, Hkv, D, 1)
    kvl = torch.tensor([1, 1280, 640, 700, 1000, 1279, 3, 512], device=dev)
    yield ("K3 decode strided attend_len=1280 view of T=4096", (q, k[:, :, :1280], v[:, :, :1280], kvl),
           K3.work(kvl, 1280, H, Hkv, D, 2))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    options = dict(a[2:].partition("=")[::2] for a in argv if a.startswith("--"))
    flush = {"write": flush_l2, "read": flush_l2_by_reading}[options.pop("flush", "write")]
    p1_rows = int(options.pop("p1-rows", PA.SHAPE[0]))
    if options:
        raise SystemExit(f"decode_variants: unknown options {sorted(options)}")
    variants = [Variant(spec) for spec in ([a for a in argv if not a.startswith("--")] or DEFAULT)]
    dev = torch.device("cuda")
    report = Report(card, flush)

    vs3 = [v for v in variants if "k3" in v.kernels]
    for name, args, work in (k3_cases(dev) if vs3 else ()):
        report.case(name, vs3, lambda x: x.k3(*args), K3.flash_decode_attention_plain(*args), work)

    vs4 = [v for v in variants if "k4" in v.kernels]
    for B, T, live in (PT.CELLS if vs4 else ()):
        rng = np.random.default_rng(PT.SEED)
        q, k, v, lens = PT.cell_inputs(rng, B, T, live, dev)
        cell = f"B={B} T={T} {int(live * 100)}% live"
        report.case(f"{cell} K3 flash_decode (contiguous)", vs4, lambda x: x.k3(q, k, v, lens),
                    K3.flash_decode_attention_plain(q, k, v, lens), K3.work(lens, T, PT.H, PT.HKV, PT.D, 2))
        for page in PT.PAGES:
            kpool, vpool, bt = PT.to_pages(k, v, page, rng)
            args = (q[:, 0], kpool, vpool, bt, lens, page)
            report.case(f"{cell} K4 paged[{page}]", vs4, lambda x: x.k4(*args),
                        K4.paged_decode_attention_plain(*args[:5], page_size=page),
                        K4.work(lens.cpu(), bt.cpu(), page, PT.H, PT.HKV, PT.D, 2))
        del k, v, kpool, vpool

    vs1 = [v for v in variants if "p1" in v.kernels]
    if vs1:
        q, k, v, _ = PA.probe_inputs(dev, p1_rows)
        ref, ref_sums = PA.stream_only_plain(q, k, v)
        mass = (k.double().abs() + v.double().abs()).reshape(ref_sums.shape[0], -1).sum(1)

        def check(result):
            out, sums = result
            step_ok = bool(((out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs() + 1e-5).all())
            sum_err = ((sums.double() - ref_sums.double()).abs() / mass).max().item()
            note = (f"out max_abs_err {err(out, ref):.3e}, within one bf16 step: {step_ok}; sums {sum_err:.3e} of the "
                    f"summed magnitudes (tol 1e-6)")
            return step_ok and sum_err <= 1e-6, note

        report.case(f"P1 stream_only B={p1_rows} T=1536 chunk 512 rb 4", vs1, lambda x: x.p1(q, k, v), None,
                    PA.stream_work(q, k), check)
    return 1 if report.wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
