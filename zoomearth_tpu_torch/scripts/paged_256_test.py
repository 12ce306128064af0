"""Paged versus slot-contiguous decode attention on the card. Port of
scripts/paged_256_test.py.

At (B=32, T=4096, 30% live) and (B=64, T=4096, 30% live), H=16, Hkv=2, D=128, bf16,
it times in turns, L2 cold, per call (CUDA events) and on the device (CUDA graph
replays): the plain slot-contiguous decode attention, K3 on the contiguous cache,
and K4 and its plain version on the same k/v laid out in pages of 64 and of 256
tokens, and prints ms per 36-layer step. Before timing, each cell checks K4 against
K3 on that k/v. `decode_loop` is a short paged decode: append_to_pages then K4,
step by step, against the contiguous cache and K3 fed the same new k/v.

On a machine with one NVIDIA GPU:  python -m zoomearth_tpu_torch.scripts.paged_256_test
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import flash_decode, paged_attention
from ..ops.attention import decode_attention
from ..ops.flash_decode import decode_attention_cuda, flash_decode_attention
from ..ops.paged_attention import append_to_pages, paged_decode_attention, paged_decode_attention_plain
from .timing import PLAIN, time_in_turns

LAYERS = 36
CELLS = ((32, 4096, 0.3), (64, 4096, 0.3))
PAGES = (64, 256)
H, HKV, D = 16, 2, 128
SEED = 0
TOL_BF16 = 2e-2  # two bf16 roundings of outputs below 2 (both kernels accumulate in fp32)


def to_pages(k, v, page, rng):
    """Lay a contiguous (B, Hkv, T, D) cache out in pages of `page` slots at shuffled
    page ids. Returns (kpool, vpool, block_table): slot t of row b lives at
    pool[block_table[b, t // page], :, t % page]."""
    B, Hkv, T, D_ = k.shape
    max_pages = T // page
    ids = torch.from_numpy(rng.permutation(B * max_pages).astype(np.int32)).to(k.device)
    block_table = ids.reshape(B, max_pages)

    def pool(x):
        pages = x.reshape(B, Hkv, max_pages, page, D_).transpose(1, 2).reshape(B * max_pages, Hkv, page, D_)
        out = torch.empty_like(pages)
        out[ids.long()] = pages
        return out

    return pool(k), pool(v), block_table


def cell_lengths(rng, B, T, live_frac):
    """The reference cell's lengths, at 20-40 % of T (paged_256_test.py:46): rng's first draw."""
    return ((rng.random(B) * 0.2 + (live_frac - 0.1)) * T).astype(np.int32)


def cell_inputs(rng, B, T, live_frac, device):
    """The reference cell's tensors, the lengths drawn first."""
    lens = cell_lengths(rng, B, T, live_frac)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    q = bf16((B, 1, H, D))
    return q, bf16((B, HKV, T, D)), bf16((B, HKV, T, D)), torch.from_numpy(lens).to(device)


def measure_cell(B, T, live_frac):
    """One cell: K4 checked against K3 at each page size, then all of them, and K4's
    plain version at each page size, timed in turns. Returns ({case: (ms per call,
    device ms per call, GB/s of live cache read on device time or None)}, max
    |K4 - K3| over the page sizes)."""
    rng = np.random.default_rng(SEED)
    q, k, v, lens = cell_inputs(rng, B, T, live_frac, torch.device("cuda"))
    q3 = q[:, 0]
    k3 = decode_attention_cuda(q, k, v, lens)[:, 0]
    fns = [("plain decode_attention (contiguous)", lambda: decode_attention(q, k, v, kv_len=lens), None),
           ("K3 flash_decode (contiguous)", lambda: decode_attention_cuda(q, k, v, lens),
            flash_decode.read_bytes(lens, T, HKV, D, 2))]
    err = 0.0
    for page in PAGES:
        kpool, vpool, bt = to_pages(k, v, page, rng)
        out = paged_decode_attention(q3, kpool, vpool, bt, lens, page_size=page)
        err = max(err, (out.float() - k3.float()).abs().max().item())
        args = (q3, kpool, vpool, bt, lens)
        fns += [(f"K4 paged[{page}]", lambda a=args, page=page: paged_decode_attention(*a, page_size=page),
                 paged_attention.read_bytes(lens, bt, page, HKV, D, 2)),
                (f"K4 paged[{page}]{PLAIN}",
                 lambda a=args, page=page: paged_decode_attention_plain(*a, page_size=page), None)]
    if not err <= TOL_BF16:
        raise AssertionError(f"B={B} T={T}: K4 disagrees with K3 on the same k/v ({err:.3e})")
    ms, dev = time_in_turns([f for _, f, _ in fns])
    return {name: (t, d, nbytes and nbytes / d / 1e6) for (name, _, nbytes), t, d in zip(fns, ms, dev)}, err


def decode_loop(device, *, B=4, steps=12, page=256, max_pages=4, seed=1):
    """`steps` decode steps on pools and on the contiguous cache (T = max_pages * page)
    fed the same new k/v: append_to_pages then K4, against a dropped-at-capacity slot
    write then K3 (their plain versions on the CPU). Row 0 starts at full capacity,
    so its writes are dropped. Returns (max |K4 - K3| over the steps, row 0's pages
    unchanged, final pools == cache on every live slot)."""
    rng = np.random.default_rng(seed)
    T = max_pages * page

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)

    k, v = bf16((B, HKV, T, D)), bf16((B, HKV, T, D))
    kpool, vpool, bt = to_pages(k, v, page, rng)
    lens = torch.from_numpy(rng.integers(1, T - steps, size=B).astype(np.int32)).to(device)
    lens[0] = T
    full_pages = bt[0].long()
    k_full0, v_full0 = kpool[full_pages].clone(), vpool[full_pages].clone()
    rows = torch.arange(B, device=device)
    err = 0.0
    for _ in range(steps):
        k_new, v_new, q = bf16((B, HKV, D)), bf16((B, HKV, D)), bf16((B, H, D))
        append_to_pages(kpool, vpool, k_new, v_new, bt, lens, page_size=page)
        keep = lens < T
        k[rows[keep], :, lens[keep].long()] = k_new[keep]
        v[rows[keep], :, lens[keep].long()] = v_new[keep]
        lens = torch.clamp(lens + 1, max=T)
        out = paged_decode_attention(q, kpool, vpool, bt, lens, page_size=page)
        ref = flash_decode_attention(q, k, v, lens)
        err = max(err, (out.float() - ref.float()).abs().max().item())
    unchanged = torch.equal(kpool[full_pages], k_full0) and torch.equal(vpool[full_pages], v_full0)
    live = torch.arange(T, device=device)[None] < lens[:, None]
    same = all(torch.equal(pool[bt.long()].transpose(2, 3).reshape(B, T, HKV, D)[live], x.transpose(1, 2)[live])
               for pool, x in ((kpool, k), (vpool, v)))
    return err, unchanged, same


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_256_test: needs a CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    for B, T, live in CELLS:
        rows, err = measure_cell(B, T, live)
        print(f"B={B} T={T} {int(live * 100)}% live | K4 vs K3 max_abs_err {err:.3e} (tol {TOL_BF16})")
        for name, (ms, dev, gbs) in rows.items():
            rate = f", {gbs:.1f} GB/s of live cache read" if gbs else ""
            print(f"B={B} T={T} {int(live * 100)}% live | {name}: {ms * LAYERS:.2f} ms/{LAYERS}-layer-step "
                  f"({ms:.4f} ms/call; device {dev * LAYERS:.2f} ms/{LAYERS}-layer-step{rate})", flush=True)
    err, unchanged, same = decode_loop(torch.device("cuda"))
    print(f"paged decode loop: K4 vs K3 max_abs_err {err:.3e}; full row's pages unchanged: {unchanged}; "
          f"pools equal the contiguous cache on live slots: {same}")
    return 0 if (unchanged and same and err <= TOL_BF16) else 1


if __name__ == "__main__":
    sys.exit(main())
