"""Time MiMo-V2.5's attention kernel forms on the card, each in turns with its plain
version and one SDPA call, and print one JSON line a case:

    python -m zoomearth_tpu_torch.scripts.time_hybrid_attention

The cases are K2's rows of PERF.md's kernel table at MiMo-V2.5's heads (B = 8): K2 with
the band and the sinks over a window layer's prefill and its chunk over a kept prefix,
K2 at 16 heads a KV head over the global layers' same calls; and K6 at the cell's decode
(B = 96, a 1280-slot attend span of a 1536-slot cache) in the window and global layers. Times are device ms from
CUDA graph replays, L2 cold (scripts/timing.py); each case's bound is its least work
(the ops modules' `work`) at 989 TFLOP/s or 3.35 TB/s (H100 SXM), and `max_abs_err`
is against the plain version. SDPA takes the same logits through an explicit mask (the
sink as one more key whose value is 0), built beforehand.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from ..ops import flash_causal as K2
from ..ops import flash_gqa_decode as K6
from . import timing

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
H, DQ, DV, WINDOW = 64, 192, 128, 128


def _randn(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def band_work(positions, kv_len, Hkv, T, window):
    """(flops, bytes) of a K2 call with a band at least: both products over each query's
    live keys, q read and out written once, each row's band of k and v rows read once."""
    klen = kv_len.long().clamp(0, T)[:, None]
    pos = positions.long()
    hi = torch.minimum(pos + 1, klen)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    live = (hi - lo).clamp(min=0)
    rows = (torch.minimum(pos.amax(1) + 1, klen[:, 0]) - lo.amin(1)).clamp(min=0)
    return (2 * H * (DQ + DV) * int(live.sum()),
            2 * (positions.numel() * H * (DQ + DV) + int(rows.sum()) * Hkv * (DQ + DV)))


def _sdpa_prefill(q, k, v, positions, kv_len, window, sink):
    """One SDPA call with the mask (and the sink column) built beforehand."""
    B, S, _, _ = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    t = torch.arange(T + 1, device="cuda")
    live = (t[None, None, :T] <= positions[:, :, None]) & (t[None, None, :T] < kv_len[:, None, None])
    if window:
        live &= t[None, None, :T] > positions[:, :, None] - window
    mask = torch.full((B, 1, S, T + 1), float("-inf"), device="cuda", dtype=torch.bfloat16)
    mask[..., :T].masked_fill_(live[:, None], 0.0)
    kk = torch.cat([k, torch.zeros_like(k[:, :, :1])], 2).repeat_interleave(H // Hkv, 1)
    vv = torch.cat([v, torch.zeros_like(v[:, :, :1])], 2).repeat_interleave(H // Hkv, 1)
    if sink is not None:
        mask = mask.expand(B, H, S, T + 1).clone()
        mask[..., T] = sink.to(mask.dtype)[None, :, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kk, vv, attn_mask=mask)


def _case(name, fns, work, err):
    ms, dev = timing.time_in_turns(fns)
    flops, nbytes = work
    bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    line = {"case": name, "device_ms": dev[0], "plain_device_ms": dev[1], "sdpa_device_ms": dev[2] if len(dev) > 2
            else None, "event_ms": ms[0], "bound_ms": bound, "by": "operations" if flops / PEAK_FLOPS
            > nbytes / PEAK_BYTES else "bytes", "share_of_bound": bound / dev[0], "max_abs_err": err}
    print(json.dumps(line), flush=True)


def prefill_cases():
    B = 8
    for label, S, T, keep in (("prefill B=8 S=768 T=768", 768, 768, [0] * B),
                              ("chunk B=8 S=384 T=1280, kept 700..900", 384, 1280,
                               [700 + (200 * i) // (B - 1) for i in range(B)])):
        keep = torch.as_tensor(keep, device="cuda")
        positions = keep[:, None] + torch.arange(S, device="cuda")[None]
        kv_len = (keep + S).to(torch.int32)
        for Hkv, window in ((8, WINDOW), (4, 0)):
            q = _randn((B, S, H, DQ), 1)
            kv = _randn((B, Hkv, T, DQ + DV), 2)
            k, v = kv[..., :DQ], kv[..., DQ:]
            sink = (_randn((H,), 3, torch.float32) * 2).contiguous() if window else None
            kernel = lambda: K2.causal_attention_cuda(q, k, v, positions, kv_len, window=window, sink=sink)  # noqa: E731
            plain = lambda: K2.flash_causal_attention_plain(q, k, v, positions, kv_len, window=window, sink=sink)  # noqa: E731
            err = (kernel().float() - plain().float()).abs().max().item()
            fns = [kernel, plain, _sdpa_prefill(q, k, v, positions, kv_len, window, sink)]
            kind = f"K2 band {window} + sinks, H=64 Hkv=8" if window else "K2 192/128, H=64 Hkv=4"
            _case(f"{kind}: {label}", fns, band_work(positions, kv_len, Hkv, T, window), err)
            del q, kv, k, v
            torch.cuda.empty_cache()


def decode_cases():
    B, T, attend = 96, 1536, 1280
    lens = torch.linspace(1000, 1280, B, device="cuda").to(torch.int32)
    for Hkv, window in ((8, WINDOW), (4, 0)):
        q = _randn((B, H, DQ), 4)
        kv = _randn((B, Hkv, T, DQ + DV), 5)
        k, v = kv[:, :, :attend, :DQ], kv[:, :, :attend, DQ:]
        sink = (_randn((H,), 6, torch.float32) * 2).contiguous() if window else None
        kernel = lambda: K6.gqa_decode_cuda(q, k, v, lens, DQ**-0.5, window, sink)  # noqa: E731
        plain = lambda: K6.flash_gqa_decode_plain(q, k, v, lens, DQ**-0.5, window, sink)  # noqa: E731
        err = (kernel().float() - plain().float()).abs().max().item()
        positions = (lens.long() - 1)[:, None]
        sdpa = _sdpa_prefill(q[:, None], k, v, positions, lens, window, sink)
        kind = f"K6 window {window} + sinks, G=8" if window else "K6 global, G=16"
        _case(f"{kind}: B=96 attend 1280 of T=1536, kv_len 1000..1280", [kernel, plain, sdpa],
              K6.work(lens, attend, H, Hkv, DQ, DV, window), err)


def main():
    with torch.inference_mode():
        prefill_cases()
        decode_cases()


if __name__ == "__main__":
    main()
