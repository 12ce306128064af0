"""Pair-pipelined two-stage wave runner (port of runtime/pipeline.py).

Waves of B two-stage episodes flow through the Generator's composable stages so that
wave n's stage-1 DECODE and wave n-1's stage-2 DECODE run CO-BATCHED in one step loop
(Generator.run_decode_pair / models.decoder.decoder_forward_pair): each step reads the
weights once for both stages instead of twice.

The caller supplies three hooks; everything device-side is orchestrated here:
  build_stage1(w) -> PreparedBatch            B-row stage-1 batch for wave w
  build_stage2(w, out1, base_lengths, base_next_pos)
      -> (chunk_batch, keep_len, inert_mask | None)   stage-2 continuation for wave w
  on_complete(w, out1_tokens, out2_tokens)    called as each wave's episode finishes

Stage 1 may start from a shared KV PREFIX (the per-image [system + image] span, which
repeats across an image's questions): pass prefix=(holder_cache, keep_len) and make
build_stage1 return the [question + instruction] continuation chunk
(prepare_continuation) instead of a full prompt batch. The holder is never written:
every wave's stage 1 chunk-prefills a copy of it.

Where the reference dispatches a whole decode loop to the device and builds the next
stage on the host meanwhile, the Generator here launches every step's kernels itself:
the structure is the reference's, but the hooks' host work runs with the device idle.
Token buffers come to the host through HostCopy (a pinned buffer and an event), so a
readback starts where the reference starts its asynchronous copy and is waited for
where the reference materializes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .generate import GenerationConfig, Generator, HostCopy, PreparedBatch


@dataclasses.dataclass
class PairedWaveResult:
    wave: int
    out1: list  # per-row stage-1 token lists (trimmed)
    out2: list  # per-row stage-2 token lists (trimmed; [] for inert rows)


def run_paired_waves(
    gen: Generator,
    n_waves: int,
    build_stage1: Callable[[int], PreparedBatch],
    build_stage2: Callable[[int, list, np.ndarray, np.ndarray], Tuple],
    *,
    gen1: GenerationConfig,
    gen2: GenerationConfig,
    seed: int = 0,
    prefix: Optional[Tuple] = None,  # (holder_cache, keep_len (B,)) for prefix-KV stage 1
    prefix_grow_to: Optional[int] = None,  # stage-1 cache rows when prefix-seeded
    on_complete: Optional[Callable[[int, list, list], None]] = None,
    on_dispatch: Optional[Callable[[int], None]] = None,  # before wave w's prefill
    edges: str = "dummy",  # bootstrap/drain strategy: "dummy" | "solo"
):
    """Run n_waves pair-pipelined two-stage waves; returns [PairedWaveResult] unless
    on_complete consumes them (then returns []).

    All waves must have the SAME batch size B. The pair decode runs
    min(gen1, gen2).max_new_tokens joint steps; the longer stage finishes its
    remaining tokens in a solo loop. EITHER stage may be the longer one, and each
    keeps its own sampling config.

    edges="dummy" (default): bootstrap and drain pair with an inert dummy partner
    (rows start done), so every iteration runs the pair loop. edges="solo": the
    bootstrap wave decodes stage 1 in the plain solo loop and the drain finishes
    stage 2 solo, so NO dummy KV cache is ever allocated and at most two full caches
    are resident. Greedy token output is identical either way.

    prefix_grow_to: rows of the stage-1 cache when prefix-seeded; None means the
    generator's max_cache_len. A caller that knows the episode's final token count
    passes its bucket; 0 leaves the size to the stage's own need.
    """
    if n_waves <= 0:
        return []
    if edges not in ("dummy", "solo"):
        raise ValueError(f"edges must be 'dummy' or 'solo', got {edges!r}")
    steps = min(gen1.max_new_tokens, gen2.max_new_tokens)
    rest1 = gen1.max_new_tokens - steps
    rest2 = gen2.max_new_tokens - steps
    g_rest1 = dataclasses.replace(gen1, max_new_tokens=rest1)
    g_rest2 = dataclasses.replace(gen2, max_new_tokens=rest2)
    grow_to = gen.max_cache_len if prefix_grow_to is None else prefix_grow_to

    results: list = []
    pending = None  # (wave, base_lengths, base_next_pos, stage-1 tokens' HostCopy, cache1)
    attend1_last = None
    B = None

    def dummy_group(b, attend):
        dlogits = torch.zeros((b, gen.cfg.text.vocab_size), dtype=torch.float32, device=gen.device)
        return (dlogits, gen.new_cache(b), np.zeros((b,), np.int32), attend, np.ones((b,), bool))

    def stage2_group(pend):
        w, base_lengths, base_next, toks_host, cache1 = pend
        out1 = gen.trim_generated(toks_host.numpy())
        chunk, keep, inert = build_stage2(w, out1, base_lengths, base_next)
        logits2, cache2, attend2 = gen.run_chunk_prefill(
            cache1, chunk, keep, max_new=gen2.max_new_tokens
        )
        done0 = np.asarray(inert, bool) if inert is not None else None
        return out1, (logits2, cache2, chunk.next_pos, attend2, done0)

    def complete(out1_prev, buf_b_host):
        out2_prev = gen.trim_generated(buf_b_host.numpy())
        if on_complete is not None:
            on_complete(pending[0], out1_prev, out2_prev)
        else:
            results.append(PairedWaveResult(pending[0], out1_prev, out2_prev))

    for w in range(n_waves):
        b1 = build_stage1(w)
        if on_dispatch is not None:
            on_dispatch(w)
        if prefix is not None:
            holder, pkeep = prefix
            # Grow the stage-1 cache straight to the EPISODE's final extent so stage 2
            # continues in place. An explicit grow_to also keeps the holder unwritten:
            # run_chunk_prefill then works on a copy.
            logits1, cache1, attend1 = gen.run_chunk_prefill(
                holder, b1, pkeep, max_new=gen1.max_new_tokens, grow_to=grow_to,
            )
            base_lengths = np.asarray(pkeep) + np.asarray(b1.lengths)
        else:
            logits1, cache1, attend1 = gen.run_prefill(b1, max_new=gen1.max_new_tokens)
            base_lengths = np.asarray(b1.lengths)
        attend1_last = attend1
        B = logits1.shape[0]
        if pending is None and edges == "solo":
            # solo bootstrap: no partner wave yet, so stage 1 decodes its full budget
            # in the plain solo loop and no third KV cache is ever resident
            toks_dev, cache1 = gen.run_decode(
                logits1, cache1, b1.next_pos, gen1, seed=seed + 2 * w, attend=attend1
            )
            pending = (w, base_lengths, np.asarray(b1.next_pos), HostCopy(toks_dev), cache1)
            continue
        if pending is not None:
            out1_prev, group_b = stage2_group(pending)
        else:
            out1_prev, group_b = None, dummy_group(B, None)
        buf_a, done_a, la2, cache1, buf_b, done_b, lb2, cache_b2 = gen.run_decode_pair(
            (logits1, cache1, b1.next_pos, attend1, None), group_b,
            steps=steps, temperature=gen1.temperature, top_p=gen1.top_p,
            temperature_b=gen2.temperature, top_p_b=gen2.top_p,
            seed=seed + 2 * w,
        )
        if rest2 > 0 and pending is not None:
            # stage 2 is the LONGER budget: it finishes its remaining tokens solo.
            # Skipped on the bootstrap wave, whose dummy partner's output is discarded.
            rest_b, _ = gen.run_decode(
                lb2, cache_b2, np.asarray(group_b[2]) + steps, g_rest2,
                seed=seed + 2 * w + 1, attend=group_b[3], done0=done_b,
            )
            buf_b = torch.cat([buf_b, rest_b], dim=1)
        # stage 2 is FINISHED once its token buffer exists: drop the cache and logits
        # references NOW. Held until the next iteration rebinds them, the dead stage-2
        # cache would stay allocated through wave w+1's prefill and chunk prefill (a
        # third full cache at the peak).
        lb2 = cache_b2 = done_b = group_b = None
        buf_b_host = HostCopy(buf_b) if pending is not None else None
        buf_b = None  # bootstrap wave: the dummy partner's buffer is never read
        if rest1 > 0:
            rest, cache1 = gen.run_decode(
                la2, cache1, np.asarray(b1.next_pos) + steps, g_rest1,
                seed=seed + 2 * w + 1, attend=attend1, done0=done_a,
            )
            toks_dev = torch.cat([buf_a, rest], dim=1)
        else:
            toks_dev = buf_a
        toks_host = HostCopy(toks_dev)
        if pending is not None:
            complete(out1_prev, buf_b_host)
        pending = (w, base_lengths, np.asarray(b1.next_pos), toks_host, cache1)
    # drain: the last wave's stage 2, in the solo loop (edges="solo": no dummy cache)
    # or paired with an inert dummy stage-1 group (edges="dummy": the pair loop)
    out1_prev, group_b = stage2_group(pending)
    if edges == "solo":
        logits2, cache2, next2, attend2, done0 = group_b
        buf_b, _ = gen.run_decode(
            logits2, cache2, np.asarray(next2), gen2,
            seed=seed + 2 * n_waves, attend=attend2, done0=done0,
        )
    else:
        _, _, _, _, buf_b, done_b, lb2, cache_b2 = gen.run_decode_pair(
            dummy_group(B, attend1_last), group_b,
            steps=steps, temperature=gen1.temperature, top_p=gen1.top_p,
            temperature_b=gen2.temperature, top_p_b=gen2.top_p,
            seed=seed + 2 * n_waves,
        )
        if rest2 > 0:
            rest_b, _ = gen.run_decode(
                lb2, cache_b2, np.asarray(group_b[2]) + steps, g_rest2,
                seed=seed + 2 * n_waves + 1, attend=group_b[3], done0=done_b,
            )
            buf_b = torch.cat([buf_b, rest_b], dim=1)
    complete(out1_prev, HostCopy(buf_b))
    return results
