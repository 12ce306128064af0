"""Continuous-batching serving engine: slot-based KV cache, chunked decode, per-request
sampling (port of serve/engine.py).

A fixed pool of `max_slots` cache slots, one decode chunk stepping the live slots
together, and batched pool-level prefill, so requests join and leave mid-flight
without draining the batch.

- Admission and continuation share ONE device routine: `_pool_prefill` chunk-prefills
  a padded (R, S) batch of token chunks into the slot pool at each row's keep_len (0
  for fresh prompts, prompt + kept for stage-2 continuations). A burst of N queued
  requests costs one batched prefill, and the first token of each row is sampled on
  the device (one small readback per batch).
- Prefix KV cache: a request may name its shared leading span (`prefix_key`,
  `prefix_len`), image blocks included. The first such request prefills in full and
  its span's KV is harvested into a prefix pool on the device; later requests copy
  the span into their slot and prefill only the suffix, skipping the span's ViT pass.
- Rows that do not take part in a decode chunk (held or idle) write garbage at their
  own `length` slot, beyond their valid window: never read (attention masks slot >=
  length), and overwritten by the row's next prefill. Their `length` does not advance.

The scheduler (`step`, the queue, the slots) is pure Python and is the reference's.
The device side is eager PyTorch on the params' device: the slot pool is ONE KVCache
written in place, `cur_tokens` / `next_pos` are device tensors written in place, and
random draws come from one `torch.Generator` seeded from `seed` on that device.
What differs from the functional reference, and why:

- Padding rows of a batch carry slot_idx == max_slots. The reference clamps their
  gathers and lets its scatters drop them; an index of max_slots would be a
  device-side assert on CUDA, so the live rows are picked on the host (slot_idx is
  built there) and only they are written back. Nothing waits for the device.
- Every refusal the scheduler relies on to isolate a poison row is raised on the
  host before anything is launched (`bucket`, the kernels' `require_*` checks): a
  device-side assert could be neither caught nor retried.
- `torch.inference_mode()` and the current CUDA device are per thread, and the pump
  thread and an HTTP server's handler threads are not the thread that built the
  engine: every method that touches the device enters both itself (`_device_scope`).
- The decode chunk is one step function of `decode_chunk` steps with no host
  contact and one readback of the (rows, steps) tokens at its end. On CUDA it is
  captured into a CUDA graph per key and replayed (runtime.graphs), the counterpart
  of the reference's decode programs cached per `attend` and per `(R, attend)`: the
  full-width chunk's key is (steps, attend, whether a row samples), and it runs in
  place on the pool; the compact chunk's adds its row bucket R, and it runs on
  persistent staging rows that the live rows are gathered into and written back
  from, outside the graph. A key's first chunk runs eagerly, every later one
  replays. Host arrays (`active`, the temperatures) are copied into static buffers
  before each chunk. The graphs read the pool and the weights by address: they are
  dropped by `reset_state()` and by a `params` assignment that moves a leaf; `reseed()`
  reseeds the generator they are registered with in place. On the CPU the same step
  runs eagerly.
- `precompile` loads the kernel library, runs each prefill shape once and captures
  the decode chunks at `attend_len` None, with inert inputs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import VLMConfig, is_kimi
from ..models.decoder import KVCache, write_index
from ..models.params import torch_dtype, tree_leaves
from ..models.rope import mrope_chunk_position_ids, mrope_position_ids
from ..models.vit import meta_to_device, vision_metadata
from ..models.vlm import compute_vision_embeds, vlm_forward
from ..runtime.families import meta_dict
from ..runtime.generate import DEFAULT_LENGTH_BUCKETS, HostCopy, bucket
from ..runtime.graphs import StepGraphs

# Coarser than the batch Generator's buckets on purpose: admission batches vary in how
# many images they carry (scheduler timing), and the patch count decides the padding
# of every ViT pass and where a burst of images is split.
ENGINE_PATCH_BUCKETS = (0, 4096, 12800, 24576, 32768)


@dataclasses.dataclass
class Request:
    request_id: str
    token_ids: List[int]
    images: List[Tuple[np.ndarray, Tuple[int, int, int]]]  # (pixel_values, grid)
    max_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 1.0  # carried, not applied (as in the reference)
    # hold_slot: keep the KV cache resident after completion so a continuation
    # (stage-2 zoom) can resume from it: the episode-serving pattern.
    hold_slot: bool = False
    # Prefix caching, image blocks included: prefix_key names the shared leading span
    # token_ids[:prefix_len] (which may contain expanded image pads, e.g. "system +
    # stage-1 image" shared by every question about the same tile). The first request
    # computes and stores its KV; later requests with the same key prefill only the
    # suffix and skip the prefix's ViT pass. n_prefix_images of `images` belong to
    # the prefix span.
    prefix_key: Optional[str] = None
    prefix_len: int = 0
    n_prefix_images: int = 0
    enqueued_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class Continuation:
    """Continue a HELD request: truncate its cache to prompt + kept_tokens generated
    tokens, prefill chunk_ids (e.g. residual text + crop vision tokens), decode on."""

    parent_request_id: str
    request_id: str
    chunk_ids: List[int]
    images: List[Tuple[np.ndarray, Tuple[int, int, int]]]
    kept_tokens: int  # generated tokens to keep from the parent
    max_tokens: int = 256
    temperature: float = 0.0
    hold_slot: bool = False


@dataclasses.dataclass
class Completion:
    request_id: str
    token_ids: List[int]
    finish_reason: str  # "stop" | "length" | "error"
    prompt_tokens: int
    created_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    held: bool = False  # completed but cache retained for a continuation
    prompt_len: int = 0
    prompt_next_pos: int = 0  # M-RoPE position right after the prompt


@dataclasses.dataclass
class _PrefillRow:
    """One host-prepared row of a batched pool prefill."""

    slot: int
    request: Request
    chunk_ids: List[int]
    images: List[Tuple[np.ndarray, Tuple[int, int, int]]]
    keep_len: int  # cache entries kept below the chunk
    start_pos: int  # M-RoPE position of the chunk's first token
    prompt_len: int  # full logical prompt length after this prefill
    use_prefix: Optional[str] = None  # prefix-store key whose KV seeds this slot
    save_prefix: Optional[str] = None  # store [0, prefix_len) KV under this key after
    prefix_next_pos: int = 0  # M-RoPE position after the prefix span (save path)
    done: bool = False  # set once this row's prefill fully committed (slot activated);
    #                     step()'s failure-isolation retry skips done rows (a split
    #                     batch can succeed group 1, then raise in group 2)


@dataclasses.dataclass
class _PrefixEntry:
    """Metadata of a cached prefix span; its KV lives in the device-side prefix pool
    at row `index`."""

    index: int
    token_ids: List[int]
    next_pos: int  # M-RoPE position right after the span
    last_used: float = dataclasses.field(default_factory=time.time)

    @property
    def length(self) -> int:
        return len(self.token_ids)


@dataclasses.dataclass
class _ChunkIO:
    """Static device inputs and outputs of a decode chunk (see _chunk_io)."""

    act: torch.Tensor  # (R,) bool: rows that take part
    temps: torch.Tensor  # (R,) fp32: sampling temperatures, read when `sampling`
    tokens: torch.Tensor  # (R, n_steps) int64: the chunk's tokens
    sampling: bool = False  # whether any row of this chunk samples (decides the graph)


@dataclasses.dataclass
class _Staging:
    """A compact chunk's persistent staging rows (see _staging_for)."""

    cache: KVCache
    cur: torch.Tensor  # (R,) int64
    pos: torch.Tensor  # (R,) int64


def _cache_tensors(cache: KVCache) -> List[torch.Tensor]:
    """Every tensor of a cache by rows: k, v, the int8 scales where there are, `length` last."""
    return cache.k + cache.v + ((cache.kscale + cache.vscale) if cache.quantized else []) + [cache.length]


class ServingEngine:
    """Continuous batching over `max_slots` concurrent sequences, on the device the
    params live on.

    Usage: submit(request) then poll/step; or start()/stop() for a background pump
    thread with results delivered to the callback or collected via get_completion.
    """

    def __init__(
        self,
        params,
        cfg: VLMConfig,
        *,
        max_slots: int = 8,
        max_seq_len: int = 2048,
        decode_chunk: int = 8,
        cache_dtype=None,
        length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
        patch_buckets: Sequence[int] = ENGINE_PATCH_BUCKETS,
        seed: int = 0,
    ):
        if is_kimi(cfg):
            raise NotImplementedError("ServingEngine: no slot pool for a latent cache (Kimi-VL); run it through the "
                                      "Generator (run_inference, run_episodes_pipelined)")
        self.device = params["text"]["embed"]["weight"].device
        # the decode chunks' captured graphs by key (public: their counts are read), the
        # static buffers they read, and the compact chunks' staging rows by row bucket
        self.graphs = StepGraphs(self.device)
        self._chunk_bufs: Dict[Tuple[int, int], _ChunkIO] = {}
        self._staging: Dict[int, _Staging] = {}
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = decode_chunk
        self.length_buckets = tuple(b for b in length_buckets if b <= max_seq_len)
        self.patch_buckets = patch_buckets
        # Admission debounce: when requests trickle in (the submitter thread is still
        # encoding prompts 2..N when request 1 lands), wait this long for stragglers so
        # a burst becomes ONE batched prefill instead of a 1-row + (N-1)-row split.
        self.admission_debounce_s = 0.012
        # Admission coalescing: while other slots are decoding, hold admissions until
        # at least this many rows are ready (each prefill batch has a fixed dispatch +
        # ViT cost; trickled single-row admissions fragment it). 1 = admit eagerly.
        self.admit_min_batch = 1
        # Compact-prefill row-count buckets (clipped to max_slots): a batch of R rows
        # is padded to the smallest of these that holds it.
        self.row_buckets = (4, 8, 16, 32, 64, 128, 256)
        self.cache_dtype = torch_dtype(cache_dtype if cache_dtype is not None else cfg.dtype)
        # int8 KV composes with the prefix pool: the pool stores int8 values AND the
        # per-token scale rows (harvest and apply copy both).
        self._kv_int8 = self.cache_dtype == torch.int8
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._stop_tokens = (cfg.tokens.eos, cfg.tokens.endoftext)
        self.held: Dict[str, int] = {}  # request_id -> held slot index
        self.reset_state()
        self.queue: "queue.Queue" = queue.Queue()  # Request | Continuation
        # ids currently inside a scheduler tick (pulled from the queue but not yet
        # visible in slots): cancel_prefix must see these as in-flight
        self._in_admission: set = set()
        self.results: Dict[str, Completion] = {}
        self._results_cond = threading.Condition()
        # Decode attend-span bucketing: attention reads only a prefix view of the
        # cache (decoder attend_len) covering the live rows' max extent + chunk, e.g.
        # stage-1 decode of a zoom episode never touches rows past ~1024 of a 2048
        # allocation. () to disable; None (full span) is always the fallback.
        self.decode_attend_buckets = tuple(b for b in (512, 1024, 1536) if b < max_seq_len)
        # Decode row-compaction ("step only live seqs"): when the live-slot count fits
        # a bucket < max_slots, the decode chunk gathers those rows' cache, steps at
        # batch R, and writes back: cache reads scale with live rows. () disables it.
        self.decode_row_buckets = tuple(sorted({
            b for b in (
                -(-max_slots // 4 // 4) * 4 if max_slots >= 16 else max(1, max_slots // 2),
                -(-max_slots // 2 // 4) * 4 if max_slots >= 16 else max(1, max_slots // 2),
                -(-(3 * max_slots) // 4 // 4) * 4 if max_slots >= 16 else max(1, max_slots // 2),
            ) if 0 < b < max_slots
        }))
        self.prefix_store: Dict[str, _PrefixEntry] = {}
        self.max_prefixes = 64  # prefix-pool rows
        self.prefix_cap = 512  # longest cacheable prefix span (tokens)
        # Explicit free-list of pool rows: len(prefix_store) is NOT a safe allocator: a
        # duplicate save of a live key would burn a fresh index without growing the
        # dict, and the next distinct key would then alias a live row's KV.
        self._free_prefix_rows = list(range(self.max_prefixes - 1, -1, -1))
        self._ppool: Optional[KVCache] = None  # lazy: (P, Hkv, cap[, D]) per layer, as a KVCache
        self._pump_thread: Optional[threading.Thread] = None
        self._running = False
        # Optional completion hook (called from the pump thread inside _finish: keep it
        # O(1), e.g. queue.put): lets a caller consume completions without one blocked
        # get_completion() thread per request.
        self.on_completion: Optional[Callable[[Completion], None]] = None
        # Optional incremental-token hook (pump thread, once per decode chunk per live
        # row, and once for the prefill's first token): on_tokens(request_id, new_toks).
        # Tokens already exclude the stop token (mirrors Completion.token_ids). Keep it
        # O(1) (queue.put): it runs inside the scheduler tick. Powers SSE streaming on
        # the OpenAI endpoint (serve/server.py).
        self.on_tokens: Optional[Callable[[str, List[int]], None]] = None
        self.stats = {"completed": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_rows": 0, "prefix_hits": 0, "prefix_saves": 0}
        # wall-clock phase accounting (host thread time, includes device wait): where
        # do engine ticks go? read via stats_timing()
        self._phase_s = collections.defaultdict(float)
        self._latencies = collections.deque(maxlen=1024)  # submit -> completion, seconds

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        """Assign the weights. A captured chunk reads them by address, so an assignment
        that moves any leaf (new tensors, another shape or layout) drops every captured
        chunk; handing over the same tensors (GRPO's weight handoff each rollout, the
        weights updated in place) keeps them, and the replays read the new values."""
        layout = [(t.data_ptr(), t.shape, t.stride(), t.dtype) for t in tree_leaves(params)]
        if layout != getattr(self, "_params_layout", None):
            self.graphs.drop()
        self._params, self._params_layout = params, layout

    def reseed(self, seed: int) -> None:
        """Restart the sampler's stream from `seed`, as a new engine's would start. The
        generator is reseeded in place: the captured chunks it is registered with read
        its state at every replay, so they stay."""
        self._rng.manual_seed(seed)

    def stats_timing(self):
        """Cumulative seconds per engine phase (prefill_host_prep, prefill_vit_dispatch,
        prefill_pool_dispatch, prefill_store_dispatch, prefill_readback_wait,
        prefill_device, decode_device, debounce_sleep)."""
        return {k: round(v, 3) for k, v in sorted(self._phase_s.items())}

    def latency_percentiles(self):
        """p50/p95 request latency (submit to completion) over the last 1024 completions."""
        if not self._latencies:
            return {"p50_latency_s": None, "p95_latency_s": None}
        arr = np.asarray(self._latencies)
        return {
            "p50_latency_s": round(float(np.percentile(arr, 50)), 3),
            "p95_latency_s": round(float(np.percentile(arr, 95)), 3),
        }

    # ------------------------------------------------------------------
    # device routines
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _device_scope(self):
        """Inference mode and, on CUDA, this engine's device as the current one, for
        the calling thread: both are per-thread state, and the pump thread and a
        server's handler threads start with neither."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            yield

    def _tensor(self, a, dtype):
        """A host array as a NEW tensor on the engine's device (never a view of the
        array: some of these tensors are written in place afterwards)."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _gather_rows(self, cache: KVCache, cidx: torch.Tensor, length: torch.Tensor) -> KVCache:
        """A copy of the pool rows cidx (contiguous, so aligned as the pool is) with
        its own `length` tensor; the int8 scales come along."""
        quant = cache.quantized
        return KVCache(
            k=[k[cidx] for k in cache.k], v=[v[cidx] for v in cache.v], length=length,
            kscale=[s[cidx] for s in cache.kscale] if quant else None,
            vscale=[s[cidx] for s in cache.vscale] if quant else None,
        )

    def _scatter_rows(self, cache: KVCache, gcache: KVCache, slot_idx: np.ndarray) -> Optional[Tuple]:
        """Write the gathered rows whose slot_idx is a pool row back into the pool
        (`length` included). Rows with slot_idx == max_slots are padding and are left
        out here, on the host: nothing is dropped on the device. Returns the (rows,
        slots) index tensors of the rows written, or None when there were none."""
        live = np.nonzero(slot_idx < self.max_slots)[0]
        if live.size == 0:
            return None
        rows = self._tensor(live, torch.int64)
        slots = self._tensor(slot_idx[live], torch.int64)
        whole = live.size == slot_idx.size

        def put(pool, gathered):
            for p, g in zip(pool, gathered):
                p.index_copy_(0, slots, g if whole else g.index_select(0, rows))

        put(cache.k, gcache.k)
        put(cache.v, gcache.v)
        if cache.quantized:
            put(cache.kscale, gcache.kscale)
            put(cache.vscale, gcache.vscale)
        put([cache.length], [gcache.length])
        return rows, slots

    def _sample(self, logits: torch.Tensor, t: Optional[torch.Tensor]) -> torch.Tensor:
        """Per row: greedy where t <= 0, else a draw at max(t, 1e-4) from the engine's
        generator. t is None when no row samples (the caller decides from its host
        array): nothing is drawn then, and the generator's stream stays where it was."""
        tok = torch.argmax(logits, dim=-1)
        if t is None:
            return tok
        greedy_row = t <= 0.0
        # a greedy row's draw is thrown away: give it flat logits, so that whatever it
        # holds (a padding row's garbage) can never fail the draw's checks on the device
        scaled = torch.where(greedy_row[:, None], 0.0, logits.float() / t.clamp(min=1e-4)[:, None])
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=self._rng)[:, 0]
        return torch.where(greedy_row, tok, sampled)

    def _pool_prefill(self, slot_idx, ids, chunk_lens, keep_lens, pos, vision_embeds, new_next_pos, temps):
        """Row-compacted chunk prefill into the slot pool.

        slot_idx: (R,) pool rows of this batch (R a small bucket, NOT max_slots: an
        admission of 4 rows does not pay a (max_slots, S) forward). Padding rows
        carry slot_idx == max_slots and chunk_lens 0: they are gathered from a
        clamped row, attend to nothing that matters, and are never written back. All
        arguments but vision_embeds are host arrays; the kv write index is built from
        them, so no layer waits for the device.

        Returns the (R,) first tokens on the device, sampled there."""
        R, S = ids.shape
        T = self.max_seq_len
        cache = self.cache
        cidx = self._tensor(np.clip(slot_idx, 0, self.max_slots - 1), torch.int64)
        keep = self._tensor(keep_lens, torch.int32)
        gcache = self._gather_rows(cache, cidx, keep)
        iota = np.arange(S)[None]
        host_pos = keep_lens.astype(np.int64)[:, None] + iota
        valid = iota < chunk_lens[:, None]
        # pads write to slot T -> dropped by the kv write
        host_write = np.where(valid, host_pos, T)
        logits, gcache = vlm_forward(
            self.params, self.cfg, self._tensor(ids, torch.int64), self._tensor(pos, torch.int32),
            vision_embeds=vision_embeds,
            attn_positions=self._tensor(host_pos, torch.int64), attn_valid=self._tensor(valid, torch.bool),
            cache=gcache, update_cache_len=False,
            logit_index=self._tensor(np.maximum(chunk_lens - 1, 0), torch.int64),
            write_pos=self._tensor(host_write, torch.int64),
            write_index=write_index(host_write, T, self.device),
        )
        gcache.length.copy_(self._tensor(keep_lens + chunk_lens, torch.int32))
        tok = self._sample(logits, self._tensor(temps, torch.float32) if (temps > 0.0).any() else None)
        written = self._scatter_rows(cache, gcache, slot_idx)
        if written is not None:
            rows, slots = written
            self.cur_tokens.index_copy_(0, slots, tok.index_select(0, rows))
            self.next_pos.index_copy_(0, slots, self._tensor(new_next_pos, torch.int64).index_select(0, rows))
        return tok

    def _apply_prefixes(self, slots: Sequence[int], entry_idx: Sequence[int], tp: Sequence[int]):
        """Seed slot slots[j]'s [0, tp[j]) cache region from prefix-pool row
        entry_idx[j], for every j at once: one (slot, pool row, position) index, built
        on the host, serves k, v and the int8 scales of every layer."""
        cap = min(self.prefix_cap, self.max_seq_len)
        n = [min(int(t), cap) for t in tp]
        if sum(n) == 0:
            return
        dst = self._tensor(np.repeat(np.asarray(slots), n), torch.int64)
        src = self._tensor(np.repeat(np.asarray(entry_idx), n), torch.int64)
        t = self._tensor(np.concatenate([np.arange(x) for x in n]), torch.int64)
        cache, pool = self.cache, self._ppool
        pairs = list(zip(cache.k, pool.k)) + list(zip(cache.v, pool.v))
        if cache.quantized:
            pairs += list(zip(cache.kscale, pool.kscale)) + list(zip(cache.vscale, pool.vscale))
        for c, p in pairs:
            c[dst, :, t] = p[src, :, t]

    def _attend_for(self, live):
        """Attention span bucket covering the live rows' cache extents after this
        chunk (prompt + generated so far + chunk + slack), or None (full span).
        Host-side slot state is the bound; held/idle rows are not stepped (compact)
        or produce ignored garbage (full width), so only live rows constrain it."""
        if not self.decode_attend_buckets or not live:
            return None
        need = max(
            self.slots[i].prompt_len + len(self.slots[i].generated) for i in live
        ) + self.decode_chunk + 2
        return next((a for a in self.decode_attend_buckets if need <= a), None)

    def _decode_loop(self, cache: KVCache, cur, pos, io: "_ChunkIO", attend_len: Optional[int]):
        """The step function of a decode chunk: io.tokens.shape[1] decode steps over
        `cache` (written in place), `cur` and `pos` (both (B,) int64, advanced in place),
        the tokens written to io.tokens. Rows where io.act is false step too (they write
        garbage at their own `length` slot, or nowhere when it equals T) but emit the pad
        id and keep their `length` and `pos`. It reads no host value and waits for
        nothing: a chunk's graph captures it."""
        B, n_steps = io.tokens.shape
        inc = io.act.to(torch.int32)
        inc_pos = io.act.to(pos.dtype)
        pad = torch.full_like(cur, self.cfg.tokens.pad)
        for step in range(n_steps):
            pos3 = pos[None, :, None].expand(3, B, 1)
            logits, _ = vlm_forward(
                self.params, self.cfg, cur[:, None], pos3,
                attn_positions=cache.length[:, None], cache=cache,
                update_cache_len=False, attend_len=attend_len,
            )
            cache.length.add_(inc)
            tok = torch.where(io.act, self._sample(logits[:, 0], io.temps if io.sampling else None), pad)
            io.tokens[:, step] = tok
            cur.copy_(tok)
            pos.add_(inc_pos)

    def _chunk_io(self, rows: int, n_steps: int, active: np.ndarray, temps: np.ndarray) -> "_ChunkIO":
        """The static inputs and outputs of a chunk of `rows` rows (one set per shape,
        shared by its graphs, which replay one at a time), with this chunk's host arrays
        copied in: outside any graph, so a replay reads this chunk's values."""
        io = self._chunk_bufs.get((rows, n_steps))
        if io is None:
            io = self._chunk_bufs[(rows, n_steps)] = _ChunkIO(
                act=torch.zeros((rows,), dtype=torch.bool, device=self.device),
                temps=torch.zeros((rows,), dtype=torch.float32, device=self.device),
                tokens=torch.zeros((rows, n_steps), dtype=torch.int64, device=self.device),
            )
        io.act.copy_(torch.from_numpy(np.ascontiguousarray(active, dtype=bool)))
        io.sampling = bool((temps > 0.0).any())
        if io.sampling:
            io.temps.copy_(torch.from_numpy(np.ascontiguousarray(temps, dtype=np.float32)))
        return io

    def _run_chunk(self, key, cache: KVCache, cur, pos, io: "_ChunkIO", attend_len: Optional[int]) -> torch.Tensor:
        """One decode chunk through the graph cached under key + (attend_len, whether a
        row samples): the counterpart of the reference's decode program cached per key.
        Returns a copy of the (rows, n_steps) tokens on the device."""
        self.graphs.run(key + (attend_len, io.sampling),
                         lambda: self._decode_loop(cache, cur, pos, io, attend_len),
                         (self._rng,) if io.sampling else ())
        return io.tokens.clone()

    def _decode_steps(self, active, temps, *, n_steps, attend_len=None):
        """One full-width decode chunk, in place on the pool: all max_slots rows step,
        inactive ones inertly (see _decode_loop). Returns tokens (max_slots, n_steps)
        on the device."""
        io = self._chunk_io(self.max_slots, n_steps, active, temps)
        return self._run_chunk(("full", n_steps), self.cache, self.cur_tokens, self.next_pos, io, attend_len)

    def _staging_for(self, R: int) -> "_Staging":
        """The persistent staging rows of the compact chunk at row bucket R: a cache of
        R rows in the pool's layout and the rows' current tokens and positions. They
        live as long as the engine, so a compact chunk's graph replays on them."""
        stage = self._staging.get(R)
        if stage is None:
            stage = self._staging[R] = _Staging(
                cache=KVCache.create(self.cfg.text, R, self.max_seq_len, self.cache_dtype, self.device),
                cur=torch.zeros((R,), dtype=torch.int64, device=self.device),
                pos=torch.zeros((R,), dtype=torch.int64, device=self.device),
            )
        return stage

    def staging_bytes(self) -> int:
        """Bytes of the compact chunks' staging caches allocated so far."""
        return sum(sum(t.numel() * t.element_size() for t in _cache_tensors(s.cache)) for s in self._staging.values())

    def _decode_steps_compact(self, slot_idx, active, temps, *, n_steps, attend_len=None):
        """Row-compacted decode chunk: gather the R rows' cache ONCE into the staging
        rows of bucket R, run n_steps at batch R, write back (the slot_idx pattern of
        _pool_prefill). Decode attention reads scale with LIVE rows, not max_slots; the
        gather and the write-back are two passes over R rows of the pool per chunk,
        amortized over n_steps, both outside the chunk's graph.

        slot_idx: (R,) pool rows; padding rows carry max_slots (gathered from a
        clamped row, active false, never written back). active/temps are (R,) host
        arrays. Returns tokens (R, n_steps) on the device."""
        R = len(slot_idx)
        stage = self._staging_for(R)
        cidx = self._tensor(np.clip(slot_idx, 0, self.max_slots - 1), torch.int64)
        for src, dst in zip(_cache_tensors(self.cache) + [self.cur_tokens, self.next_pos],
                            _cache_tensors(stage.cache) + [stage.cur, stage.pos]):
            torch.index_select(src, 0, cidx, out=dst)
        io = self._chunk_io(R, n_steps, active, temps)
        tokens = self._run_chunk(("compact", R, n_steps), stage.cache, stage.cur, stage.pos, io, attend_len)
        written = self._scatter_rows(self.cache, stage.cache, slot_idx)
        if written is not None:
            rows, slots = written
            self.cur_tokens.index_copy_(0, slots, stage.cur.index_select(0, rows))
            self.next_pos.index_copy_(0, slots, stage.pos.index_select(0, rows))
        return tokens

    def precompile(self, *, progress: Optional[Callable[[str], None]] = None):
        """Warm every device routine the engine can hit: on CUDA load (and, the first
        time, build) the kernel library, then run one inert pool prefill per row
        bucket and two inert decode chunks per row bucket and at full width, at
        attend_len None and greedy: the first runs eagerly, the second captures the
        chunk's graph and replays it. Inert inputs (slot_idx past the pool, chunk_lens
        0, no active row) change no row's valid window; the pool, `cur_tokens` and
        `next_pos` are then zeroed in place (not reallocated, which would drop the
        graphs), so serving starts from a clean state."""
        cfg = self.cfg
        with self._device_scope():
            if self.device.type == "cuda":
                if progress:
                    progress("kernels")
                from ..ops import _cuda

                _cuda.lib()
            S = self.length_buckets[0]
            for RB in sorted({r for r in self.row_buckets if r <= self.max_slots} | {self.max_slots}):
                if progress:
                    progress(f"pool[{RB}, {S}]")
                self._pool_prefill(
                    np.full((RB,), self.max_slots, np.int32),  # all rows padding
                    np.full((RB, S), cfg.tokens.pad, np.int32),
                    np.zeros((RB,), np.int32), np.zeros((RB,), np.int32),
                    np.ones((3, RB, S), np.int32), None,
                    np.zeros((RB,), np.int32), np.zeros((RB,), np.float32),
                )
            if progress:
                progress("decode")
            for _ in range(2):
                self._decode_steps(np.zeros((self.max_slots,), bool), np.zeros((self.max_slots,), np.float32),
                                   n_steps=self.decode_chunk)
            for R in self.decode_row_buckets:
                if progress:
                    progress(f"decode_compact[{R}]")
                for _ in range(2):
                    self._decode_steps_compact(
                        np.full((R,), self.max_slots, np.int32), np.zeros((R,), bool),
                        np.zeros((R,), np.float32), n_steps=self.decode_chunk,
                    )
            self._ensure_ppool()
            for t in _cache_tensors(self.cache) + [self.cur_tokens, self.next_pos]:
                t.zero_()
        self._clear_slots()

    def reset_state(self):
        """Reallocate the slot pool's device state (drops all in-flight work, and the
        captured chunks, which read the old pool)."""
        self.graphs.drop()
        with self._device_scope():
            self.cache = KVCache.create(self.cfg.text, self.max_slots, self.max_seq_len, self.cache_dtype,
                                        self.device)
            self.cur_tokens = torch.zeros((self.max_slots,), dtype=torch.int64, device=self.device)
            self.next_pos = torch.zeros((self.max_slots,), dtype=torch.int64, device=self.device)  # M-RoPE position
        self._clear_slots()

    def _clear_slots(self):
        self.active = np.zeros((self.max_slots,), bool)
        self.slots: List[_Slot] = [_Slot() for _ in range(self.max_slots)]
        self.held.clear()

    # ------------------------------------------------------------------
    # prefix KV cache (lazy, keyed store)
    # ------------------------------------------------------------------

    def _harvest_prefix(self, slot: int, idx: int, Tp: int):
        """Copy slot `slot`'s [0, Tp) KV (and int8 scales) into prefix-pool row idx."""
        n = min(Tp, self.prefix_cap)
        cache, pool = self.cache, self._ppool
        pairs = list(zip(pool.k, cache.k)) + list(zip(pool.v, cache.v))
        if cache.quantized:
            pairs += list(zip(pool.kscale, cache.kscale)) + list(zip(pool.vscale, cache.vscale))
        for p, c in pairs:
            p[idx, :, :n] = c[slot, :, :n]

    def _ensure_ppool(self):
        if self._ppool is None:
            with self._device_scope():
                self._ppool = KVCache.create(self.cfg.text, self.max_prefixes, self.prefix_cap, self.cache_dtype,
                                             self.device)

    def _store_prefix(self, key: str, slot: int, token_ids: List[int], next_pos: int):
        Tp = len(token_ids)
        if Tp > self.prefix_cap:
            return
        if key in self.prefix_store:
            # already cached (e.g. two same-prefix requests admitted in one batch both
            # missed and both carry save_prefix): keep the existing entry
            self.prefix_store[key].last_used = time.time()
            return
        self._ensure_ppool()
        if self._free_prefix_rows:
            idx = self._free_prefix_rows.pop()
        else:
            lru = min(self.prefix_store, key=lambda k: self.prefix_store[k].last_used)
            idx = self.prefix_store.pop(lru).index
        self._harvest_prefix(slot, idx, Tp)
        self.prefix_store[key] = _PrefixEntry(index=idx, token_ids=list(token_ids), next_pos=next_pos)
        self.stats["prefix_saves"] += 1

    # ------------------------------------------------------------------
    # host-side scheduler
    # ------------------------------------------------------------------

    def submit(self, request: Request):
        if len(request.token_ids) + request.max_tokens > self.max_seq_len:
            raise ValueError(
                f"request {request.request_id}: prompt ({len(request.token_ids)}) + "
                f"max_tokens ({request.max_tokens}) exceeds max_seq_len ({self.max_seq_len})"
            )
        # reject at the submission boundary (the caller gets a clean error, e.g. an
        # HTTP 400) instead of poisoning an admission batch in the pump. A prefix-KV
        # request only prefills its post-prefix chunk on a hit, so the guard applies
        # to that chunk: a prefix MISS with an over-bucket full prompt still fails
        # safely via the pump's admission containment (finish_reason="error").
        chunk_len = len(request.token_ids)
        if request.prefix_key and request.prefix_len:
            chunk_len -= request.prefix_len
        if chunk_len > self.length_buckets[-1]:
            raise ValueError(
                f"request {request.request_id}: prefill chunk ({chunk_len}) "
                f"exceeds the largest prefill bucket ({self.length_buckets[-1]})"
            )
        self.queue.put(request)

    def submit_continuation(self, continuation: Continuation):
        """Queue a continuation of a hold_slot request (the stage-2 zoom pattern)."""
        self.queue.put(continuation)

    def release_slot(self, request_id: str):
        """Free a held slot without continuing it."""
        slot_idx = self.held.pop(request_id, None)
        if slot_idx is not None:
            self.slots[slot_idx] = _Slot()

    def cancel_prefix(self, prefix: str, timeout: float = 300.0):
        """Cancel every request whose id starts with `prefix`: drop queued items,
        let in-flight rows finish, then free their held slots and unread results.

        A caller tearing down a rollout mid-flight against a PERSISTENT engine needs
        this: a request still decoding at teardown would complete AFTER a naive
        held/results sweep and, with hold_slot=True, re-insert a held slot that leaks
        a pool row forever. Cancellation therefore WAITS for in-flight matching work
        (including rows inside a scheduler admission, tracked via _in_admission) to
        drain before sweeping."""
        def drain_queue():
            keep, dropped = [], 0
            while True:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
                if item.request_id.startswith(prefix):
                    dropped += 1
                else:
                    keep.append(item)
            for it in keep:
                self.queue.put(it)
            return dropped

        def in_flight():
            if any(r.startswith(prefix) for r in self._in_admission):
                return True
            return any(
                self.active[i] and s.request is not None
                and s.request.request_id.startswith(prefix)
                for i, s in enumerate(self.slots)
            )

        drain_queue()
        deadline = time.time() + timeout
        clean = 0
        while time.time() < deadline:
            if in_flight():
                clean = 0
                if self._running:
                    time.sleep(0.02)
                else:
                    self.step()  # no pump thread: tick the scheduler ourselves
                continue
            # two consecutive clean observations separated by a tick close the
            # window where an item sits between queue.get and _in_admission
            clean += 1
            if clean >= 2:
                break
            time.sleep(0.02) if self._running else self.step()
        drain_queue()  # a continuation enqueued by a late completion's consumer
        for key in [k for k in self.held if k.startswith(prefix)]:
            self.release_slot(key)
        with self._results_cond:
            for key in [k for k in self.results if k.startswith(prefix)]:
                self.results.pop(key, None)

    def _prep_request(self, req: Request, slot_idx: int) -> _PrefillRow:
        if req.prefix_key and req.prefix_len:
            prefix_ids = list(req.token_ids[: req.prefix_len])
            entry = self.prefix_store.get(req.prefix_key)
            if entry is not None and entry.token_ids == prefix_ids:
                entry.last_used = time.time()
                self.stats["prefix_hits"] += 1
                return _PrefillRow(
                    slot=slot_idx, request=req,
                    chunk_ids=list(req.token_ids[req.prefix_len:]),
                    images=req.images[req.n_prefix_images:],
                    keep_len=entry.length, start_pos=entry.next_pos,
                    prompt_len=len(req.token_ids), use_prefix=req.prefix_key,
                )
            # miss: full prefill now, harvest the prefix KV for later requests
            prefix_grids = [g for _, g in req.images[: req.n_prefix_images]]
            _, prefix_next = mrope_position_ids(
                np.asarray(prefix_ids, np.int32), prefix_grids,
                image_pad_id=self.cfg.tokens.image_pad,
                merge_size=self.cfg.vision.spatial_merge_size,
            )
            return _PrefillRow(
                slot=slot_idx, request=req, chunk_ids=list(req.token_ids),
                images=req.images, keep_len=0, start_pos=0,
                prompt_len=len(req.token_ids), save_prefix=req.prefix_key,
                prefix_next_pos=int(prefix_next),
            )
        return _PrefillRow(
            slot=slot_idx, request=req, chunk_ids=list(req.token_ids), images=req.images,
            keep_len=0, start_pos=0, prompt_len=len(req.token_ids),
        )

    def _prep_continuation(self, c: Continuation) -> _PrefillRow:
        slot_idx = self.held.pop(c.parent_request_id)
        slot = self.slots[slot_idx]
        # cache holds prompt + all generated EXCEPT the last produced token
        in_cache = max(len(slot.generated) - 1, 0)
        kept = min(c.kept_tokens, len(slot.generated))
        extra = slot.generated[in_cache:kept] if kept > in_cache else []
        chunk_ids = list(extra) + list(c.chunk_ids)
        kept_cached = min(kept, in_cache)
        keep_len = slot.prompt_len + kept_cached
        start_pos = slot.prompt_next_pos + kept_cached
        req = Request(
            request_id=c.request_id, token_ids=chunk_ids, images=c.images,
            max_tokens=c.max_tokens, temperature=c.temperature, hold_slot=c.hold_slot,
        )
        return _PrefillRow(
            slot=slot_idx, request=req, chunk_ids=chunk_ids, images=c.images,
            keep_len=keep_len, start_pos=start_pos,
            prompt_len=keep_len + len(chunk_ids),
        )

    def _run_prefill_batch(self, rows: List[_PrefillRow]):
        """One row-compacted pool prefill for up to max_slots prepared rows."""
        t_start = time.time()
        cfg = self.cfg
        # a burst whose images exceed the largest patch bucket (e.g. a cold first
        # round: every stage-1 admission carries a full image) splits greedily
        cap = self.patch_buckets[-1]
        total = sum(pv.shape[0] for r in rows for pv, _ in r.images)
        if total > cap and len(rows) > 1:
            group: List[_PrefillRow] = []
            acc = 0
            for r in rows:
                n = sum(pv.shape[0] for pv, _ in r.images)
                if group and acc + n > cap:
                    self._run_prefill_batch(group)
                    group, acc = [], 0
                group.append(r)
                acc += n
            if group:
                self._run_prefill_batch(group)
            return
        rows = sorted(rows, key=lambda r: r.slot)  # vision embeds splice in row order
        R = len(rows)
        # compact row-count bucket: prefill work scales with RB, not max_slots
        RB = next((r for r in self.row_buckets if R <= r <= self.max_slots),
                  self.max_slots)
        S = bucket(max(len(r.chunk_ids) for r in rows), self.length_buckets)
        ids = np.full((RB, S), cfg.tokens.pad, np.int32)
        chunk_lens = np.zeros((RB,), np.int32)
        keep_lens = np.zeros((RB,), np.int32)
        new_next = np.zeros((RB,), np.int32)
        pos = np.ones((3, RB, S), np.int32)
        temps = np.zeros((RB,), np.float32)
        # padding rows point past the pool: they are never written back
        slot_idx = np.full((RB,), self.max_slots, np.int32)
        all_pv, all_grids = [], []
        prefix_rows: List[Tuple[int, _PrefixEntry]] = []
        for j, r in enumerate(rows):
            n = len(r.chunk_ids)
            slot_idx[j] = r.slot
            ids[j, :n] = r.chunk_ids
            chunk_lens[j] = n
            keep_lens[j] = r.keep_len
            temps[j] = r.request.temperature
            if r.use_prefix:
                prefix_rows.append((r.slot, self.prefix_store[r.use_prefix]))
            grids = [g for _, g in r.images]
            p, nxt = mrope_chunk_position_ids(
                np.asarray(r.chunk_ids), grids, r.start_pos,
                image_pad_id=cfg.tokens.image_pad, merge_size=cfg.vision.spatial_merge_size,
            )
            pos[:, j, :n] = p
            new_next[j] = nxt
            all_pv.extend(x for x, _ in r.images)
            all_grids.extend(grids)

        self._phase_s["prefill_host_prep"] += time.time() - t_start
        t_dev = time.time()
        with self._device_scope():
            vision_embeds = None
            if all_pv:
                t_vit = time.time()
                pv = np.concatenate(all_pv, axis=0)
                n_patches = bucket(pv.shape[0], self.patch_buckets)
                meta = vision_metadata(all_grids, cfg.vision, pad_to=n_patches)
                if n_patches > pv.shape[0]:
                    pv = np.concatenate([pv, np.zeros((n_patches - pv.shape[0], pv.shape[1]), pv.dtype)])
                # the ViT runs once for the batch's images, ahead of the pool prefill
                vision_embeds = compute_vision_embeds(
                    self.params, cfg, torch.as_tensor(pv, device=self.device),
                    meta_to_device(meta_dict(meta), self.device), win_mode=meta.win_mode,
                )
                self._phase_s["prefill_vit_dispatch"] += time.time() - t_vit

            if prefix_rows:
                self._apply_prefixes([b for b, _ in prefix_rows], [e.index for _, e in prefix_rows],
                                     [e.length for _, e in prefix_rows])

            t_pool = time.time()
            tok = self._pool_prefill(slot_idx, ids, chunk_lens, keep_lens, pos, vision_embeds, new_next, temps)
            self._phase_s["prefill_pool_dispatch"] += time.time() - t_pool
            self.stats["prefills"] += 1
            self.stats["prefill_rows"] += len(rows)
            t_store = time.time()
            for r in rows:
                if r.save_prefix:
                    self._store_prefix(
                        r.save_prefix, r.slot,
                        list(r.request.token_ids[: r.request.prefix_len]), r.prefix_next_pos,
                    )
            self._phase_s["prefill_store_dispatch"] += time.time() - t_store
            t_rb = time.time()
            first = HostCopy(tok).numpy()  # one small readback per BATCH, not per request
            self._phase_s["prefill_readback_wait"] += time.time() - t_rb
        # device total: ViT + prefix apply + pool prefill + prefix harvest, measured
        # to the blocking first-token readback
        self._phase_s["prefill_device"] += time.time() - t_dev
        for j, r in enumerate(rows):
            b = r.slot
            t = int(first[j])
            slot = self.slots[b]
            slot.request = r.request
            slot.generated = [t]
            slot.remaining = r.request.max_tokens - 1
            slot.held = False
            slot.prompt_len = r.prompt_len
            slot.prompt_next_pos = int(new_next[j])
            self.active[b] = True
            r.done = True  # committed: failure-isolation retries must skip this row
            if self.on_tokens is not None and t not in self._stop_tokens:
                self.on_tokens(r.request.request_id, [t])
            if t in self._stop_tokens or slot.remaining <= 0:
                self._finish(b, "stop" if t in self._stop_tokens else "length")

    def _finish(self, slot_idx: int, reason: str):
        slot = self.slots[slot_idx]
        req = slot.request
        toks = slot.generated
        if reason == "stop" and toks and toks[-1] in self._stop_tokens:
            toks = toks[:-1]
        completion = Completion(
            request_id=req.request_id,
            token_ids=toks,
            finish_reason=reason,
            prompt_tokens=len(req.token_ids),
        )
        with self._results_cond:
            self.results[req.request_id] = completion
            self._results_cond.notify_all()
        if self.on_completion is not None:
            self.on_completion(completion)
        self.stats["completed"] += 1
        self._latencies.append(completion.created_at - req.enqueued_at)
        self.active[slot_idx] = False
        if req.hold_slot:
            slot.held = True
            self.held[req.request_id] = slot_idx
        else:
            self.slots[slot_idx] = _Slot()

    def _fail_admission(self, admissible, exc: Exception):
        """An admission batch whose prep/prefill raised (an over-bucket continuation
        chunk, an unexpected shape) must not kill the pump thread: every waiting
        client would then block forever on get_completion with zero diagnostics.
        Error-complete each admitted item so callers unblock, and free any slot state
        the partial admission left behind."""
        import sys
        import traceback

        print(f"engine: admission batch failed ({exc!r}); "
              f"erroring {len(admissible)} request(s)", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        for item, slot_idx in admissible:
            if isinstance(item, Continuation):
                slot_idx = self.held.pop(item.parent_request_id, None)
            if slot_idx is not None:
                self.active[slot_idx] = False
                self.slots[slot_idx] = _Slot()
            completion = Completion(request_id=item.request_id, token_ids=[],
                                    finish_reason="error", prompt_tokens=0)
            with self._results_cond:
                self.results[item.request_id] = completion
                self._results_cond.notify_all()
            if self.on_completion is not None:
                self.on_completion(completion)
            self.stats["errors"] = self.stats.get("errors", 0) + 1

    def _count_contained(self, key: str, what: str):
        """Count a failure that the scheduler contains and serves on after, from inside
        its `except`: stats["admission_retries"] (a batch prefill raised; its
        uncommitted rows retry one by one, and may all succeed) and
        stats["pump_errors"] (a tick raised outside an admission). Neither shows in
        stats["errors"], which counts requests, so a caller that must know the device
        routines never refused anything reads these. Every occurrence is logged with
        its traceback."""
        import sys
        import traceback

        self.stats[key] = self.stats.get(key, 0) + 1
        print(f"engine: {what} ({key} {self.stats[key]})", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)

    def _sweep_orphan_held(self):
        """Reset held slots no longer reachable through self.held: _prep_continuation
        pops self.held BEFORE its batch runs, so a failed admission would otherwise
        leak those slots. Called once per tick AFTER all admission retries (a sweep
        mid-retry could reset a slot whose solo retry is still pending)."""
        held_slots = set(self.held.values())
        for i, s in enumerate(self.slots):
            if s.held and i not in held_slots and not self.active[i]:
                self.slots[i] = _Slot()

    def step(self):
        """One scheduler tick: drain the queue into batched prefills, pump one decode
        chunk, retire finished slots."""
        deferred = []
        admissible = []  # raw items with capacity: (item, slot_or_None)
        free = [i for i in range(self.max_slots) if not self.active[i] and not self.slots[i].held]
        taken = set()
        debounced = False
        try:
            while True:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    if admissible and not debounced and self.admission_debounce_s > 0:
                        debounced = True
                        self._phase_s["debounce_sleep"] += self.admission_debounce_s
                        time.sleep(self.admission_debounce_s)
                        continue
                    break
                self._in_admission.add(item.request_id)
                if isinstance(item, Continuation):
                    if item.parent_request_id in self.held:
                        admissible.append((item, None))
                    else:
                        deferred.append(item)  # parent not finished/held yet
                else:
                    slot_idx = next((i for i in free if i not in taken), None)
                    if slot_idx is None:
                        deferred.append(item)
                        break
                    taken.add(slot_idx)
                    admissible.append((item, slot_idx))
            if admissible and len(admissible) < self.admit_min_batch and self.active.any():
                # coalesce: let the decoding slots run on; these rows wait for company
                deferred.extend(item for item, _ in admissible)
                admissible = []
            for item in deferred:
                self.queue.put(item)
                self._in_admission.discard(item.request_id)
            if admissible:
                # per-item prep: a failing item (e.g. an over-bucket continuation
                # chunk) is errored alone, never poisoning its co-admitted peers
                rows, prepped = [], []
                for item, slot_idx in admissible:
                    try:
                        rows.append(
                            self._prep_continuation(item) if isinstance(item, Continuation)
                            else self._prep_request(item, slot_idx)
                        )
                        prepped.append((item, slot_idx))
                    except Exception as e:  # noqa: BLE001 (see _fail_admission)
                        self._fail_admission([(item, slot_idx)], e)
                if rows:
                    try:
                        self._run_prefill_batch(rows)
                    except Exception as e:  # noqa: BLE001
                        self._count_contained("admission_retries", f"a prefill batch of {len(rows)} rows failed")
                        # rows already committed before the failure (a patch-cap
                        # split runs groups sequentially: group 1 may have activated
                        # its slots and emitted first tokens) must NOT re-run: a
                        # retry would resample their first token and double-fire
                        # on_tokens/_finish
                        pending_rows = [(row, pi) for row, pi in zip(rows, prepped)
                                        if not row.done]
                        if len(pending_rows) == 1:
                            self._fail_admission([pending_rows[0][1]], e)
                        else:
                            # isolate the poison row(s): each row retries in its own
                            # single-row batch; only genuine offenders error out
                            for row, pi in pending_rows:
                                try:
                                    self._run_prefill_batch([row])
                                except Exception as e2:  # noqa: BLE001
                                    self._fail_admission([pi], e2)
                self._sweep_orphan_held()
        finally:
            # slots now reflect the admitted rows (or the tick failed): either way
            # cancel_prefix no longer needs the admission shadow
            for item, _ in admissible:
                self._in_admission.discard(item.request_id)
        if not self.active.any():
            return False
        t_dec = time.time()
        live = [i for i in range(self.max_slots) if self.active[i]]
        bucket_R = next((b for b in self.decode_row_buckets if b >= len(live)), None)
        with self._device_scope():
            if bucket_R is not None:
                # row-compacted chunk: step only a gathered bucket of the live rows
                slot_idx = np.full((bucket_R,), self.max_slots, np.int32)
                slot_idx[: len(live)] = live
                act = np.zeros((bucket_R,), bool)
                act[: len(live)] = True
                temps = np.array(
                    [self.slots[i].request.temperature if self.slots[i].request else 0.0
                     for i in live] + [0.0] * (bucket_R - len(live)), np.float32,
                )
                toks_c = self._decode_steps_compact(
                    slot_idx, act, temps, n_steps=self.decode_chunk, attend_len=self._attend_for(live),
                )
                toks_np = HostCopy(toks_c).numpy()  # (bucket_R, n_steps)
                row_toks = {i: toks_np[j] for j, i in enumerate(live)}
                stepped_rows = bucket_R
            else:
                temps = np.array(
                    [s.request.temperature if s.request else 0.0 for s in self.slots], np.float32
                )
                toks = self._decode_steps(
                    self.active.copy(), temps, n_steps=self.decode_chunk, attend_len=self._attend_for(live),
                )
                toks_np = HostCopy(toks).numpy()
                row_toks = {i: toks_np[i] for i in live}
                stepped_rows = self.max_slots
        self._phase_s["decode_device"] += time.time() - t_dec
        self.stats["decode_steps"] += self.decode_chunk
        # decode-slot utilization: live rows vs device rows actually stepped (with
        # compaction the latter tracks the bucket, not max_slots)
        self.stats["decode_live_row_steps"] = (
            self.stats.get("decode_live_row_steps", 0) + len(live) * self.decode_chunk
        )
        self.stats["decode_device_row_steps"] = (
            self.stats.get("decode_device_row_steps", 0) + stepped_rows * self.decode_chunk
        )
        for slot_idx in live:
            slot = self.slots[slot_idx]
            rid = slot.request.request_id
            streamed: List[int] = []
            for t in row_toks[slot_idx]:
                t = int(t)
                slot.generated.append(t)
                slot.remaining -= 1
                if t in self._stop_tokens:
                    self._finish(slot_idx, "stop")
                    break
                streamed.append(t)  # after the stop check: mirror Completion.token_ids
                if slot.remaining <= 0:
                    self._finish(slot_idx, "length")
                    break
            if streamed and self.on_tokens is not None:
                self.on_tokens(rid, streamed)
        return True

    def get_completion(self, request_id: str, timeout: Optional[float] = None) -> Completion:
        deadline = time.time() + timeout if timeout else None
        with self._results_cond:
            while request_id not in self.results:
                remaining = (deadline - time.time()) if deadline else None
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(request_id)
                self._results_cond.wait(timeout=remaining)
            return self.results.pop(request_id)

    def run_until_idle(self, max_ticks: int = 100000):
        for _ in range(max_ticks):
            busy = self.step()
            if not busy and self.queue.empty():
                return
        raise RuntimeError("engine did not drain")

    # -- background pump ----------------------------------------------------

    def start(self):
        self._running = True

        def pump():
            while self._running:
                try:
                    busy = self.step()
                except Exception:  # noqa: BLE001
                    # the pump IS the engine: if it dies, every get_completion
                    # blocks forever. Admission failures are contained upstream
                    # (_fail_admission); anything that still escapes is logged and
                    # the loop continues serving the remaining slots.
                    self._count_contained("pump_errors", "a scheduler tick failed")
                    busy = False
                if not busy:
                    time.sleep(0.002)

        self._pump_thread = threading.Thread(target=pump, daemon=True)
        self._pump_thread.start()

    def stop(self):
        self._running = False
        if self._pump_thread:
            self._pump_thread.join(timeout=5)
            self._pump_thread = None
