"""Generation runtime: bucketed prefill + decode with a KV cache (port of
runtime/generate.py).

The host-side packing (`bucket`, `GenerationConfig`, `PreparedBatch`,
`prepare_batch`, `prepare_continuation`) is a verbatim copy of the reference's,
held equal to it by exact-equality tests. `Generator` runs on the params' device:

- prefill and chunk prefill are one eager forward each (their attention is K2);
- decode is one step function over fixed device buffers (`DecodeState`: logits,
  done, positions, the token buffer and a device step counter through which the step
  writes its token column; attention K3), driven by a host loop that checks for
  all-rows-done only every DONE_CHECK_EVERY steps (the only host sync of the loop)
  and reads the tokens back once at the end. On CUDA each call's step runs eagerly
  once, is captured into a CUDA graph and replayed for the rest of the call
  (runtime.graphs): the counterpart of the reference's jitted while-loop. On the CPU
  the same step runs eagerly every time;
- `run_decode_pair` is the same over TWO row groups with a cache each: one dense
  pass per step for both (models.decoder.decoder_forward_pair), after which either
  group resumes in the solo loop;
- caches are written in place and keep one `length` tensor for their lifetime (see
  models.decoder.KVCache). A consumed cache is never reused: `run_chunk_prefill`
  works on a copy whenever the reference would not have donated its input (an
  explicit grow_to marks a reusable prefix holder);
- `HostCopy` is the asynchronous token readback (`generate(block=False)` hands the
  device buffer to a caller that reads it later).

Not ported: the split-row prefill, `right_size_cache` and the ZOOMEARTH_* switches.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import VLMConfig
from ..models.decoder import KVCache, decoder_forward_pair, logits_from_hidden, write_index
from ..models.params import torch_dtype
from ..models.rope import mrope_position_ids_batch
from ..models.vit import meta_to_device, vision_metadata
from ..models.vlm import embed_tokens, vlm_forward
from ..ops.sampling import greedy, sample
from .graphs import StepGraphs

DEFAULT_LENGTH_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048)
DEFAULT_CACHE_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 2048, 3072, 4096)
DEFAULT_PATCH_BUCKETS = (0, 256, 512, 1024, 1600, 2304, 3136, 4096, 6400, 8192, 10368, 12800, 16384, 20736, 24576, 32768, 41472, 49152, 65536, 82944, 98304, 131072)
DONE_CHECK_EVERY = 8  # decode steps between all-rows-done checks (host syncs)


def bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 1024
    temperature: float = 0.0  # 0 = greedy (reference demo); eval uses 0.01+sample
    top_p: float = 1.0
    # stop tokens default to (eos, endoftext) from the model config


@dataclasses.dataclass
class PreparedBatch:
    """Host-prepared, bucket-padded model inputs for one generation call."""

    input_ids: np.ndarray  # (B, S) right-padded
    lengths: np.ndarray  # (B,)
    position_ids: np.ndarray  # (3, B, S)
    next_pos: np.ndarray  # (B,) first decode M-RoPE position
    pixel_values: Optional[np.ndarray]  # (P, D) padded to patch bucket
    vision_meta: Optional[dict]


def prepare_batch(
    cfg: VLMConfig,
    token_lists: Sequence[Sequence[int]],
    images_per_seq: Sequence[Sequence[Tuple[np.ndarray, Tuple[int, int, int]]]],
    *,
    length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
    patch_buckets: Sequence[int] = DEFAULT_PATCH_BUCKETS,
) -> PreparedBatch:
    """Pack prompts + preprocessed images into bucket-padded arrays.

    images_per_seq[b] is a list of (pixel_values, grid_thw) per image of sequence b, in
    order of appearance. Pads input ids with cfg.tokens.pad on the right.
    """
    B = len(token_lists)
    lengths = np.asarray([len(t) for t in token_lists], dtype=np.int32)
    S = bucket(int(lengths.max()), length_buckets)
    ids = np.full((B, S), cfg.tokens.pad, dtype=np.int32)
    for b, toks in enumerate(token_lists):
        ids[b, : len(toks)] = toks

    grids_per_seq = [[g for _, g in imgs] for imgs in images_per_seq]
    pos, next_pos = mrope_position_ids_batch(
        ids,
        grids_per_seq,
        image_pad_id=cfg.tokens.image_pad,
        merge_size=cfg.vision.spatial_merge_size,
        attention_mask=(ids != cfg.tokens.pad).astype(np.int32)
        if any(len(t) != S for t in token_lists)
        else None,
    )

    all_pv = [pv for imgs in images_per_seq for pv, _ in imgs]
    all_grids = [g for gs in grids_per_seq for g in gs]
    pixel_values = None
    meta_dev = None
    if all_pv:
        pv = np.concatenate(all_pv, axis=0)
        P = bucket(pv.shape[0], patch_buckets)
        meta = vision_metadata(all_grids, cfg.vision, pad_to=P)
        if P > pv.shape[0]:
            pv = np.concatenate([pv, np.zeros((P - pv.shape[0], pv.shape[1]), pv.dtype)])
        pixel_values = pv
        meta_dev = _meta_dict(meta)
    return PreparedBatch(ids, lengths, pos, next_pos, pixel_values, meta_dev)


def _meta_dict(meta) -> dict:
    """VisionMetadata -> host meta dict for PreparedBatch (numpy arrays; uploaded by
    the Generator). win_mode is a plain int."""
    d = {
        "perm": meta.perm,
        "inv_perm_merged": meta.inv_perm_merged,
        "seg_window": meta.seg_window,
        "seg_full": meta.seg_full,
        "pos_ids": meta.pos_ids,
        "win_mode": meta.win_mode,
    }
    if meta.win_gidx is not None:
        d["win_gidx"] = meta.win_gidx
        d["win_valid"] = meta.win_valid
        d["win_sidx"] = meta.win_sidx
    return d


def prepare_continuation(
    cfg: VLMConfig,
    chunk_token_lists: Sequence[Sequence[int]],
    images_per_seq: Sequence[Sequence[Tuple[np.ndarray, Tuple[int, int, int]]]],
    start_positions: Sequence[int],
    *,
    length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
    patch_buckets: Sequence[int] = DEFAULT_PATCH_BUCKETS,
) -> PreparedBatch:
    """Pack CONTINUATION chunks (e.g. stage-2 vision tokens) for cache-reuse prefill.

    start_positions[b] is the M-RoPE position where row b's chunk begins (the kept
    prefix's next position). Unlike prepare_batch, position ids are per-row offset."""
    from ..models.rope import mrope_chunk_position_ids

    B = len(chunk_token_lists)
    lengths = np.asarray([len(t) for t in chunk_token_lists], dtype=np.int32)
    S = bucket(int(lengths.max()), length_buckets)
    ids = np.full((B, S), cfg.tokens.pad, dtype=np.int32)
    pos = np.ones((3, B, S), dtype=np.int32)
    next_pos = np.zeros((B,), np.int32)
    for b, toks in enumerate(chunk_token_lists):
        ids[b, : len(toks)] = toks
        grids = [g for _, g in images_per_seq[b]]
        p, nxt = mrope_chunk_position_ids(
            np.asarray(toks), grids, int(start_positions[b]),
            image_pad_id=cfg.tokens.image_pad, merge_size=cfg.vision.spatial_merge_size,
        )
        pos[:, b, : len(toks)] = p
        next_pos[b] = nxt

    all_pv = [pv for imgs in images_per_seq for pv, _ in imgs]
    all_grids = [g for imgs in images_per_seq for _, g in imgs]
    pixel_values = None
    meta_dev = None
    if all_pv:
        pv = np.concatenate(all_pv, axis=0)
        P = bucket(pv.shape[0], patch_buckets)
        meta = vision_metadata(all_grids, cfg.vision, pad_to=P)
        if P > pv.shape[0]:
            pv = np.concatenate([pv, np.zeros((P - pv.shape[0], pv.shape[1]), pv.dtype)])
        pixel_values = pv
        meta_dev = _meta_dict(meta)
    return PreparedBatch(ids, lengths, pos, next_pos, pixel_values, meta_dev)


@dataclasses.dataclass
class DecodeState:
    """The device buffers one decode call steps over, in place: what its step reads
    and writes, at addresses that stay fixed for the call (a captured step replays on
    them)."""

    logits: torch.Tensor  # (B, V) fp32: the logits the next token is picked from
    done: torch.Tensor  # (B,) bool: rows finished (they emit pad)
    pos: torch.Tensor  # (B,) int64: the next token's M-RoPE position
    tokens: torch.Tensor  # (B, steps) int64: the tokens, pad after a stop
    step: torch.Tensor  # (1,) int64: the column the next token goes to


class HostCopy:
    """A device tensor on its way to the host (the reference's copy_to_host_async,
    then np.asarray): from a CUDA tensor, a non-blocking copy into a pinned buffer with
    an event recorded behind it on the current stream, and `numpy()` waits for that
    event before it hands out a view of the buffer (read earlier, the buffer would
    hold whatever was there before). From a CPU tensor it is a plain copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t.detach().clone()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


class Generator:
    """Generation engine over a parameter tree on one device."""

    def __init__(self, params, cfg: VLMConfig, max_cache_len: int = 4096, cache_dtype=None):
        self.params = params
        self.cfg = cfg
        self.max_cache_len = max_cache_len
        self.cache_dtype = torch_dtype(cache_dtype or cfg.dtype)
        self.device = params["text"]["embed"]["weight"].device
        self._stop = torch.as_tensor((cfg.tokens.eos, cfg.tokens.endoftext), device=self.device)
        self.graphs = StepGraphs(self.device)  # one captured step per decode call (see _drive)
        self.decode_steps = collections.Counter()  # steps taken, by "solo" and "pair"
        self._calls = 0

    def new_cache(self, batch: int) -> KVCache:
        """Fresh full-size cache in this generator's layout."""
        return KVCache.create(self.cfg.text, batch, self.max_cache_len, self.cache_dtype, self.device)

    @staticmethod
    def _attend_bucket(need: int, alloc: int):
        """Smallest cache bucket covering `need` rows, or None for a full-allocation
        read: decode attention then reads only that prefix of the cache (K3 takes any
        span, so no rounding to a kernel chunk)."""
        for b in DEFAULT_CACHE_BUCKETS:
            if need <= b < alloc:
                return b
        return None

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _vision_kwargs(self, batch: PreparedBatch):
        """(vlm_forward vision kwargs, win_mode) for the batch's packed images.
        pixel_values with vision_meta=None are PRECOMPUTED vision embeddings
        (N_tokens, E), as compute_vision_embeds gives them."""
        if batch.pixel_values is None:
            return {}, 0
        pv = torch.as_tensor(batch.pixel_values, device=self.device)
        if batch.vision_meta is None:
            return {"vision_embeds": pv}, 0
        meta = meta_to_device(batch.vision_meta, self.device)
        return {"pixel_values": pv, "vision_meta": meta}, int(batch.vision_meta["win_mode"])

    # -- composable stages ------------------------------------------------------

    @torch.inference_mode()
    def run_prefill(self, batch: PreparedBatch, *, max_new: int = 0):
        """Stage-1 prefill into a fresh cache. Returns (first_logits, cache, attend):
        attend is the decode read span for this stage (run_decode's attend=)."""
        B, S = batch.input_ids.shape
        cache = self.new_cache(B)
        lengths = self._tensor(batch.lengths, torch.int32)
        attn_positions = torch.arange(S, device=self.device)[None].expand(B, S)
        vis, win_mode = self._vision_kwargs(batch)
        logits, cache = vlm_forward(
            self.params, self.cfg, self._tensor(batch.input_ids, torch.int64),
            self._tensor(batch.position_ids, torch.int32),
            attn_positions=attn_positions, attn_valid=attn_positions < lengths[:, None],
            cache=cache, update_cache_len=False, logit_index=lengths - 1,
            win_mode=win_mode, **vis,
        )
        cache.length.copy_(lengths)
        return logits, cache, self._attend_bucket(S + max_new, self.max_cache_len)

    @torch.inference_mode()
    def run_chunk_prefill(self, cache: KVCache, batch: PreparedBatch, keep_len, *, max_new: int,
                          grow_to: Optional[int] = None):
        """Prefill a continuation chunk into an existing cache truncated to keep_len[b]
        rows. Returns (first_logits, cache, attend).

        grow_to: grow the cache to at least this many rows. An explicit grow_to marks
        a REUSABLE prefix holder: the holder is then never written (the chunk goes into
        a copy), as the reference never donates it. Without grow_to, a cache of the
        right size is consumed and written in place."""
        B, S = batch.input_ids.shape
        T_old = cache.max_len
        keep_host = np.asarray(keep_len.cpu() if isinstance(keep_len, torch.Tensor) else keep_len)
        # pad tokens write to the drop slot, so size to keep + ACTUAL chunk + budget
        need = int((keep_host + np.asarray(batch.lengths)).max()) + max_new
        T2 = T_old
        if need > T_old:
            T2 = self.max_cache_len
            for b in DEFAULT_CACHE_BUCKETS:
                if need <= b <= self.max_cache_len:
                    T2 = b
                    break
            T2 = max(T2, T_old)
        if grow_to is not None:
            T2 = max(min(grow_to, self.max_cache_len), T2)
        if T2 > T_old:
            cache = cache.grown(T2)
        elif grow_to is not None:
            cache = cache.clone()
        keep = self._tensor(keep_host, torch.int32)
        chunk_lens = self._tensor(batch.lengths, torch.int32)
        iota = torch.arange(S, device=self.device)[None]
        attn_positions = keep[:, None] + iota
        attn_valid = iota < chunk_lens[:, None]
        # pad tokens write to slot T2 -> dropped. The kept (row, slot) pairs come from
        # the host arrays, once for every layer, so no layer waits for the device.
        host_pos = keep_host.astype(np.int64)[:, None] + np.arange(S)[None]
        host_pos = np.where(np.arange(S)[None] < np.asarray(batch.lengths)[:, None], host_pos, T2)
        write_pos = self._tensor(host_pos, torch.int64)
        index = write_index(host_pos, T2, self.device)
        cache.length.copy_(keep)
        vis, win_mode = self._vision_kwargs(batch)
        logits, cache = vlm_forward(
            self.params, self.cfg, self._tensor(batch.input_ids, torch.int64),
            self._tensor(batch.position_ids, torch.int32),
            attn_positions=attn_positions, attn_valid=attn_valid, cache=cache,
            update_cache_len=False, logit_index=chunk_lens - 1, write_pos=write_pos,
            write_index=index, win_mode=win_mode, **vis,
        )
        cache.length.copy_(keep + chunk_lens)
        return logits, cache, self._attend_bucket(need, T2)

    def _decode_state(self, logits, pos, steps: int, done0) -> DecodeState:
        """Fresh buffers for one decode call: a copy of the first logits, done0 (or no
        row done), the positions, a token buffer of pad ids, the step counter at 0."""
        B = logits.shape[0]
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        if done0 is not None:
            done.copy_(torch.as_tensor(done0, dtype=torch.bool, device=self.device))
        return DecodeState(
            logits=logits.clone(), done=done, pos=pos,
            tokens=torch.full((B, steps), self.cfg.tokens.pad, dtype=torch.int64, device=self.device),
            step=torch.zeros((1,), dtype=torch.int64, device=self.device),
        )

    def _pick(self, logits, done, rng, temperature: float, top_p: float):
        """The next token of each row (pad where the row is done) and the rows done
        after it."""
        tok = sample(logits, rng, temperature, top_p) if temperature > 0.0 else greedy(logits)
        tok = torch.where(done, torch.full_like(tok, self.cfg.tokens.pad), tok)
        return tok, done | torch.isin(tok, self._stop)

    def _rng(self, temperatures, seed: int) -> Optional[torch.Generator]:
        """The call's generator, where any of its groups samples."""
        if any(t > 0.0 for t in temperatures):
            return torch.Generator(device=self.device).manual_seed(seed)
        return None

    def solo_step(self, first_logits, cache: KVCache, next_pos, gen: GenerationConfig, *, seed: int = 0,
                  attend: Optional[int] = None, done0=None):
        """(state, step, rng): the buffers of one run_decode call and its step function,
        which picks the next token from state.logits, writes it at column state.step,
        runs the model on it (K3 once per layer) and advances logits, done, pos, step and
        the cache's `length` in place. It reads no host value and waits for nothing:
        run_decode captures it on CUDA. Called in a loop, it is the eager decode."""
        rng = self._rng((gen.temperature,), seed)
        st = self._decode_state(first_logits, self._tensor(next_pos, torch.int64), gen.max_new_tokens, done0)
        B = st.done.shape[0]

        def step():
            tok, done = self._pick(st.logits, st.done, rng, gen.temperature, gen.top_p)
            st.done.copy_(done)
            st.tokens.index_copy_(1, st.step, tok[:, None])
            pos3 = st.pos[None, :, None].expand(3, B, 1)
            logits, _ = vlm_forward(
                self.params, self.cfg, tok[:, None], pos3,
                attn_positions=cache.length[:, None], cache=cache, attend_len=attend,
            )
            st.logits.copy_(logits[:, 0])
            st.pos.add_(1)
            st.step.add_(1)

        return st, step, rng

    def pair_step(self, a, b, *, steps: int, temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                  temperature_b: Optional[float] = None, top_p_b: Optional[float] = None):
        """(state, step, rng) of one run_decode_pair call (same arguments): rows [0:Ba]
        of the state are group a, the rest group b. The step draws for group a, then for
        group b, and runs one dense pass for both (decoder_forward_pair: K3 twice per
        layer)."""
        logits_a, cache_a, pos_a, attend_a, done0_a = a
        logits_b, cache_b, pos_b, attend_b, done0_b = b
        Ba, Bb = logits_a.shape[0], logits_b.shape[0]
        temp_b = temperature if temperature_b is None else temperature_b
        tp_b = top_p if top_p_b is None else top_p_b
        rng = self._rng((temperature, temp_b), seed)
        done0 = None
        if done0_a is not None or done0_b is not None:
            done0 = torch.cat([torch.zeros((n,), dtype=torch.bool, device=self.device) if d is None
                               else torch.as_tensor(d, dtype=torch.bool, device=self.device)
                               for d, n in ((done0_a, Ba), (done0_b, Bb))])
        pos = torch.cat([self._tensor(pos_a, torch.int64), self._tensor(pos_b, torch.int64)])
        st = self._decode_state(torch.cat([logits_a, logits_b]), pos, steps, done0)
        text = self.params["text"]

        def step():
            tok_a, done_a = self._pick(st.logits[:Ba], st.done[:Ba], rng, temperature, top_p)
            tok_b, done_b = self._pick(st.logits[Ba:], st.done[Ba:], rng, temp_b, tp_b)
            st.done.copy_(torch.cat([done_a, done_b]))
            tok = torch.cat([tok_a, tok_b])
            st.tokens.index_copy_(1, st.step, tok[:, None])
            pos3 = st.pos[None, :, None].expand(3, Ba + Bb, 1)
            hidden, _, _ = decoder_forward_pair(
                text, self.cfg.text, embed_tokens(self.params, tok[:, None]), pos3,
                cache_a, cache_b, attend_a, attend_b,
            )
            st.logits.copy_(logits_from_hidden(text, self.cfg.text, hidden)[:, 0])
            st.pos.add_(1)
            st.step.add_(1)

        return st, step, rng

    def _drive(self, st: DecodeState, steps: int, step, rng, kind: str) -> None:
        """Up to `steps` runs of `step`, looking for all-rows-done every
        DONE_CHECK_EVERY steps (the loop's only host sync), through a graph keyed to this
        call: on CUDA the first step is eager, then the step is captured and replayed. The
        graph is released at the end: it holds the addresses of this call's buffers and
        cache, which the next call does not share."""
        key = (kind, self._calls)
        self._calls += 1
        try:
            for i in range(steps):
                if i % DONE_CHECK_EVERY == 0 and bool(st.done.all()):
                    break
                self.graphs.run(key, step, (rng,) if rng is not None else ())
                self.decode_steps[kind] += 1
        finally:
            self.graphs.release(key)

    @torch.inference_mode()
    def run_decode(self, first_logits, cache: KVCache, next_pos, gen: GenerationConfig, *,
                   seed: int = 0, attend: Optional[int] = None, done0=None):
        """Decode up to gen.max_new_tokens tokens. Returns (tokens (B, max_new) on the
        device, padded with the pad id after a stop token, cache). attend: prefix read
        span; done0: (B,) rows already finished (they stay inert)."""
        st, step, rng = self.solo_step(first_logits, cache, next_pos, gen, seed=seed, attend=attend, done0=done0)
        self._drive(st, gen.max_new_tokens, step, rng, "solo")
        return st.tokens, cache

    @torch.inference_mode()
    def run_decode_pair(self, a, b, *, steps: int, temperature: float = 0.0, top_p: float = 1.0,
                        seed: int = 0, temperature_b: Optional[float] = None,
                        top_p_b: Optional[float] = None):
        """Co-batched decode of two stages sharing one dense pass per step (see
        decoder_forward_pair): the weights are read once per step for both groups.

        a, b: (first_logits, cache, next_pos, attend, done0-or-None) per group.
        temperature_b/top_p_b: group b's sampling params (default: group a's); each
        step draws for group a, then for group b, from one generator seeded by `seed`.
        Returns (buf_a, done_a, next_logits_a, cache_a, buf_b, done_b, next_logits_b,
        cache_b): either group resumes its remaining tokens via
        run_decode(next_logits_*, cache_*, next_pos + steps, ..., done0=done_*).
        The loop looks for both-groups-done every DONE_CHECK_EVERY steps, as the solo
        loop does, so after an early stop a cache's `length` may stand up to
        DONE_CHECK_EVERY - 1 past the reference's: done rows write pad, and a slot
        past the cache's end is dropped."""
        st, step, rng = self.pair_step(a, b, steps=steps, temperature=temperature, top_p=top_p, seed=seed,
                                       temperature_b=temperature_b, top_p_b=top_p_b)
        self._drive(st, steps, step, rng, "pair")
        Ba = a[0].shape[0]
        return (st.tokens[:Ba], st.done[:Ba], st.logits[:Ba], a[1],
                st.tokens[Ba:], st.done[Ba:], st.logits[Ba:], b[1])

    # -- public API ---------------------------------------------------------------

    def continue_generate(self, cache: KVCache, batch: PreparedBatch, keep_len,
                          gen: GenerationConfig = GenerationConfig(), *, seed: int = 0,
                          return_cache: bool = False, inert_mask: Optional[np.ndarray] = None,
                          block: bool = True):
        """Continue from a prior stage's cache: truncate row b to keep_len[b], prefill
        only the continuation chunk (stage-2 vision tokens), then decode. Consumes
        `cache` (written in place unless it has to grow).

        block=False: returns (tokens on the device, cache) without reading the tokens
        back, as generate(block=False) does."""
        first_logits, cache, attend = self.run_chunk_prefill(
            cache, batch, keep_len, max_new=gen.max_new_tokens
        )
        tokens, cache = self.run_decode(
            first_logits, cache, batch.next_pos, gen, seed=seed, attend=attend, done0=inert_mask,
        )
        if not block:
            return tokens, cache
        out = self.trim_generated(HostCopy(tokens).numpy())
        return (out, cache) if return_cache else out

    def generate(self, batch: PreparedBatch, gen: GenerationConfig = GenerationConfig(), *,
                 seed: int = 0, return_cache: bool = False, block: bool = True):
        """Prefill + decode. Returns per-row generated token lists (stop token
        excluded), and the cache when return_cache.

        block=False: returns (tokens on the device, cache) without reading the tokens
        back; the caller reads them later with trim_generated(HostCopy(tokens).numpy()),
        after its own host work."""
        B, S = batch.input_ids.shape
        if S + gen.max_new_tokens > self.max_cache_len:
            raise ValueError(
                f"prompt bucket ({S}) + max_new_tokens ({gen.max_new_tokens}) exceeds "
                f"max_cache_len ({self.max_cache_len})"
            )
        first_logits, cache, attend = self.run_prefill(batch, max_new=gen.max_new_tokens)
        tokens, cache = self.run_decode(first_logits, cache, batch.next_pos, gen, seed=seed, attend=attend)
        if not block:
            return tokens, cache
        out = self.trim_generated(HostCopy(tokens).numpy())
        return (out, cache) if return_cache else out

    def trim_generated(self, tokens: np.ndarray):
        """(B, max_new) raw decode buffer -> per-row lists trimmed at the stop token."""
        stop_tokens = (self.cfg.tokens.eos, self.cfg.tokens.endoftext)
        out = []
        for b in range(tokens.shape[0]):
            row = tokens[b]
            stops = np.isin(row, stop_tokens)
            end = int(np.argmax(stops)) if stops.any() else len(row)
            out.append([int(t) for t in row[:end]])
        return out
