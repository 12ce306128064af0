"""Generation runtime: bucketed prefill + decode with a KV cache (port of
runtime/generate.py).

The host-side packing (`bucket`, `GenerationConfig`, `PreparedBatch`,
`prepare_batch`, `prepare_continuation`) is a verbatim copy of the reference's,
held equal to it by exact-equality tests. `Generator` runs eagerly on the params'
device:

- prefill and chunk prefill are one forward each (their attention is K2);
- decode is a fixed-shape Python step loop (attention K3) that keeps the token
  buffer on the device, checks for all-rows-done only every DONE_CHECK_EVERY steps
  (the only host sync of the loop), and reads the tokens back once at the end;
- caches are written in place (see models.decoder.KVCache). A consumed cache is
  never reused: `run_chunk_prefill` works on a copy whenever the reference would
  not have donated its input (an explicit grow_to marks a reusable prefix holder).

Not ported: the split-row prefill, `run_decode_pair` and the ZOOMEARTH_* switches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import VLMConfig
from ..models.decoder import KVCache
from ..models.params import torch_dtype
from ..models.rope import mrope_position_ids_batch
from ..models.vit import meta_to_device, vision_metadata
from ..models.vlm import vlm_forward
from ..ops.sampling import greedy, sample

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


class Generator:
    """Generation engine over a parameter tree on one device."""

    def __init__(self, params, cfg: VLMConfig, max_cache_len: int = 4096, cache_dtype=None):
        self.params = params
        self.cfg = cfg
        self.max_cache_len = max_cache_len
        self.cache_dtype = torch_dtype(cache_dtype or cfg.dtype)
        self.device = params["text"]["embed"]["weight"].device

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
        """(vlm_forward vision kwargs, win_mode) for the batch's packed images."""
        if batch.pixel_values is None:
            return {}, 0
        pv = torch.as_tensor(batch.pixel_values, device=self.device)
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
        cache.length = lengths
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
        # pad tokens write to slot T2 -> dropped
        write_pos = torch.where(attn_valid, attn_positions, torch.full_like(attn_positions, T2))
        cache.length = keep
        vis, win_mode = self._vision_kwargs(batch)
        logits, cache = vlm_forward(
            self.params, self.cfg, self._tensor(batch.input_ids, torch.int64),
            self._tensor(batch.position_ids, torch.int32),
            attn_positions=attn_positions, attn_valid=attn_valid, cache=cache,
            update_cache_len=False, logit_index=chunk_lens - 1, write_pos=write_pos,
            win_mode=win_mode, **vis,
        )
        cache.length = keep + chunk_lens
        return logits, cache, self._attend_bucket(need, T2)

    @torch.inference_mode()
    def run_decode(self, first_logits, cache: KVCache, next_pos, gen: GenerationConfig, *,
                   seed: int = 0, attend: Optional[int] = None, done0=None):
        """Decode up to gen.max_new_tokens tokens. Returns (tokens (B, max_new) on the
        device, padded with the pad id after a stop token, cache). attend: prefix read
        span; done0: (B,) rows already finished (they stay inert)."""
        B = first_logits.shape[0]
        pad_id = self.cfg.tokens.pad
        stop = torch.as_tensor((self.cfg.tokens.eos, self.cfg.tokens.endoftext), device=self.device)
        rng = None
        if gen.temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(seed)
        tokens = torch.full((B, gen.max_new_tokens), pad_id, dtype=torch.int64, device=self.device)
        done = (torch.zeros((B,), dtype=torch.bool, device=self.device) if done0 is None
                else torch.as_tensor(done0, dtype=torch.bool, device=self.device))
        pos = self._tensor(next_pos, torch.int64)
        logits = first_logits
        for step in range(gen.max_new_tokens):
            if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            tok = sample(logits, rng, gen.temperature, gen.top_p) if rng is not None else greedy(logits)
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            tokens[:, step] = tok
            done = done | torch.isin(tok, stop)
            pos3 = pos[None, :, None].expand(3, B, 1)
            logits, cache = vlm_forward(
                self.params, self.cfg, tok[:, None], pos3,
                attn_positions=cache.length[:, None], cache=cache, attend_len=attend,
            )
            logits = logits[:, 0]
            pos = pos + 1
        return tokens, cache

    # -- public API ---------------------------------------------------------------

    def continue_generate(self, cache: KVCache, batch: PreparedBatch, keep_len,
                          gen: GenerationConfig = GenerationConfig(), *, seed: int = 0,
                          return_cache: bool = False, inert_mask: Optional[np.ndarray] = None):
        """Continue from a prior stage's cache: truncate row b to keep_len[b], prefill
        only the continuation chunk (stage-2 vision tokens), then decode. Consumes
        `cache` (written in place unless it has to grow)."""
        first_logits, cache, attend = self.run_chunk_prefill(
            cache, batch, keep_len, max_new=gen.max_new_tokens
        )
        tokens, cache = self.run_decode(
            first_logits, cache, batch.next_pos, gen, seed=seed, attend=attend, done0=inert_mask,
        )
        out = self.trim_generated(tokens.cpu().numpy())
        return (out, cache) if return_cache else out

    def generate(self, batch: PreparedBatch, gen: GenerationConfig = GenerationConfig(), *,
                 seed: int = 0, return_cache: bool = False):
        """Prefill + decode. Returns per-row generated token lists (stop token
        excluded), and the cache when return_cache."""
        B, S = batch.input_ids.shape
        if S + gen.max_new_tokens > self.max_cache_len:
            raise ValueError(
                f"prompt bucket ({S}) + max_new_tokens ({gen.max_new_tokens}) exceeds "
                f"max_cache_len ({self.max_cache_len})"
            )
        first_logits, cache, attend = self.run_prefill(batch, max_new=gen.max_new_tokens)
        tokens, cache = self.run_decode(first_logits, cache, batch.next_pos, gen, seed=seed, attend=attend)
        out = self.trim_generated(tokens.cpu().numpy())
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
