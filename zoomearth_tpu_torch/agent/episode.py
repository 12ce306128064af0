"""The two-stage "zoom-and-answer" episode driver (port of agent/episode.py).

Stage 1 sees the downsampled full image and may emit a bbox; the host crops the
ORIGINAL full-res image around it, appends the crop as a second image continuing the
assistant turn, and stage 2 produces the final <answer>. Stage 2 either re-prefills
the stitched two-image prompt (reuse_cache=False, the eval default) or continues
from the stage-1 KV cache with a chunk prefill of the crop's tokens
(reuse_cache=True). run_episodes_pipelined runs a stream of equal-size waves with
reuse_cache semantics through the pair-pipelined runner (runtime/pipeline.py), and
builds each next wave's stage-1 inputs on a host thread while the device runs the
current one.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Optional, Sequence

import numpy as np

from ..image.geometry import cut_image, extract_answer, extract_bboxes, resize_image
from ..runtime.families import family
from ..runtime.generate import GenerationConfig, Generator, prepare_batch, prepare_continuation
from ..utils.profiling import tracer
from . import prompts as PT
from .processor import Processor


@dataclasses.dataclass
class EpisodeResult:
    question: str
    stage1: str
    stage2: str
    answer1: Optional[str]
    answer2: Optional[str]
    bbox: Optional[list]  # full-res coords of the first predicted bbox
    error: bool  # True = no bbox produced (stage 2 skipped)
    latency_s: Optional[float] = None

    @property
    def answer(self) -> Optional[str]:
        return self.answer2 if self.answer2 is not None else self.answer1


def split_kept_tokens(tokenizer, completion_tokens: List[int], pre_answer_text: str):
    """Longest prefix of the GENERATED tokens whose decode is a prefix of the
    pre-<answer> text, plus the residual text to re-tokenize (token-merge boundary)."""
    lo, hi = 0, len(completion_tokens)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pre_answer_text.startswith(tokenizer.decode(completion_tokens[:mid], skip_special_tokens=False)):
            lo = mid
        else:
            hi = mid - 1
    kept = completion_tokens[:lo]
    residual = pre_answer_text[len(tokenizer.decode(kept, skip_special_tokens=False)):]
    return kept, residual


_pool: Optional[ThreadPoolExecutor] = None  # the process's preparation threads, made at first use
_prefetch: Optional[ThreadPoolExecutor] = None  # the thread that builds next waves' stage 1, made at first use
_pool_lock = threading.Lock()


def _usable_cores() -> int:
    return len(os.sched_getaffinity(0))


def _prep_map(fn, items):
    """[fn(x) for x in items], in order, on the process's pool of host threads.

    The width is min(len(items), usable cores); at 1 the tasks run inline and no thread
    starts. `fn` prepares one image (PIL's resample and the native patchify release the
    GIL) and touches no torch tensor. A pooled section is traced as `episode.prep_pool` on
    the calling thread and its images counted in `episode.prep_pooled`; the spans that the
    tasks open are kept per thread, so their per-name totals are thread time."""
    global _pool
    if min(len(items), _usable_cores()) <= 1:
        return [fn(x) for x in items]
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(_usable_cores(), thread_name_prefix="episode-prep")
        pool = _pool
    with tracer.span("episode.prep_pool"):
        out = list(pool.map(fn, items))
    tracer.count("episode.prep_pooled", len(items))
    return out


def _prefetch_thread() -> ThreadPoolExecutor:
    global _prefetch
    with _pool_lock:
        if _prefetch is None:
            _prefetch = ThreadPoolExecutor(1, thread_name_prefix="episode-stage1")
        return _prefetch


def _stage1_inputs(generator, processor, questions, images, stage1_max_size):
    """Encode one wave's stage-1 prompts: returns (texts, resized, scales, encoded,
    prepared batch).

    Rows that show the same image object (questions about one tile) share its shrink,
    scale and patches: each distinct image is resized and preprocessed once a call, on
    the preparation pool. `images` keeps every object alive for the call, so `id` is an
    exact key. Rows that reuse an earlier row's image are counted in
    `episode.stage1_images_reused`."""
    cfg = generator.cfg
    tk = processor.tokenizer
    stage1_prompt = family(cfg).prompts()[0]

    def prepare(img):
        small = resize_image(img, stage1_max_size)
        scale = max(img.width, img.height) / max(small.width, small.height)
        return small, scale, processor.preprocess_images([small])[0]

    with tracer.span("episode.stage1_inputs"):
        stage1_texts = [stage1_prompt(q) for q in questions]
        distinct = list({id(img): img for img in images}.values())  # first-seen order
        shared = dict(zip(map(id, distinct), _prep_map(prepare, distinct)))  # id(image) -> (small, scale, (pv, grid))
        resized, scales, encoded = [], [], []
        for text, img in zip(stage1_texts, images):
            small, scale, prepped = shared[id(img)]
            with tracer.span("text.tokenize"):
                ids = processor.expand_image_pads(tk.encode(text), [prepped[1]])
            resized.append(small)
            scales.append(scale)
            encoded.append((ids, [prepped]))
        reused = len(images) - len(distinct)
        if reused:
            tracer.count("episode.stage1_images_reused", reused)
        batch = prepare_batch(cfg, [ids for ids, _ in encoded], [imgs for _, imgs in encoded])
    return stage1_texts, resized, scales, encoded, batch


def _stage2_continuation(
    generator, processor, questions, images, stage1_texts, resized, scales,
    encoded, batch, out_tokens, crop_min_size, crop_max_size,
):
    """Build one wave's stage-2 continuation from its stage-1 tokens.

    Returns (partial results [stage2 empty], continuation batch, keep_len, inert
    mask, s2_idx). Rows without a bbox get an inert placeholder chunk (they decode
    nothing). The bboxes, the kept tokens and the crops are taken row by row on the
    calling thread (a crop copies its window out of a tile other rows share); each crop's
    resize and preprocessing runs on the preparation pool."""
    cfg = generator.cfg
    tk = processor.tokenizer

    def prepare(crop):
        return processor.preprocess_images([resize_image(crop, crop_max_size)])

    with tracer.span("episode.stage2_inputs"):
        with tracer.span("text.decode"):
            stage1_out = [tk.decode(t).strip() for t in out_tokens]
        n = len(questions)
        results: List[Optional[EpisodeResult]] = [None] * n
        s2_idx, crops, splits = [], [], []
        full_chunks: List[List[int]] = [[] for _ in range(n)]
        full_imgs: List[list] = [[] for _ in range(n)]
        full_keep = [0] * n
        full_start = [0] * n
        for i, out1 in enumerate(stage1_out):
            with tracer.span("text.decode"):
                boxes = extract_bboxes(out1, scales[i])
            if not boxes:
                results[i] = EpisodeResult(
                    question=questions[i], stage1=out1, stage2="",
                    answer1=extract_answer(out1), answer2=None, bbox=None, error=True,
                )
                continue
            bbox = boxes[0]
            crops.append(cut_image(images[i], bbox, crop_min_size))
            s2_idx.append(i)
            results[i] = EpisodeResult(
                question=questions[i], stage1=out1, stage2="",
                answer1=extract_answer(out1), answer2=None, bbox=bbox, error=False,
            )
            # split on the UNSTRIPPED decode so tokens<->text stays bijective
            with tracer.span("text.decode"):
                raw = tk.decode(out_tokens[i], skip_special_tokens=False)
                pre_text = raw.split("<answer>")[0]
                splits.append(split_kept_tokens(tk, out_tokens[i], pre_text))
        for i, (kept, residual), crop_prepped in zip(s2_idx, splits, _prep_map(prepare, crops)):
            with tracer.span("text.tokenize"):
                chunk_ids = tk.encode(residual) if residual else []
                chunk_ids += processor.expand_image_pads(
                    tk.encode(family(cfg).prompts()[1]), [crop_prepped[0][1]]
                )
            full_chunks[i] = chunk_ids
            full_imgs[i] = crop_prepped
            full_keep[i] = len(encoded[i][0]) + len(kept)
            full_start[i] = int(batch.next_pos[i]) + len(kept)
        for i in range(n):
            if not full_chunks[i]:  # inert placeholder for non-s2 rows
                full_chunks[i] = [cfg.tokens.pad]
                full_keep[i] = len(encoded[i][0])
                full_start[i] = int(batch.next_pos[i])
        bc = prepare_continuation(cfg, full_chunks, full_imgs, full_start)
        inert = np.ones((n,), bool)
        inert[s2_idx] = False
    return results, bc, np.asarray(full_keep, np.int32), inert, s2_idx


def run_episodes_pipelined(
    generator: Generator,
    processor: Processor,
    waves: Sequence,  # (questions, images) pairs OR zero-arg callables returning one
    #                     (lazy tile loading: only ~2 waves of images live at once),
    #                     EQUAL batch sizes
    *,
    stage1_max_size: int = 512,
    crop_min_size: int = 512,
    crop_max_size: int = 512,
    gen: GenerationConfig = GenerationConfig(max_new_tokens=1024, temperature=0.01),
    seed: int = 0,
    stage2_gen: Optional[GenerationConfig] = None,
) -> List[List[EpisodeResult]]:
    """Pair-pipelined cache-reuse episodes over a stream of equal-size waves.

    Same semantics as run_episodes(reuse_cache=True) per wave, but wave n's stage-1
    decode runs CO-BATCHED with wave n-1's stage-2 decode, one dense pass per step for
    both (runtime.pipeline.run_paired_waves): the batch-eval throughput configuration.

    Wave w+1's stage 1 (its loader and `_stage1_inputs`: host work and numpy only) is
    built on one prefetch thread while the device runs wave w: wave 1's as soon as wave
    0's is built inline, wave w+1's once wave w-1's stage 2 is prepared, so its images
    do not queue on the preparation pool ahead of that stage 2's crops, and at most two
    waves of full-resolution images are alive. The runner's wait for a prefetched build
    is traced as `episode.stage1_wait`, and the waves built ahead are counted in
    `episode.stage1_prefetched`. A build that raises raises here when its wave is
    reached; no build is left running when the call returns or raises."""
    from ..runtime.pipeline import run_paired_waves

    state: dict = {}
    ahead: dict = {}  # wave -> its stage-1 build submitted to the prefetch thread
    out: List[Optional[List[EpisodeResult]]] = [None] * len(waves)

    def stage1(w):
        entry = waves[w]
        questions, images = entry() if callable(entry) else entry
        return (questions, images) + _stage1_inputs(generator, processor, questions, images, stage1_max_size)

    def prefetch(w):
        if w < len(waves):
            ahead[w] = _prefetch_thread().submit(stage1, w)

    def build_stage1(w):
        if w in ahead:
            with tracer.span("episode.stage1_wait"):
                state[w] = ahead.pop(w).result()
            tracer.count("episode.stage1_prefetched")
        else:  # wave 0: built here, and wave 1's build starts at once
            state[w] = stage1(w)
            prefetch(w + 1)
        return state[w][-1]

    def build_stage2(w, out1, base_lengths, base_next):
        # (questions, images, texts, resized, scales, encoded, batch): popped, so no name here
        # keeps wave w's images alive once its crops are cut
        results, bc, keep, inert, s2_idx = _stage2_continuation(
            generator, processor, *state.pop(w), out1, crop_min_size, crop_max_size,
        )
        state[w] = (results, s2_idx)
        prefetch(w + 2)
        return bc, keep, inert

    def on_complete(w, out1, out2):
        results, s2_idx = state.pop(w)
        tk = processor.tokenizer
        with tracer.span("text.decode"):
            for i in s2_idx:
                text2 = tk.decode(out2[i]).strip()
                results[i] = dataclasses.replace(results[i], stage2=text2, answer2=extract_answer(text2))
        out[w] = results

    try:
        run_paired_waves(
            generator, len(waves), build_stage1, build_stage2,
            gen1=gen, gen2=stage2_gen or gen, seed=seed, on_complete=on_complete,
        )
    finally:  # the runner raised before it reached a prefetched wave: end that build first
        for f in ahead.values():
            f.cancel()
        wait(ahead.values())
    return out  # type: ignore[return-value]


def run_episodes(
    generator: Generator,
    processor: Processor,
    questions: Sequence[str],
    images: Sequence,  # PIL images at FULL resolution
    *,
    stage1_max_size: int = 512,
    crop_min_size: int = 512,
    crop_max_size: int = 512,
    gen: GenerationConfig = GenerationConfig(max_new_tokens=1024, temperature=0.01),
    seed: int = 0,
    reuse_cache: bool = False,
    stage2_gen: Optional[GenerationConfig] = None,
) -> List[EpisodeResult]:
    """Run one batched two-stage episode per (question, full-res image) pair.

    reuse_cache=True continues stage 2 from the stage-1 KV cache (prefilling only the
    crop's tokens); the kept tokens are then the GENERATED ids rather than a
    re-tokenization, so eval-parity runs use False (the default).
    stage2_gen: stage-2 decoding config (default: same as stage 1)."""
    cfg = generator.cfg
    tk = processor.tokenizer
    gen2 = stage2_gen or gen

    stage1_texts, resized, scales, encoded, batch = _stage1_inputs(
        generator, processor, questions, images, stage1_max_size
    )

    if reuse_cache:
        out_tokens, stage1_cache = generator.generate(batch, gen, seed=seed, return_cache=True)
        results, bc, keep, inert, s2_idx = _stage2_continuation(
            generator, processor, questions, images, stage1_texts, resized, scales,
            encoded, batch, out_tokens, crop_min_size, crop_max_size,
        )
        if s2_idx:
            out2_all = generator.continue_generate(
                stage1_cache, bc, keep, gen2, seed=seed + 1, inert_mask=inert,
            )
            for i in s2_idx:
                out2 = tk.decode(out2_all[i]).strip()
                results[i] = dataclasses.replace(results[i], stage2=out2, answer2=extract_answer(out2))
        return results  # type: ignore[return-value]

    out_tokens = generator.generate(batch, gen, seed=seed)
    stage1_out = [tk.decode(t).strip() for t in out_tokens]

    # stage 2: full stitched re-prefill, batched over samples with a bbox
    results: List[Optional[EpisodeResult]] = [None] * len(questions)
    s2_idx, s2_texts, s2_images = [], [], []
    for i, out1 in enumerate(stage1_out):
        boxes = extract_bboxes(out1, scales[i])
        if not boxes:
            results[i] = EpisodeResult(
                question=questions[i], stage1=out1, stage2="",
                answer1=extract_answer(out1), answer2=None, bbox=None, error=True,
            )
            continue
        bbox = boxes[0]
        crop = resize_image(cut_image(images[i], bbox, crop_min_size), crop_max_size)
        s2_idx.append(i)
        s2_texts.append(PT.stage2_prompt(stage1_texts[i], out1, family(cfg).prompts()[1]))
        s2_images.append([resized[i], crop])
        results[i] = EpisodeResult(
            question=questions[i], stage1=out1, stage2="",
            answer1=extract_answer(out1), answer2=None, bbox=bbox, error=False,
        )

    if s2_idx:
        encoded2 = [processor.encode(t, ims) for t, ims in zip(s2_texts, s2_images)]
        batch2 = prepare_batch(cfg, [ids for ids, _ in encoded2], [imgs for _, imgs in encoded2])
        out2_tokens = generator.generate(batch2, gen2, seed=seed + 1)
        for j, i in enumerate(s2_idx):
            out2 = tk.decode(out2_tokens[j]).strip()
            results[i] = dataclasses.replace(results[i], stage2=out2, answer2=extract_answer(out2))
    return results  # type: ignore[return-value]
