"""Episode-aware serving: pipelined two-stage zoom-QA on the continuous-batching engine
(port of serve/episodes.py; host code, the engine does the device work).

Each episode's stage 1 runs as a hold_slot request; when it completes, the host parses
the bbox and crops WHILE OTHER EPISODES KEEP DECODING, then submits a Continuation that
reuses the held KV cache (prefilling only the crop's vision tokens): crop
preprocessing is hidden under decode at the request level, with no wave barriers.

Completions flow through ONE worker thread fed by the engine's on_completion hook
instead of a blocked collector thread per episode: N threads doing PIL/numpy crop
work would starve the scheduler pump of the interpreter lock.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..agent import prompts as PT
from ..agent.episode import EpisodeResult, split_kept_tokens
from ..agent.processor import Processor
from ..image.geometry import cut_image, extract_answer, extract_bboxes, resize_image
from .engine import Continuation, Request, ServingEngine


def run_episodes_served(
    engine: ServingEngine,
    processor: Processor,
    questions: Sequence[str],
    images: Sequence,
    *,
    stage1_max_size: int = 512,
    crop_min_size: int = 512,
    max_new_tokens=1024,  # int, or a per-episode sequence
    stage2_max_tokens=None,  # int, or a per-episode sequence
    temperature: float = 0.01,
    prompt_fn: Optional[Callable[[str], str]] = None,
    image_keys: Optional[Sequence[str]] = None,
    prefix_str: Optional[str] = None,
) -> List[EpisodeResult]:
    """Run N two-stage episodes through the engine, fully pipelined.

    image_keys: stable per-image identifiers (e.g. file names). When given, the shared
    leading span "system prefix + stage-1 image" is prefix-cached in the engine keyed by
    image — repeat questions about the same image (LRS-GRO asks ~10.7 per image) skip
    that span's ViT pass and prefill only "question + instruction". prefix_str overrides
    the leading span (default PT.PREFIX, which ends at the stage-1 image).

    The engine pump thread must be running (engine.start()) or the caller must tick
    engine.step() concurrently. Registers engine.on_completion for the duration (one
    episode run at a time)."""
    tk = processor.tokenizer
    cfg = engine.cfg
    prompt_fn = prompt_fn or PT.stage1_prompt
    n = len(questions)
    if stage2_max_tokens is None:
        stage2_max_tokens = max_new_tokens
    s1_budget = [int(max_new_tokens)] * n if np.isscalar(max_new_tokens) else [int(x) for x in max_new_tokens]
    s2_budget = [int(stage2_max_tokens)] * n if np.isscalar(stage2_max_tokens) else [int(x) for x in stage2_max_tokens]
    results: List[Optional[EpisodeResult]] = [None] * n
    t_submit: List[float] = [0.0] * n
    done = threading.Event()
    pending = {"n": n}
    completions: "queue.Queue" = queue.Queue()

    prompts = [prompt_fn(q) for q in questions]
    resized, scales = [], []
    for img in images:
        small = resize_image(img, stage1_max_size)
        resized.append(small)
        scales.append(max(img.width, img.height) / max(small.width, small.height))

    def finish(i, r: EpisodeResult):
        results[i] = dataclasses.replace(r, latency_s=time.time() - t_submit[i])
        pending["n"] -= 1
        if pending["n"] == 0:
            done.set()

    stage1_text: List[str] = [""] * n
    stage1_bbox: List[Optional[list]] = [None] * n

    def handle_stage1(i, completion):
        out1_tokens = completion.token_ids
        out1 = tk.decode(out1_tokens).strip()
        stage1_text[i] = out1
        boxes = extract_bboxes(out1, scales[i])
        if not boxes:
            engine.release_slot(f"ep{i}-s1")
            finish(i, EpisodeResult(
                question=questions[i], stage1=out1, stage2="",
                answer1=extract_answer(out1), answer2=None, bbox=None, error=True,
            ))
            return
        stage1_bbox[i] = boxes[0]
        crop = resize_image(cut_image(images[i], boxes[0], crop_min_size), stage1_max_size)
        raw = tk.decode(out1_tokens, skip_special_tokens=False)
        kept, residual = split_kept_tokens(tk, out1_tokens, raw.split("<answer>")[0])
        crop_prepped = processor.preprocess_images([crop])
        chunk = (tk.encode(residual) if residual else []) + processor.expand_image_pads(
            tk.encode(PT.VISION_TOKENS), [crop_prepped[0][1]]
        )
        engine.submit_continuation(Continuation(
            parent_request_id=f"ep{i}-s1", request_id=f"ep{i}-s2",
            chunk_ids=chunk, images=crop_prepped, kept_tokens=len(kept),
            max_tokens=s2_budget[i], temperature=temperature,
        ))

    def handle_stage2(i, completion):
        out2 = tk.decode(completion.token_ids).strip()
        finish(i, EpisodeResult(
            question=questions[i], stage1=stage1_text[i], stage2=out2,
            answer1=extract_answer(stage1_text[i]), answer2=extract_answer(out2),
            bbox=stage1_bbox[i], error=False,
        ))

    def worker():
        while pending["n"] > 0:
            try:
                c = completions.get(timeout=1.0)
            except queue.Empty:
                continue
            rid = c.request_id
            if not rid.startswith("ep"):
                continue
            try:
                idx, stage = rid[2:].split("-")
                i = int(idx)
            except ValueError:
                # a malformed/foreign "ep*" id must not kill the single consumer
                # thread (a dead worker hangs the caller until the done.wait timeout)
                continue
            engine.results.pop(rid, None)  # consumed here, not via get_completion
            try:
                if stage == "s1":
                    handle_stage1(i, c)
                else:
                    handle_stage2(i, c)
            except Exception:  # a dead worker would silently hang the caller
                import traceback

                traceback.print_exc()
                # free the held stage-1 slot (a leaked hold blocks a queued episode
                # forever under oversubscription)
                engine.release_slot(f"ep{i}-s1")
                finish(i, EpisodeResult(
                    question=questions[i], stage1=stage1_text[i], stage2="",
                    answer1=None, answer2=None, bbox=None, error=True,
                ))

    prev_hook = engine.on_completion
    engine.on_completion = completions.put
    wt = threading.Thread(target=worker, daemon=True)
    wt.start()
    try:
        for i in range(n):
            ids, prepped = processor.encode(prompts[i], [resized[i]])
            prefix_key = None
            prefix_len = 0
            n_prefix_images = 0
            if image_keys is not None:
                pstr = prefix_str if prefix_str is not None else PT.PREFIX
                pids = tk.encode(pstr)
                n_prefix_images = pids.count(cfg.tokens.image_pad)
                grids = [g for _, g in prepped]
                pids = processor.expand_image_pads(pids, grids[:n_prefix_images])
                if list(ids[: len(pids)]) == list(pids):
                    prefix_len = len(pids)
                    prefix_key = f"{image_keys[i]}|{grids[:n_prefix_images]}"
            t_submit[i] = time.time()
            engine.submit(Request(
                request_id=f"ep{i}-s1", token_ids=ids, images=prepped,
                max_tokens=s1_budget[i], temperature=temperature, hold_slot=True,
                prefix_key=prefix_key, prefix_len=prefix_len, n_prefix_images=n_prefix_images,
            ))
        done.wait(timeout=3600)
        wt.join(timeout=5)
    finally:
        engine.on_completion = prev_hook
    return results  # type: ignore[return-value]
