"""Batch two-stage inference over LRS-GRO (port of eval/infer.py).

Writes jsonl result records with the reference's exact schema, one file per rank;
eval/score.py (python -m zoomearth_tpu_torch.cli.eval) scores them.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from ..agent.episode import EpisodeResult, run_episodes, run_episodes_pipelined
from ..agent.processor import Processor
from ..image.geometry import extract_bbox
from ..runtime.generate import GenerationConfig, Generator
from ..train.data import LRSGROSample, batched

DEFAULT_MODEL_ID = "zoomearth-tpu-torch"


def record_dict(sample: LRSGROSample, r: EpisodeResult, model_id: str = DEFAULT_MODEL_ID) -> dict:
    """Reference record schema (infer.py:126-143)."""
    return {
        "question_id": sample.question_id,
        "ground_truth": sample.ground_truth,
        "answer1": r.answer1,
        "answer2": r.answer2,
        "bbox_ref": sample.bbox,
        "bbox": extract_bbox(r.stage1, 1),
        "prompt": sample.question,
        "category": sample.category,
        "stage1": r.stage1,
        "stage2": r.stage2,
        "type": sample.type,
        "image": sample.image_name,
        "error": r.error,
        "model_id": model_id,
    }


def run_inference(
    generator: Generator,
    processor: Processor,
    samples: Sequence[LRSGROSample],
    out_path: str,
    *,
    batch_size: int = 8,
    rank: int = 0,
    world_size: int = 1,
    stage1_max_size: int = 512,
    gen: GenerationConfig = GenerationConfig(max_new_tokens=1024, temperature=0.01),
    stage2_gen: Optional[GenerationConfig] = None,
    model_id: str = DEFAULT_MODEL_ID,
    image_loader=None,
    group_by_image: bool = True,
    mode: str = "sequential",
) -> str:
    """Run the two-stage eval over this rank's shard; returns the output path.

    image_loader(sample) -> PIL image; defaults to opening sample.image_path.
    group_by_image: process questions about the same tile consecutively so a small
    loader cache decodes each ~5000 px tile once.

    mode="pipelined": run the batches as PAIR-PIPELINED waves
    (agent.episode.run_episodes_pipelined): wave n's stage-1 decode co-batches with
    wave n-1's stage-2 decode. It uses cache-reuse stage-2 semantics (kept tokens are
    the generated ids); eval-parity runs keep the default sequential mode. The last
    partial batch runs sequentially with reuse_cache=True (waves share one batch size)."""
    if image_loader is None:
        from PIL import Image

        def image_loader(s):
            return Image.open(s.image_path).convert("RGB")

    _cache: dict = {}

    def cached_loader(s):
        key = s.image_name or s.image_path
        if key not in _cache:
            if len(_cache) >= 4:
                _cache.pop(next(iter(_cache)))
            _cache[key] = image_loader(s)
        return _cache[key]

    shard = [s for i, s in enumerate(samples) if i % world_size == rank]
    if group_by_image:
        shard = sorted(shard, key=lambda s: s.image_name or "")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fout:
        if mode == "pipelined":
            groups = list(batched(shard, batch_size))
            full = [g for g in groups if len(g) == batch_size]
            remaining = [g for g in groups if len(g) != batch_size]
            if full:
                # lazy wave loaders: only ~2 waves of full-res tiles live at once
                waves = [(lambda g=g: ([s.question for s in g], [cached_loader(s) for s in g])) for g in full]
                wave_results = run_episodes_pipelined(
                    generator, processor, waves,
                    stage1_max_size=stage1_max_size, gen=gen, stage2_gen=stage2_gen,
                )
                for g, results in zip(full, wave_results):
                    for s, r in zip(g, results):
                        fout.write(json.dumps(record_dict(s, r, model_id), ensure_ascii=False) + "\n")
                    fout.flush()
        else:
            remaining = batched(shard, batch_size)
        for batch in remaining:
            images = [cached_loader(s) for s in batch]
            questions = [s.question for s in batch]
            results = run_episodes(
                generator, processor, questions, images,
                stage1_max_size=stage1_max_size, gen=gen, stage2_gen=stage2_gen,
                reuse_cache=(mode == "pipelined"),
            )
            for s, r in zip(batch, results):
                fout.write(json.dumps(record_dict(s, r, model_id), ensure_ascii=False) + "\n")
            fout.flush()
    return out_path
