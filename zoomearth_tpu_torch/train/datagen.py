"""Data-generation pipeline: N sampled completions per prompt at serving throughput
(the port's own copy of zoomearth_tpu/train/datagen.py, over the port's ServingEngine
and ChatClient; held equal to it by tests/test_torch_tools.py).

TPU-native rebuild of the reference's distilabel pipeline (open_r1/generate.py:22-55:
`build_distilabel_pipeline` = TextGeneration step -> OpenAILLM against a vLLM server,
`num_generations` per prompt, input_batch_size 64, results as a dataset). Two
backends, same record schema:

- `generate_records(engine=...)`: drive the IN-PROCESS ServingEngine directly —
  prompts x G requests flow through continuous batching with no HTTP hop (the
  engine's admission coalescing + slot backfill replaces distilabel's ray batching).
- `generate_records(client=...)`: drive any OpenAI-compatible endpoint (our
  serve.server, or an actual vLLM) with a thread pool — the reference's exact
  topology (generate.py:40-46), reusing eval/client.py's stdlib client.

Each record: {"instruction", "generations": [str x G], "model_name", "generation
config fields"} — the distiset row shape (distilabel's TextGeneration output columns)
flattened to plain jsonl so `datasets.Dataset.from_json` ingests it directly.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence


def _engine_generate(engine, processor, prompts: Sequence[str], *, num_generations: int,
                     max_new_tokens: int, temperature: float, top_p: float,
                     timeout: float) -> List[List[str]]:
    """All prompts x G through the engine's continuous batching; returns texts."""
    from ..serve.engine import Request

    tk = processor.tokenizer
    ids_list = [processor.encode(p, [])[0] for p in prompts]
    reqs = []
    for i, ids in enumerate(ids_list):
        for g in range(num_generations):
            reqs.append(Request(
                request_id=f"datagen-{i}-{g}", token_ids=list(ids), images=[],
                max_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
            ))
    for r in reqs:
        engine.submit(r)
    outs: List[List[str]] = [[] for _ in prompts]
    for i in range(len(prompts)):
        for g in range(num_generations):
            c = engine.get_completion(f"datagen-{i}-{g}", timeout=timeout)
            outs[i].append(tk.decode(c.token_ids).strip())
    return outs


def _client_generate(client, prompts: Sequence[str], *, num_generations: int,
                     max_new_tokens: int, temperature: float, top_p: float,
                     concurrency: int) -> List[List[str]]:
    """OpenAI-endpoint backend: thread-pooled chat calls (reference topology —
    generate.py:40-46 OpenAILLM + input_batch_size; infer_vllm.py:244-265's
    ThreadPoolExecutor pattern)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(args):
        i, g = args
        text = client.create(
            [{"role": "user", "content": prompts[i]}],
            max_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
        )
        return i, g, text

    outs: List[List[Optional[str]]] = [[None] * num_generations for _ in prompts]
    jobs = [(i, g) for i in range(len(prompts)) for g in range(num_generations)]
    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        for i, g, text in ex.map(one, jobs):
            outs[i][g] = text
    return [[t for t in row] for row in outs]


def generate_records(
    prompts: Sequence[str],
    *,
    engine=None,
    processor=None,
    client=None,
    num_generations: int = 1,
    max_new_tokens: int = 256,
    temperature: float = 0.7,
    top_p: float = 1.0,
    concurrency: int = 64,
    model_name: str = "zoomearth-tpu",
    timeout: float = 600.0,
) -> List[dict]:
    """num_generations sampled completions per prompt; returns distilabel-row-shaped
    dicts. Exactly one of (engine [+processor], client) selects the backend."""
    if (engine is None) == (client is None):
        raise ValueError("pass exactly one backend: engine=... (with processor) or client=...")
    if engine is not None:
        if processor is None:
            raise ValueError("engine backend needs processor= for tokenization")
        texts = _engine_generate(engine, processor, prompts,
                                 num_generations=num_generations,
                                 max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_p=top_p, timeout=timeout)
    else:
        texts = _client_generate(client, prompts, num_generations=num_generations,
                                 max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_p=top_p,
                                 concurrency=concurrency)
    return [
        {
            "instruction": p,
            "generations": row,
            "model_name": model_name,
            "num_generations": num_generations,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_p": top_p,
        }
        for p, row in zip(prompts, texts)
    ]


def write_records(records: Sequence[dict], out_path: str) -> str:
    """jsonl output (the local stand-in for distiset.push_to_hub, generate.py:150-153)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return out_path
