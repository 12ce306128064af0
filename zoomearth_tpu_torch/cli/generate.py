"""Data-generation CLI: N sampled completions per prompt against a serving endpoint
(the port's own copy of zoomearth_tpu/cli/generate.py).

Reference surface: open_r1/generate.py __main__ (distilabel pipeline over a vLLM
OpenAI endpoint; --hf-dataset/--prompt-column/--num-generations/--temperature/
--top-p/--max-new-tokens/--vllm-server-url). Local-first: the dataset is a jsonl
file and the output is a jsonl file (ingestable by datasets.Dataset.from_json); the
endpoint is any OpenAI-compatible server, including `python -m zoomearth_tpu_torch.cli.serve`.
"""

from __future__ import annotations

import argparse
import json

from ..eval.client import ChatClient
from ..train.datagen import generate_records, write_records


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate completions for a prompt dataset")
    p.add_argument("--dataset", required=True, help="input jsonl with one object per line")
    p.add_argument("--prompt-column", default="prompt")
    p.add_argument("--model", default="zoomearth-tpu")
    p.add_argument("--server-url", default="http://127.0.0.1:8000",
                   help="OpenAI-compatible endpoint (serve CLI or vLLM)")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--num-generations", type=int, default=1)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--limit", type=int, default=0, help="only the first N prompts")
    p.add_argument("--out", required=True, help="output jsonl")
    args = p.parse_args(argv)

    prompts = []
    with open(args.dataset) as f:
        for line in f:
            if line.strip():
                prompts.append(json.loads(line)[args.prompt_column])
            if args.limit and len(prompts) >= args.limit:
                break
    client = ChatClient(args.server_url, model=args.model)
    records = generate_records(
        prompts, client=client, num_generations=args.num_generations,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_p=args.top_p, concurrency=args.concurrency, model_name=args.model,
    )
    out = write_records(records, args.out)
    print(f"wrote {len(records)} records -> {out}")


if __name__ == "__main__":
    main()
