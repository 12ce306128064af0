"""Batch LRS-GRO inference (port of cli/infer.py).

python -m zoomearth_tpu_torch.cli.infer --model_name MODEL_DIR --exp_name NAME \
    --data_file test.jsonl --image_folder ./image [--batch_size 8] [--device cuda] \
    [--mode pipelined]
Writes results/{exp_name}{rank}.jsonl; python -m zoomearth_tpu_torch.cli.eval scores it.
Runs on the CUDA device unless --device names another; without a CUDA device and
without --device cpu it raises.
"""

from __future__ import annotations

import argparse

from ..eval.infer import run_inference
from ..runtime.generate import GenerationConfig, Generator
from ..train.data import load_lrs_gro_jsonl
from .common import add_device_arg, load_model_and_processor
from .config import parse_with_yaml


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch two-stage inference over LRS-GRO (PyTorch port)")
    p.add_argument("--model_name", required=True, help="local HF checkpoint directory")
    p.add_argument("--exp_name", required=True)
    p.add_argument("--data_file", required=True, help="LRS-GRO jsonl")
    p.add_argument("--image_folder", required=True)
    p.add_argument("--out_dir", default="results")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--stage2_max_new_tokens", type=int, default=0,
                   help="stage-2 decode budget (0 = same as stage 1)")
    p.add_argument("--temperature", type=float, default=0.01)
    p.add_argument("--max_pixels", type=int, default=128 * 128 * 28 * 28)
    p.add_argument("--limit", type=int, default=0, help="only the first N samples")
    p.add_argument("--mode", choices=("sequential", "pipelined"), default="sequential",
                   help="pipelined: pair-pipelined waves + KV-reuse stage 2 (the throughput "
                        "configuration; sequential is the eval-parity default)")
    add_device_arg(p)
    return p


def main(argv=None):
    args = parse_with_yaml(build_parser(), argv)

    params, cfg, processor = load_model_and_processor(args.model_name, max_pixels=args.max_pixels,
                                                      device=args.device)
    generator = Generator(params, cfg, max_cache_len=4096)
    samples = load_lrs_gro_jsonl([args.data_file], [args.image_folder])
    if args.limit:
        samples = samples[: args.limit]
    out = run_inference(
        generator, processor, samples,
        f"{args.out_dir}/{args.exp_name}{args.rank}.jsonl",
        batch_size=args.batch_size, rank=args.rank, world_size=args.world_size,
        gen=GenerationConfig(max_new_tokens=args.max_new_tokens, temperature=args.temperature),
        stage2_gen=GenerationConfig(max_new_tokens=args.stage2_max_new_tokens,
                                    temperature=args.temperature)
        if args.stage2_max_new_tokens else None,
        model_id=f"{args.exp_name}---LRS-GRO",
        mode=args.mode,
    )
    print("Done! Predictions has been written to: ", out)


if __name__ == "__main__":
    main()
