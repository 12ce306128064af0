"""SFT training CLI (port of cli/train_sft.py; the reference's run_scripts/train_sft.sh
-> src/train/SFT.py surface).

python -m zoomearth_tpu_torch.cli.train_sft --model_name MODEL_DIR \
    --dataset_name_train sft.jsonl --img_folder ./image [--output_dir ./sft_out] [--device cuda]

Flag names follow the reference argparse (SFT.py:228-257), plus --device. Trains on
one device: the CUDA device unless --device names another (without a CUDA device and
without --device cpu it raises). The mesh flags (--fsdp, --tensor) and a
multi-process launch (--num_processes or WORLD_SIZE above 1, --coordinator_address)
are refused with an error until the port has its parallel layer (ROADMAP item 16);
they are never ignored.
"""

from __future__ import annotations

import argparse
import os

from ..train.data import load_sft_dataset
from ..train.sft import SFTConfig
from ..train.sft_loop import SFTLoopConfig, train_sft
from .common import add_device_arg, load_model_and_processor
from .config import parse_with_yaml


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ZoomEarth SFT (PyTorch port)")
    p.add_argument("--model_name", required=True, help="local HF checkpoint directory")
    p.add_argument("--dataset_name_train", required=True, help="SFT jsonl file or HF dataset directory")
    p.add_argument("--img_folder", required=True)
    p.add_argument("--output_dir", default="./sft_out")
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=8, help="samples per micro-step")
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--save_steps", type=int, default=100)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--max_pixels", type=int, default=64 * 64 * 28 * 28)  # train_sft.sh:22
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--report_to", nargs="+", default=["jsonl"],
                   help="metric sinks: jsonl, tensorboard, wandb (reference SFT.py:333-339)")
    p.add_argument("--fsdp", type=int, default=1, help="fsdp mesh axis size (only 1 until the parallel layer)")
    p.add_argument("--tensor", type=int, default=1, help="tensor mesh axis size (only 1 until the parallel layer)")
    p.add_argument("--coordinator_address", default=None, help="multi-process launch (not yet supported)")
    p.add_argument("--num_processes", type=int, default=None, help="multi-process launch (only 1 until the "
                   "parallel layer)")
    p.add_argument("--process_id", type=int, default=None)
    add_device_arg(p)
    return p


def refuse_parallel(args) -> None:
    """Raise on any request for more than one device or process."""
    asked = []
    if args.fsdp != 1:
        asked.append(f"--fsdp {args.fsdp}")
    if args.tensor != 1:
        asked.append(f"--tensor {args.tensor}")
    if (args.num_processes or 1) > 1:
        asked.append(f"--num_processes {args.num_processes}")
    if args.coordinator_address:
        asked.append(f"--coordinator_address {args.coordinator_address}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        asked.append(f"WORLD_SIZE={os.environ['WORLD_SIZE']}")
    if asked:
        raise SystemExit(f"train_sft: {', '.join(asked)}: the PyTorch port trains on one device until its parallel "
                         "layer lands (ROADMAP item 16); drop these flags")


def main(argv=None):
    args = parse_with_yaml(build_parser(), argv)
    refuse_parallel(args)
    # outside torch.inference_mode(): the loaded tensors become trainable leaves
    params, cfg, processor = load_model_and_processor(args.model_name, max_pixels=args.max_pixels,
                                                      device=args.device)
    # jsonl file OR an HF dataset directory (the reference's load_from_disk format,
    # SFT.py:181), auto-detected
    dataset = load_sft_dataset(args.dataset_name_train, args.img_folder)
    sft_cfg = SFTConfig(
        learning_rate=args.lr, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
    )
    loop_cfg = SFTLoopConfig(
        output_dir=args.output_dir, num_train_epochs=args.num_train_epochs,
        batch_size=args.batch_size, save_steps=args.save_steps, log_steps=args.log_steps,
        max_pixels=args.max_pixels, seed=args.seed,
        resume_from_checkpoint=args.resume_from_checkpoint,
        report_to=tuple(set(args.report_to) | {"jsonl"}),
    )
    train_sft(params, cfg, sft_cfg, loop_cfg, dataset, processor, device=args.device)


if __name__ == "__main__":
    main()
