"""SFT training CLI (port of cli/train_sft.py; the reference's run_scripts/train_sft.sh
-> src/train/SFT.py surface).

python -m zoomearth_tpu_torch.cli.train_sft --model_name MODEL_DIR \
    --dataset_name_train sft.jsonl --img_folder ./image [--output_dir ./sft_out] [--device cuda]

Flag names follow the reference argparse (SFT.py:228-257), plus --device and
--backend. Each process trains on one device: the CUDA device of its local rank
unless --device names another (without a CUDA device and without --device cpu it
raises). A multi-process launch joins the process group first (parallel/multihost.py):
--num_processes, --coordinator_address and --process_id, as the JAX CLI takes them, or
torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT; the processes then train one
model over a (data, fsdp, tensor) mesh of the world (--fsdp, --tensor; data takes the
rest), and rank 0 alone writes. A --tensor that does not divide the model's head
counts (its config.json's) is refused before anything is loaded; --fsdp and --tensor
beyond the world fail on the mesh's size.

    torchrun --nproc_per_node 2 -m zoomearth_tpu_torch.cli.train_sft ... --tensor 2 --device cpu
    torchrun --nproc_per_node 2 -m zoomearth_tpu_torch.cli.train_sft ... --tensor 2 --backend gloo --device cuda:0
"""

from __future__ import annotations

import argparse

from ..config import VLMConfig
from ..parallel.mesh import check_tensor_heads, make_mesh
from ..parallel.multihost import initialize, rank_device
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
    add_launch_args(p)
    add_device_arg(p)
    return p


def add_launch_args(p, *, mesh_axes: bool = True) -> None:
    """The multi-process flags both training CLIs take, and the mesh's axis sizes
    (train_sft's, as the JAX CLIs have them)."""
    if mesh_axes:
        p.add_argument("--fsdp", type=int, default=1, help="fsdp mesh axis size")
        p.add_argument("--tensor", type=int, default=1,
                       help="tensor mesh axis size (must divide the decoder's and the ViT's head counts)")
    # multi-process launch (torchrun --master_addr/--nnodes/--node_rank analog,
    # reference run_scripts/train_grpo.sh:34-36); torchrun's environment works too
    p.add_argument("--coordinator_address", default=None, help="host:port of rank 0's rendezvous")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on CUDA, gloo on the CPU)")


def join_mesh(args, prog: str):
    """Join the process group where the launch asks for one, then the mesh:
    (device, mesh or None). A --tensor above 1 that does not divide the head counts of
    the model's config is refused before anything starts."""
    tensor = getattr(args, "tensor", 1)
    if tensor != 1:
        try:
            check_tensor_heads(VLMConfig.from_hf_dir(args.model_name), tensor)
        except ValueError as e:
            raise SystemExit(f"{prog}: --tensor {tensor}: {e}") from None
    joined = initialize(args.coordinator_address, args.num_processes, args.process_id, backend=args.backend,
                        device=args.device)
    device = rank_device(args.device)
    fsdp = getattr(args, "fsdp", 1)
    mesh = make_mesh(data=-1, fsdp=fsdp, tensor=tensor) if joined or fsdp != 1 or tensor != 1 else None
    return device, mesh


def main(argv=None):
    args = parse_with_yaml(build_parser(), argv)
    device, mesh = join_mesh(args, "train_sft")
    # outside torch.inference_mode(): the loaded tensors become trainable leaves
    params, cfg, processor = load_model_and_processor(args.model_name, max_pixels=args.max_pixels,
                                                      device=str(device))
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
    train_sft(params, cfg, sft_cfg, loop_cfg, dataset, processor, mesh=mesh, device=device)


if __name__ == "__main__":
    main()
