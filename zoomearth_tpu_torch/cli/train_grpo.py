"""GRPO training CLI (port of cli/train_grpo.py; the reference's run_scripts/train_grpo.sh
-> grpo_jsonl.py surface).

python -m zoomearth_tpu_torch.cli.train_grpo --model_name_or_path MODEL_DIR \
    --data_file_paths rl.jsonl --image_folders ./image [--output_dir ./grpo_out] [--device cuda]

Flag names follow the reference TrlParser args (grpo_jsonl.py:66-116, train_grpo.sh:39-60),
plus --device and --backend; `data_file_paths` / `image_folders` are
`:`-separated like the reference's. Each process trains on one device: the CUDA device
of its local rank unless --device names another (without a CUDA device and without
--device cpu it raises). A multi-process launch (--coordinator_address,
--num_processes, --process_id, or torchrun's environment) joins the process group, as
the JAX CLI does; the port's processes then train one policy over a data mesh of the
world (GRPOTrainer(mesh=)), each rolling out its share of the step's prompts
(per_device_train_batch_size of them), and rank 0 alone writes. The JAX CLI builds no
mesh, so its processes would each train alone into one output_dir.
"""

from __future__ import annotations

import argparse
import json
import os
import random

from ..parallel.multihost import gather_params
from ..rewards.registry import get_reward_funcs
from ..train.checkpoints import CheckpointManager
from ..train.data import batched, load_lrs_gro_jsonl
from ..train.grpo import GRPOConfig, GRPOTrainer
from .common import add_device_arg, load_model_and_processor
from .config import parse_with_yaml
from .train_sft import add_launch_args, join_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ZoomEarth GRPO (PyTorch port)")
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--data_file_paths", required=True, help="`:`-separated jsonl paths")
    p.add_argument("--image_folders", required=True, help="`:`-separated image folders")
    p.add_argument("--output_dir", default="./grpo_out")
    p.add_argument("--per_device_train_batch_size", type=int, default=4,
                   help="prompts each data rank rolls out a step; a multi-process launch trains one policy over a "
                        "data mesh of the world, so a step takes this times the world's size (the reference's "
                        "torchrun semantics; the JAX CLI builds no mesh and its processes each train alone)")
    p.add_argument("--num_generations", type=int, default=4)
    p.add_argument("--max_completion_length", type=int, default=2048)
    p.add_argument("--learning_rate", type=float, default=1e-7)
    p.add_argument("--beta", type=float, default=0.04)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.add_argument("--epsilon_high", type=float, default=None)
    p.add_argument("--num_iterations", type=int, default=1)
    p.add_argument("--scale_rewards", action="store_true",
                   help="divide advantages by group std (vLLM-trainer variant)")
    p.add_argument("--freeze_vision_modules", action="store_true")
    p.add_argument("--sync_ref_model", action="store_true",
                   help="TR-DPO: mix policy into the reference every sync steps")
    p.add_argument("--ref_model_mixup_alpha", type=float, default=0.6)
    p.add_argument("--ref_model_sync_steps", type=int, default=512)
    p.add_argument("--use_lora", action="store_true",
                   help="train LoRA adapters on the decoder, base frozen (PEFT path)")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--reward_funcs", nargs="+", default=["iou", "format", "answer"])
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=50)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--max_samples", type=int, default=2400)  # reference select(range(2400))
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--report_to", nargs="+", default=["jsonl"],
                   help="metric sinks: jsonl, tensorboard, wandb (reference train_grpo.sh:58)")
    p.add_argument("--log_completions", action="store_true",
                   help="append per-step rollout samples to <output_dir>/completions.jsonl")
    p.add_argument("--seed", type=int, default=42)
    add_launch_args(p, mesh_axes=False)
    add_device_arg(p)
    return p


def main(argv=None):
    args = parse_with_yaml(build_parser(), argv)
    device, mesh = join_mesh(args, "train_grpo")
    writer = mesh is None or mesh.rank == 0
    # outside torch.inference_mode(): the loaded tensors become trainable leaves
    params, cfg, processor = load_model_and_processor(args.model_name_or_path, device=str(device))
    samples = load_lrs_gro_jsonl(args.data_file_paths.split(":"), args.image_folders.split(":"))
    if args.max_samples:
        samples = samples[: args.max_samples]

    grpo_cfg = GRPOConfig(
        num_generations=args.num_generations,
        max_completion_length=args.max_completion_length,
        stage2_max_completion_length=min(args.max_completion_length, 800),
        learning_rate=args.learning_rate,
        beta=args.beta,
        epsilon_low=args.epsilon,
        epsilon_high=args.epsilon_high if args.epsilon_high is not None else args.epsilon,
        num_iterations=args.num_iterations,
        scale_rewards=args.scale_rewards,
        freeze_vision_modules=args.freeze_vision_modules,
        sync_ref_model=args.sync_ref_model,
        ref_model_mixup_alpha=args.ref_model_mixup_alpha,
        ref_model_sync_steps=args.ref_model_sync_steps,
        use_lora=args.use_lora, lora_r=args.lora_r, lora_alpha=args.lora_alpha,
        log_completions=args.log_completions,
        completions_path=os.path.join(args.output_dir, "completions.jsonl"),
    )
    trainer = GRPOTrainer(
        params, cfg, grpo_cfg, processor,
        get_reward_funcs(args.reward_funcs), reward_names=args.reward_funcs, device=device, mesh=mesh,
    )
    ckpt = CheckpointManager(args.output_dir)
    start_step = 0
    if args.resume_from_checkpoint:
        latest = ckpt.latest()
        if latest is not None:
            restored, opt_state, meta = ckpt.restore(latest, trainer.params, mesh=mesh, specs=trainer.specs)
            trainer.load_state(restored, opt_state)
            start_step = meta["step"]

    os.makedirs(args.output_dir, exist_ok=True)
    from ..utils.metrics_sinks import MetricsLogger

    logger = MetricsLogger(args.output_dir, report_to=tuple(set(args.report_to) | {"jsonl"})) if writer else None
    prompts = args.per_device_train_batch_size * (mesh.shape["data"] if mesh is not None else 1)
    global_step = 0
    try:
        for epoch in range(args.num_train_epochs):
            # per-epoch shuffle, seeded for a deterministic resume (the reference's
            # RepeatRandomSampler shuffles prompt order, grpo_trainer.py:897-911)
            epoch_samples = list(samples)
            random.Random(args.seed + epoch).shuffle(epoch_samples)
            for batch in batched(epoch_samples, prompts, drop_last=True):
                global_step += 1
                if global_step <= start_step:
                    continue
                m = trainer.step(batch, seed=args.seed + global_step)
                if global_step % args.logging_steps == 0 and writer:
                    print(json.dumps({"step": global_step, "epoch": epoch, **m}))
                    logger.log({"epoch": epoch, **m}, global_step)
                if global_step % args.save_steps == 0:
                    full = (trainer.params if mesh is None else
                            gather_params(trainer.params, trainer.specs, mesh, root=0, device="cpu"))
                    opt_state = trainer.state_dict(root=0)
                    if writer:
                        ckpt.save(global_step, full, opt_state, extra={"epoch": epoch})
                    del full, opt_state
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
