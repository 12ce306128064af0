"""Full SFT training loop: collate -> train step -> metrics -> checkpoint/resume
(port of train/sft_loop.py).

The reference's sample semantics (its accelerate loop, SFT.py:259-390): the
<location>/<bbox>-tag SFT template (SFT.py:134-145, distinct from the RL/eval
template), 1- or 2-image samples depending on `cut`, label masking by the text_pair
convention. One device per process, given explicitly (`cuda` unless the caller names
another, through cli/common.py::resolve_device); with `mesh=` the processes of a
(data, fsdp, tensor) mesh train one model through train/sft.py's sharded step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..agent.processor import Processor
from ..cli.common import resolve_device
from ..config import VLMConfig
from ..image.geometry import cut_image, resize_image
from ..models.params import tree_leaves
from ..models.rope import mrope_position_ids_batch
from ..models.vit import vision_metadata
from ..runtime.generate import DEFAULT_LENGTH_BUCKETS, DEFAULT_PATCH_BUCKETS, bucket
from ..parallel.collectives import max_over
from ..parallel.mesh import Mesh, check_tensor_heads, param_shardings, shard_params
from ..parallel.multihost import gather_params
from .checkpoints import CheckpointManager
from .data import SFTSample, batched
from .sft import (
    SFTConfig,
    SFTOptimizer,
    batch_shardings,
    batch_to_device,
    shard_batch,
    sharded_train_step,
    train_step,
)

# The SFT task template — reference SFT.py:134-145 verbatim.
SFT_TASK_INSTRUCTION = """
Task:
1. Global view – Give a one-sentence description of the entire scene.
2. Reasoning focus – Decide which part of the image you must attend to in order to answer the question. Wrap the chosen keyword (pick exactly one from bottom-left, bottom-right, bottom-center, top-left, top-right, top-center, center-left, center-right, center) in the tag <location>...</location>.
3. Answer box – Output the bounding box of that region as pixel coordinates in the form <bbox>[x1,y1,x2,y2]</bbox>. Use integers, no spaces.
4. Post-crop analysis - After cropping to the box in step 3, examine that patch and write a brief statement explaining the visual evidence that supports your answer.
5. Answer - your answer. In the tag <answer>...</answer>

Rules:
- Return exactly one <location> tag and one <bbox> tag; nothing else after them.
- If unsure, pick the most probable location and best-guess box—never say you are uncertain.
"""


def sft_prompt(question: str) -> str:
    return "<|image_pad|> \n" + question + SFT_TASK_INSTRUCTION


def sft_label(example: SFTSample) -> str:
    """Reference SFT.py:148-168: cut samples embed the cropped image mid-label."""
    if example.cut:
        return (
            f"{example.global_desc}"
            f" {example.stage_1_reasoning} "
            f"<location>{example.area}</location>\n"
            f"<bbox>{example.bbox}</bbox>\n"
            f"<|image_pad|>\n"
            f"{example.stage_2_reasoning}\n"
            f"<answer>{example.ground_truth}</answer> <|endoftext|>"
        )
    return (
        f"{example.global_desc}"
        f" {example.stage_1_reasoning} "
        f"{example.stage_2_reasoning}\n"
        f"<answer>{example.ground_truth}</answer> <|endoftext|>"
    )


def collate_sft(
    examples: Sequence[SFTSample],
    processor: Processor,
    *,
    image_loader: Optional[Callable] = None,
    max_image_size: int = 1024,
    length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
    patch_buckets: Sequence[int] = DEFAULT_PATCH_BUCKETS,
) -> dict:
    """Build one padded training batch (numpy) from SFT samples.

    image_loader(sample) -> full-res PIL image; default opens sample.image_path.
    Reference host pipeline: full image resized to <=1024; cut samples also crop the
    ORIGINAL around bbox (SFT.py:158-169)."""
    from PIL import Image

    if image_loader is None:
        def image_loader(s):
            return Image.open(s.image_path).convert("RGB")

    cfg = processor.cfg
    ids_list, labels_list, images_all, grids_per_seq = [], [], [], []
    for ex in examples:
        full = image_loader(ex)
        if ex.cut:
            crop = cut_image(full, ex.bbox)
            imgs = [resize_image(full, max_image_size), crop]
        else:
            imgs = [resize_image(full, max_image_size)]
        ids, labels, prepped = processor.encode_with_labels(sft_prompt(ex.question), sft_label(ex), imgs)
        ids_list.append(ids)
        labels_list.append(labels)
        images_all.extend(prepped)
        grids_per_seq.append([g for _, g in prepped])

    B = len(examples)
    S = bucket(max(len(i) for i in ids_list), length_buckets)
    input_ids = np.full((B, S), cfg.tokens.pad, np.int32)
    labels = np.full((B, S), -100, np.int32)
    for b, (ids, lab) in enumerate(zip(ids_list, labels_list)):
        input_ids[b, : len(ids)] = ids
        labels[b, : len(lab)] = lab
    pos, _ = mrope_position_ids_batch(
        input_ids, grids_per_seq, image_pad_id=cfg.tokens.image_pad,
        merge_size=cfg.vision.spatial_merge_size,
        attention_mask=(input_ids != cfg.tokens.pad).astype(np.int32),
    )
    pv = np.concatenate([p for p, _ in images_all], axis=0)
    n_p = bucket(pv.shape[0], patch_buckets)
    meta = vision_metadata([g for _, g in images_all], cfg.vision, pad_to=n_p)
    if n_p > pv.shape[0]:
        pv = np.concatenate([pv, np.zeros((n_p - pv.shape[0], pv.shape[1]), pv.dtype)])
    return {
        "input_ids": input_ids,
        "labels": labels,
        "position_ids": pos,
        "pixel_values": pv,
        "vision_meta": {
            "perm": meta.perm,
            "inv_perm_merged": meta.inv_perm_merged,
            "seg_window": meta.seg_window,
            "seg_full": meta.seg_full,
            "pos_ids": meta.pos_ids,
        },
    }


@dataclasses.dataclass
class SFTLoopConfig:
    """Loop-level knobs, names matching the reference argparse (SFT.py:228-257)."""

    output_dir: str = "./sft_out"
    num_train_epochs: int = 3
    batch_size: int = 8  # samples per micro-step (on a mesh: the whole batch, split over `data`)
    save_steps: int = 100
    log_steps: int = 10
    max_pixels: int = 64 * 64 * 28 * 28
    seed: int = 42
    resume_from_checkpoint: bool = False
    # metric sinks: jsonl always; "tensorboard"/"wandb" mirror the reference's
    # accelerate trackers (SFT.py:333-339)
    report_to: tuple = ("jsonl",)


def make_trainable(params) -> None:
    """Mark every floating-point leaf as a leaf that requires grad. A tree made under
    torch.inference_mode() cannot be: build it outside (load_hf_checkpoint and
    init_vlm_params do not enter it)."""
    for t in tree_leaves(params):
        if t.is_inference():
            raise RuntimeError("train_sft: the parameters were made under torch.inference_mode() and cannot be "
                               "trained; load or build them outside it")
        if t.is_floating_point():
            t.requires_grad_(True)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_sft(
    params,
    cfg: VLMConfig,
    sft_cfg: SFTConfig,
    loop_cfg: SFTLoopConfig,
    dataset: List[SFTSample],
    processor: Processor,
    *,
    mesh: Optional[Mesh] = None,
    device=None,
    image_loader=None,
    max_steps: Optional[int] = None,
    callbacks: Optional[list] = None,
    on_grads: Optional[Callable[[int, tuple], None]] = None,
):
    """Run the SFT loop on `device` (None: cuda; the parameters must already be
    there). Returns (params, metrics_history); the parameters are trained in place
    (on a resume, the restored tree is trained and returned). Each logged record
    also holds the micro-step's seconds in train_step, the device synchronized
    before and after (`step_s`), and its padded tokens and patches.

    mesh: a (data, fsdp, tensor) mesh of the world's ranks (parallel/mesh.make_mesh); every
    rank calls train_sft with the same full parameters and dataset. The parameters
    are sharded at entry and the returned tree is this rank's shards
    (parallel/multihost.gather_params gives the full one); every rank collates the
    same global batch of `batch_size` samples and keeps its data slice; only rank 0
    writes metrics, checkpoints (full values) and runs the callbacks; `history` is
    the same on every rank (the whole batch's loss, grad norm and tokens; the
    slowest rank's seconds).

    callbacks: train.callbacks-style objects; `on_save(step, ckpt_dir, params)` fires
    after each checkpoint save (reference PushToHubRevisionCallback semantics,
    utils/callbacks.py:28-85: HF export + benchmark job triggering).
    on_grads(step, grads): sees each micro-step's gradients before the optimizer
    (train_step's `on_grads`)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if any(t.device != device for t in tree_leaves(params)):
        raise ValueError(f"train_sft: the parameters must be on {device}")
    specs = None
    if mesh is not None:
        check_tensor_heads(cfg, mesh.shape["tensor"])
        if loop_cfg.batch_size % mesh.shape["data"]:
            raise ValueError(f"train_sft: a batch of {loop_cfg.batch_size} does not split over {mesh.shape['data']} "
                             "data ranks")
        specs = param_shardings(params, mesh)
        params = shard_params(params, mesh)
    writer = mesh is None or mesh.rank == 0
    if sft_cfg.total_steps is None:
        # reference num_training_steps = epochs * len(dataloader) (SFT.py:201-206)
        steps_per_epoch = len(dataset) // loop_cfg.batch_size
        sft_cfg = dataclasses.replace(
            sft_cfg, total_steps=max(loop_cfg.num_train_epochs * steps_per_epoch, 1)
        )
    ckpt = CheckpointManager(loop_cfg.output_dir)
    start_step, opt_state = 0, None
    if loop_cfg.resume_from_checkpoint:
        latest = ckpt.latest()
        if latest is not None:
            params, opt_state, meta = ckpt.restore(latest, params, mesh=mesh, specs=specs)
            start_step = meta["step"]
    make_trainable(params)
    optimizer = SFTOptimizer(params, sft_cfg, mesh=mesh, specs=specs)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)

    os.makedirs(loop_cfg.output_dir, exist_ok=True)
    from ..utils.metrics_sinks import MetricsLogger

    logger = MetricsLogger(loop_cfg.output_dir, report_to=tuple(loop_cfg.report_to)) if writer else None
    shardings = batch_shardings(mesh, True, patch_shardable=False) if mesh is not None else None
    history = []
    rng = np.random.default_rng(loop_cfg.seed)
    global_step = 0
    t_start = time.time()
    try:
        for epoch in range(loop_cfg.num_train_epochs):
            order = rng.permutation(len(dataset))
            for batch_samples in batched([dataset[i] for i in order], loop_cfg.batch_size, drop_last=True):
                global_step += 1
                if global_step <= start_step:
                    continue  # deterministic dataloader fast-forward (SFT.py:312-324)
                collated = collate_sft(batch_samples, processor, image_loader=image_loader)
                step_grads = None if on_grads is None else functools.partial(on_grads, global_step)
                logged = global_step % loop_cfg.log_steps == 0 or max_steps
                if logged:
                    _synchronize(device)
                t0 = time.perf_counter()
                if mesh is None:
                    metrics = train_step(params, optimizer, batch_to_device(collated, device), cfg=cfg,
                                         on_grads=step_grads)
                else:
                    local = shard_batch(collated, mesh, shardings, cfg.tokens.image_pad)
                    metrics = sharded_train_step(params, optimizer, batch_to_device(local, device), cfg=cfg,
                                                 mesh=mesh, specs=specs, on_grads=step_grads)
                if logged:
                    _synchronize(device)
                    step_s, elapsed = time.perf_counter() - t0, time.time() - t_start
                    if mesh is not None:
                        step_s, elapsed = max_over([step_s, elapsed], mesh.world_group(), device)
                    rec = {
                        "step": global_step,
                        "epoch": epoch,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "tokens": int(metrics["tokens"]),
                        "step_s": step_s,
                        "input_tokens": collated["input_ids"].size,
                        "patches": collated["pixel_values"].shape[0],
                        "elapsed_s": round(elapsed, 1),
                    }
                    history.append(rec)
                    if writer:
                        logger.log({k: v for k, v in rec.items() if k != "step"}, global_step)
                if global_step % loop_cfg.save_steps == 0:
                    full = params if mesh is None else gather_params(params, specs, mesh, root=0, device="cpu")
                    opt_state = optimizer.state_dict(root=0)
                    if writer:
                        ckpt.save(global_step, full, opt_state, extra={"epoch": epoch, "loss": float(metrics["loss"])})
                    if callbacks and writer:
                        from .callbacks import run_callbacks

                        run_callbacks(callbacks, global_step,
                                      os.path.join(loop_cfg.output_dir, f"checkpoint-{global_step}"), full)
                    del full, opt_state
                if max_steps and global_step - start_step >= max_steps:
                    return params, history
        return params, history
    finally:
        if logger is not None:
            logger.close()
