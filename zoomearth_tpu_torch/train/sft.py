"""SFT: masked-label supervised fine-tuning on one device (port of train/sft.py).

The reference's semantics (its custom accelerate loop, SFT.py:259-390, as the JAX
package rebuilt it with optax): AdamW with a linear warmup from 0 and a linear decay
to 0, gradient clipping by the global norm, gradient accumulation, parameters and
optimizer states in the parameters' dtype, and the text_pair label masking. Here in
PyTorch idiom: autograd through the model (K1 and K2 are autograd.Functions with
backward kernels on the card), `torch.optim.AdamW` for the update and an explicit
count of updates for the schedule. `SFTOptimizer` reproduces the JAX package's
optax chain step for step:

- `optax.MultiSteps(k)`: k micro-steps whose gradients are averaged with the same
  running mean (acc + (g - acc) / (n + 1)), then one update; the schedule counts
  updates, not micro-steps;
- `clip_by_global_norm(max_grad_norm)`: unchanged below the norm, else g / norm *
  max_grad_norm, on the averaged gradients;
- `adamw(schedule, b1, b2, eps=1e-8, weight_decay)`: weight decay on every leaf, the
  learning rate of update n being schedule(n), so the first update moves nothing
  (schedule(0) = 0) but the moments.

There is no mesh here: the reference's sharded step is ROADMAP item 16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import VLMConfig
from ..models.params import tree_leaves
from ..models.vit import meta_to_device
from ..models.vlm import masked_ce_loss, vlm_forward


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    """Knob names follow the reference's TrainingConfig (SFT.py:21-74)."""

    learning_rate: float = 3e-5
    warmup_steps: int = 100
    # schedule horizon (reference num_training_steps = epochs * len(dataloader),
    # SFT.py:201-206); None -> derived from the dataset by train_sft, or 10k standalone
    total_steps: Optional[int] = None
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1


def make_schedule(cfg: SFTConfig) -> Callable[[int], float]:
    """Warmup then linear decay to zero at total_steps (the reference's
    get_linear_schedule_with_warmup, SFT.py:16,201-206): lr ramps 0 -> learning_rate
    over warmup_steps, then decays linearly to 0 at total_steps and stays there.
    Computed in float32 in optax's order (join_schedules of two linear_schedules), so
    each value equals the JAX package's bit for bit."""
    warmup = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps or 10_000, warmup + 1)
    f32, lr = np.float32, cfg.learning_rate

    def linear(init: float, end: float, steps: int, count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(f32(init - end) * frac) + f32(end))

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(0.0, lr, warmup, count)
        return linear(lr, 0.0, total - warmup, count - warmup)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, accumulated in fp32 (a 0-d fp32
    tensor on the tensors' device; nothing waits for it)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


class SFTOptimizer:
    """The reference's optimizer over the leaves of a parameter tree: gradient
    averaging over `gradient_accumulation_steps` micro-steps, clipping by the global
    norm, then `torch.optim.AdamW` at the schedule's rate for this update (see the
    module docstring). The leaves are updated in place; their moments live in their
    dtype, as optax keeps them. `state_dict()` / `load_state_dict()` carry everything
    a resume needs: AdamW's state, the update count, the micro-step and the running
    mean of a partial accumulation.

    `schedule` replaces the warmup-and-decay schedule (GRPO's rate is constant);
    `frozen` names leaves that AdamW never steps (GRPO's frozen vision tower, LoRA's
    base weights): their gradients still count in the global norm, as the JAX
    package's masked updates do, but neither the update nor the weight decay moves
    them."""

    def __init__(self, params, cfg: SFTConfig, *, schedule: Optional[Callable[[int], float]] = None,
                 frozen: Sequence[torch.Tensor] = ()):
        self.params: List[torch.Tensor] = tree_leaves(params)
        self.cfg = cfg
        self.schedule = schedule or make_schedule(cfg)
        self.k = max(1, cfg.gradient_accumulation_steps)
        frozen_ids = {id(t) for t in frozen}
        self.moving = [id(p) not in frozen_ids for p in self.params]
        self.adamw = torch.optim.AdamW([p for p, m in zip(self.params, self.moving) if m], lr=0.0,
                                       betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8, weight_decay=cfg.weight_decay)
        self.updates = 0  # updates applied: the schedule's count
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Take one micro-step's gradients (one per leaf, in the leaves' order).
        Returns whether the parameters were updated (every k-th micro-step)."""
        grads = list(grads)
        if self.k > 1:
            if self.mini_step == 0:
                self.acc = grads  # acc + (g - acc) / 1 with acc = 0 is g itself
            else:
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        norm = global_norm(grads)
        clip = self.cfg.max_grad_norm
        for p, g, moving in zip(self.params, grads, self.moving):
            if moving:
                p.grad = torch.where(norm < clip, g, g / norm.to(g.dtype) * clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "updates": self.updates, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.updates, self.mini_step = int(state["updates"]), int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [a.to(device=p.device, dtype=p.dtype) for a, p in zip(acc, self.params)]


def make_optimizer(params, cfg: SFTConfig) -> SFTOptimizer:
    return SFTOptimizer(params, cfg)


def batch_to_device(batch: dict, device) -> dict:
    """A collated batch (numpy, collate_sft) -> tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items() if k != "vision_meta"}
    if batch.get("vision_meta") is not None:
        out["vision_meta"] = meta_to_device(batch["vision_meta"], device)
    return out


def sft_loss(params, cfg: VLMConfig, batch):
    """batch: tensors input_ids (B, S), labels (B, S), position_ids (3, B, S), and
    optionally pixel_values (P, D) with vision_meta (meta_to_device) and attn_valid.
    Returns (mean loss, number of supervised tokens)."""
    logits, _ = vlm_forward(
        params, cfg, batch["input_ids"], batch["position_ids"],
        pixel_values=batch.get("pixel_values"), vision_meta=batch.get("vision_meta"),
        attn_valid=batch.get("attn_valid"),
    )
    return masked_ce_loss(logits, batch["labels"])


def train_step(params, optimizer: SFTOptimizer, batch, *, cfg: VLMConfig,
               on_grads: Optional[Callable[[tuple], None]] = None) -> dict:
    """One micro-step: loss, gradients of every leaf, then the optimizer's step
    (an update every gradient_accumulation_steps micro-steps). The parameters are
    updated in place. `on_grads(grads)`, where given, sees this micro-step's
    gradients (one per leaf, in the optimizer's order) before the optimizer takes
    them. Returns {"loss", "grad_norm" (this micro-step's gradients, before
    clipping), "tokens"} as 0-d tensors on the device; nothing here waits for the
    device."""
    loss, n_tok = sft_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, optimizer.params, materialize_grads=True)
    gnorm = global_norm(grads)
    if on_grads is not None:
        on_grads(grads)
    optimizer.step(grads)
    return {"loss": loss.detach(), "grad_norm": gnorm, "tokens": n_tok}
