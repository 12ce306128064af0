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

On a (data, fsdp, tensor) mesh (parallel/), `make_sharded_train_step` is the JAX
package's sharded step with the math of one device: the batch splits on `data` only
(`batch_shardings`), each leaf the rules split on `fsdp` is a shard that the forward
gathers (parallel/collectives.py), a leaf split on `tensor` stays this rank's heads or
columns and the forward runs Megatron's column/row splits over it (TensorParallel),
the loss is a rank's sum over the WHOLE batch's supervised-token count (one
all-reduce of the count), the gradients sum over `data`, the clip's global norm is
over the full gradients (each piece's squares summed over the axes that split it, a
replicated leaf counted once), and AdamW steps pieces: optimizer state inherits each
parameter's sharding and layout, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import VLMConfig
from ..models.params import tree_leaves
from ..models.vit import meta_to_device
from ..models.vlm import compute_vision_embeds, masked_ce_loss, vlm_forward
from ..parallel.collectives import all_reduce, gather_for_compute, reduce_gradients, tensor_parallel
from ..parallel.mesh import Mesh, check_tensor_heads, is_sharded, local_slice, param_shardings, spec_leaves, split_axes
from ..parallel.multihost import gather_params, global_put


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


def mesh_global_norm(grads, specs: Sequence, mesh: Optional[Mesh]) -> torch.Tensor:
    """global_norm of the full gradients from piece gradients (one spec per leaf):
    the pieces' squares summed over each axis that splits them (fsdp, tensor or both),
    a leaf every rank holds whole counted once, so each element of the full gradient
    counts once. Where no leaf is split it is global_norm itself, bit for bit."""
    if mesh is None or not any(is_sharded(s, mesh) for s in specs):
        return global_norm(grads)
    by_axes = {}
    for g, s in zip(grads, specs):
        by_axes.setdefault(split_axes(s, mesh), []).append(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2)
    whole_sq = by_axes.pop((), [])
    total = None
    for axes, sq in by_axes.items():
        part = torch.stack(sq).sum()
        for a in axes:
            part = all_reduce(part, mesh.group(a))
        total = part if total is None else total + part
    if whole_sq:
        total = total + torch.stack(whole_sq).sum()
    return torch.sqrt(total)


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
    them.

    On a mesh (`mesh`, with `specs` the tree's spec tree from param_shardings) the
    leaves are this rank's shards: the step takes shard gradients, already summed
    over the data axis, and clips by the norm of the full gradients
    (mesh_global_norm); `state_dict()` gathers the moments and a partial
    accumulation into full tensors (a collective: every rank calls it) and
    `load_state_dict()` takes such a full state and keeps this rank's slices, so a
    checkpoint holds today's format whatever the mesh."""

    def __init__(self, params, cfg: SFTConfig, *, schedule: Optional[Callable[[int], float]] = None,
                 frozen: Sequence[torch.Tensor] = (), mesh: Optional[Mesh] = None, specs=None):
        self.params: List[torch.Tensor] = tree_leaves(params)
        self.mesh = mesh
        self.specs = spec_leaves(params, specs) if mesh is not None else [()] * len(self.params)
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
        norm = self.norm(grads)
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

    def norm(self, grads) -> torch.Tensor:
        """The global norm of the full gradients (0-d fp32 tensor)."""
        return mesh_global_norm(grads, self.specs, self.mesh)

    def _moving_specs(self) -> list:
        return [s for s, m in zip(self.specs, self.moving) if m]

    def state_dict(self, root: Optional[int] = None) -> Optional[dict]:
        """The state a resume needs. On a mesh that splits a leaf: full tensors,
        gathered onto the host (root=r: only rank r keeps them and the other ranks
        get None)."""
        state = {"adamw": self.adamw.state_dict(), "updates": self.updates, "mini_step": self.mini_step,
                 "acc": self.acc}
        if self.mesh is None or not any(is_sharded(s, self.mesh) for s in self.specs):
            return state
        keep = root is None or self.mesh.rank == root
        specs = self._moving_specs()
        adamw = dict(state["adamw"], state={})
        for j, st in sorted(state["adamw"]["state"].items()):
            keys = [k for k in ("exp_avg", "exp_avg_sq") if k in st]
            full = gather_params([st[k] for k in keys], [specs[j]] * len(keys), self.mesh, root=root, device="cpu")
            adamw["state"][j] = dict(st, **dict(zip(keys, full))) if keep else None
        acc = None if self.acc is None else gather_params(self.acc, self.specs, self.mesh, root=root, device="cpu")
        return dict(state, adamw=adamw, acc=acc) if keep else None

    def load_state_dict(self, state: dict) -> None:
        """Take a state_dict (full tensors where the mesh splits a leaf: this rank's
        slices are kept)."""
        adamw = state["adamw"]
        if self.mesh is not None:
            specs = self._moving_specs()
            adamw = dict(adamw, state={j: {k: (local_slice(v, specs[int(j)], self.mesh)
                                               if k in ("exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
                                       for j, st in adamw["state"].items()})
        self.adamw.load_state_dict(adamw)
        self.updates, self.mini_step = int(state["updates"]), int(state["mini_step"])
        acc = state.get("acc")
        if acc is not None and self.mesh is not None:
            acc = [local_slice(a, s, self.mesh) for a, s in zip(acc, self.specs)]
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


# ---------------------------------------------------------------------------
# The sharded step (port of train/sft.py's batch_shardings / make_sharded_train_step)
# ---------------------------------------------------------------------------

def batch_shardings(mesh: Mesh, has_vision: bool, patch_shardable: bool = True) -> dict:
    """Specs for one training batch, the JAX package's: batch dim on 'data'; packed
    patches on 'data' too when patch_shardable. The sharded step takes whole patches
    (patch_shardable=False: every rank collates the whole batch, and the ViT packs
    every image of it in one sequence); True is the JAX layout, which XLA gathers."""
    s = {
        "input_ids": ("data", None),
        "labels": ("data", None),
        "position_ids": (None, "data", None),
    }
    if has_vision:
        s["pixel_values"] = ("data" if patch_shardable else None, None)
        s["vision_meta"] = {k: () for k in ("perm", "inv_perm_merged", "seg_window", "seg_full", "pos_ids")}
    return s


def shard_batch(batch: dict, mesh: Mesh, specs: dict, image_pad: int) -> dict:
    """This rank's part of a global collated batch (numpy; every rank collates the
    same one): global_put under `specs`, plus `image_offset`, the image tokens of the
    rows before this rank's, where its vision embeddings start in the batch's."""
    specs = {k: v for k, v in specs.items() if k in batch}
    if specs.get("pixel_values", (None,))[0] is not None:
        raise ValueError("the sharded step takes whole patches: batch_shardings(mesh, has_vision, "
                         "patch_shardable=False)")
    out = global_put({k: batch[k] for k in specs}, specs, mesh)
    out.update({k: v for k, v in batch.items() if k not in specs})
    if batch.get("pixel_values") is not None:
        ids = np.asarray(batch["input_ids"])
        rows = ids.shape[0] // mesh.shape["data"]
        out["image_offset"] = int((ids[: mesh.coordinate["data"] * rows] == image_pad).sum())
    return out


def sharded_sft_loss(params, cfg: VLMConfig, batch: dict, mesh: Mesh, tp=None):
    """This rank's part of the whole batch's masked CE: the sum over its rows divided
    by the supervised tokens of every row (so the data ranks' losses sum to the
    batch's mean). `params` is the tree gather_for_compute gives, `tp` its
    TensorParallel view on a tensor mesh (tensor_parallel). The ViT runs over the
    whole batch's packed images and this rank's rows read their embeddings from
    `image_offset` on. Returns (loss, whole batch's token count)."""
    vis = None
    if batch.get("pixel_values") is not None:
        vis = compute_vision_embeds(params, cfg, batch["pixel_values"], batch["vision_meta"], tp=tp)
        if mesh.shape["data"] > 1:
            offset = int(batch["image_offset"])
            vis = vis[offset:] if offset < vis.shape[0] else None
    logits, _ = vlm_forward(params, cfg, batch["input_ids"], batch["position_ids"], vision_embeds=vis,
                            attn_valid=batch.get("attn_valid"), tp=tp)
    labels = batch["labels"]
    count = all_reduce((labels[:, 1:] != -100).sum(), mesh.group("data"))
    loss, _ = masked_ce_loss(logits, labels, count=count)
    return loss, count


def sharded_train_step(shards, optimizer: SFTOptimizer, batch, *, cfg: VLMConfig, mesh: Mesh, specs,
                       on_grads: Optional[Callable[[tuple], None]] = None) -> dict:
    """One micro-step on the mesh: train_step's contract over this rank's shards and
    its part of the batch (shard_batch, then batch_to_device). The returned loss,
    grad_norm and tokens are the whole batch's, the same on every rank."""
    full = gather_for_compute(shards, specs, mesh)
    loss, n_tok = sharded_sft_loss(full, cfg, batch, mesh, tensor_parallel(mesh, specs))
    grads = torch.autograd.grad(loss, optimizer.params, materialize_grads=True)
    del full
    grads = reduce_gradients(grads, optimizer.specs, mesh)
    gnorm = optimizer.norm(grads)
    if on_grads is not None:
        on_grads(grads)
    optimizer.step(grads)
    return {"loss": all_reduce(loss.detach(), mesh.group("data")), "grad_norm": gnorm, "tokens": n_tok}


def make_sharded_train_step(mesh: Mesh, cfg: VLMConfig, sft_cfg: SFTConfig, params_tree):
    """Build (step, param_specs, init_opt) for the mesh, the JAX package's
    make_sharded_train_step without its optax transform (the port's optimizer holds
    its state): param_specs is param_shardings of the tree; init_opt(shards) makes
    the shard leaves trainable and returns their SFTOptimizer, whose state inherits
    each parameter's sharding; step(shards, optimizer, batch) takes this rank's
    part of a batch put with batch_shardings(mesh, has_vision, patch_shardable=False)
    (shard_batch) and returns the whole batch's metrics. A tensor axis that does not
    divide the head counts is refused here (check_tensor_heads)."""
    check_tensor_heads(cfg, mesh.shape["tensor"])
    p_shard = param_shardings(params_tree, mesh)

    def init_opt(shards):
        from .sft_loop import make_trainable

        make_trainable(shards)
        return SFTOptimizer(shards, sft_cfg, mesh=mesh, specs=p_shard)

    return partial(sharded_train_step, cfg=cfg, mesh=mesh, specs=p_shard), p_shard, init_opt


