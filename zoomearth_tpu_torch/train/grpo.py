"""GRPO: two-stage rollout RL with Region-Guided rewards, grouped advantages,
clip + KL (port of train/grpo.py; the reference's VLMGRPOTrainer,
trainer/grpo_trainer.py:126-919).

The JAX package's training semantics, on one device in PyTorch idiom:

- rollouts run through the port's Generator (or a ServingEngine actor) under
  torch.inference_mode(), on the LIVE parameter tensors: the update is in place, so
  `generator.params = self.params` is the whole weight handoff;
- stage-2 rollouts are batched into one call and, with reuse_cache, continue from the
  stage-1 KV cache (prefilling only the crop's vision tokens, K2's chunk prefill);
- the G rollouts of a prompt stay contiguous, so grouped advantages are a reshape;
  they are mean-centered only (scale_rewards divides by the group std);
- the training sequence per sample is prompt1 + completion1 (or, when stage 2 ran,
  prompt1 + kept stage-1 tokens + crop chunk + completion2); the optimized region
  runs from the stage-1 prompt length to the first stop token, image tokens included;
- the loss is PPO's clipped ratio with epsilon_low/high plus beta * KL(exp(r) - r - 1)
  against a reference policy, a per-sequence mean over completion tokens;
- the policy step is autograd through models.vlm (win_mode 0: the ViT's 32 blocks on
  K1, the decoder on K2's no-cache path, both with their backward kernels on the
  card); every leaf gets a gradient and the global norm covers all of them;
- the optimizer is the JAX package's optax.chain(clip_by_global_norm, adamw(lr)):
  SFTOptimizer's clip and AdamW at a constant rate with optax's default weight decay
  1e-4. Frozen leaves (the vision tower under freeze_vision_modules, each LoRA base
  weight and scale) are never stepped, but their gradients count in the norm.

Nothing made under inference_mode reaches the autograd forward: the training batch
is rebuilt from the rollout's numpy arrays, as the JAX package rebuilds it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..agent import prompts as PT
from ..agent.processor import Processor
from ..cli.common import resolve_device
from ..config import VLMConfig
from ..image.geometry import cut_image, resize_image
from ..models.decoder import decoder_forward, logits_from_hidden
from ..models.params import map_tree, tree_leaves
from ..models.rope import mrope_position_ids_batch
from ..models.vit import meta_to_device, vision_metadata
from ..models.vlm import compute_vision_embeds, embed_tokens, merge_vision_embeddings
from ..rewards.zoomearth import extract_bboxes_float
from ..runtime.generate import (
    DEFAULT_LENGTH_BUCKETS,
    DEFAULT_PATCH_BUCKETS,
    GenerationConfig,
    Generator,
    bucket,
    prepare_batch,
    prepare_continuation,
)
from ..parallel.collectives import (all_reduce, gather_for_compute, gather_objects, reduce_gradients, sum_over,
                                    tensor_parallel)
from ..parallel.mesh import Mesh, check_tensor_heads, param_shardings, shard_params
from ..parallel.multihost import gather_params
from .data import LRSGROSample
from .lora import apply_lora, frozen_leaves, strip_lora
from .sft import SFTConfig, SFTOptimizer
from .sft_loop import make_trainable

OPTAX_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX package's GRPO applies
ROW_SEED_STRIDE = 1_000_003  # data rank d samples its rows from seed + d * this


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    """Knobs follow the reference GRPOConfig (trainer/grpo_config.py:22-350) and the
    shipped run config (run_scripts/train_grpo.sh:33-60)."""

    num_generations: int = 4  # G (train_grpo.sh: 4)
    max_completion_length: int = 256  # stage-1 rollout budget
    stage2_max_completion_length: int = 256  # customized_funcs chat: 800
    rollout_temperature: float = 0.7  # customized_funcs.py:12
    learning_rate: float = 1e-7
    beta: float = 0.04  # KL coefficient
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    num_iterations: int = 1  # mu: reuse rollouts for this many optimizer steps
    max_grad_norm: float = 1.0
    stage1_image_size: int = 512  # customized resize (infer/RL variant)
    mask_image_tokens: bool = False  # True diverges from the reference
    reward_weights: Optional[Sequence[float]] = None
    # Advantage normalization: the default VLMGRPOTrainer mean-centers only
    # (grpo_trainer.py:733-734); the vLLM trainer also divides by the group std
    # (vllm_grpo_trainer.py:~705-712). True selects the vLLM variant.
    scale_rewards: bool = False
    # Freeze the vision tower: neither its gradient nor weight decay moves it
    # (reference grpo_trainer.py:277 freeze_vision_modules).
    freeze_vision_modules: bool = False
    # TR-DPO reference sync (reference sync_ref_model / ref_model_mixup_alpha /
    # ref_model_sync_steps): every sync steps, ref <- alpha * policy + (1 - alpha) * ref.
    sync_ref_model: bool = False
    ref_model_mixup_alpha: float = 0.6
    ref_model_sync_steps: int = 512
    # LoRA (the reference PEFT path, grpo_trainer.py:293-305): adapters on the decoder
    # matmuls train, base weights freeze, and the KL reference is the adapter-DISABLED
    # policy (a tree sharing the base tensors, no second copy on the device).
    use_lora: bool = False
    lora_r: int = 8
    lora_alpha: float = 16.0
    # Log rollout samples (reference log_completions: a wandb table of prompt /
    # completion / reward rows): appends jsonl records to completions_path (or
    # "grpo_completions.jsonl") each step.
    log_completions: bool = False
    completions_path: Optional[str] = None
    # Stage-2 rollouts continue from the stage-1 KV cache and the training sequence
    # keeps the GENERATED stage-1 tokens verbatim. False = the reference's behaviour
    # (re-tokenized stitched text, full re-prefill, grpo_trainer.py:607-611).
    reuse_cache: bool = True


@dataclasses.dataclass
class RolloutBatch:
    """Host arrays + metadata for one GRPO optimizer step (numpy only: the policy
    step makes its own tensors from them)."""

    input_ids: np.ndarray  # (N, S) stitched training sequences, right-padded
    completion_mask: np.ndarray  # (N, S) 1 where the loss applies
    position_ids: np.ndarray  # (3, N, S)
    pixel_values: Optional[np.ndarray]
    vision_meta: Optional[dict]
    advantages: np.ndarray  # (N,)
    old_logps: Optional[np.ndarray]  # (N, S); None when num_iterations == 1
    ref_logps: Optional[np.ndarray]  # (N, S); None when beta == 0
    completions1: List[str]
    completions2: List[str]
    rewards_per_func: np.ndarray  # (N, F) for metrics


def _first_stop_mask(ids: np.ndarray, start: np.ndarray, stops: Sequence[int]) -> np.ndarray:
    """mask[i, t] = 1 for start[i] <= t <= the first stop token at/after start
    (inclusive); to the end of the row when there is none."""
    N, S = ids.shape
    t = np.arange(S)[None, :]
    after_start = t >= start[:, None].astype(np.int64)
    is_stop = np.isin(ids, np.asarray(list(stops))) & after_start
    first_stop = np.where(is_stop.any(1), is_stop.argmax(1), S)
    return (after_start & (t <= first_stop[:, None])).astype(np.int32)


def _chunk_logps(text_params, cfg: VLMConfig, hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log_softmax(head(hidden))[target] for one chunk of positions: (B, c)."""
    logits = logits_from_hidden(text_params, cfg.text, hidden)  # (B, c, V) fp32
    return torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]


def per_token_logps(params, cfg: VLMConfig, input_ids, position_ids, pixel_values, vision_meta, *,
                    chunk: int = 256, image_offset: int = 0, tp=None) -> torch.Tensor:
    """log p(token_t | tokens_<t) for every position, (B, S) fp32; the first position
    gets 0. vision_meta holds device tensors (meta_to_device). image_offset: where
    these rows' vision embeddings start among those of every packed image (a data
    rank's rows of a batch whose images all go through the ViT). tp: the
    TensorParallel view of `params` on a tensor mesh.

    The hidden states are computed once; the head, log_softmax and gather run over
    chunks of `chunk` positions, so the (B, S, V) fp32 logits never exist at once.
    Under autograd each chunk is checkpointed: the backward recomputes its logits from
    the saved hidden states instead of keeping every chunk's log-probabilities."""
    x = embed_tokens(params, input_ids)
    if pixel_values is not None:
        vis = compute_vision_embeds(params, cfg, pixel_values, vision_meta, tp=tp)
        if image_offset:
            vis = vis[image_offset:]
        if vis.shape[0]:
            x = merge_vision_embeddings(x, vis, input_ids == cfg.tokens.image_pad)
    hidden, _ = decoder_forward(params["text"], cfg.text, x, position_ids, tp=None if tp is None else tp.at("text"))
    B, S, _ = hidden.shape
    # the token at t + 1 is predicted from the hidden state at t
    targets = torch.cat([input_ids[:, 1:], input_ids.new_zeros((B, 1))], dim=1).long()
    grad = torch.is_grad_enabled() and hidden.requires_grad
    pieces = []
    for s0 in range(0, S, chunk):
        h, tgt = hidden[:, s0:s0 + chunk], targets[:, s0:s0 + chunk]
        if grad:
            pieces.append(checkpoint(_chunk_logps, params["text"], cfg, h, tgt, use_reentrant=False))
        else:
            pieces.append(_chunk_logps(params["text"], cfg, h, tgt))
    lp = torch.cat(pieces, dim=1)
    return torch.cat([lp.new_zeros((B, 1)), lp[:, :-1]], dim=1)


def grpo_loss(params, cfg: VLMConfig, batch: Dict, *, beta: float, epsilon_low: float, epsilon_high: float,
              chunk: int = 256, rows: Optional[int] = None, tp=None):
    """Clipped-ratio GRPO loss (grpo_trainer.py:770-828). batch holds tensors
    (`batch_to_device`); old_logps / ref_logps may be None. Returns (loss, metrics)
    as 0-d tensors.

    rows: the whole batch's row count where `batch` is one data rank's rows. The
    loss, kl and completion_length are then this rank's share of the whole batch's
    means (their sums over the ranks are the means), and clip_ratio is split into
    its numerator (`clip_ratio`) and denominator (`clip_den`), each to be summed."""
    logps = per_token_logps(params, cfg, batch["input_ids"], batch["position_ids"], batch.get("pixel_values"),
                            batch.get("vision_meta"), chunk=chunk, image_offset=batch.get("image_offset", 0), tp=tp)
    mask = batch["completion_mask"].float()
    adv = batch["advantages"][:, None]
    old = batch["old_logps"] if batch.get("old_logps") is not None else logps.detach()
    coef1 = torch.exp(logps - old)
    coef2 = torch.clamp(coef1, 1 - epsilon_low, 1 + epsilon_high)
    loss1 = coef1 * adv
    loss2 = coef2 * adv
    per_token = -torch.minimum(loss1, loss2)
    metrics = {}
    denom = mask.sum(1).clamp(min=1)

    def mean(per_row):
        return per_row.mean() if rows is None else per_row.sum() / rows

    if beta > 0 and batch.get("ref_logps") is not None:
        ref = batch["ref_logps"]
        kl = torch.exp(ref - logps) - (ref - logps) - 1
        per_token = per_token + beta * kl
        metrics["kl"] = mean((kl * mask).sum(1) / denom).detach()
    loss = mean((per_token * mask).sum(1) / denom)
    clipped = (loss1 < loss2).float()
    if rows is None:
        metrics["clip_ratio"] = ((clipped * mask).sum() / mask.sum().clamp(min=1)).detach()
    else:
        metrics["clip_ratio"], metrics["clip_den"] = (clipped * mask).sum().detach(), mask.sum()
    metrics["completion_length"] = mean(mask.sum(1))
    return loss, metrics


def batch_to_device(rb: RolloutBatch, device) -> Dict:
    """A RolloutBatch's arrays as NEW tensors on `device` (never the rollout's own
    tensors, which were made under inference_mode)."""
    def t(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "input_ids": t(rb.input_ids, torch.int64),
        "completion_mask": t(rb.completion_mask, torch.int32),
        "position_ids": t(rb.position_ids, torch.int32),
        "pixel_values": t(rb.pixel_values, None),
        "vision_meta": meta_to_device(rb.vision_meta, device) if rb.vision_meta else None,
        "advantages": t(rb.advantages, torch.float32),
        "old_logps": t(rb.old_logps, torch.float32),
        "ref_logps": t(rb.ref_logps, torch.float32),
    }


class GRPOTrainer:
    """GRPO engine: rollouts, rewards, advantages, the policy step; on one device, or
    on a (data, fsdp, tensor) mesh of processes (`mesh`)."""

    def __init__(
        self,
        params,
        cfg: VLMConfig,
        grpo_cfg: GRPOConfig,
        processor: Processor,
        reward_funcs: Sequence[Callable],
        *,
        reward_names: Optional[Sequence[str]] = None,
        max_cache_len: int = 2048,
        image_loader=None,
        length_buckets=DEFAULT_LENGTH_BUCKETS,
        patch_buckets=DEFAULT_PATCH_BUCKETS,
        cache_dtype=None,
        rollout_engine=None,
        prompt_fn: Optional[Callable[[str], str]] = None,
        device=None,
        time_stages: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        """params: a tree on `device` (None: cuda; raises without a CUDA device), made
        outside torch.inference_mode(); its floating leaves become trainable leaves
        and are updated in place.

        mesh: a (data, fsdp, tensor) mesh of the world's ranks; every rank builds the trainer
        from the same full tree and steps on the same samples. The tree (with its LoRA
        adapters, drawn alike on every rank) is sharded by param_shardings, and
        `params` holds this rank's shards (`specs` their spec tree). A step's N rows
        split as the data axis splits a batch, contiguous blocks of N / data (a
        group of G rows may straddle two ranks): each data rank rolls out its own
        rows on the gathered full weights (gather_params: the Generator's or the
        engine's weight push, handed the shards back once the rollout ends, so the
        policy's forward and backward hold one gathered tree; an engine that was
        running before the rollout keeps the full tree it serves on), sampling from
        seed + d * ROW_SEED_STRIDE, and the
        rollouts of every rank are gathered so that every rank stitches the same
        whole batch. Rewards are computed for the rank's rows and gathered, so the
        grouped advantages and the logged rewards are the whole batch's; the loss
        divides by the whole batch's row count and its metrics are summed over the
        mesh, as the JAX package's grpo_loss means them over the global batch. Over
        a tensor axis the old and reference logps and the loss and its backward run
        on each rank's heads and columns (TensorParallel), the rollout on the tree
        gathered over fsdp and tensor (no collective is captured in a CUDA graph).

        rollout_engine: optional serve.engine.ServingEngine used as the rollout actor
        instead of the in-process Generator (the reference's decoupled vLLM trainer,
        vllm_grpo_trainer.py:409-420): stage 1 is a hold_slot request, stage 2 a
        Continuation on the held KV, and the weight push is `engine.params =
        self.params`, a pointer handoff.

        time_stages: synchronize the device between the stages of each step and keep
        their seconds in `stage_seconds` (stage1_rollout, stage2_rollout,
        rewards_stitch, ref_logps, loss_backward, update; an engine rollout's two
        stages interleave and are kept together as engine_rollout)."""
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if any(t.device != device for t in tree_leaves(params)):
            raise ValueError(f"GRPOTrainer: the parameters must be on {device}")
        if mesh is not None:
            check_tensor_heads(cfg, mesh.shape["tensor"])
        self.device = device
        self.mesh = mesh
        if grpo_cfg.use_lora:
            if grpo_cfg.sync_ref_model:
                # Under LoRA the KL reference IS the frozen base (strip_lora of the live
                # params, re-taken every step): a TR-DPO mixup would blend the base with
                # itself, and the two trees do not share their structure.
                raise ValueError(
                    "sync_ref_model (TR-DPO) is incompatible with use_lora: the LoRA "
                    "reference policy is the frozen base model by construction"
                )
            params = apply_lora(params, torch.Generator(device=device).manual_seed(0),
                                r=grpo_cfg.lora_r, alpha=grpo_cfg.lora_alpha)
        self.specs = None
        if mesh is not None:
            self.specs = param_shardings(params, mesh)
            params = shard_params(params, mesh)
        make_trainable(params)
        self.params = params
        self.cfg = cfg
        self.grpo = grpo_cfg
        self.processor = processor
        self.reward_funcs = list(reward_funcs)
        self.reward_names = list(reward_names or [f.__name__ for f in reward_funcs])
        self.generator = Generator(params, cfg, max_cache_len=max_cache_len, cache_dtype=cache_dtype or cfg.dtype)
        self.rollout_engine = rollout_engine
        # stage-1 prompt builder for image samples (default: the LRS_GRO template,
        # agent/prompts.py rl_prompt); injectable so harnesses with small token
        # budgets can use a short template
        self.prompt_fn = prompt_fn or PT.rl_prompt
        self.image_loader = image_loader
        self.length_buckets = length_buckets
        self.patch_buckets = patch_buckets
        # Reference policy for the KL term. LoRA: the adapter-disabled policy, a tree
        # sharing the base tensors (PEFT semantics, grpo_trainer.py:299-303; the base
        # is never stepped). Full fine-tune: a detached copy (create_reference_model
        # semantics, grpo_trainer.py:305).
        if grpo_cfg.beta <= 0:
            self.ref_params = None
        elif grpo_cfg.use_lora:
            self.ref_params = strip_lora(params)
        else:
            self.ref_params = map_tree(lambda t: t.detach().clone(), params)
        self.ref_specs = None if mesh is None else (strip_lora(self.specs) if grpo_cfg.use_lora else self.specs)
        frozen = list(frozen_leaves(params)) if grpo_cfg.use_lora else []
        if grpo_cfg.freeze_vision_modules:
            frozen += tree_leaves(params["vision"])
        lr = grpo_cfg.learning_rate
        self.optimizer = SFTOptimizer(
            params,
            SFTConfig(learning_rate=lr, weight_decay=OPTAX_ADAMW_WEIGHT_DECAY, max_grad_norm=grpo_cfg.max_grad_norm),
            schedule=lambda count: lr, frozen=frozen, mesh=mesh, specs=self.specs,
        )
        # on_grads(grads): sees each step's gradients (one per leaf, in the
        # optimizer's order) before the optimizer takes them
        self.on_grads: Optional[Callable[[tuple], None]] = None
        self.time_stages = time_stages
        self.stage_seconds: Dict[str, float] = {}
        self._t_mark = 0.0
        self._buffered: Optional[RolloutBatch] = None
        self._step_count = 0
        self._rollout_nonce = 0
        self.metrics_history: List[Dict] = []

    # ------------------------------------------------------------------
    # stage clock
    # ------------------------------------------------------------------

    def _mark(self, stage: Optional[str] = None) -> None:
        """With time_stages: synchronize, add the seconds since the last mark to
        `stage` (None starts the clock)."""
        if not self.time_stages:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + now - self._t_mark
        self._t_mark = now

    # ------------------------------------------------------------------
    # The mesh
    # ------------------------------------------------------------------

    def full_params(self, params=None, specs=None):
        """The full tree of `params` (default: the policy): on a mesh, gathered from
        the shards (a collective: every rank calls it; a leaf no axis splits stays the
        same tensor); else the tree itself."""
        params, specs = (self.params, self.specs) if params is None else (params, specs)
        return params if self.mesh is None else gather_params(params, specs, self.mesh)

    def _rows(self, n: int):
        """(first, end) of this rank's rows among a step's n: contiguous blocks of
        n / data, as P("data") splits them."""
        if self.mesh is None:
            return 0, n
        d, D = self.mesh.coordinate["data"], self.mesh.shape["data"]
        if n % D:
            raise ValueError(f"GRPOTrainer: {n} rollout rows do not split over {D} data ranks")
        return d * n // D, (d + 1) * n // D

    def _gather_rows(self, local: np.ndarray) -> np.ndarray:
        """Every data rank's rows of an array, in row order."""
        if self.mesh is None:
            return local
        return np.concatenate(gather_objects(local, self.mesh.group("data")))

    def _gather_rollouts(self, out1, out2, lo):
        """Every row's completions from the ranks that rolled them out: the first rank
        of each data index's fsdp group, so every rank takes the same tokens."""
        everyone = gather_objects((out1, {lo + i: t for i, t in out2.items()}), self.mesh.world_group())
        step = self.mesh.shape["fsdp"] * self.mesh.shape["tensor"]
        picked = everyone[::step]
        return [t for o1, _ in picked for t in o1], {i: t for _, o2 in picked for i, t in o2.items()}

    # ------------------------------------------------------------------
    # Rollout
    # ------------------------------------------------------------------

    def rollout(self, samples: Sequence[LRSGROSample], seed: int = 0) -> RolloutBatch:
        """G-repeated two-stage rollouts + rewards + advantages for one step (on a
        mesh: this rank's rows rolled out, every row's stitched)."""
        G = self.grpo.num_generations
        tk = self.processor.tokenizer
        rep: List[LRSGROSample] = [s for s in samples for _ in range(G)]
        self._mark()

        if self.image_loader is None:
            from PIL import Image

            def image_loader(s):
                return Image.open(s.image_path).convert("RGB")
        else:
            image_loader = self.image_loader

        # imageless samples (the reference's text GRPO, grpo.py:118-142) take the
        # text-only prompt and skip every vision step
        full_images = [image_loader(s) if (s.image_path or s.image_name) else None for s in rep]
        # stage-1 inputs: customized resize (max 512, min side 30), customized_funcs.py:76-85
        stage1_images = [
            resize_image(im, self.grpo.stage1_image_size, min_side=30) if im is not None else None
            for im in full_images
        ]
        prompts_text = [
            self.prompt_fn(s.question) if im is not None else PT.text_rl_prompt(s.question)
            for s, im in zip(rep, stage1_images)
        ]
        enc1 = [self.processor.encode(t, [im] if im is not None else []) for t, im in zip(prompts_text, stage1_images)]
        prompt1_lens = [len(ids) for ids, _ in enc1]
        N = len(rep)
        lo, hi = self._rows(N)
        mine = slice(lo, hi)
        row_seed = seed + ROW_SEED_STRIDE * (self.mesh.coordinate["data"] if self.mesh is not None else 0)
        if self.rollout_engine is not None:
            out1_tokens, out2_tokens_by_row, pieces = self._engine_rollout(
                rep[mine], full_images[mine], stage1_images[mine], enc1[mine], row_seed)
            self._mark("engine_rollout")
        else:
            out1_tokens, out2_tokens_by_row, pieces = self._generator_rollout(
                rep[mine], full_images[mine], stage1_images[mine], prompts_text[mine], enc1[mine], row_seed)
        chunked = self.rollout_engine is not None or self.grpo.reuse_cache
        pieces = {lo + i: p for i, p in pieces.items()}
        if self.mesh is not None:
            out1_tokens, out2_tokens_by_row = self._gather_rollouts(out1_tokens, out2_tokens_by_row, lo)
            if self.mesh.coordinate["fsdp"] or self.mesh.coordinate["tensor"]:
                pieces = {}  # this rank's rows were taken from its group's first rank: rebuilt below from them

        completions1 = [tk.decode(t).strip() for t in out1_tokens]
        completions2 = [""] * N
        for i in range(N):
            if rep[i].bbox and full_images[i] is not None:
                if i not in pieces:
                    pieces[i] = self._stage2_piece(out1_tokens[i], completions1[i], full_images[i],
                                                   stage1_images[i], prompts_text[i], chunked)
                completions2[i] = tk.decode(out2_tokens_by_row[i]).strip()
        return self._stitch_rollout(rep, enc1, prompt1_lens, out1_tokens, completions1, completions2, pieces,
                                    out2_tokens_by_row, chunked=chunked)

    def _stage2_piece(self, out1, completion1: str, full, stage1_image, prompt_text: str, chunked: bool) -> Dict:
        """A stage-2 row's host inputs from its stage-1 completion: the crop's scale,
        and either the KV-reuse continuation (kept stage-1 tokens, chunk ids, the
        preprocessed crop) or the re-tokenized stitched prompt with its two images."""
        crop, scale = self._crop(completion1, full, stage1_image)
        if chunked:
            kept, _, chunk, crop_prepped = self._build_stage2_chunk(out1, crop)
            return {"scale": scale, "kept": kept, "chunk": chunk, "imgs": crop_prepped}
        s2_text = prompt_text + completion1.split("<answer>")[0] + PT.VISION_TOKENS
        ids2, prepped2 = self.processor.encode(s2_text, [stage1_image, crop])
        return {"scale": scale, "ids": ids2, "imgs": prepped2}

    def _generator_rollout(self, rep, full_images, stage1_images, prompts_text, enc1, seed):
        """Both stages of `rep`'s rows through the in-process Generator: (stage-1
        tokens by row, stage-2 tokens by row index, stage-2 host inputs by row index)."""
        cfg = self.cfg
        tk = self.processor.tokenizer
        batch1 = prepare_batch(
            cfg, [ids for ids, _ in enc1], [imgs for _, imgs in enc1],
            length_buckets=self.length_buckets, patch_buckets=self.patch_buckets,
        )
        gen1 = GenerationConfig(max_new_tokens=self.grpo.max_completion_length,
                                temperature=self.grpo.rollout_temperature)
        self.generator.params = self.full_params()  # the weight handoff: the live leaves, or gathered ones
        if self.grpo.reuse_cache:
            out1_tokens, stage1_cache = self.generator.generate(batch1, gen1, seed=seed, return_cache=True)
        else:
            out1_tokens = self.generator.generate(batch1, gen1, seed=seed)
            stage1_cache = None
        self._mark("stage1_rollout")

        # ---- stage 2 (batched) for samples whose DATASET bbox is non-empty ----
        pieces: Dict[int, Dict] = {}
        for i, s in enumerate(rep):
            if s.bbox and full_images[i] is not None:
                pieces[i] = self._stage2_piece(out1_tokens[i], tk.decode(out1_tokens[i]).strip(), full_images[i],
                                               stage1_images[i], prompts_text[i], self.grpo.reuse_cache)
        s2_idx = sorted(pieces)
        gen2 = GenerationConfig(max_new_tokens=self.grpo.stage2_max_completion_length,
                                temperature=self.grpo.rollout_temperature)
        out2_tokens_by_row: Dict[int, List[int]] = {}
        if s2_idx and self.grpo.reuse_cache:
            # inert rows keep their slot idle; their outputs are ignored
            full_chunks = [[cfg.tokens.pad] for _ in rep]
            full_imgs: List[List] = [[] for _ in rep]
            keep_len = [int(batch1.lengths[i]) for i in range(len(rep))]
            starts = [int(batch1.next_pos[i]) for i in range(len(rep))]
            for i in s2_idx:
                full_chunks[i] = pieces[i]["chunk"]
                full_imgs[i] = pieces[i]["imgs"]
                keep_len[i] = int(batch1.lengths[i]) + len(pieces[i]["kept"])
                starts[i] = int(batch1.next_pos[i]) + len(pieces[i]["kept"])
            bc = prepare_continuation(cfg, full_chunks, full_imgs, starts,
                                      length_buckets=self.length_buckets, patch_buckets=self.patch_buckets)
            inert = np.ones((len(rep),), bool)
            inert[s2_idx] = False  # rows without a crop decode NOTHING
            out2_all = self.generator.continue_generate(stage1_cache, bc, np.asarray(keep_len, np.int32), gen2,
                                                        seed=seed + 1, inert_mask=inert)
            for i in s2_idx:
                out2_tokens_by_row[i] = out2_all[i]
        elif s2_idx:
            batch2 = prepare_batch(cfg, [pieces[i]["ids"] for i in s2_idx], [pieces[i]["imgs"] for i in s2_idx],
                                   length_buckets=self.length_buckets, patch_buckets=self.patch_buckets)
            out2_tokens = self.generator.generate(batch2, gen2, seed=seed + 1)
            for j, i in enumerate(s2_idx):
                out2_tokens_by_row[i] = out2_tokens[j]
        del stage1_cache
        if self.mesh is not None:
            self.generator.params = self.params  # free the gathered tree before the policy gathers its own
        self._mark("stage2_rollout")
        return out1_tokens, out2_tokens_by_row, pieces

    def _crop(self, completion1: str, full, stage1_image):
        """The stage-2 crop of a stage-1 completion: its first predicted box (the
        whole stage-1 image when it has none, customized_funcs.py:598-601) scaled to
        the full image, cut and resized. Returns (crop, scale)."""
        boxes = extract_bboxes_float(completion1)
        w0, h0 = stage1_image.size
        box = boxes[0] if boxes else [0, 0, w0, h0]
        scale = max(max(full.width, full.height) / self.grpo.stage1_image_size, 1)
        box = [p * scale for p in box]
        return resize_image(cut_image(full, box), self.grpo.stage1_image_size, min_side=30), scale

    def _build_stage2_chunk(self, out1_tokens_i, crop):
        """Host-side stage-2 continuation pieces: (kept stage-1 tokens, residual text,
        chunk ids = residual + expanded crop vision tokens, preprocessed crop)."""
        from ..agent.episode import split_kept_tokens

        tk = self.processor.tokenizer
        raw = tk.decode(out1_tokens_i, skip_special_tokens=False)
        kept, residual = split_kept_tokens(tk, out1_tokens_i, raw.split("<answer>")[0])
        crop_prepped = self.processor.preprocess_images([crop])
        chunk = (tk.encode(residual) if residual else []) + self.processor.expand_image_pads(
            tk.encode(PT.VISION_TOKENS), [crop_prepped[0][1]]
        )
        return kept, residual, chunk, crop_prepped

    def _engine_rollout(self, rep, full_images, stage1_images, enc1, seed=0):
        """Rollouts through the ServingEngine actor (the reference's vllm_grpo_trainer
        architecture, vllm_grpo_trainer.py:409-420,531-575): stage 1 = hold_slot
        request, stage 2 = Continuation on the held KV. Completions are read in
        submission order; each row's crop and chunk are built while other rows keep
        decoding, and released slots backfill queued rows, so N may exceed
        engine.max_slots. Returns _generator_rollout's triple."""
        from ..serve.engine import Continuation, Request

        eng = self.rollout_engine
        tk = self.processor.tokenizer
        eng.params = self.full_params()  # the weight push: a pointer handoff, or gathered leaves on a mesh
        # seed the engine's sampler: reproducible given the same seed AND the same
        # scheduling (admission batching changes the order of the draws)
        eng.reseed(seed)
        was_running = eng._running
        if not was_running:
            eng.start()
        N = len(rep)
        temp = self.grpo.rollout_temperature
        # a unique id prefix per call: a failed step must never read an earlier
        # call's stale completions under recycled request ids
        self._rollout_nonce += 1
        nonce = self._rollout_nonce

        def rid(i, stage):
            return f"grpo{nonce}-{i}-{stage}"

        try:
            for i in range(N):
                ids, prepped = enc1[i]
                eng.submit(Request(
                    request_id=rid(i, "s1"), token_ids=list(ids), images=list(prepped),
                    max_tokens=self.grpo.max_completion_length, temperature=temp, hold_slot=True,
                ))
            out1_tokens: List[List[int]] = [[] for _ in range(N)]
            pieces: Dict[int, Dict] = {}
            for i in range(N):
                c1 = eng.get_completion(rid(i, "s1"), timeout=3600)
                out1_tokens[i] = list(c1.token_ids)
                if not rep[i].bbox or full_images[i] is None:
                    eng.release_slot(rid(i, "s1"))
                    continue
                pieces[i] = self._stage2_piece(out1_tokens[i], tk.decode(c1.token_ids).strip(), full_images[i],
                                               stage1_images[i], "", chunked=True)
                eng.submit_continuation(Continuation(
                    parent_request_id=rid(i, "s1"), request_id=rid(i, "s2"),
                    chunk_ids=pieces[i]["chunk"], images=pieces[i]["imgs"], kept_tokens=len(pieces[i]["kept"]),
                    max_tokens=self.grpo.stage2_max_completion_length, temperature=temp,
                ))
            out2_tokens_by_row: Dict[int, List[int]] = {}
            for i in pieces:
                out2_tokens_by_row[i] = list(eng.get_completion(rid(i, "s2"), timeout=3600).token_ids)
        finally:
            # a mid-rollout exception must not poison a PERSISTENT engine: cancel
            # everything this call submitted (cancel_prefix waits for in-flight rows,
            # which would otherwise re-insert held slots after the sweep)
            eng.cancel_prefix(f"grpo{nonce}-")
            if not was_running:
                eng.stop()
                if self.mesh is not None:
                    eng.params = self.params  # free the gathered tree (a running engine keeps serving on it)
        return out1_tokens, out2_tokens_by_row, pieces

    def _stitch_rollout(
        self, rep, enc1, prompt1_lens, out1_tokens, completions1, completions2, pieces, out2_tokens_by_row, *,
        chunked,
    ) -> RolloutBatch:
        """Stitch training sequences + rewards + grouped advantages + old/ref logps.

        pieces: each stage-2 row's _stage2_piece. chunked=True: stage-2 rows were
        generated as KV-reuse continuations (prompt + kept stage-1 prefix + crop chunk);
        False: full re-tokenized stage-2 prompts."""
        cfg = self.cfg
        G = self.grpo.num_generations
        scales = [pieces[i]["scale"] if i in pieces else 1.0 for i in range(len(rep))]
        train_ids_list: List[List[int]] = []
        train_imgs: List[List] = []
        for i in range(len(rep)):
            prompt_ids = [int(t) for t in enc1[i][0]]
            if completions2[i] != "":
                p = pieces[i]
                if chunked:
                    ids = prompt_ids + p["kept"] + p["chunk"] + out2_tokens_by_row[i] + [cfg.tokens.endoftext]
                    train_imgs.append(enc1[i][1] + p["imgs"])
                else:
                    ids = list(p["ids"]) + out2_tokens_by_row[i] + [cfg.tokens.endoftext]
                    train_imgs.append(p["imgs"])
            else:
                ids = prompt_ids + out1_tokens[i] + [cfg.tokens.endoftext]
                train_imgs.append(enc1[i][1])
            train_ids_list.append(ids)

        S = bucket(max(len(x) for x in train_ids_list), self.length_buckets)
        N = len(rep)
        input_ids = np.full((N, S), cfg.tokens.pad, np.int32)
        for i, ids in enumerate(train_ids_list):
            input_ids[i, : len(ids)] = ids
        start = np.asarray(prompt1_lens, np.int32)
        stops = (cfg.tokens.eos, cfg.tokens.endoftext)
        completion_mask = _first_stop_mask(input_ids, start, stops)
        # beyond the real sequence nothing applies
        for i, ids in enumerate(train_ids_list):
            completion_mask[i, len(ids):] = 0
        if self.grpo.mask_image_tokens:
            completion_mask[input_ids == cfg.tokens.image_pad] = 0

        grids_per_seq = [[g for _, g in imgs] for imgs in train_imgs]
        pos, _ = mrope_position_ids_batch(
            input_ids, grids_per_seq, image_pad_id=cfg.tokens.image_pad,
            merge_size=cfg.vision.spatial_merge_size,
            attention_mask=(input_ids != cfg.tokens.pad).astype(np.int32),
        )
        all_pv = [pv for imgs in train_imgs for pv, _ in imgs]
        all_grids = [g for gs in grids_per_seq for g in gs]
        if all_pv:
            pv = np.concatenate(all_pv, axis=0)
            P = bucket(pv.shape[0], self.patch_buckets)
            meta = vision_metadata(all_grids, cfg.vision, pad_to=P)
            if P > pv.shape[0]:
                pv = np.concatenate([pv, np.zeros((P - pv.shape[0], pv.shape[1]), pv.dtype)])
            vision_meta = {
                "perm": meta.perm, "inv_perm_merged": meta.inv_perm_merged,
                "seg_window": meta.seg_window, "seg_full": meta.seg_full,
                "pos_ids": meta.pos_ids,
            }
        else:  # all-text batch
            pv = None
            vision_meta = None

        # ---- rewards (this rank's rows, gathered) + grouped advantages ----
        lo, hi = self._rows(N)
        mine = rep[lo:hi]
        reward_kwargs: Dict[str, list] = {
            "question": [s.question for s in mine],
            "ground_truth": [s.ground_truth for s in mine],
            "bbox": [s.bbox for s in mine],
            "scale": scales[lo:hi],
            "image_path": [s.image_path for s in mine],
            "category": [s.category for s in mine],
            "type": [s.type for s in mine],
        }
        F = len(self.reward_funcs)
        rewards_per_func = np.zeros((hi - lo, F), np.float32)
        for fi, fn in enumerate(self.reward_funcs):
            rewards_per_func[:, fi] = np.asarray(fn(completions1[lo:hi], completions2[lo:hi], **reward_kwargs),
                                                 np.float32)
        rewards_per_func = self._gather_rows(rewards_per_func)
        rewards = self._weighted_rewards(rewards_per_func)
        grouped = rewards.reshape(-1, G)
        advantages = (rewards - np.repeat(grouped.mean(1), G)).astype(np.float32)
        if self.grpo.scale_rewards:
            # the vLLM trainer's variant: divide by the group std (vllm_grpo_trainer.py:~705-712)
            advantages = advantages / (np.repeat(grouped.std(1), G) + 1e-4)
        self._mark("rewards_stitch")

        rb = RolloutBatch(
            input_ids=input_ids, completion_mask=completion_mask, position_ids=pos,
            pixel_values=pv, vision_meta=vision_meta, advantages=advantages,
            old_logps=None, ref_logps=None,
            completions1=completions1, completions2=completions2,
            rewards_per_func=rewards_per_func,
        )
        # ---- old / ref logps (this rank's rows, gathered) ----
        if self.grpo.num_iterations > 1 or self.grpo.beta > 0:
            batch = self._train_batch(rb)
            if self.grpo.num_iterations > 1:
                rb.old_logps = self._logps(self.params, self.specs, batch)
            if self.grpo.beta > 0:
                rb.ref_logps = self._logps(self.ref_params, self.ref_specs, batch)
            self._mark("ref_logps")
        return rb

    def _train_batch(self, rb: RolloutBatch) -> Dict:
        """This rank's rows of a stitched batch as tensors on the device (every row on
        one device), with every packed image and its rows' `image_offset`."""
        lo, hi = self._rows(rb.input_ids.shape[0])
        if self.mesh is None:
            return batch_to_device(rb, self.device)

        def rows(a, axis=0):
            return None if a is None else np.take(a, np.arange(lo, hi), axis=axis)

        mine = dataclasses.replace(
            rb, input_ids=rows(rb.input_ids), completion_mask=rows(rb.completion_mask),
            position_ids=rows(rb.position_ids, 1), advantages=rows(rb.advantages), old_logps=rows(rb.old_logps),
            ref_logps=rows(rb.ref_logps))
        batch = batch_to_device(mine, self.device)
        batch["image_offset"] = int((rb.input_ids[:lo] == self.cfg.tokens.image_pad).sum())
        return batch

    @torch.no_grad()
    def _logps(self, params, specs, batch) -> np.ndarray:
        tp = None
        if self.mesh is not None:
            params, tp = gather_for_compute(params, specs, self.mesh), tensor_parallel(self.mesh, specs)
        lp = per_token_logps(params, self.cfg, batch["input_ids"], batch["position_ids"], batch["pixel_values"],
                             batch["vision_meta"], image_offset=batch.get("image_offset", 0), tp=tp)
        return self._gather_rows(lp.cpu().numpy())

    # ------------------------------------------------------------------
    # Optimizer step
    # ------------------------------------------------------------------

    def step(self, samples: Sequence[LRSGROSample], seed: int = 0) -> Dict:
        """One GRPO optimizer step (rollouts regenerated every num_iterations steps).
        The parameters are updated in place."""
        self.stage_seconds = {}
        if self._step_count % self.grpo.num_iterations == 0:
            self._buffered = self.rollout(samples, seed=seed)
        rb = self._buffered
        self._step_count += 1
        self._mark()

        batch = self._train_batch(rb)
        if self.mesh is None:
            loss, aux = grpo_loss(self.params, self.cfg, batch, beta=self.grpo.beta,
                                  epsilon_low=self.grpo.epsilon_low, epsilon_high=self.grpo.epsilon_high)
            grads = torch.autograd.grad(loss, self.optimizer.params, materialize_grads=True)
        else:
            full = gather_for_compute(self.params, self.specs, self.mesh)
            loss, aux = grpo_loss(full, self.cfg, batch, beta=self.grpo.beta, epsilon_low=self.grpo.epsilon_low,
                                  epsilon_high=self.grpo.epsilon_high, rows=rb.input_ids.shape[0],
                                  tp=tensor_parallel(self.mesh, self.specs))
            grads = torch.autograd.grad(loss, self.optimizer.params, materialize_grads=True)
            del full
            grads = reduce_gradients(grads, self.optimizer.specs, self.mesh)
            loss = all_reduce(loss.detach(), self.mesh.group("data"))
            names = sorted(aux)
            sums = sum_over([float(aux[k]) for k in names], self.mesh.group("data"), self.device)
            aux = dict(zip(names, sums))
            aux["clip_ratio"] = aux["clip_ratio"] / max(aux.pop("clip_den"), 1.0)
        self._mark("loss_backward")
        if self.on_grads is not None:
            self.on_grads(grads)
        self.optimizer.step(grads)
        del grads
        if self.grpo.use_lora and self.ref_params is not None:
            # the base is never stepped; re-take the adapter-disabled view as the JAX
            # package does after each update
            self.ref_params = strip_lora(self.params)
        if (
            self.grpo.sync_ref_model
            and self.ref_params is not None
            and (self._step_count + 1) % self.grpo.ref_model_sync_steps == 0
        ):
            self._sync_ref()
        self._mark("update")
        rewards = self._weighted_rewards(rb.rewards_per_func)
        metrics = {
            "loss": float(loss.detach()),
            "reward": float(rewards.mean()),
            "reward_std": float(rewards.reshape(-1, self.grpo.num_generations).std(1).mean()),
            "completion_length": float(aux["completion_length"]),
            "clip_ratio": float(aux["clip_ratio"]),
        }
        if "kl" in aux:
            metrics["kl"] = float(aux["kl"])
        for fi, name in enumerate(self.reward_names):
            metrics[f"rewards/{name}"] = float(rb.rewards_per_func[:, fi].mean())
        self.metrics_history.append(metrics)
        if self.grpo.log_completions and (self.mesh is None or self.mesh.rank == 0):
            self._log_completions(rb)  # every rank holds the same rows: one writes them
        return metrics

    @torch.no_grad()
    def _sync_ref(self) -> None:
        """TR-DPO mixup, in place: ref <- alpha * policy + (1 - alpha) * ref, mixed in
        fp32 and cast back to the reference's dtype."""
        a = self.grpo.ref_model_mixup_alpha
        for r, p in zip(tree_leaves(self.ref_params), tree_leaves(self.params)):
            r.copy_((a * p.float() + (1 - a) * r.float()).to(r.dtype))

    def state_dict(self, root: Optional[int] = None) -> Optional[dict]:
        """The optimizer's state (what a checkpoint's opt_state holds; on a mesh, full
        tensors: SFTOptimizer.state_dict)."""
        return self.optimizer.state_dict(root)

    @torch.no_grad()
    def load_state(self, params, opt_state: Optional[dict]) -> None:
        """Resume: copy a restored parameter tree (CheckpointManager.restore with this
        trainer's params as the template; on a mesh, with its mesh and specs, so this
        rank's shards) into the live leaves in place, so the Generator, an engine and
        the optimizer keep their tensors, then load the optimizer's state where given.
        The reference policy is not touched: as in the JAX package's CLI, it stays the
        one this trainer was built with."""
        for dst, src in zip(tree_leaves(self.params), tree_leaves(params)):
            dst.copy_(src)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)

    def _weighted_rewards(self, rewards_per_func: np.ndarray) -> np.ndarray:
        """(N, F) per-function rewards -> (N,) training rewards (the weights the
        advantages use)."""
        F = rewards_per_func.shape[1]
        weights = np.asarray(self.grpo.reward_weights or [1.0] * F, np.float32)
        return rewards_per_func @ weights

    def _log_completions(self, rb: RolloutBatch):
        """Append this step's rollout samples as jsonl (the reference's log_completions
        table, offline)."""
        path = self.grpo.completions_path or "grpo_completions.jsonl"
        rewards = self._weighted_rewards(rb.rewards_per_func)
        with open(path, "a") as f:
            for i in range(len(rb.completions1)):
                f.write(json.dumps({
                    "step": self._step_count,
                    "completion1": rb.completions1[i],
                    "completion2": rb.completions2[i],
                    "reward": float(rewards[i]),
                    "advantage": float(rb.advantages[i]),
                }) + "\n")
