"""The ranks of tests/test_torch_tensor.py and tests/test_torch_tensor_procs.py that
need a group of processes: each function runs in one process of a gloo group of CPU
ranks, started by zoomearth_tpu_torch.parallel.launch, and writes what it computed
under `workdir` for the test process to hold against the one-device forward and the
JAX package. This module imports torch and the port only (torch_parallel_worker's
scenarios run here too)."""

import dataclasses
import os
import sys

import torch

from zoomearth_tpu_torch.cli import train_sft as SCLI
from zoomearth_tpu_torch.models.params import tree_leaves
from zoomearth_tpu_torch.parallel.collectives import (ShareKVHead, gather_for_compute, reduce_gradients,
                                                      tensor_parallel, traffic)
from zoomearth_tpu_torch.parallel.mesh import (local_slice, make_mesh, map_with_path, param_shardings, shard_params,
                                               spec_leaves)
from zoomearth_tpu_torch.parallel.multihost import gather_params, initialize
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train.sft_loop import make_trainable

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as W  # noqa: E402


def wide_mlp_cfg(width):
    """The tiny config with the ViT's MLP `width` wide (a width the tensor axis may not
    split)."""
    return dataclasses.replace(W.CFG, vision=dataclasses.replace(W.CFG.vision, intermediate_size=width))


def _grads(params, batch, mesh, cfg):
    """This rank's loss, its gradients (as autograd gives them, then reduced) and the
    blocks the forward ran split, through the sharded step's pieces."""
    specs = param_shardings(params, mesh)
    shards = shard_params(params, mesh)
    make_trainable(shards)
    tp = tensor_parallel(mesh, specs)
    loss, _ = TS.sharded_sft_loss(gather_for_compute(shards, specs, mesh), cfg, batch, mesh, tp)
    raw = torch.autograd.grad(loss, tree_leaves(shards))
    leaf_specs = spec_leaves(shards, specs)
    reduced = reduce_gradients([g.clone() for g in raw], leaf_specs, mesh)
    return loss, raw, reduced, leaf_specs, tp.blocks


def block_rules(rank, workdir, shape=(1, 1, 2), names=("bias_params", "lora_bias_params"), vision_mlp=None):
    """On a `shape` mesh: the loss, every gradient (gathered into the JAX layout) and
    the split blocks of the tensor-parallel forward, of the tree with random biases
    (bias_params.pt) and of its LoRA form (lora_bias_params.pt); this rank's raw
    gradient of the ViT's replicated column biases; the ViT's output; the global
    gradient norm over the mesh of the reduced pieces. With `vision_mlp`, of the trees
    `names` of wide_mlp_cfg(vision_mlp), written under a name that carries the width."""
    mesh = make_mesh(*shape)
    cfg = W.CFG if vision_mlp is None else wide_mlp_cfg(vision_mlp)
    batch = TS.batch_to_device(torch.load(os.path.join(workdir, "batch.pt"), weights_only=False), "cpu")
    out = {"coord": mesh.coordinate}
    for name in names:
        params = torch.load(os.path.join(workdir, f"{name}.pt"), weights_only=True)
        loss, raw, reduced, leaf_specs, blocks = _grads(params, batch, mesh, cfg)
        paths = spec_leaves(params, map_with_path(lambda p, leaf: p, params))  # in tree_leaves order
        out[name] = {"loss": float(loss), "blocks": blocks,
                     "grad_norm": float(TS.mesh_global_norm(reduced, leaf_specs, mesh)),
                     "grads": W.numpy_leaves(gather_params(list(reduced), leaf_specs, mesh)),
                     "raw": {p: g.numpy().copy() for p, g in zip(paths, raw)
                             if p.endswith(("mlp/bg", "mlp/bu", "merger/b0"))}}
        with torch.no_grad():
            specs = param_shardings(params, mesh)
            shards = shard_params(params, mesh)
            vis = TS.compute_vision_embeds(gather_for_compute(shards, specs, mesh), cfg, batch["pixel_values"],
                                           batch["vision_meta"], tp=tensor_parallel(mesh, specs))
        out[name]["vision"] = vis.numpy().copy()
    W.save(workdir, "rules" + ("" if tuple(shape) == (1, 1, 2) else "".join(map(str, shape)))
           + ("" if vision_mlp is None else f"_mlp{vision_mlp}"), rank, out)


def share_kv(rank, workdir):
    """ShareKVHead on a (1, 1, 4) mesh, whose KV-replica groups of 2 are ranks {0, 1}
    and {2, 3}: this rank's piece of a (3, 8) leaf split on its columns (head h is
    columns [4h, 4h + 4)), the whole head the forward joins, and the piece's gradient of
    sum(head * w_rank), w_rank drawn from the rank's seed; the group's ranks and the
    bytes each collective carried."""
    mesh = make_mesh(1, 1, 4)
    group = mesh.kv_group(2)
    full = torch.arange(24.0).reshape(3, 8)
    spec = ("fsdp", "tensor")
    piece = local_slice(full, spec, mesh).requires_grad_(True)
    traffic.clear()
    head = ShareKVHead.apply(piece, 1, group)
    w = torch.randn(head.shape, generator=torch.Generator().manual_seed(rank))
    (grad,) = torch.autograd.grad((head * w).sum(), piece)
    p = {"wk": piece}
    untouched = tensor_parallel(mesh, {"wk": spec}).share_kv_head(p, 4) is p
    W.save(workdir, "share_kv", rank, {"whole_heads_untouched": untouched, "piece": piece.detach().numpy().copy(), "head": head.detach().numpy().copy(),
                                       "w": w.numpy(), "grad": grad.numpy().copy(),
                                       "group": W.dist.get_process_group_ranks(group),
                                       "tensor_group": W.dist.get_process_group_ranks(mesh.group("tensor")),
                                       "traffic": dict(traffic)})


def cli_tensor(rank, world, addr, workdir, tensor=2):
    """cli.train_sft over `tensor` processes with --tensor `tensor` (the JAX CLI's
    launch flags), the model's config.json read for the head check, loading stubbed."""
    torch.set_num_threads(1)
    W.PT.rl_prompt, W.PT.text_rl_prompt = W.short_prompt, W.text_prompt
    seen = []

    def load(path, *, device=None, max_pixels=None, **kw):
        seen.append((os.path.basename(path), device))
        return (torch.load(os.path.join(workdir, "params.pt"), weights_only=True), W.CFG,
                W.Processor(W.FakeTokenizer(W.CFG.tokens), W.CFG, max_pixels=W.MAX_PIXELS))

    SCLI.load_model_and_processor = load
    traffic.clear()
    suffix = "" if tensor == 2 else str(tensor)
    SCLI.main(["--model_name", os.path.join(workdir, "ckpt"), "--dataset_name_train", os.path.join(workdir, "sft.jsonl"),
               "--img_folder", os.path.join(workdir, "imgs"), "--output_dir", os.path.join(workdir, "cli_sft" + suffix),
               "--num_train_epochs", "1", "--batch_size", "2", "--gradient_accumulation_steps", "1",
               "--save_steps", "2", "--log_steps", "1", "--max_pixels", str(W.MAX_PIXELS),
               "--num_processes", str(tensor), "--coordinator_address", addr, "--process_id", str(rank),
               "--tensor", str(tensor), "--device", "cpu"])
    W.save(workdir, "cli_tensor" + suffix, rank,
           {"seen": seen, "world": W.dist.get_world_size(), "traffic": dict(traffic)})


SCENARIOS = dict(W.SCENARIOS, block_rules=block_rules, share_kv=share_kv)


def run(rank, world, addr, workdir, scenarios):
    """Join a gloo group of `world` CPU ranks, then run each [name, kwargs] in order."""
    torch.set_num_threads(1)
    W.PT.rl_prompt, W.PT.text_rl_prompt = W.short_prompt, W.text_prompt
    initialize(addr, world, rank, device="cpu")
    for name, kwargs in scenarios:
        SCENARIOS[name](rank, workdir, **kwargs)
        W.dist.barrier()
