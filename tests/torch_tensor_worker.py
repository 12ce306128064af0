"""The ranks of tests/test_torch_tensor.py and tests/test_torch_tensor_procs.py that
need a group of processes: each function runs in one process of a gloo group of CPU
ranks, started by zoomearth_tpu_torch.parallel.launch, and writes what it computed
under `workdir` for the test process to hold against the one-device forward and the
JAX package. This module imports torch and the port only (torch_parallel_worker's
scenarios run here too)."""

import os
import sys

import torch

from zoomearth_tpu_torch.cli import train_sft as SCLI
from zoomearth_tpu_torch.models.params import tree_leaves
from zoomearth_tpu_torch.parallel.collectives import (gather_for_compute, reduce_gradients, tensor_parallel,
                                                      traffic)
from zoomearth_tpu_torch.parallel.mesh import make_mesh, map_with_path, param_shardings, shard_params, spec_leaves
from zoomearth_tpu_torch.parallel.multihost import gather_params, initialize
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train.sft_loop import make_trainable

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as W  # noqa: E402


def _grads(params, batch, mesh):
    """This rank's loss, its gradients (as autograd gives them, then reduced) and the
    blocks the forward ran split, through the sharded step's pieces."""
    specs = param_shardings(params, mesh)
    shards = shard_params(params, mesh)
    make_trainable(shards)
    tp = tensor_parallel(mesh, specs)
    loss, _ = TS.sharded_sft_loss(gather_for_compute(shards, specs, mesh), W.CFG, batch, mesh, tp)
    raw = torch.autograd.grad(loss, tree_leaves(shards))
    leaf_specs = spec_leaves(shards, specs)
    reduced = reduce_gradients([g.clone() for g in raw], leaf_specs, mesh)
    return loss, raw, reduced, leaf_specs, tp.blocks


def block_rules(rank, workdir):
    """On a (1, 1, 2) mesh: the loss, every gradient (gathered into the JAX layout) and
    the split blocks of the tensor-parallel forward, of the tree with random biases
    (bias_params.pt) and of its LoRA form (lora_bias_params.pt); this rank's raw
    gradient of the ViT's replicated column biases; the ViT's output."""
    mesh = make_mesh(1, 1, 2)
    batch = TS.batch_to_device(torch.load(os.path.join(workdir, "batch.pt"), weights_only=False), "cpu")
    out = {"coord": mesh.coordinate}
    for name in ("bias_params", "lora_bias_params"):
        params = torch.load(os.path.join(workdir, f"{name}.pt"), weights_only=True)
        loss, raw, reduced, leaf_specs, blocks = _grads(params, batch, mesh)
        paths = spec_leaves(params, map_with_path(lambda p, leaf: p, params))  # in tree_leaves order
        out[name] = {"loss": float(loss), "blocks": blocks,
                     "grads": W.numpy_leaves(gather_params(list(reduced), leaf_specs, mesh)),
                     "raw": {p: g.numpy().copy() for p, g in zip(paths, raw)
                             if p.endswith(("mlp/bg", "mlp/bu", "merger/b0"))}}
        with torch.no_grad():
            specs = param_shardings(params, mesh)
            shards = shard_params(params, mesh)
            vis = TS.compute_vision_embeds(gather_for_compute(shards, specs, mesh), W.CFG, batch["pixel_values"],
                                           batch["vision_meta"], tp=tensor_parallel(mesh, specs))
        out[name]["vision"] = vis.numpy().copy()
    W.save(workdir, "rules", rank, out)


def cli_tensor(rank, world, addr, workdir):
    """cli.train_sft over two processes with --tensor 2 (the JAX CLI's launch flags),
    the model's config.json read for the head check, loading stubbed."""
    torch.set_num_threads(1)
    W.PT.rl_prompt, W.PT.text_rl_prompt = W.short_prompt, W.text_prompt
    seen = []

    def load(path, *, device=None, max_pixels=None, **kw):
        seen.append((os.path.basename(path), device))
        return (torch.load(os.path.join(workdir, "params.pt"), weights_only=True), W.CFG,
                W.Processor(W.FakeTokenizer(W.CFG.tokens), W.CFG, max_pixels=W.MAX_PIXELS))

    SCLI.load_model_and_processor = load
    traffic.clear()
    SCLI.main(["--model_name", os.path.join(workdir, "ckpt"), "--dataset_name_train", os.path.join(workdir, "sft.jsonl"),
               "--img_folder", os.path.join(workdir, "imgs"), "--output_dir", os.path.join(workdir, "cli_sft"),
               "--num_train_epochs", "1", "--batch_size", "2", "--gradient_accumulation_steps", "1",
               "--save_steps", "2", "--log_steps", "1", "--max_pixels", str(W.MAX_PIXELS), "--num_processes", "2",
               "--coordinator_address", addr, "--process_id", str(rank), "--tensor", "2", "--device", "cpu"])
    W.save(workdir, "cli_tensor", rank, {"seen": seen, "world": W.dist.get_world_size(), "traffic": dict(traffic)})


SCENARIOS = dict(W.SCENARIOS, block_rules=block_rules)


def run(rank, world, addr, workdir, scenarios):
    """Join a gloo group of `world` CPU ranks, then run each [name, kwargs] in order."""
    torch.set_num_threads(1)
    W.PT.rl_prompt, W.PT.text_rl_prompt = W.short_prompt, W.text_prompt
    initialize(addr, world, rank, device="cpu")
    for name, kwargs in scenarios:
        SCENARIOS[name](rank, workdir, **kwargs)
        W.dist.barrier()
