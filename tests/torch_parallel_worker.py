"""The ranks of tests/test_torch_parallel_procs.py: each function runs in one process of
a multi-process CPU group (gloo), started by zoomearth_tpu_torch.parallel.launch, and
writes what it computed under `workdir` for the test process to hold against the JAX
package. This module imports torch and the port only."""

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from zoomearth_tpu_torch.agent import prompts as PT
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import tree_leaves
from zoomearth_tpu_torch.parallel.mesh import (is_sharded, local_slice, make_mesh, map_with_spec, shard_params,
                                               spec_leaves)
from zoomearth_tpu_torch.parallel.multihost import gather_params, initialize
from zoomearth_tpu_torch.rewards import registry as REG
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.train import grpo as TG
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL
from zoomearth_tpu_torch.train.data import LRSGROSample, SFTSample

CFG = VLMConfig.tiny()
MAX_PIXELS = 4 * 28 * 28
SFT_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.01, max_grad_norm=1.0,
               gradient_accumulation_steps=2)
GRPO_KW = dict(num_generations=2, max_completion_length=6, stage2_max_completion_length=4, rollout_temperature=1.0,
               learning_rate=1e-4, beta=0.04)
TRAINER_KW = dict(max_cache_len=512, length_buckets=(256, 384), patch_buckets=(64, 128), cache_dtype="float32")
REWARD_NAMES = ["iou", "format", "answer", "length"]


def short_prompt(q):
    return PT.PREFIX + q + "<|im_end|>\n<|im_start|>assistant\n"


def text_prompt(q):
    return "<|im_start|>system\nsolve<|im_end|>\n<|im_start|>user\n" + q + "<|im_end|>\n<|im_start|>assistant\n"


def length_reward(c1, c2, **kw):
    """A reward of each row's own completion (not of its place in the list)."""
    return [float(len(a) % 7) / 7.0 for a in c1]


def grpo_fields(kind):
    img = dict(question_id="1", image_name="a.png", category="c", question="what?", higher_level="p",
               ground_truth="car", bbox=[10, 10, 40, 40], type="object")
    glob = dict(question_id="2", image_name="b.png", category="c", question="count?", higher_level="p",
                ground_truth="3", bbox=[], type="global")
    txt = dict(question_id="3", image_name="", category="m", question="1+2?", higher_level="r", ground_truth="3",
               bbox=[], type="global", image_path=None)
    return {"img": [img, glob], "mixed": [img, txt], "one": [img]}[kind]


def grpo_loader():
    """Seeded 600 x 600 tiles, one per image name."""
    from PIL import Image

    imgs = {}

    def load(s):
        if s.image_name not in imgs:
            rng = np.random.default_rng(3 + len(imgs))
            imgs[s.image_name] = Image.fromarray(rng.integers(0, 255, (600, 600, 3), dtype=np.uint8))
        return imgs[s.image_name]

    return load


def sft_fields(i, cut):
    return dict(question=f"what is at site {i}?", cut=cut, global_desc="An aerial scene.",
                stage_1_reasoning="I should look closer." if cut else "The whole image suffices.",
                area="top-left", bbox=[50, 60, 200, 220] if cut else [], stage_2_reasoning="It is a car.",
                ground_truth="car", image_name=f"img{i}.png")


def sft_loader():
    """Seeded images, each from its sample's number (whatever order they load in: a
    resumed run skips the first batches)."""
    from PIL import Image

    def load(s):
        rng = np.random.default_rng(int(s.image_name[3:-4]))
        return Image.fromarray(rng.integers(0, 255, (300, 280, 3), dtype=np.uint8))

    return load


def processor():
    return Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=MAX_PIXELS)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def numpy_leaves(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def save(workdir, name, rank, obj):
    torch.save(obj, os.path.join(workdir, f"{name}_rank{rank}.pt"))


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def sft_step(rank, workdir, shape):
    """make_sharded_train_step over `shape` for every micro-step of sft_batches.pt;
    per micro-step the whole batch's metrics, per update every leaf's digest, at the
    end the full parameters."""
    mesh = make_mesh(*shape)
    params = torch.load(os.path.join(workdir, "params.pt"), weights_only=True)
    batches = torch.load(os.path.join(workdir, "sft_batches.pt"), weights_only=False)
    step, specs, init_opt = TS.make_sharded_train_step(mesh, CFG, TS.SFTConfig(**SFT_CFG), params)
    shards = shard_params(params, mesh)
    opt = init_opt(shards)
    shardings = TS.batch_shardings(mesh, True, patch_shardable=False)
    metrics, digests = [], []
    for batch in batches:
        local = TS.shard_batch(batch, mesh, shardings, CFG.tokens.image_pad)
        m = step(shards, opt, TS.batch_to_device(local, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
        if opt.mini_step == 0:
            digests.append([digest(t) for t in tree_leaves(shards)])
    full = gather_params(shards, specs, mesh)
    save(workdir, f"sft_{''.join(map(str, shape))}", rank,
         {"metrics": metrics, "digests": digests, "coord": mesh.coordinate,
          "sharded": [is_sharded(s, mesh) for s in spec_leaves(shards, specs)],
          "params": numpy_leaves(full) if rank == 0 else None})


def grpo_step(rank, workdir, shape, kind, steps, lora=False):
    """GRPOTrainer(mesh=) for `steps` steps (seeds 0, 1, ...) on `kind`'s prompts; per
    step the metrics, the whole stitched rollout and every leaf's digest, at the end
    the full parameters."""
    mesh = make_mesh(*shape)
    params = torch.load(os.path.join(workdir, "params.pt"), weights_only=True)
    kw = dict(GRPO_KW, use_lora=lora, lora_r=4, lora_alpha=8.0) if lora else dict(GRPO_KW)
    trainer = TG.GRPOTrainer(params, CFG, TG.GRPOConfig(**kw), processor(),
                             REG.get_reward_funcs(REWARD_NAMES[:3]) + [length_reward], reward_names=REWARD_NAMES,
                             image_loader=grpo_loader(), device="cpu", mesh=mesh, **TRAINER_KW)
    if lora:
        # the JAX package's adapters, carried across as the single-device tests carry them
        full = torch.load(os.path.join(workdir, "lora_params.pt"), weights_only=True)
        trainer.load_state(map_with_spec(lambda t, s: local_slice(t, s, mesh), full, trainer.specs), None)
    samples = [LRSGROSample(**f) for f in grpo_fields(kind)]
    out = {"steps": [], "coord": mesh.coordinate}
    for seed in range(steps):
        m = trainer.step(samples, seed=seed)
        rb = trainer._buffered
        out["steps"].append({"metrics": m, "rollout": dataclasses.asdict(rb),
                             "digests": [digest(t) for t in tree_leaves(trainer.params)],
                             # the rollout's gathered tree is freed: the Generator holds the shards again
                             "generator_on_shards": trainer.generator.params is trainer.params})
    full = trainer.full_params()
    out["params"] = numpy_leaves(full) if rank == 0 else None
    save(workdir, f"grpo_{''.join(map(str, shape))}_{kind}{'_lora' if lora else ''}", rank, out)


class CountSaves:
    """A save callback that appends one line per call (rank, step) to a file."""

    def __init__(self, path, rank):
        self.path, self.rank = path, rank

    def on_save(self, step, ckpt_dir, params):
        with open(self.path, "a") as f:
            f.write(json.dumps({"rank": self.rank, "step": step, "leaves": len(tree_leaves(params))}) + "\n")


def sft_loop(rank, workdir, shape):
    """train_sft(mesh=) over `shape`: an uninterrupted run of 4 micro-steps saving at 2
    and 4, then a run resumed from a copy of its checkpoint-2."""
    mesh = make_mesh(*shape)
    tag = "".join(map(str, shape))
    params = torch.load(os.path.join(workdir, "params.pt"), weights_only=True)
    samples = [SFTSample(**sft_fields(i, i % 2 == 0)) for i in range(8)]
    sft_cfg = TS.SFTConfig(**SFT_CFG)
    full_dir, resumed_dir = os.path.join(workdir, f"loop{tag}_full"), os.path.join(workdir, f"loop{tag}_resumed")
    loop = TL.SFTLoopConfig(output_dir=full_dir, num_train_epochs=1, batch_size=2, save_steps=2, log_steps=1, seed=3)
    done, hist = TL.train_sft(params, CFG, sft_cfg, loop, samples, processor(), mesh=mesh, device="cpu",
                              image_loader=sft_loader(), max_steps=4,
                              callbacks=[CountSaves(os.path.join(workdir, f"loop{tag}_callbacks.jsonl"), rank)])
    specs = TS.param_shardings(params, mesh)
    final = gather_params(done, specs, mesh)
    if rank == 0:
        os.makedirs(resumed_dir)
        shutil.copytree(os.path.join(full_dir, "checkpoint-2"), os.path.join(resumed_dir, "checkpoint-2"))
    dist.barrier()
    again, hist2 = TL.train_sft(torch.load(os.path.join(workdir, "params.pt"), weights_only=True), CFG, sft_cfg,
                                dataclasses.replace(loop, output_dir=resumed_dir, resume_from_checkpoint=True),
                                samples, processor(), mesh=mesh, device="cpu", image_loader=sft_loader(), max_steps=2)
    resumed = gather_params(again, specs, mesh)
    save(workdir, f"loop{tag}", rank,
         {"history": hist, "resumed_history": hist2,
          "resumed_equal": all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed), tree_leaves(final))),
          "params": numpy_leaves(final) if rank == 0 else None})


# ---------------------------------------------------------------------------
# a launch stopped at its rendezvous (the CLI tests' helper)
# ---------------------------------------------------------------------------

# torchrun's environment for the launch tests: RANK 1 and MASTER_ADDR:MASTER_PORT
LAUNCH_ENV = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29512", "RANK": "1"}


def reach_rendezvous(monkeypatch, cli, argv, env):
    """Run a CLI with a launch's flags and environment (WORLD_SIZE=env where given),
    stopped where it joins the process group, nothing loaded before; returns
    init_process_group's (backend, init_method, world_size, rank)."""
    import pytest

    def no_load(*a, **k):
        raise AssertionError("the model was loaded before the process group formed")

    monkeypatch.setattr(cli, "load_model_and_processor", no_load)
    for k in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in LAUNCH_ENV.items():
        monkeypatch.setenv(k, v)
    if env is not None:
        monkeypatch.setenv("WORLD_SIZE", env)
    reached = []

    def rendezvous(backend, init_method=None, world_size=None, rank=None, timeout=None):
        reached.append((backend, init_method, world_size, rank))
        raise SystemExit("stopped at the rendezvous")

    monkeypatch.setattr(dist, "init_process_group", rendezvous)
    with pytest.raises(SystemExit, match="stopped at the rendezvous"):
        cli.main(argv)
    return reached[0]


SCENARIOS = {"sft_step": sft_step, "grpo_step": grpo_step, "sft_loop": sft_loop}


def run(rank, world, addr, workdir, scenarios):
    """Join a gloo group of `world` CPU ranks, then run each [name, kwargs] in order."""
    torch.set_num_threads(1)
    for mod in (PT,):
        mod.rl_prompt, mod.text_rl_prompt = short_prompt, text_prompt
    initialize(addr, world, rank, device="cpu")
    for name, kwargs in scenarios:
        SCENARIOS[name](rank, workdir, **kwargs)
        dist.barrier()


def cli(rank, world, addr, workdir, grpo_port):
    """Both training CLIs as a launch would start them: train_sft with the JAX CLI's
    flags, then train_grpo from torchrun's environment; loading stubbed."""
    torch.set_num_threads(1)
    PT.rl_prompt, PT.text_rl_prompt = short_prompt, text_prompt
    from zoomearth_tpu_torch.cli import train_grpo as GCLI
    from zoomearth_tpu_torch.cli import train_sft as SCLI

    seen = []

    def load(path, *, device=None, max_pixels=None, **kw):
        seen.append((path, device))
        return (torch.load(os.path.join(workdir, "params.pt"), weights_only=True), CFG,
                Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=MAX_PIXELS))

    SCLI.load_model_and_processor = GCLI.load_model_and_processor = load
    SCLI.main(["--model_name", "ckpt", "--dataset_name_train", os.path.join(workdir, "sft.jsonl"), "--img_folder",
               os.path.join(workdir, "imgs"), "--output_dir", os.path.join(workdir, "cli_sft"),
               "--num_train_epochs", "1", "--batch_size", "2", "--gradient_accumulation_steps", "1",
               "--save_steps", "2", "--log_steps", "1", "--max_pixels", str(MAX_PIXELS), "--num_processes", "2",
               "--coordinator_address", addr, "--process_id", str(rank), "--fsdp", "2", "--device", "cpu"])
    sft_world = dist.get_world_size()
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(grpo_port))
    GCLI.main(["--model_name_or_path", "ckpt", "--data_file_paths", os.path.join(workdir, "rl.jsonl"),
               "--image_folders", os.path.join(workdir, "imgs"), "--output_dir", os.path.join(workdir, "cli_grpo"),
               "--per_device_train_batch_size", "1", "--num_generations", "2", "--max_completion_length", "6",
               "--learning_rate", "1e-4", "--num_train_epochs", "1", "--save_steps", "1", "--log_completions",
               "--device", "cpu"])
    save(workdir, "cli", rank, {"seen": seen, "sft_world": sft_world, "grpo_world": dist.get_world_size()})
