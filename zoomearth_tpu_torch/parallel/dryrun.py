"""Driver entry points: the flagship forward step, and a multi-process dryrun of the
four sharded surfaces (port of the JAX package's `entry()` / `dryrun_multichip`).

- entry(): (fn, example_args) for the forward of the flagship model (Qwen2.5-VL-3B
  config, zero weights on the `meta` device unless another is named: nothing is
  allocated, and the caller moves what it runs).
- dryrun_multichip(n): n ranks on this host over a (data, fsdp, tensor) mesh, factored
  as the JAX package factors it (tensor 2 and fsdp 2 where they fit: n = 4 is data 1,
  fsdp 2, tensor 2) run, on the tiny config, one
  sharded SFT step, one GRPO step, a serving-engine prefill and decode tick and a
  pair-pipelined wave over the mesh's gathered weights, and print a line for each.
  The engine's and the wave's greedy tokens must be the same on every rank and
  equal a single-process run over the same weights. Each rank runs on the CUDA device
  of its local rank (raising where the host has fewer), unless the caller names a
  device: `cpu`, or `cuda:0` for ranks that share one card over gloo.

    python -m zoomearth_tpu_torch.parallel.dryrun 4 [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600


def example_inputs(cfg, batch=1, seq=512, grid=(1, 32, 32), patch_bucket=1024):
    """Synthetic prompt with one image: ids, positions, packed patches, metadata."""
    from ..models.rope import mrope_position_ids_batch
    from ..models.vit import vision_metadata

    tok = cfg.tokens
    n_img = (grid[0] * grid[1] * grid[2]) // cfg.vision.merge_unit
    ids = np.full((batch, seq), tok.pad, dtype=np.int32)
    prompt = [tok.im_start] + [17] * 8 + [tok.vision_start] + [tok.image_pad] * n_img + [tok.vision_end] + [23] * 40
    assert len(prompt) <= seq
    for b in range(batch):
        ids[b, : len(prompt)] = prompt
    pos, _ = mrope_position_ids_batch(
        ids, [[grid]] * batch, image_pad_id=tok.image_pad,
        attention_mask=(ids != tok.pad).astype(np.int32),
    )
    n_patches = grid[0] * grid[1] * grid[2] * batch
    meta = vision_metadata([grid] * batch, cfg.vision, pad_to=patch_bucket if patch_bucket > n_patches else 0)
    # random (not zero) pixels: all-zero patches give RMSNorm var=0, whose backward
    # amplifies grads by rsqrt(eps)=1e3 per block, an artifact of synthetic input
    pv = np.random.default_rng(0).standard_normal(
        (max(n_patches, patch_bucket), cfg.vision.patch_dim)
    ).astype(np.float32)
    meta_arrays = {
        "perm": meta.perm,
        "inv_perm_merged": meta.inv_perm_merged,
        "seg_window": meta.seg_window,
        "seg_full": meta.seg_full,
        "pos_ids": meta.pos_ids,
    }
    return ids, pos, pv, meta_arrays


def entry(device="meta"):
    """(fn, example_args) for the flagship forward step (one device): params are zeros
    of the 3B config's shapes in bf16 on `device` (`meta`: shapes only)."""
    from ..config import VLMConfig
    from ..models.params import init_vlm_params, map_tree
    from ..models.vit import meta_to_device
    from ..models.vlm import vlm_forward

    cfg = VLMConfig.qwen2_5_vl_3b()
    with torch.device("meta"):
        shapes = init_vlm_params(cfg, generator=torch.Generator(), device="meta", dtype=torch.bfloat16)
    params = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), shapes)
    ids, pos, pv, meta = example_inputs(cfg)

    def fn(params, input_ids, position_ids, pixel_values, vision_meta):
        dev = params["text"]["embed"]["weight"].device
        ids_t = torch.as_tensor(input_ids, device=dev)
        logits, _ = vlm_forward(
            params, cfg, ids_t, torch.as_tensor(position_ids, device=dev),
            pixel_values=torch.as_tensor(pixel_values, device=dev, dtype=torch.bfloat16),
            vision_meta=meta_to_device(vision_meta, dev),
            logit_index=torch.full((ids_t.shape[0],), ids_t.shape[1] - 1, dtype=torch.int64, device=dev),
        )
        return logits

    return fn, (params, ids, pos, pv, meta)


def serve_surfaces(params, cfg, cache_dtype="float32"):
    """The engine tick and the pair-pipelined wave over one full parameter tree:
    (engine tokens by request, engine stats, wave lengths, wave tokens)."""
    from ..runtime.generate import GenerationConfig, Generator, prepare_batch, prepare_continuation
    from ..runtime.pipeline import run_paired_waves
    from ..serve.engine import Request, ServingEngine

    engine = ServingEngine(params, cfg, max_slots=2, max_seq_len=128, decode_chunk=2, cache_dtype=cache_dtype,
                           length_buckets=(64,), patch_buckets=(0, 64))
    tokd = cfg.tokens
    rngq = np.random.default_rng(0)
    grid = (1, 4, 4)
    pv_img = rngq.standard_normal((grid[0] * grid[1] * grid[2], cfg.vision.patch_dim)).astype(np.float32)
    n_img = (grid[0] * grid[1] * grid[2]) // cfg.vision.merge_unit
    ids_img = [tokd.im_start] + [int(t) for t in rngq.integers(1, 400, size=6)] + \
        [tokd.vision_start] + [tokd.image_pad] * n_img + [tokd.vision_end]
    engine.submit(Request(request_id="d0", token_ids=ids_img, images=[(pv_img, grid)], max_tokens=4))
    engine.submit(Request(request_id="d1", token_ids=[tokd.im_start] + [int(t) for t in rngq.integers(1, 400, size=9)],
                          images=[], max_tokens=4))
    engine.run_until_idle()
    engine_tokens = {rid: list(engine.get_completion(rid, timeout=5).token_ids) for rid in ("d0", "d1")}
    assert all(len(t) >= 1 for t in engine_tokens.values()), engine_tokens

    gen = Generator(params, cfg, max_cache_len=128, cache_dtype=cache_dtype)
    B = 2

    def stage1(w):
        rngw = np.random.default_rng(w)
        seqs = [[tokd.im_start] + [int(t) for t in rngw.integers(1, 400, size=5 + b)] for b in range(B)]
        return prepare_batch(cfg, seqs, [[] for _ in range(B)], length_buckets=(32,), patch_buckets=(0,))

    def stage2(w, out1, base_lengths, base_next):
        rngw = np.random.default_rng(100 + w)
        chunks = [[int(t) for t in rngw.integers(1, 400, size=3)] for _ in range(B)]
        keep = np.asarray([int(base_lengths[b]) + len(out1[b]) for b in range(B)], np.int32)
        starts = [int(base_next[b]) + len(out1[b]) for b in range(B)]
        bc = prepare_continuation(cfg, chunks, [[] for _ in range(B)], starts, length_buckets=(32,))
        return bc, keep, None

    done = []
    run_paired_waves(gen, 2, stage1, stage2, gen1=GenerationConfig(max_new_tokens=6),
                     gen2=GenerationConfig(max_new_tokens=4),
                     on_complete=lambda w, o1, o2: done.append((w, [list(x) for x in o1], [list(x) for x in o2])))
    assert sorted(w for w, *_ in done) == [0, 1], done
    lengths = sorted((w, len(o1), len(o2)) for w, o1, o2 in done)
    return engine_tokens, dict(engine.stats), lengths, sorted(done)


def _rank_main(rank, world, addr, device=None, backend=None, out=None):
    """One rank of dryrun_multichip (run by parallel/launch.py)."""
    from PIL import Image

    from ..agent import prompts as PT
    from ..agent.processor import Processor
    from ..config import VLMConfig
    from ..models.params import init_vlm_params
    from ..tokenizer import FakeTokenizer
    from ..train.data import LRSGROSample
    from ..train.grpo import GRPOConfig, GRPOTrainer
    from ..train.sft import SFTConfig, batch_shardings, batch_to_device, make_sharded_train_step, shard_batch
    from .collectives import gather_objects
    from .mesh import make_mesh, shard_params
    from .multihost import gather_params, initialize, rank_device

    initialize(addr, world, rank, backend=backend, device=device)
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    # the JAX package's factorization: 2-way tensor and 2-way fsdp where they fit
    tensor = 2 if world % 2 == 0 else 1
    fsdp = 2 if world % (2 * tensor) == 0 else 1
    mesh = make_mesh(data=-1, fsdp=fsdp, tensor=tensor)
    lead = rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"mesh: {mesh.shape}")
    n = world
    cfg = VLMConfig.tiny()
    params = init_vlm_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    step, specs, init_opt = make_sharded_train_step(mesh, cfg, SFTConfig(warmup_steps=1, gradient_accumulation_steps=1),
                                                    params)
    shards = shard_params(params, mesh)
    opt = init_opt(shards)
    ids, pos, pv, meta = example_inputs(cfg, batch=mesh.shape["data"] * 2, seq=128, grid=(1, 8, 8), patch_bucket=0)
    labels = np.where(ids == cfg.tokens.pad, -100, ids)
    batch = {"input_ids": ids, "labels": labels, "position_ids": pos, "pixel_values": pv, "vision_meta": meta}
    local = shard_batch(batch, mesh, batch_shardings(mesh, True, patch_shardable=False), cfg.tokens.image_pad)
    m = step(shards, opt, batch_to_device(local, dev))
    loss = float(m["loss"])
    assert np.isfinite(loss)
    say(f"dryrun_multichip({n}): one SFT step OK, loss={loss:.4f}, grad_norm={float(m['grad_norm']):.4f}")
    del shards, opt

    proc = Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=4 * 28 * 28)
    img = Image.fromarray(np.random.default_rng(5).integers(0, 255, (600, 600, 3), dtype=np.uint8))
    trainer = GRPOTrainer(
        params, cfg,
        GRPOConfig(num_generations=2, max_completion_length=5, stage2_max_completion_length=4,
                   rollout_temperature=1.0, learning_rate=1e-3, beta=0.04),
        proc, [lambda c1, c2, **kw: [float(len(a) % 5) for a in c1]],
        reward_names=["len"], max_cache_len=512, image_loader=lambda s: img,
        length_buckets=(256, 384), patch_buckets=(64, 128), cache_dtype="float32",
        # a short prompt template: the full LRS_GRO instruction overflows the tiny config's buckets
        prompt_fn=lambda q: PT.PREFIX + q + "<|im_end|>\n<|im_start|>assistant\n",
        device=dev, mesh=mesh,
    )
    samples = [
        LRSGROSample(question_id="1", image_name="a", category="c", question="what?", higher_level="p",
                     ground_truth="car", bbox=[10, 10, 40, 40], type="object"),
        LRSGROSample(question_id="2", image_name="b", category="c", question="count?", higher_level="p",
                     ground_truth="3", bbox=[], type="global"),
    ]
    del params
    gm = trainer.step(samples, seed=0)
    assert np.isfinite(gm["loss"]), gm
    say(f"dryrun_multichip({n}): one GRPO step OK, loss={gm['loss']:.4f}, params sharded over {mesh.size} ranks")

    # the weight push: the full tree from the mesh's shards, as a rollout actor gets it
    full = gather_params(trainer.params, trainer.specs, mesh)
    engine_tokens, stats, lengths, wave = serve_surfaces(full, cfg)
    say(f"dryrun_multichip({n}): engine prefill/decode tick OK (stats={stats})")
    say(f"dryrun_multichip({n}): pair-pipelined wave tick OK ({[tuple(x) for x in lengths]})")
    everyone = gather_objects((engine_tokens, wave), mesh.world_group())
    assert all(x == everyone[0] for x in everyone), "the ranks' greedy tokens differ"
    if lead and out:
        torch.save({"params": full, "engine": engine_tokens, "wave": wave}, out)


def dryrun_multichip(n_devices: int, device=None, backend=None, timeout_s: float = DRYRUN_TIMEOUT_S):
    """Run the four surfaces over n ranks (see the module docstring); prints and
    returns rank 0's lines, then the check against a single-process run. device
    None: each rank's own CUDA device (multihost.rank_device)."""
    from ..cli.common import resolve_device
    from ..config import VLMConfig
    from .launch import run_ranks

    resolve_device(device)  # no CUDA device and none named: raise here, before any rank starts
    with tempfile.TemporaryDirectory(prefix="zt_dryrun_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        outs = run_ranks("zoomearth_tpu_torch.parallel.dryrun:_rank_main", n_devices,
                         {"device": device, "backend": backend, "out": out}, timeout_s=timeout_s)
        saved = torch.load(out, weights_only=True)
    lines = [ln for ln in outs[0].splitlines() if ln.startswith(("mesh:", "dryrun_multichip("))]
    for ln in lines:
        print(ln, flush=True)
    engine_tokens, _, _, wave = serve_surfaces(saved["params"], VLMConfig.tiny())
    if engine_tokens != saved["engine"] or wave != saved["wave"]:
        raise AssertionError(f"the ranks' greedy tokens {saved['engine']} {saved['wave']} differ from a "
                             f"single-process run's {engine_tokens} {wave}")
    line = (f"dryrun_multichip({n_devices}): engine and pair-wave tokens equal a single-process run over the "
            "same weights")
    print(line, flush=True)
    return lines + [line]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="multi-process dryrun of the sharded surfaces (tiny config)")
    p.add_argument("n", type=int, nargs="?", default=4, help="ranks")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: the CUDA device of its local rank; cpu; cuda:0 shares one card "
                        "over gloo)")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: by the device)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dryrun_multichip(args.n, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main(sys.argv[1:])
