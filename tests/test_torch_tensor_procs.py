"""The port's training paths over tensor meshes, across gloo processes on the CPU,
against the JAX package's sharded programs on meshes of the same shapes: the sharded
SFT step over (1,1,2), (2,1,2), (1,2,2), (1,1,4) and (2,1,4) (tensor 4: two ranks
share each of the tiny decoder's 2 KV heads), GRPOTrainer(mesh=) over (2,2,2) (the
mesh of tests/test_grpo_mesh.py), over (1,1,4) and with LoRA over (1,1,2) (the mixed
blocks), train_sft(mesh=) over (1,1,2) with its JAX-layout checkpoint and a resume,
and cli.train_sft --tensor 2 and --tensor 4 as two and four processes.

The ranks run tests/torch_tensor_worker.py (torch and the port only) through
parallel/launch.py's run_ranks. The weights are the JAX package's tiny init with every
bias drawn at random (the init's zero biases would hide a bias added on every rank).
Losses, metrics, gradient norms and parameters are held to atol 5e-5 in fp32;
replicas and pieces two ranks hold, a resume and a single-process restore to bits."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent import prompts as JPT
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.train.data import LRSGROSample as JSample
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import hf_config_dict, tree_leaves
from zoomearth_tpu_torch.parallel import mesh as TM
from zoomearth_tpu_torch.parallel.launch import run_ranks
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL
from zoomearth_tpu_torch.train.checkpoints import CheckpointManager
from zoomearth_tpu_torch.train.data import SFTSample
from zoomearth_tpu_torch.train.lora import frozen_leaves

import test_torch_parallel_procs as PP  # noqa: E402  (tests/ is on sys.path under pytest)
import torch_parallel_worker as W  # noqa: E402

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
ATOL = 5e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tensor_worker.py")
GROUP_TIMEOUT_S = 300
SFT_SHAPES = [(1, 1, 2), (2, 1, 2), (1, 2, 2), (1, 1, 4), (2, 1, 4)]
# (mesh, prompts, steps, lora)
GRPO_CASES = [((2, 2, 2), "img", 1, False), ((1, 1, 2), "img", 1, True), ((1, 1, 4), "img", 1, False)]


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module", autouse=True)
def _short_prompts():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPT, "rl_prompt", W.short_prompt)
        mp.setattr(JPT, "text_rl_prompt", W.text_prompt)
        yield


@pytest.fixture(scope="module")
def jparams():
    """The JAX init with every bias drawn from N(0, 0.5)."""
    rng = np.random.default_rng(21)

    def draw(path, x):
        name = str(getattr(path[-1], "key", ""))
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.5) if name.startswith("b") else x

    return jax.tree_util.tree_map_with_path(draw, jax_init(jax.random.key(0), PP.JCFG))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, jparams):
    """Inputs every group reads: the parameters, the SFT batches, the JAX package's
    LoRA adapters (its trainer on the (1,1,2) mesh, kept for the comparison), the CLI's
    dataset and a model directory holding only the tiny config.json."""
    d = tmp_path_factory.mktemp("tensor")
    torch.save(PP._port_params(jparams), d / "params.pt")
    torch.save(PP.sft_batches(), d / "sft_batches.pt")
    lora_trainer = PP._jax_grpo_trainer(jparams, (1, 1, 2), True)
    torch.save(PP._port_params(lora_trainer.params), d / "lora_params.pt")
    imgs = d / "imgs"
    imgs.mkdir()
    rows = []
    for i in range(4):
        f = W.sft_fields(i, i % 2 == 0)
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (300, 280, 3), dtype=np.uint8)).save(
            imgs / f["image_name"])
        rows.append({"question": f["question"], "cut": f["cut"], "global": f["global_desc"],
                     "stage_1_reasoning": f["stage_1_reasoning"], "area": f["area"], "bbox": f["bbox"],
                     "stage_2_reasoning": f["stage_2_reasoning"], "ground_truth": f["ground_truth"],
                     "image_name": f["image_name"]})
    (d / "sft.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "ckpt").mkdir()
    (d / "ckpt" / "config.json").write_text(json.dumps(hf_config_dict(CFG)))
    return d, {"lora": lora_trainer}


def _run(d, world, scenarios):
    run_ranks(f"{WORKER}:run", world, {"workdir": str(d), "scenarios": scenarios}, timeout_s=GROUP_TIMEOUT_S)
    return d


@pytest.fixture(scope="module")
def world2(workdir):
    """(1,1,2): the sharded SFT step, the LoRA GRPO step, train_sft(mesh=)."""
    d, _ = workdir
    return _run(d, 2, [["sft_step", {"shape": [1, 1, 2]}],
                       ["grpo_step", {"shape": [1, 1, 2], "kind": "img", "steps": 1, "lora": True}],
                       ["sft_loop", {"shape": [1, 1, 2]}]])


@pytest.fixture(scope="module")
def world4(workdir):
    """(2,1,2), (1,2,2) and (1,1,4), where two ranks share each of the 2 KV heads: the
    sharded SFT step; GRPO on (1,1,4)."""
    d, _ = workdir
    return _run(d, 4, [["sft_step", {"shape": [2, 1, 2]}], ["sft_step", {"shape": [1, 2, 2]}],
                       ["sft_step", {"shape": [1, 1, 4]}],
                       ["grpo_step", {"shape": [1, 1, 4], "kind": "img", "steps": 1, "lora": False}]])


@pytest.fixture(scope="module")
def world8(workdir):
    d, _ = workdir
    return _run(d, 8, [["grpo_step", {"shape": [2, 2, 2], "kind": "img", "steps": 1, "lora": False}],
                       ["sft_step", {"shape": [2, 1, 4]}]])


def _world(request, shape):
    return request.getfixturevalue({2: "world2", 4: "world4", 8: "world8"}[int(np.prod(shape))])


def _close(a, b, what):
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=what)


def _same_piece(shape, tree):
    """For each leaf, a function of two ranks' coordinates: whether they hold the same
    piece of it (the same coordinate on every axis that splits it)."""
    mesh = TM.Mesh(*shape)
    specs = TM.spec_leaves(tree, TM.param_shardings(tree, mesh))
    return [lambda a, b, axes=TM.split_axes(s, mesh): all(a[x] == b[x] for x in axes) for s in specs]


@pytest.mark.parametrize("shape", SFT_SHAPES, ids=["tensor2", "data2_tensor2", "fsdp2_tensor2", "tensor4",
                                                   "data2_tensor4"])
def test_sharded_sft_step_over_the_tensor_axis_equals_jax_and_the_unsharded_step(request, jparams, shape):
    """2 updates of 2 micro-steps with a clip that binds: each micro-step's loss, grad
    norm and tokens, and every leaf after the last update gathered into the JAX
    layout, within 5e-5 of the JAX package's make_sharded_train_step on the same mesh
    shape and of the port's unsharded step; every two ranks that hold the same piece
    of a leaf (a replicated leaf: all of them) hold it in the same bits after every
    update."""
    d = _world(request, shape)
    results = PP._load(d, f"sft_{''.join(map(str, shape))}", int(np.prod(shape)))
    jm, jleaves = PP._jax_sharded_sft(jparams, shape, PP.sft_batches())
    um, uleaves = PP._port_unsharded_sft(jparams, PP.sft_batches())
    ours = results[0]
    assert all(r["metrics"] == ours["metrics"] for r in results), "the ranks' metrics differ"
    assert min(m["grad_norm"] for m in ours["metrics"]) > W.SFT_CFG["max_grad_norm"]
    for i, (m, j, u) in enumerate(zip(ours["metrics"], jm, um)):
        for k in ("loss", "grad_norm", "tokens"):
            _close(m[k], j[k], f"micro-step {i} {k} against JAX")
            _close(m[k], u[k], f"micro-step {i} {k} against the unsharded step")
    for i, (a, b, c) in enumerate(zip(ours["params"], jleaves, uleaves)):
        _close(a, b, f"leaf {i} against JAX")
        _close(a, c, f"leaf {i} against the unsharded step")
    same = _same_piece(shape, PP._port_params(jparams))
    assert len(ours["digests"]) == 2
    for r in results[1:]:
        for u in range(2):
            for leaf, (a, b) in enumerate(zip(r["digests"][u], ours["digests"][u])):
                if same[leaf](r["coord"], ours["coord"]):
                    assert a == b, f"update {u}: leaf {leaf} differs between rank 0 and a rank holding its piece"


@pytest.mark.parametrize("case", GRPO_CASES, ids=["data2_fsdp2_tensor2", "tensor2_lora", "tensor4"])
def test_grpo_over_the_tensor_axis_equals_the_jax_trainer_on_that_mesh(request, workdir, jparams, case):
    """GRPOTrainer(mesh=) with G = 2, sampled, on (2,2,2) and with LoRA on (1,1,2): every
    rank stitches the same whole rollout (made on the tree gathered over fsdp and
    tensor, handed back after it); the JAX trainer on the same mesh shape, handed that
    rollout, takes old and reference logps equal to the port's tensor-parallel ones and
    gives the same loss, metrics and parameters to 5e-5; the ranks holding the same
    piece hold it in bits; with LoRA the bases bit for bit."""
    shape, kind, steps, lora = case
    d = _world(request, shape)
    n = int(np.prod(shape))
    results = PP._load(d, f"grpo_{''.join(map(str, shape))}_{kind}{'_lora' if lora else ''}", n)
    jt = workdir[1]["lora"] if lora else PP._jax_grpo_trainer(jparams, shape, False)
    js = [JSample(**f) for f in W.grpo_fields(kind)]
    ours = results[0]
    start = torch.load(d / ("lora_params.pt" if lora else "params.pt"), weights_only=True)
    same = _same_piece(shape, start)
    for s in range(steps):
        rb = ours["steps"][s]["rollout"]
        for other in results[1:]:
            o = other["steps"][s]
            assert o["metrics"] == ours["steps"][s]["metrics"] and o["generator_on_shards"]
            for k, v in rb.items():
                x = o["rollout"][k]
                assert (np.array_equal(v, x) if isinstance(v, np.ndarray) else
                        all(np.array_equal(v[y], x[y]) for y in v) if isinstance(v, dict) else v == x), k
            for leaf, (a, b) in enumerate(zip(o["digests"], ours["steps"][s]["digests"])):
                if same[leaf](other["coord"], ours["coord"]):
                    assert a == b, f"step {s}: leaf {leaf} differs between two ranks holding its piece"
        assert np.abs(rb["advantages"]).max() > 0
        jt.rollout = lambda samples, seed, rb=rb: PP._jax_rollout_of(jt, rb)
        jm = jt.step(js, seed=s)
        got = jt._buffered
        for k in ("ref_logps", "old_logps"):
            if rb[k] is not None:
                _close(rb[k], getattr(got, k), f"step {s} {k}")
        tm = ours["steps"][s]["metrics"]
        assert tm.keys() == jm.keys()
        for k in tm:
            _close(tm[k], jm[k], f"step {s} {k}")
    for i, (a, b) in enumerate(zip(ours["params"], jax.tree.leaves(jt.params))):
        _close(a, np.asarray(b), f"leaf {i}")
    if lora:
        frozen = {id(t) for t in frozen_leaves(start)}
        moved = 0
        for a, t in zip(ours["params"], tree_leaves(start)):
            if id(t) in frozen:
                assert np.array_equal(a, t.numpy())
            else:
                moved += int(not np.array_equal(a, t.numpy()))
        assert moved > 0


def test_train_sft_on_a_tensor_mesh_writes_the_jax_layout_and_resumes_bit_for_bit(world2, jparams):
    """train_sft(mesh=(1,1,2)): the same history on both ranks, one writer; a run
    resumed from the step-2 checkpoint takes steps 3-4 to the uninterrupted run's
    losses and parameters bit for bit; the step-4 checkpoint restores in one process to
    the mesh's gathered parameters bit for bit; its parameters and AdamW moments, the
    fused ViT wqkv / bqkv among them, are in the JAX layout: within 5e-5 of an
    unsharded train_sft's step-4 checkpoint leaf for leaf."""
    results = PP._load(world2, "loop112", 2)
    assert results[0]["history"] == results[1]["history"]
    assert [r["step"] for r in results[0]["history"]] == [1, 2, 3, 4]
    lines = [json.loads(x) for x in open(world2 / "loop112_full" / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    calls = [json.loads(x) for x in open(world2 / "loop112_callbacks.jsonl")]
    assert [(c["rank"], c["step"]) for c in calls] == [(0, 2), (0, 4)]
    keep = ("step", "loss", "grad_norm", "tokens")
    assert [{k: r[k] for k in keep} for r in results[0]["resumed_history"]] == \
        [{k: r[k] for k in keep} for r in results[0]["history"][2:]]
    assert all(r["resumed_equal"] for r in results)
    template = PP._port_params(jparams)
    restored, opt_state, meta = CheckpointManager(str(world2 / "loop112_full")).restore(4, template)
    assert meta["step"] == 4
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(tree_leaves(restored), results[0]["params"]))
    samples = [SFTSample(**W.sft_fields(i, i % 2 == 0)) for i in range(8)]
    _, plain = TL.train_sft(PP._port_params(jparams), CFG, TS.SFTConfig(**W.SFT_CFG),
                            TL.SFTLoopConfig(output_dir=str(world2 / "plain112"), num_train_epochs=1, batch_size=2,
                                             save_steps=2, log_steps=1, seed=3),
                            samples, W.processor(), device="cpu", image_loader=W.sft_loader(), max_steps=4)
    for a, b in zip(results[0]["history"], plain):
        for k in ("loss", "grad_norm"):
            _close(a[k], b[k], f"step {a['step']} {k}")
    ref, ref_opt, _ = CheckpointManager(str(world2 / "plain112")).restore(4, template)
    for i, (a, b) in enumerate(zip(tree_leaves(restored), tree_leaves(ref))):
        _close(a.numpy(), b.numpy(), f"checkpoint leaf {i}")
    moments = [(opt_state["adamw"]["state"][j][k], ref_opt["adamw"]["state"][j][k])
               for j in ref_opt["adamw"]["state"] for k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(tree_leaves(ref))
    for i, (a, b) in enumerate(moments):
        _close(a.numpy(), b.numpy(), f"checkpoint moment {i}")
    wqkv = [i for i, p in enumerate(TM.spec_leaves(template, TM.map_with_path(lambda p, _: p, template)))
            if p.endswith("attn/wqkv")]
    assert wqkv and max(float(np.abs(moments[2 * i][0].numpy()).max()) for i in wqkv) > 1e-6


def test_cli_train_sft_takes_tensor_2_as_two_processes(workdir):
    """cli.train_sft --num_processes 2 --coordinator_address --process_id --tensor 2
    --device cpu, loading stubbed: the head check reads the model's config.json, both
    ranks train on a (1, 1, 2) mesh and all-reduce activations, and one writes."""
    _cli_tensor(workdir, 2)


def test_cli_train_sft_takes_tensor_4_as_four_processes(workdir, jparams):
    """The same with --tensor 4 over four processes: the tiny config's 2 KV heads are
    shared by two ranks each, so the ranks also all-gather each head's pieces; the
    step-2 checkpoint, read in one process, is a tree of the JAX layout's shapes."""
    d = _cli_tensor(workdir, 4)
    template = PP._port_params(jparams)
    restored, _, _ = CheckpointManager(str(d / "cli_sft4")).restore(2, template)
    assert [t.shape for t in tree_leaves(restored)] == [t.shape for t in tree_leaves(template)]
    assert all(torch.isfinite(t).all() for t in tree_leaves(restored))


def _cli_tensor(workdir, tensor):
    d, _ = workdir
    run_ranks(f"{WORKER}:cli_tensor", tensor, {"workdir": str(d), "tensor": tensor}, timeout_s=GROUP_TIMEOUT_S)
    name = "cli_tensor" + ("" if tensor == 2 else str(tensor))
    results = PP._load(d, name, tensor)
    assert all(r["world"] == tensor and r["seen"] == [("ckpt", "cpu")] for r in results)
    assert all(r["traffic"]["all_reduce"] > 0 for r in results)
    if tensor > 2:
        assert all(r["traffic"]["kv_all_gather"] > 0 and r["traffic"]["kv_all_reduce"] > 0 for r in results)
    out = d / ("cli_sft" + ("" if tensor == 2 else str(tensor)))
    sft = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["step"] for x in sft] == [1, 2] and all(np.isfinite(x["loss"]) for x in sft)
    assert CheckpointManager(str(out)).latest() == 2
    return d
