"""The port's parallel layer across processes on the CPU (gloo), against the JAX
package's sharded programs: the sharded SFT step over (2,1,1), (1,2,1) and (2,2,1)
ranks, train_sft(mesh=) with its checkpoint and resume, GRPOTrainer(mesh=) over
(2,1,1) and (1,2,1) (a group that straddles two data ranks, LoRA), both training CLIs
launched as two processes (the JAX CLI's flags, torchrun's environment), and the
four-surface dryrun.

The ranks run tests/torch_parallel_worker.py (torch and the port only), a few
scenarios per group of processes, each group under its own wall limit
(parallel/launch.py kills the group when one rank fails). The JAX side runs here on
conftest's 8 virtual CPU devices, on meshes of the same shapes. Losses, metrics,
gradient norms and parameters are held to atol 5e-5 (the single-device tests' bar);
replicas, shards held by two ranks, a resume and a single-process restore to bits.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent import prompts as JPT
from zoomearth_tpu.agent.processor import Processor as JProcessor
from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.parallel import mesh as JM
from zoomearth_tpu.rewards import registry as JREG
from zoomearth_tpu.tokenizer import FakeTokenizer as JFakeTokenizer
from zoomearth_tpu.train import grpo as JG
from zoomearth_tpu.train import sft as JS
from zoomearth_tpu.train.data import LRSGROSample as JSample
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import params_from_numpy, tree_leaves
from zoomearth_tpu_torch.models.vlm import masked_ce_loss, vlm_forward
from zoomearth_tpu_torch.parallel.dryrun import dryrun_multichip, example_inputs
from zoomearth_tpu_torch.parallel.launch import free_port, run_ranks
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL
from zoomearth_tpu_torch.train.checkpoints import CheckpointManager
from zoomearth_tpu_torch.train.data import SFTSample
from zoomearth_tpu_torch.train.lora import frozen_leaves

import torch_parallel_worker as W  # noqa: E402  (tests/ is on sys.path under pytest)

torch.set_num_threads(1)
CFG, JCFG = VLMConfig.tiny(), JVLMConfig.tiny()
ATOL = 5e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
GROUP_TIMEOUT_S = 300
SFT_SHAPES = [(2, 1, 1), (1, 2, 1), (2, 2, 1)]
# (mesh, prompts, steps, lora): the first's N = 4 rows split 2 / 2 with images on both
# ranks; "one" is one prompt of G = 2 rows, its group split 1 / 1 across the data ranks
GRPO_CASES = [((2, 1, 1), "img", 2, False), ((1, 2, 1), "mixed", 1, False), ((2, 1, 1), "one", 1, False),
              ((1, 2, 1), "img", 1, True)]


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


def _mesh(shape):
    return JM.make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


def sft_batches(n=4, rows=4):
    """n global batches of `rows` rows, one image each; rows 0-1 supervise 47 tokens
    and rows 2-3 only 7, so the data ranks of a (2, ., .) mesh hold different counts."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids, pos, pv, meta = example_inputs(CFG, batch=rows, seq=128, grid=(1, 8, 8), patch_bucket=0)
        text = (ids != CFG.tokens.pad) & (ids != CFG.tokens.image_pad) & (ids >= 17)
        ids = np.where(text & (np.arange(ids.shape[1]) > 0), rng.integers(32, 280, ids.shape), ids).astype(np.int32)
        pv = rng.standard_normal(pv.shape).astype(np.float32)
        start = np.asarray([20, 20, 60, 60] * (rows // 4))[:, None]
        labels = np.where((ids != CFG.tokens.pad) & (np.arange(ids.shape[1]) >= start), ids, -100).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels, "position_ids": pos, "pixel_values": pv,
                    "vision_meta": meta})
    return out


@pytest.fixture(scope="module")
def jparams():
    return jax_init(jax.random.key(0), JCFG)


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _jax_grpo_trainer(jparams, shape, lora):
    mesh = _mesh(shape)
    params = jax.tree.map(jnp.copy, jparams)
    params = jax.tree.map(jax.device_put, params, JM.param_shardings(params, mesh))
    kw = dict(W.GRPO_KW, use_lora=True, lora_r=4, lora_alpha=8.0) if lora else dict(W.GRPO_KW)
    return JG.GRPOTrainer(params, JCFG, JG.GRPOConfig(**kw), JProcessor(JFakeTokenizer(JCFG.tokens), JCFG,
                          max_pixels=W.MAX_PIXELS), JREG.get_reward_funcs(W.REWARD_NAMES[:3]) + [W.length_reward],
                          reward_names=W.REWARD_NAMES,
                          image_loader=W.grpo_loader(), **W.TRAINER_KW)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, jparams):
    """Inputs every group reads: the parameters, the SFT batches, the JAX package's
    LoRA adapters (its trainer on the (1,2,1) mesh, kept for the comparison), the CLI
    datasets."""
    d = tmp_path_factory.mktemp("parallel")
    torch.save(_port_params(jparams), d / "params.pt")
    torch.save(sft_batches(), d / "sft_batches.pt")
    lora_trainer = _jax_grpo_trainer(jparams, (1, 2, 1), True)
    torch.save(_port_params(lora_trainer.params), d / "lora_params.pt")
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
    rl = []
    for f in W.grpo_fields("img"):
        Image.fromarray(np.random.default_rng(7).integers(0, 255, (300, 280, 3), dtype=np.uint8)).save(
            imgs / f["image_name"])
        rl.append({k: f[k] for k in ("question_id", "image_name", "category", "question", "higher_level",
                                      "ground_truth", "bbox", "type")})
    (d / "rl.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rl))
    return d, {"lora": lora_trainer}


def _load(d, name, world):
    return [torch.load(d / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def world2(workdir):
    """One group of 2 ranks: the sharded SFT step on (2,1,1) and (1,2,1), every GRPO
    case, train_sft(mesh=) on (1,2,1) and (2,1,1)."""
    d, _ = workdir
    scenarios = ([["sft_step", {"shape": list(s)}] for s in SFT_SHAPES[:2]]
                 + [["grpo_step", {"shape": list(s), "kind": k, "steps": n, "lora": lo}]
                    for s, k, n, lo in GRPO_CASES]
                 + [["sft_loop", {"shape": [1, 2, 1]}], ["sft_loop", {"shape": [2, 1, 1]}]])
    run_ranks(f"{WORKER}:run", 2, {"workdir": str(d), "scenarios": scenarios}, timeout_s=GROUP_TIMEOUT_S)
    return d


@pytest.fixture(scope="module")
def world4(workdir):
    d, _ = workdir
    run_ranks(f"{WORKER}:run", 4, {"workdir": str(d), "scenarios": [["sft_step", {"shape": [2, 2, 1]}]]},
              timeout_s=GROUP_TIMEOUT_S)
    return d


def _sft_results(request, shape):
    d = request.getfixturevalue("world4" if np.prod(shape) == 4 else "world2")
    return _load(d, f"sft_{''.join(map(str, shape))}", int(np.prod(shape)))


def _port_unsharded_sft(jparams, batches):
    params = _port_params(jparams)
    TL.make_trainable(params)
    opt = TS.SFTOptimizer(params, TS.SFTConfig(**W.SFT_CFG))
    metrics = [{k: float(v) for k, v in TS.train_step(params, opt, TS.batch_to_device(b, "cpu"), cfg=CFG).items()}
               for b in batches]
    return metrics, [t.detach().numpy() for t in tree_leaves(params)]


def _jax_sharded_sft(jparams, shape, batches):
    mesh = _mesh(shape)
    step, _, p_shard, init_opt = JS.make_sharded_train_step(mesh, JCFG, JS.SFTConfig(**W.SFT_CFG), jparams)
    params = jax.tree.map(jax.device_put, jax.tree.map(jnp.copy, jparams), p_shard)
    opt = init_opt(params)
    bs = JS.batch_shardings(mesh, True)
    metrics = []
    for b in batches:
        jb = {k: (jax.device_put(v, bs[k]) if k != "vision_meta" else
                  {kk: jax.device_put(vv, bs[k][kk]) for kk, vv in v.items()}) for k, v in b.items()}
        params, opt, m = step(params, opt, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [np.asarray(x) for x in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def unsharded_sft(jparams):
    return _port_unsharded_sft(jparams, sft_batches())


def _close(a, b, what):
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("shape", SFT_SHAPES, ids=["data2", "fsdp2", "data2_fsdp2"])
def test_sharded_sft_step_equals_jax_sharded_step_and_the_unsharded_step(request, jparams, unsharded_sft, shape):
    """2 updates of 2 micro-steps (k = 2) with a clip that binds and data ranks that hold
    47 and 7 supervised tokens a row: each micro-step's loss, grad norm and tokens and
    every leaf after the last update (gathered from the shards) within 5e-5 of the JAX
    package's make_sharded_train_step on the same mesh shape and of the port's
    unsharded step; replicas and shards held by two ranks equal in bits after every
    update."""
    results = _sft_results(request, shape)
    jm, jleaves = _jax_sharded_sft(jparams, shape, sft_batches())
    um, uleaves = unsharded_sft
    ours = results[0]
    assert all(r["metrics"] == ours["metrics"] for r in results), "the ranks' metrics differ"
    assert min(m["grad_norm"] for m in ours["metrics"]) > W.SFT_CFG["max_grad_norm"]  # the clip binds
    for i, (m, j, u) in enumerate(zip(ours["metrics"], jm, um)):
        for k in ("loss", "grad_norm", "tokens"):
            _close(m[k], j[k], f"micro-step {i} {k} against JAX")
            _close(m[k], u[k], f"micro-step {i} {k} against the unsharded step")
    assert len(ours["params"]) == len(jleaves) == len(uleaves)
    for i, (a, b, c) in enumerate(zip(ours["params"], jleaves, uleaves)):
        _close(a, b, f"leaf {i} against JAX")
        _close(a, c, f"leaf {i} against the unsharded step")
    assert len(ours["digests"]) == 2
    for r in results[1:]:
        same_shards = r["coord"]["fsdp"] == ours["coord"]["fsdp"]
        for u in range(2):
            for leaf, (a, b, split) in enumerate(zip(r["digests"][u], ours["digests"][u], ours["sharded"])):
                if same_shards or not split:
                    assert a == b, f"update {u}: leaf {leaf} differs between rank 0 and a rank holding it too"


def test_unequal_token_counts_would_fail_a_mean_of_means(jparams):
    """The batch of the first micro-step gives the data ranks of a (2, ., .) mesh 94 and
    14 supervised tokens: the mean of their two means misses the whole batch's mean
    (what the sharded step and the JAX package compute) by far more than 5e-5."""
    b = TS.batch_to_device(sft_batches()[0], "cpu")
    params = _port_params(jparams)
    with torch.no_grad():
        logits, _ = vlm_forward(params, CFG, b["input_ids"], b["position_ids"], pixel_values=b["pixel_values"],
                                vision_meta=b["vision_meta"])
        whole, n = masked_ce_loss(logits, b["labels"])
        halves = [masked_ce_loss(logits[r], b["labels"][r]) for r in (slice(0, 2), slice(2, 4))]
    assert [int(h[1]) for h in halves] == [94, 14] and int(n) == 108
    assert abs(float(sum(h[0] for h in halves)) / 2 - float(whole)) > 1e-3


def _jax_rollout_of(jt, fields):
    jb = {k: jnp.asarray(fields[k]) for k in ("input_ids", "position_ids")}
    pv = jnp.asarray(fields["pixel_values"]) if fields["pixel_values"] is not None else None
    meta = {k: jnp.asarray(v) for k, v in fields["vision_meta"].items()} if fields["vision_meta"] else None
    args = (JCFG, jb["input_ids"], jb["position_ids"], pv, meta)
    f = dict(fields)
    f["old_logps"] = np.asarray(jt._logps_fn(jt.params, *args)) if jt.grpo.num_iterations > 1 else None
    f["ref_logps"] = np.asarray(jt._logps_fn(jt.ref_params, *args)) if jt.grpo.beta > 0 else None
    return JG.RolloutBatch(**f)


@pytest.mark.parametrize("case", GRPO_CASES, ids=["data2_two_prompts", "fsdp2_mixed", "data2_straddling_group",
                                                  "fsdp2_lora"])
def test_grpo_on_a_mesh_equals_the_jax_trainer_on_that_mesh(world2, workdir, jparams, case):
    """GRPOTrainer(mesh=) with G = 2, sampled: every rank stitches the same whole
    rollout; the JAX trainer on the same mesh shape, handed that rollout (it takes its
    own old and reference logps, which must equal the port's), gives the same loss and
    metrics to 5e-5 and the same parameters after each step; replicas equal in bits;
    with LoRA the bases bit for bit."""
    shape, kind, steps, lora = case
    name = f"grpo_{''.join(map(str, shape))}_{kind}{'_lora' if lora else ''}"
    results = _load(world2, name, 2)
    jt = workdir[1]["lora"] if lora else _jax_grpo_trainer(jparams, shape, False)
    js = [JSample(**f) for f in W.grpo_fields(kind)]
    ours = results[0]
    for s in range(steps):
        rb = ours["steps"][s]["rollout"]
        other = results[1]["steps"][s]
        assert other["metrics"] == ours["steps"][s]["metrics"]
        assert ours["steps"][s]["generator_on_shards"] and other["generator_on_shards"]
        for k, v in rb.items():
            o = other["rollout"][k]
            assert (np.array_equal(v, o) if isinstance(v, np.ndarray) else
                    all(np.array_equal(v[x], o[x]) for x in v) if isinstance(v, dict) else v == o), k
        assert np.abs(rb["advantages"]).max() > 0
        jt.rollout = lambda samples, seed, rb=rb: _jax_rollout_of(jt, rb)
        jm = jt.step(js, seed=s)
        got = jt._buffered
        for k in ("ref_logps", "old_logps"):
            if rb[k] is not None:
                _close(rb[k], getattr(got, k), f"step {s} {k}")
        tm = ours["steps"][s]["metrics"]
        assert tm.keys() == jm.keys()
        for k in tm:
            _close(tm[k], jm[k], f"step {s} {k}")
        same = ours["coord"]["fsdp"] == results[1]["coord"]["fsdp"]
        if same:
            assert other["digests"] == ours["steps"][s]["digests"]
    for i, (a, b) in enumerate(zip(ours["params"], jax.tree.leaves(jt.params))):
        _close(a, np.asarray(b), f"leaf {i}")
    if lora:
        start = torch.load(world2 / "lora_params.pt", weights_only=True)
        frozen = {id(t) for t in frozen_leaves(start)}
        for a, t in zip(ours["params"], tree_leaves(start)):
            if id(t) in frozen:
                assert np.array_equal(a, t.numpy())


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 1)], ids=["fsdp2", "data2"])
def test_train_sft_on_a_mesh_one_writer_resume_and_a_single_process_restore(world2, jparams, shape):
    """train_sft(mesh=): the history is the same on every rank; one writer (one metrics
    line a step, each save's callback fired once, on rank 0); a run resumed from the
    step-2 checkpoint on the mesh takes steps 3-4 to the uninterrupted run's losses and
    parameters bit for bit; the step-4 checkpoint (full values) restores in one
    process to the mesh's gathered parameters bit for bit, its optimizer state into a
    plain SFTOptimizer; and the losses equal an unsharded train_sft's to 5e-5."""
    tag = "".join(map(str, shape))
    results = _load(world2, f"loop{tag}", 2)
    keep = ("step", "loss", "grad_norm", "tokens", "input_tokens", "patches")

    def strip(hist):
        return [{k: r[k] for k in keep} for r in hist]

    assert all(r["history"] == results[0]["history"] for r in results)
    assert [r["step"] for r in results[0]["history"]] == [1, 2, 3, 4]
    lines = [json.loads(x) for x in open(world2 / f"loop{tag}_full" / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    calls = [json.loads(x) for x in open(world2 / f"loop{tag}_callbacks.jsonl")]
    assert [(c["rank"], c["step"]) for c in calls] == [(0, 2), (0, 4)]
    assert strip(results[0]["resumed_history"]) == strip(results[0]["history"][2:])
    assert all(r["resumed_equal"] for r in results)
    mgr = CheckpointManager(str(world2 / f"loop{tag}_full"))
    template = _port_params(jparams)
    restored, opt_state, meta = mgr.restore(4, template)
    assert meta["step"] == 4
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(tree_leaves(restored), results[0]["params"]))
    TL.make_trainable(restored)
    opt = TS.SFTOptimizer(restored, TS.SFTConfig(**W.SFT_CFG))
    opt.load_state_dict(opt_state)
    assert opt.updates == 2 and len(opt.adamw.state) == len(tree_leaves(restored))
    samples = [SFTSample(**W.sft_fields(i, i % 2 == 0)) for i in range(8)]
    _, plain = TL.train_sft(_port_params(jparams), CFG, TS.SFTConfig(**W.SFT_CFG),
                            TL.SFTLoopConfig(output_dir=str(world2 / f"plain{tag}"), num_train_epochs=1, batch_size=2,
                                             save_steps=100, log_steps=1, seed=3),
                            samples, W.processor(), device="cpu", image_loader=W.sft_loader(), max_steps=4)
    for a, b in zip(results[0]["history"], plain):
        for k in ("loss", "grad_norm"):
            _close(a[k], b[k], f"step {a['step']} {k}")
        assert a["tokens"] == b["tokens"]


def test_both_clis_train_as_two_processes_and_one_writes(workdir):
    """cli.train_sft with --num_processes 2 --coordinator_address --process_id --fsdp 2
    --device cpu, then cli.train_grpo from torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT, loading stubbed: both train over the two ranks, each loaded onto its
    own device, and the output directories hold one writer's files."""
    d, _ = workdir
    run_ranks(f"{WORKER}:cli", 2, {"workdir": str(d), "grpo_port": free_port()}, timeout_s=GROUP_TIMEOUT_S)
    results = _load(d, "cli", 2)
    assert all(r["sft_world"] == 2 and r["grpo_world"] == 2 for r in results)
    assert all(r["seen"] == [("ckpt", "cpu"), ("ckpt", "cpu")] for r in results)
    sft = [json.loads(x) for x in open(d / "cli_sft" / "metrics.jsonl")]
    assert [x["step"] for x in sft] == [1, 2] and all(np.isfinite(x["loss"]) for x in sft)
    assert CheckpointManager(str(d / "cli_sft")).latest() == 2
    grpo = [json.loads(x) for x in open(d / "cli_grpo" / "metrics.jsonl")]
    assert [x["step"] for x in grpo] == [1] and np.isfinite(grpo[0]["loss"])
    assert len((d / "cli_grpo" / "completions.jsonl").read_text().splitlines()) == 4
    assert CheckpointManager(str(d / "cli_grpo")).latest() == 1


def test_dryrun_multichip_4_prints_its_four_surfaces(capsys):
    """python -m zoomearth_tpu_torch.parallel.dryrun 4 --device cpu: the JAX package's
    factorization, a (1, 2, 2) mesh, one SFT step, one GRPO step, the engine tick and
    the pair wave over the gathered weights, whose greedy tokens equal a
    single-process run's."""
    lines = dryrun_multichip(4, device="cpu")
    assert lines[0] == "mesh: {'data': 1, 'fsdp': 2, 'tensor': 2}"
    heads = ["one SFT step OK", "one GRPO step OK", "engine prefill/decode tick OK", "pair-pipelined wave tick OK",
             "engine and pair-wave tokens equal a single-process run"]
    assert [h for h in heads for ln in lines[1:] if h in ln] == heads
    assert "params sharded over 4 ranks" in lines[2]
