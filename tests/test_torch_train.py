"""The port's SFT training path against the JAX package on the CPU, at the tiny config
in fp32: masked_ce_loss, the schedule, collate_sft, one train step (the loss, every
gradient leaf, grad_norm) and the parameters after several updates with and without
gradient accumulation, the loop with its metrics, checkpoint and resume, the HF
export, the save callbacks and the CLI.

Activations, gradients and parameters are held to atol 5e-5 (the repo's parity bar);
integer and host outputs (the collated batch, the schedule, the export's keys and
values) to exact equality. The JAX side's jitted step is compiled once per optimizer
and shared through module fixtures.
"""

import dataclasses
import io
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent.processor import Processor as JProcessor
from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.eval.benchmarks import build_job as jax_build_job
from zoomearth_tpu.models.params import export_hf_state_dict as jax_export
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.models.vlm import masked_ce_loss as jax_masked_ce_loss
from zoomearth_tpu.tokenizer import FakeTokenizer as JFakeTokenizer
from zoomearth_tpu.train import sft as JS
from zoomearth_tpu.train import sft_loop as JL
from zoomearth_tpu.train.data import SFTSample as JSFTSample
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.cli import train_sft as CLI
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import (export_hf_state_dict, hf_config_dict, load_hf_checkpoint, map_tree,
                                               params_from_numpy, save_hf_checkpoint, tree_leaves)
from zoomearth_tpu_torch.models.vlm import masked_ce_loss
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.train import callbacks as TCB
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL
from zoomearth_tpu_torch.train.checkpoints import CheckpointManager
from zoomearth_tpu_torch.train.data import SFTSample

import torch_parallel_worker as W  # noqa: E402  (tests/ is on sys.path under pytest)

torch.set_num_threads(1)
CFG, JCFG = VLMConfig.tiny(), JVLMConfig.tiny()
ATOL = 5e-5
MAX_PIXELS = 4 * 28 * 28
BUCKETS = {"length_buckets": (1536,), "patch_buckets": (64,)}


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _fields(i, cut):
    return dict(question=f"what is at site {i}?", cut=cut, global_desc="An aerial scene.",
                stage_1_reasoning="I should look closer." if cut else "The whole image suffices.",
                area="top-left", bbox=[50, 60, 200, 220] if cut else [], stage_2_reasoning="It is a car.",
                ground_truth="car", image_name=f"img{i}.png")


def _samples(n, cut_every=2):
    """(port samples, JAX samples): the same fields, cut on every cut_every-th."""
    f = [_fields(i, i % cut_every == 0) for i in range(n)]
    return [SFTSample(**x) for x in f], [JSFTSample(**x) for x in f]


def _loader(seed=0):
    """Seeded full-resolution images, one per sample name (the same for both packages)."""
    cache = {}

    def load(s):
        if s.image_name not in cache:
            rng = np.random.default_rng(seed + len(cache))
            cache[s.image_name] = Image.fromarray(rng.integers(0, 255, (700, 650, 3), dtype=np.uint8))
        return cache[s.image_name]

    return load


def _processors():
    return (Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=MAX_PIXELS),
            JProcessor(JFakeTokenizer(JCFG.tokens), JCFG, max_pixels=MAX_PIXELS))


def _jax_params():
    return jax_init(jax.random.key(0), JCFG)


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _batches():
    """Two collated batches of one sample each (a cut one, an uncut one), both
    packages' collate on the same inputs; the shapes are the same (one bucket each)."""
    tp, jp = _processors()
    ts, js = _samples(2)
    out = []
    for i in range(2):
        tl, jl = _loader(i), _loader(i)
        out.append((TL.collate_sft([ts[i]], tp, image_loader=tl, **BUCKETS),
                    JL.collate_sft([js[i]], jp, image_loader=jl, **BUCKETS)))
    return out


def _assert_trees_close(port_leaves, jax_leaves, atol=ATOL, what="leaf"):
    assert len(port_leaves) == len(jax_leaves)
    for i, (a, b) in enumerate(zip(port_leaves, jax_leaves)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (what, i)
        np.testing.assert_allclose(a.detach().numpy(), b, atol=atol, rtol=0, err_msg=f"{what} {i}")


# ---------------------------------------------------------------------------
# loss, schedule, collate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_masked_ce_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, S, V = 3, 17, 29
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.4] = -100
    labels[1] = -100  # a row with nothing supervised
    loss, n = masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    jloss, jn = jax_masked_ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    # nothing supervised at all: loss 0, count 0 (the divisor is at least 1)
    loss0, n0 = masked_ce_loss(torch.from_numpy(logits), torch.full((B, S), -100))
    assert float(loss0) == 0.0 and int(n0) == 0


@pytest.mark.parametrize("kw", [dict(learning_rate=3e-5, warmup_steps=100, total_steps=1000),
                                dict(learning_rate=1e-3, warmup_steps=1, total_steps=5),
                                dict(learning_rate=2e-4, warmup_steps=0, total_steps=None),
                                dict(learning_rate=1e-4, warmup_steps=7, total_steps=3)])
def test_schedule_equals_optax(kw):
    """Warmup from 0 then linear decay to 0: the port's float32 arithmetic gives
    optax's values bit for bit at every count, past the horizon too."""
    ours, theirs = TS.make_schedule(TS.SFTConfig(**kw)), JS.make_schedule(JS.SFTConfig(**kw))
    counts = list(range(0, 120)) + [999, 1000, 1001, 1500, 10_000, 10_001]
    assert [ours(c) for c in counts] == [float(theirs(c)) for c in counts]


@pytest.mark.parametrize("batch_size,cut_every", [(1, 1), (1, 3), (3, 2)])
def test_collate_sft_equals_jax(batch_size, cut_every):
    """Cut and uncut samples, one or three to a batch, default buckets: every array
    of the batch equal, the vision metadata too."""
    tp, jp = _processors()
    ts, js = _samples(batch_size, cut_every)
    ours = TL.collate_sft(ts, tp, image_loader=_loader(3))
    theirs = JL.collate_sft(js, jp, image_loader=_loader(3))
    assert ours.keys() == theirs.keys() and ours["vision_meta"].keys() == theirs["vision_meta"].keys()
    for k in ours:
        pairs = [(ours[k][m], theirs[k][m]) for m in ours[k]] if k == "vision_meta" else [(ours[k], theirs[k])]
        for a, b in pairs:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert TL.sft_prompt("what?") == JL.sft_prompt("what?") and TL.SFT_TASK_INSTRUCTION == JL.SFT_TASK_INSTRUCTION
    assert [TL.sft_label(s) for s in ts] == [JL.sft_label(s) for s in js]


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """The batches, the JAX params and the JAX runs both step tests compare with:
    k = 2 over four micro-steps (its first micro-step's accumulator is that step's
    gradient, leaf for leaf) and k = 1 over three updates."""
    batches = _batches()
    jparams = _jax_params()
    runs = {}
    for k, n in ((2, 4), (1, 3)):
        cfg = JS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10, weight_decay=0.01,
                           max_grad_norm=1.0, gradient_accumulation_steps=k)
        tx = JS.make_optimizer(cfg)
        step = jax.jit(partial(JS.train_step, cfg=JCFG, tx=tx))
        p, st, metrics = jparams, tx.init(jparams), []
        first_grads = None
        for i in range(n):
            p, st, m = step(p, st, batches[i % 2][1])
            metrics.append({key: float(v) for key, v in m.items()})
            if k == 2 and i == 0:
                first_grads = [np.asarray(g) for g in jax.tree.leaves(st.acc_grads)]
        runs[k] = {"cfg": cfg, "params": [np.asarray(x) for x in jax.tree.leaves(p)], "metrics": metrics,
                   "first_grads": first_grads}
    return batches, jparams, runs


def test_loss_and_every_gradient_leaf_match_jax(step_case):
    batches, jparams, runs = step_case
    params = _port_params(jparams)
    TL.make_trainable(params)
    batch = TS.batch_to_device(batches[0][0], "cpu")
    loss, n = TS.sft_loss(params, CFG, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params), materialize_grads=True)
    ref = runs[2]["metrics"][0]
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], atol=ATOL, rtol=0)
    assert int(n) == ref["tokens"]
    _assert_trees_close(grads, runs[2]["first_grads"], what="gradient leaf")
    np.testing.assert_allclose(float(TS.global_norm(grads)), ref["grad_norm"], atol=ATOL, rtol=0)
    # every leaf gets a gradient, and the attention projections' are not zero (the kernels' outputs are not
    # cut off from the graph)
    assert len(grads) == len(jax.tree.leaves(jparams))
    vit0, dec0 = params["vision"]["blocks"][0]["attn"]["wqkv"], params["text"]["layers"][0]["attn"]
    leaves = tree_leaves(params)
    for w in (vit0, dec0["wq"], dec0["wk"], dec0["wv"]):
        assert float(grads[next(i for i, x in enumerate(leaves) if x is w)].abs().sum()) > 0


@pytest.mark.parametrize("k,n_micro", [(1, 3), (2, 4)])
def test_train_steps_match_jax(step_case, k, n_micro):
    """The metrics of every micro-step and the parameters after 3 updates (k = 1) or
    2 updates of 2 micro-steps each (k = 2) equal the JAX package's to 5e-5."""
    batches, jparams, runs = step_case
    run = runs[k]
    params = _port_params(jparams)
    TL.make_trainable(params)
    opt = TS.make_optimizer(params, TS.SFTConfig(**dataclasses.asdict(run["cfg"])))
    for i in range(n_micro):
        m = TS.train_step(params, opt, TS.batch_to_device(batches[i % 2][0], "cpu"), cfg=CFG)
        ref = run["metrics"][i]
        np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])], [ref["loss"], ref["grad_norm"]],
                                   atol=ATOL, rtol=0)
        assert int(m["tokens"]) == ref["tokens"]
    assert opt.updates == n_micro // k and opt.mini_step == 0
    _assert_trees_close(tree_leaves(params), run["params"], what="parameter leaf")


def test_optimizer_state_round_trips_mid_accumulation(step_case):
    """A resume in the middle of an accumulation continues exactly: the state dict,
    through a file as a checkpoint takes it (a live state dict shares the optimizer's
    tensors, as torch's own do), holds AdamW's moments, the update count, the
    micro-step and the running mean."""
    batches, jparams, runs = step_case
    cfg = TS.SFTConfig(**dataclasses.asdict(runs[2]["cfg"]))
    p1 = _port_params(jparams)
    TL.make_trainable(p1)
    o1 = TS.make_optimizer(p1, cfg)
    for i in range(3):
        TS.train_step(p1, o1, TS.batch_to_device(batches[i % 2][0], "cpu"), cfg=CFG)
    buf = io.BytesIO()
    torch.save(o1.state_dict(), buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    assert state["mini_step"] == 1 and state["updates"] == 1 and len(state["acc"]) == len(o1.params)
    p2 = map_tree(lambda t: t.detach().clone(), p1)
    TL.make_trainable(p2)
    o2 = TS.make_optimizer(p2, cfg)
    o2.load_state_dict(state)
    for p, o in ((p1, o1), (p2, o2)):
        TS.train_step(p, o, TS.batch_to_device(batches[1][0], "cpu"), cfg=CFG)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    _assert_trees_close(tree_leaves(p2), runs[2]["params"], what="parameter leaf")


def test_make_trainable_refuses_inference_tensors():
    with torch.inference_mode():
        params = {"w": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="inference_mode"):
        TL.make_trainable(params)


# ---------------------------------------------------------------------------
# the loop: loss falls, metrics, checkpoint and resume (after tests/test_sft.py)
# ---------------------------------------------------------------------------

def test_train_sft_loss_decreases_checkpoints_and_resumes(tmp_path):
    tp, _ = _processors()
    data, _ = _samples(4)
    params = _port_params(_jax_params())
    sft_cfg = TS.SFTConfig(learning_rate=1e-3, warmup_steps=1, max_grad_norm=1.0)
    out = str(tmp_path / "out")
    loop_cfg = TL.SFTLoopConfig(output_dir=out, num_train_epochs=50, batch_size=1, save_steps=4, log_steps=1)
    seen = []
    new_params, hist = TL.train_sft(params, CFG, sft_cfg, loop_cfg, data, tp, device="cpu",
                                    image_loader=_loader(), max_steps=8,
                                    on_grads=lambda step, grads: seen.append((step, len(grads))))
    assert new_params is params and len(hist) == 8
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["grad_norm"])
    assert seen == [(step, len(tree_leaves(params))) for step in range(1, 9)]
    assert all(r["step_s"] > 0 and r["input_tokens"] > 0 and r["patches"] > 0 for r in hist)
    lines = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in lines] == list(range(1, 9))
    info = json.load(open(os.path.join(out, "training_info.json")))
    assert info["step"] == 8 and CheckpointManager(out).latest() == 8
    assert sorted(os.listdir(os.path.join(out, "checkpoint-4"))) == ["meta.json", "opt_state.pt", "params.pt"]

    # resume: fast-forwards past step 8 and carries on from the saved parameters and optimizer
    params2 = _port_params(_jax_params())
    loop_cfg2 = dataclasses.replace(loop_cfg, save_steps=100, resume_from_checkpoint=True)
    resumed, hist2 = TL.train_sft(params2, CFG, sft_cfg, loop_cfg2, data, tp, device="cpu",
                                  image_loader=_loader(), max_steps=2)
    assert hist2[0]["step"] == 9 and hist2[-1]["loss"] < hist[0]["loss"]
    assert resumed is not params2  # the restored tree


def test_checkpoint_restore_onto_the_templates_device_and_dtype(tmp_path):
    params = _port_params(_jax_params())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, {"updates": 1}, extra={"epoch": 0})
    template = map_tree(lambda t: torch.zeros_like(t, dtype=torch.bfloat16), params)
    restored, opt_state, meta = mgr.restore(3, template)
    assert meta["step"] == 3 and meta["epoch"] == 0 and opt_state == {"updates": 1}
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    assert mgr.restore(3, template, load_opt_state=False)[1] is None
    with pytest.raises(ValueError, match="template"):
        mgr.restore(3, {"vision": template["vision"]})


def test_train_sft_refuses_parameters_off_its_device():
    tp, _ = _processors()
    params = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="must be on"):
        TL.train_sft(params, CFG, TS.SFTConfig(), TL.SFTLoopConfig(), [], tp, device="meta")


# ---------------------------------------------------------------------------
# HF export, callbacks, CLI
# ---------------------------------------------------------------------------

def test_hf_export_equals_jax_key_for_key_and_round_trips(tmp_path):
    jparams = _jax_params()
    params = _port_params(jparams)
    ours, theirs = export_hf_state_dict(params, CFG), jax_export(jparams, JCFG)
    assert list(ours) == list(theirs)
    for key in ours:
        assert ours[key].dtype == torch.float32 and np.array_equal(ours[key].numpy(), theirs[key]), key
    path = save_hf_checkpoint(params, CFG, str(tmp_path / "hf"))
    assert VLMConfig.from_hf_dir(path).text == CFG.text
    back = load_hf_checkpoint(path, CFG, dtype="float32")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))


def test_save_callbacks_export_and_queue_the_ports_eval(tmp_path):
    params = _port_params(_jax_params())
    exp = TCB.ExportHFCallback(export_dir=str(tmp_path / "hub"), cfg=CFG, revision="r1")
    bench = TCB.BenchmarkCallback(output_dir=str(tmp_path / "jobs"), data_file="d.jsonl", image_folder="imgs")
    TCB.run_callbacks([exp, bench], 50, str(tmp_path / "checkpoint-50"), params)
    out = tmp_path / "hub" / "r1-step000050"
    assert out.is_dir() and any(f.suffix == ".safetensors" for f in out.iterdir())
    jobs = [json.loads(line) for line in (tmp_path / "jobs" / "benchmark_jobs.jsonl").read_text().splitlines()]
    ref_job = jax_build_job("lrs_gro", str(tmp_path / "checkpoint-50"), step=50, out_dir=str(tmp_path / "jobs"),
                            data_file="d.jsonl", image_folder="imgs")
    assert jobs[0]["step"] == 50 and jobs[0]["checkpoint"] == ref_job["checkpoint"]
    for key in ("cmd", "score_cmd"):
        assert jobs[0][key] == [a.replace("zoomearth_tpu.", "zoomearth_tpu_torch.") for a in ref_job[key]]
    with pytest.raises(ValueError, match="unknown benchmark"):
        TCB.BenchmarkCallback(output_dir=str(tmp_path), benchmarks=("nope",)).on_save(1, "c")


_CLI_BASE = ["--model_name", "m", "--dataset_name_train", "d.jsonl", "--img_folder", "i", "--device", "cpu"]


@pytest.mark.parametrize("extra,env", [(["--fsdp", "2"], None), (["--tensor", "3"], None),
                                       (["--num_processes", "2"], None),
                                       (["--coordinator_address", "localhost:1234", "--num_processes", "2",
                                         "--process_id", "0"], None), ([], "2")])
def test_cli_refuses_mesh_flags_and_multi_process_launches(monkeypatch, tmp_path, extra, env):
    """--tensor 3 is refused, naming the head counts of the model's config.json (the
    tiny config's 4 query heads do not split 3 ways); --fsdp 2 in a world of one
    process fails on the mesh's size, as the JAX package's make_mesh does; a
    multi-process launch (--num_processes with torchrun's RANK and MASTER_ADDR, the
    JAX CLI's three flags, or WORLD_SIZE) reaches the rendezvous with the arguments it
    gave, over gloo for --device cpu. Nothing is loaded before."""
    if extra[:1] in (["--fsdp"], ["--tensor"]):
        monkeypatch.setattr(CLI, "load_model_and_processor", lambda *a, **k: pytest.fail("loaded"))
        for k in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK"):
            monkeypatch.delenv(k, raising=False)
        if extra[0] == "--tensor":
            model = tmp_path / "m"
            model.mkdir()
            (model / "config.json").write_text(json.dumps(hf_config_dict(CFG)))
            argv = [str(model) if a == "m" else a for a in _CLI_BASE]
            with pytest.raises(SystemExit, match=r"--tensor 3: a tensor axis of 3 does not divide the head counts "
                                                 r"\(decoder num_attention_heads 4, decoder num_key_value_heads 2"):
                CLI.main(argv + extra)
        else:
            with pytest.raises(ValueError, match=r"1 ranks not divisible by fsdp\*tensor=2"):
                CLI.main(_CLI_BASE + extra)
        return
    backend, init_method, world, rank = W.reach_rendezvous(monkeypatch, CLI, _CLI_BASE + extra, env)
    address = "localhost:1234" if "--coordinator_address" in extra else "127.0.0.1:29512"
    assert (backend, init_method, world, rank) == ("gloo", f"tcp://{address}", 2, 0 if "--process_id" in extra else 1)


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    """python -m zoomearth_tpu_torch.cli.train_sft --device cpu over a jsonl and an
    image folder, the checkpoint loading stubbed (no HF checkpoint on disk)."""
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rows = []
    for i in range(2):
        f = _fields(i, i == 0)
        np_img = np.random.default_rng(i).integers(0, 255, (300, 280, 3), dtype=np.uint8)
        Image.fromarray(np_img).save(imgs / f["image_name"])
        rows.append({"question": f["question"], "cut": f["cut"], "global": f["global_desc"],
                     "stage_1_reasoning": f["stage_1_reasoning"], "area": f["area"], "bbox": f["bbox"],
                     "stage_2_reasoning": f["stage_2_reasoning"], "ground_truth": f["ground_truth"],
                     "image_name": f["image_name"]})
    data = tmp_path / "sft.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    seen = {}

    def load(path, *, max_pixels=None, device=None, **kw):
        seen.update(path=path, max_pixels=max_pixels, device=device)
        return _port_params(_jax_params()), CFG, Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=max_pixels)

    monkeypatch.setattr(CLI, "load_model_and_processor", load)
    out = tmp_path / "out"
    CLI.main(["--model_name", "ckpt", "--dataset_name_train", str(data), "--img_folder", str(imgs),
              "--output_dir", str(out), "--num_train_epochs", "1", "--batch_size", "1",
              "--gradient_accumulation_steps", "2", "--save_steps", "2", "--log_steps", "1",
              "--max_pixels", str(MAX_PIXELS), "--device", "cpu"])
    assert seen == {"path": "ckpt", "max_pixels": MAX_PIXELS, "device": "cpu"}
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [1, 2] and all(np.isfinite(r["loss"]) for r in lines)
    assert CheckpointManager(str(out)).latest() == 2
