"""The port's parallel layer in one process, against the JAX package: the sharding
rules spec for spec (the tiny tree, the 3B tree's shapes, LoRA trees; meshes (2,2,2),
(1,2,1), (4,2,1), (2,1,1), (1,1,8), with the fall-back to replicated where a
dimension does not divide), make_mesh's checks and their sizes, batch_shardings,
slicing and putting, initialize's single-process no-op and its refusals, the sharded
step and GRPOTrainer(mesh=) on a one-rank mesh against the unsharded ones, and the
flagship entry point's shapes. The multi-process checks are
tests/test_torch_parallel_procs.py."""

import jax
import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.parallel import mesh as JM
from zoomearth_tpu.train import lora as JLORA
from zoomearth_tpu.train import sft as JS
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import init_vlm_params, params_from_numpy, tree_leaves
from zoomearth_tpu_torch.parallel import mesh as TM
from zoomearth_tpu_torch.parallel import multihost as TH
from zoomearth_tpu_torch.parallel.dryrun import build_parser as dryrun_parser
from zoomearth_tpu_torch.parallel.dryrun import dryrun_multichip, entry, example_inputs
from zoomearth_tpu_torch.train import grpo as TG
from zoomearth_tpu_torch.train import lora as TLORA
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL

import torch_parallel_worker as W  # noqa: E402  (tests/ is on sys.path under pytest)

torch.set_num_threads(1)
CFG, JCFG = VLMConfig.tiny(), JVLMConfig.tiny()
MESHES = [(2, 2, 2), (1, 2, 1), (4, 2, 1), (2, 1, 1), (1, 1, 8)]


def _jax_specs(tree, shape):
    mesh = JM.make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])
    flat, _ = jax.tree_util.tree_flatten_with_path(JM.param_shardings(tree, mesh))
    return {JM._path_str(path): tuple(s.spec) for path, s in flat}


def _port_specs_by_path(tree, shape):
    specs = TM.param_shardings(tree, TM.make_mesh(*shape, world_size=int(np.prod(shape))))
    out = {}
    TM.map_with_path(lambda path, leaf: out.__setitem__(path, None), tree)
    paths = list(out)
    leaves = []
    TM.map_with_spec(lambda leaf, spec: leaves.append(spec), tree, specs)
    return dict(zip(paths, leaves))


@pytest.fixture(scope="module")
def trees():
    """(port tree, JAX tree) pairs: the tiny config, its LoRA form, and the 3B config's
    shapes (jax.eval_shape; the port's on the meta device: nothing is allocated)."""
    jt = jax_init(jax.random.key(0), JCFG)
    tt = params_from_numpy(jax.tree.map(np.asarray, jt))
    jl = JLORA.apply_lora(jt, jax.random.key(1), r=4)
    tl = TLORA.apply_lora(tt, torch.Generator().manual_seed(0), r=4)
    cfg3 = JVLMConfig.qwen2_5_vl_3b()
    j3 = jax.eval_shape(lambda: jax_init(jax.random.key(0), cfg3))
    with torch.device("meta"):
        t3 = init_vlm_params(VLMConfig.qwen2_5_vl_3b(), generator=torch.Generator(), device="meta")
    return {"tiny": (tt, jt), "tiny_lora": (tl, jl), "3b": (t3, j3)}


@pytest.mark.parametrize("tree", ["tiny", "tiny_lora", "3b"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_param_shardings_equal_the_jax_rules_spec_for_spec(trees, tree, shape):
    tt, jt = trees[tree]
    ours, theirs = _port_specs_by_path(tt, shape), _jax_specs(jt, shape)
    assert ours == theirs
    assert len(ours) == len(tree_leaves(tt))
    if shape == (1, 1, 8):
        # a dimension that does not split 8 ways falls back to replicated, as the JAX rules do
        fell_back = [p for p, s in ours.items() if s == () and not p.endswith(("scale", "bias", "/s"))]
        assert fell_back, ours


def test_make_mesh_checks_and_messages_match_the_reference():
    for kw, n in [(dict(fsdp=3), 8), (dict(data=3, fsdp=2), 8), (dict(fsdp=2, tensor=2), 6)]:
        with pytest.raises(AssertionError) as theirs:
            JM.make_mesh(**kw, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as ours:
            TM.make_mesh(**kw, world_size=n)
        assert str(ours.value).replace(" ranks", "") == str(theirs.value).replace(" devices", "")
    m = TM.make_mesh(fsdp=2, world_size=8)
    assert m.shape == dict(JM.make_mesh(fsdp=2, devices=jax.devices()).shape) == {"data": 4, "fsdp": 2, "tensor": 1}
    with pytest.raises(RuntimeError, match="did not join"):
        m.group("fsdp")
    assert TM.make_mesh().shape == {"data": 1, "fsdp": 1, "tensor": 1} and TM.make_mesh().group("data") is None


def test_mesh_coordinates_are_row_major():
    coords = [TM.Mesh(2, 2, 2, rank=r).coordinate for r in range(8)]
    assert [(c["data"], c["fsdp"], c["tensor"]) for c in coords] == [
        (d, f, t) for d in range(2) for f in range(2) for t in range(2)]
    assert TM.split(("fsdp", "tensor"), TM.Mesh(2, 2, 2, rank=3)) == (4, 3)


def test_batch_shardings_and_data_sharding_equal_the_reference():
    for shape in [(2, 1, 1), (2, 2, 2)]:
        jmesh = JM.make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])
        mesh = TM.make_mesh(*shape, world_size=int(np.prod(shape)))
        for vision in (True, False):
            for patches in (True, False):
                theirs = JS.batch_shardings(jmesh, vision, patches)
                ours = TS.batch_shardings(mesh, vision, patches)
                assert ours.keys() == theirs.keys()
                for k, v in theirs.items():
                    if k == "vision_meta":
                        assert {kk: tuple(vv.spec) for kk, vv in v.items()} == ours[k]
                    else:
                        assert tuple(v.spec) == ours[k], k
        assert tuple(JM.data_sharding(jmesh).spec) == TM.data_sharding(mesh)


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 2, 2), (2, 1, 1)])
def test_local_slices_put_back_the_full_value(shape):
    """Every rank's slices (shard_params, global_put) tile each leaf exactly once; a
    replicated leaf stays the same tensor."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(0), JCFG)))
    n = int(np.prod(shape))
    meshes = [TM.Mesh(*shape, rank=r) for r in range(n)]
    specs = TM.param_shardings(params, meshes[0])
    shards = [TM.shard_params(params, m) for m in meshes]
    for i, (full, spec) in enumerate(zip(tree_leaves(params), TM.spec_leaves(params, specs))):
        pieces = [tree_leaves(s)[i] for s in shards]
        if not TM.is_sharded(spec, meshes[0]):
            assert all(p is full for p in pieces)
            continue
        cover = torch.zeros(full.shape)
        for m, p in zip(meshes, pieces):
            index = []
            for dim, entry in enumerate(spec):
                k, j = TM.split(entry, m)
                size = full.shape[dim]
                if "tensor" in TM._axes(entry) and isinstance(spec, TM.QKVSpec):
                    # the fused [3][H][D] q|k|v: this rank's heads of q, k and v (the head-aligned layout)
                    third = size // 3
                    index.append(torch.cat([torch.arange(g * third + j * third // k, g * third + (j + 1) * third // k)
                                            for g in range(3)]))
                else:
                    index.append(torch.arange(j * size // k, (j + 1) * size // k))
            index = torch.meshgrid(*index, indexing="ij")
            assert torch.equal(full[index], p)
            cover[index] += 1
        reps = n // int(np.prod([TM.split(e, meshes[0])[0] for e in spec]))
        assert torch.all(cover == reps)
    batch = {"input_ids": np.arange(8 * 3).reshape(8, 3), "position_ids": np.arange(3 * 8 * 3).reshape(3, 8, 3)}
    bspecs = {"input_ids": ("data", None), "position_ids": (None, "data", None)}
    got = [TH.global_put(batch, bspecs, m) for m in meshes]
    D = shape[0]
    for m, g in zip(meshes, got):
        d = m.coordinate["data"]
        assert np.array_equal(g["input_ids"], batch["input_ids"][d * 8 // D:(d + 1) * 8 // D])
        assert np.array_equal(g["position_ids"], batch["position_ids"][:, d * 8 // D:(d + 1) * 8 // D])


def test_initialize_is_a_no_op_alone_and_refuses_half_a_launch(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert TH.initialize() is False and TH.initialize(num_processes=1) is False
    assert TH.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    with pytest.raises(ValueError, match="coordinator address"):
        TH.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        TH.initialize("127.0.0.1:1", device="cpu")
    assert TH.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TH.rank_device(None)
    with pytest.raises(ValueError, match="exceeds local devices"):
        TH.make_global_mesh(fsdp=2)


def _sft_batch():
    ids, pos, pv, meta = example_inputs(CFG, batch=2, seq=128, grid=(1, 8, 8), patch_bucket=0)
    labels = np.where(ids == CFG.tokens.pad, -100, ids).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "position_ids": pos, "pixel_values": pv, "vision_meta": meta}


def test_sharded_step_on_one_rank_is_the_unsharded_step_bit_for_bit():
    """A mesh of one rank (no process group) runs make_sharded_train_step without a
    collective: two updates of two micro-steps give the unsharded step's losses, norms
    and parameters in bits (the chip smoke's nccl world of one relies on it)."""
    jparams = jax_init(jax.random.key(0), JCFG)
    cfg = TS.SFTConfig(**W.SFT_CFG)
    plain = params_from_numpy(jax.tree.map(np.asarray, jparams))
    TL.make_trainable(plain)
    opt = TS.SFTOptimizer(plain, cfg)
    mesh = TM.make_mesh()
    step, specs, init_opt = TS.make_sharded_train_step(mesh, CFG, cfg, plain)
    shards = TM.shard_params(params_from_numpy(jax.tree.map(np.asarray, jparams)), mesh)
    sopt = init_opt(shards)
    for i in range(4):
        b = _sft_batch()
        b["pixel_values"] = b["pixel_values"] + i
        a = TS.train_step(plain, opt, TS.batch_to_device(b, "cpu"), cfg=CFG)
        local = TS.shard_batch(b, mesh, TS.batch_shardings(mesh, True, patch_shardable=False), CFG.tokens.image_pad)
        s = step(shards, sopt, TS.batch_to_device(local, "cpu"))
        assert all(torch.equal(a[k], s[k]) for k in a), (a, s)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(plain), tree_leaves(shards)))
    assert sopt.state_dict()["updates"] == 2


def test_the_sharded_step_takes_whole_patches():
    """Every rank collates the whole batch and the ViT packs all its images in one
    sequence, so shard_batch refuses the layout that splits the patches on `data`."""
    mesh = TM.make_mesh(2, 1, 1, world_size=2)
    with pytest.raises(ValueError, match="whole patches"):
        TS.shard_batch(_sft_batch(), mesh, TS.batch_shardings(mesh, True), CFG.tokens.image_pad)
    local = TS.shard_batch(_sft_batch(), mesh, TS.batch_shardings(mesh, True, patch_shardable=False),
                           CFG.tokens.image_pad)
    assert local["pixel_values"].shape == _sft_batch()["pixel_values"].shape and local["input_ids"].shape[0] == 1


def test_dryrun_takes_the_card_unless_the_cpu_is_named():
    """The dryrun's ranks run on their CUDA devices by default: without one, and with
    none named, it raises before any rank starts."""
    assert dryrun_parser().parse_args(["4"]).device is None
    assert dryrun_parser().parse_args(["4", "--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)


def test_tensor_axis_is_refused_with_the_roadmap_item():
    """A tensor axis that does not divide the head counts is refused on the host with
    the counts named: tensor 3 over a world of 3 at the tiny config, whose decoder has
    4 query and 2 key/value heads."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(0), JCFG)))
    mesh = TM.make_mesh(tensor=3, world_size=3)
    counts = (r"a tensor axis of 3 does not divide the head counts \(decoder num_attention_heads 4, decoder "
              r"num_key_value_heads 2, ViT num_heads 4\)")
    with pytest.raises(ValueError, match=counts):
        TL.train_sft(params, CFG, TS.SFTConfig(), TL.SFTLoopConfig(), [], W.processor(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match=counts):
        TG.GRPOTrainer(params, CFG, TG.GRPOConfig(), W.processor(), [], device="cpu", mesh=mesh)


def test_grpo_on_a_one_rank_mesh_equals_the_unsharded_trainer():
    """GRPOTrainer(mesh=) over one rank: the same rollout and, through the row-share
    loss (rows=N), the same metrics and parameters as the unsharded trainer to 5e-5."""
    jparams = jax_init(jax.random.key(0), JCFG)
    samples = [TG.LRSGROSample(**f) for f in W.grpo_fields("img")]
    runs = []
    for mesh in (None, TM.make_mesh()):
        t = TG.GRPOTrainer(params_from_numpy(jax.tree.map(np.asarray, jparams)), CFG, TG.GRPOConfig(**W.GRPO_KW),
                           W.processor(), [W.length_reward], reward_names=["length"], image_loader=W.grpo_loader(),
                           prompt_fn=W.short_prompt, device="cpu", mesh=mesh, **W.TRAINER_KW)
        runs.append((t.step(samples, seed=0), t._buffered, [x.detach().clone() for x in tree_leaves(t.params)]))
    (m0, rb0, p0), (m1, rb1, p1) = runs
    assert np.array_equal(rb0.input_ids, rb1.input_ids) and np.array_equal(rb0.advantages, rb1.advantages)
    assert m0.keys() == m1.keys()
    for k in m0:
        np.testing.assert_allclose(m0[k], m1[k], atol=5e-5, rtol=0, err_msg=k)
    for a, b in zip(p0, p1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=0)


def test_entry_gives_the_flagship_forward_on_the_meta_device():
    fn, (params, ids, pos, pv, meta) = entry()
    n = sum(int(t.numel()) for t in tree_leaves(params))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jax.eval_shape(lambda: jax_init(jax.random.key(0), JVLMConfig.qwen2_5_vl_3b()))))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in tree_leaves(params))
    assert ids.shape == (1, 512) and pos.shape == (3, 1, 512) and pv.shape[0] == 1024 and callable(fn)
