"""The port's tensor axis in one process, and its three hazards on a group of two
ranks: the head-aligned layout of the ViT's fused q|k|v (every rule's pieces put back
into the JAX layout bit for bit, at the tiny config and at the 3B tree's shapes), the
refusal of a tensor axis that does not divide the head counts, Megatron's f and g on
a world of one, and on a (1, 1, 2) mesh of gloo ranks (tests/torch_tensor_worker.py)
the row-split biases added once, the replicated column biases' whole gradients, and
LoRA's mixed blocks (the decoder whole, the ViT and merger split), each held to the
one-device forward and backward at 5e-5. The training paths over tensor meshes
against the JAX package are tests/test_torch_tensor_procs.py."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.parallel import mesh as JM
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import init_vlm_params, params_from_numpy, tree_leaves
from zoomearth_tpu_torch.parallel import collectives as TC
from zoomearth_tpu_torch.parallel import mesh as TM
from zoomearth_tpu_torch.parallel.dryrun import example_inputs
from zoomearth_tpu_torch.parallel.launch import free_port, run_ranks
from zoomearth_tpu_torch.train import grpo as TG
from zoomearth_tpu_torch.train import lora as TLORA
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train import sft_loop as TL

import torch_parallel_worker as W  # noqa: E402  (tests/ is on sys.path under pytest)

torch.set_num_threads(1)
CFG, JCFG = VLMConfig.tiny(), JVLMConfig.tiny()
ATOL = 5e-5
WIDE_MLP = 66  # a ViT MLP width that does not split 4 ways
WIDE_CFG = dataclasses.replace(CFG, vision=dataclasses.replace(CFG.vision, intermediate_size=WIDE_MLP))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tensor_worker.py")
LAYOUT_MESHES = [(1, 1, 2), (2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4), (1, 2, 4)]


def _pieces_to_full(pieces, spec, meshes):
    """The full value from every rank's piece, as gather_params joins them: along each
    split dimension, the pieces of the ranks that differ only in that axis,
    concatenated in index order and joined (mesh.join_pieces)."""
    out = {tuple(m.coordinate.values()): p for m, p in zip(meshes, pieces)}
    shape = meshes[0].shape
    for dim, axis in TC.split_dims(spec, meshes[0]):
        k = list(TM.AXES).index(axis)
        merged = {}
        for coord in out:
            if coord[k] == 0:
                parts = [out[coord[:k] + (i,) + coord[k + 1:]] for i in range(shape[axis])]
                merged[coord] = TM.join_pieces(torch.cat(parts, dim), dim, shape[axis], TM.groups_of(spec, dim))
        out = {c[:k] + (i,) + c[k + 1:]: v for c, v in merged.items() for i in range(shape[axis])}
    return next(iter(out.values()))


@pytest.mark.parametrize("shape", LAYOUT_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_every_rules_pieces_put_back_the_jax_layout_bit_for_bit(shape):
    """The tiny tree (random values) sliced by every rank (shard_params, through
    take_piece) and joined back (join_pieces) is the full tree in bits; each rank's
    piece of the ViT's wqkv / bqkv is its own heads of q, k and v, as the JAX
    package's reshape to (S, 3, H, D) reads them."""
    params = init_vlm_params(CFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    n = int(np.prod(shape))
    meshes = [TM.Mesh(*shape, rank=r) for r in range(n)]
    specs = TM.param_shardings(params, meshes[0])
    shards = [tree_leaves(TM.shard_params(params, m)) for m in meshes]
    for i, (full, spec) in enumerate(zip(tree_leaves(params), TM.spec_leaves(params, specs))):
        assert torch.equal(_pieces_to_full([s[i] for s in shards], spec, meshes), full), (i, spec)
    H, D = CFG.vision.num_heads, CFG.vision.head_dim
    t = shape[2]
    bqkv = params["vision"]["blocks"][0]["attn"]["bqkv"]
    spec = specs["vision"]["blocks"][0]["attn"]["bqkv"]
    assert isinstance(spec, TM.QKVSpec) and spec == ("tensor",)
    for m in meshes:
        j = m.coordinate["tensor"]
        want = bqkv.reshape(3, H, D)[:, j * H // t:(j + 1) * H // t].reshape(-1)
        assert torch.equal(TM.local_slice(bqkv, spec, m), want)


@pytest.mark.parametrize("t", [2, 4])
def test_the_3b_trees_pieces_are_head_sets_and_join_back(t):
    """At the Qwen2.5-VL-3B shapes (the meta tree's; each leaf numbered, its last
    dimension whole and its leading ones cut to 8 rows): every rule's pieces over
    (1, 2, t) join back in order, and a rank's
    piece of wqkv's 3840 columns is its 16 / t heads of q, k and v (at tensor 2, not
    all of q and half of k)."""
    cfg = VLMConfig.qwen2_5_vl_3b()
    with torch.device("meta"):
        tree = init_vlm_params(cfg, generator=torch.Generator(), device="meta")
    meshes = [TM.Mesh(1, 2, t, rank=r) for r in range(2 * t)]
    specs = TM.param_shardings(tree, meshes[0])
    H, D = cfg.vision.num_heads, cfg.vision.head_dim
    for leaf, spec in zip(tree_leaves(tree), TM.spec_leaves(tree, specs)):
        if not TM.is_sharded(spec, meshes[0]):
            continue
        shp = tuple(min(s, 8) for s in leaf.shape[:-1]) + (leaf.shape[-1],)
        numbered = torch.arange(int(np.prod(shp)), dtype=torch.int64).reshape(shp)
        pieces = [TM.local_slice(numbered, spec, m) for m in meshes]
        assert torch.equal(_pieces_to_full(pieces, spec, meshes), numbered)
        if isinstance(spec, TM.QKVSpec):
            assert leaf.shape[-1] == 3 * H * D == 3840
            for m, p in zip(meshes, pieces):
                j = m.coordinate["tensor"]
                cols = p.reshape(-1, p.shape[-1])[0] % leaf.shape[-1]
                heads = torch.unique(cols // D)  # global head ids, q 0-15, k 16-31, v 32-47
                assert heads.tolist() == [g * H + h for g in range(3) for h in range(j * H // t, (j + 1) * H // t)]


def test_a_tensor_axis_that_does_not_divide_the_heads_is_refused_with_the_counts():
    """--tensor 3 at the tiny config (decoder 4 / 2 heads, ViT 4): refused by the
    sharded step, train_sft and GRPOTrainer on the host, naming the counts. Tensor 4,
    where 2 KV heads divide the axis (two ranks share each), is accepted at the tiny
    config and at 3B, as is 2; so is 3B at tensor 8, whose ViT MLP width 3420 does not
    split 8 ways: the rules leave those leaves whole there, as the JAX rules do
    (test_torch_parallel holds the 3B specs on (1, 1, 8) against them), and their blocks
    run whole. No refusal names a ROADMAP item."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(0), JCFG)))
    mesh = TM.make_mesh(tensor=3, world_size=3)
    msg = "a tensor axis of 3 does not divide the head counts .decoder num_attention_heads 4, decoder " \
          "num_key_value_heads 2, ViT num_heads 4."
    with pytest.raises(ValueError, match=msg):
        TS.make_sharded_train_step(mesh, CFG, TS.SFTConfig(), params)
    with pytest.raises(ValueError, match=msg):
        TL.train_sft(params, CFG, TS.SFTConfig(), TL.SFTLoopConfig(), [], W.processor(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match=msg):
        TG.GRPOTrainer(params, CFG, TG.GRPOConfig(), W.processor(), [], device="cpu", mesh=mesh)
    for cfg in (CFG, VLMConfig.qwen2_5_vl_3b()):
        TM.check_tensor_heads(cfg, 2)
        TM.check_tensor_heads(cfg, 4)
    cfg3 = VLMConfig.qwen2_5_vl_3b()
    TM.check_tensor_heads(cfg3, 8)
    with torch.device("meta"):
        tree = init_vlm_params(cfg3, generator=torch.Generator(), device="meta")
    specs = TM.param_shardings(tree, TM.make_mesh(1, 1, 8, world_size=8))
    assert [specs["vision"]["blocks"][0]["mlp"][n] for n in ("wg", "wu", "wd")] == [()] * 3
    assert specs["vision"]["blocks"][0]["attn"]["wqkv"] == ("fsdp", "tensor")
    assert not hasattr(TM, "TENSOR_AXIS_ITEM")


def test_a_tensor_parallel_decoder_refuses_the_fused_layout():
    """The fused inference layout (ops.quant.fuse_decoder_matmuls: wqkv, wgu) has no
    tensor rule: a tensor-parallel forward over it raises, naming the block, in the
    attention and in the MLP, where a split would otherwise skip g's all-reduce."""
    from zoomearth_tpu_torch.models import decoder as DEC
    from zoomearth_tpu_torch.ops.quant import fuse_decoder_matmuls

    params = fuse_decoder_matmuls(params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(0), JCFG))))
    mesh = TM.make_mesh(world_size=1)
    tp = TC.TensorParallel(mesh, TM.param_shardings(params, mesh)["text"])
    B, S = 1, 3
    x = torch.zeros(B, S, CFG.text.hidden_size)
    pos = torch.arange(S)[None].expand(3, B, S)
    with pytest.raises(ValueError, match="layers/0/attn: .*not the fused 'wqkv'"):
        DEC.decoder_forward(params["text"], CFG.text, x, pos, tp=tp)
    with pytest.raises(ValueError, match="layers/0/mlp: .*not the fused 'wgu'"):
        DEC._mlp(params["text"]["layers"][0]["mlp"], x, tp.at("layers", 0, "mlp"))


def test_f_and_g_on_a_world_of_one():
    """Megatron's f (identity forward, all-reduce backward) and g (all-reduce forward,
    identity backward) over a gloo group of one rank: the identity both ways, the
    backward's gradient a new tensor; with no group both are the input itself."""
    x = torch.randn(3, 5, requires_grad=True)
    assert TC.f(x, None) is x and TC.g(x, None) is x
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        TC.traffic.clear()
        y = TC.f(x, group)
        assert torch.equal(y, x)
        (gx,) = torch.autograd.grad((y * 2).sum(), x)
        assert torch.equal(gx, torch.full_like(x, 2.0))
        z = TC.g(x, group)
        assert torch.equal(z, x) and z.data_ptr() != x.data_ptr()
        w = torch.randn(3, 5)
        (gz,) = torch.autograd.grad((z * w).sum(), x)
        assert torch.equal(gz, w)
        b = torch.randn(6, requires_grad=True)
        piece = TC.SliceLocal.apply(b, 0, group, 0, 3)
        assert torch.equal(piece, b)
        (gb,) = torch.autograd.grad((piece * torch.arange(6.0)).sum(), b)
        assert torch.equal(gb, torch.arange(6.0))
        assert TC.traffic["all_reduce"] == 2 * x.numel() * 4 and TC.traffic["all_gather"] == 6 * 4
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the hazards, on two ranks
# ---------------------------------------------------------------------------

def _with_random_biases(params, seed):
    """The tree with every bias (and LoRA b) drawn from N(0, 0.5): a bias added twice,
    or a stale piece of one, shows."""
    g = torch.Generator().manual_seed(seed)

    def draw(path, t):
        if path.rsplit("/", 1)[-1].startswith("b"):
            return torch.randn(t.shape, generator=g) * 0.5
        return t

    return TM.map_with_path(draw, params)


def _batch():
    ids, pos, pv, meta = example_inputs(CFG, batch=2, seq=128, grid=(1, 8, 8), patch_bucket=0)
    pv = np.random.default_rng(3).standard_normal(pv.shape).astype(np.float32)
    labels = np.where(ids == CFG.tokens.pad, -100, ids).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "position_ids": pos, "pixel_values": pv, "vision_meta": meta}


@pytest.fixture(scope="module")
def rules_inputs(tmp_path_factory):
    """The tree with random biases, its LoRA form and a batch, written for the workers;
    the loss, gradients and ViT output of each on one device."""
    d = tmp_path_factory.mktemp("tensor_rules")
    params = _with_random_biases(init_vlm_params(CFG, torch.Generator().manual_seed(0), device="cpu",
                                                 dtype=torch.float32), 1)
    lora = _with_random_biases(TLORA.apply_lora(params, torch.Generator().manual_seed(2), r=4, alpha=8.0), 3)
    wide = _with_random_biases(init_vlm_params(WIDE_CFG, torch.Generator().manual_seed(4), device="cpu",
                                               dtype=torch.float32), 5)
    torch.save(params, d / "bias_params.pt")
    torch.save(lora, d / "lora_bias_params.pt")
    torch.save(wide, d / "wide_params.pt")
    torch.save(_batch(), d / "batch.pt")
    batch = TS.batch_to_device(_batch(), "cpu")
    want = {}
    for name, tree, cfg in (("bias_params", params, CFG), ("lora_bias_params", lora, CFG),
                            ("wide_params", wide, WIDE_CFG)):
        TL.make_trainable(tree)
        loss, _ = TS.sft_loss(tree, cfg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        paths = TM.spec_leaves(tree, TM.map_with_path(lambda p, leaf: p, tree))  # in tree_leaves order
        with torch.no_grad():
            vis = TS.compute_vision_embeds(tree, cfg, batch["pixel_values"], batch["vision_meta"])
        want[name] = {"loss": float(loss.detach()), "grads": [g.numpy() for g in grads], "paths": paths,
                      "vision": vis.numpy(), "grad_norm": float(TS.global_norm(list(grads)))}
    return d, want


@pytest.fixture(scope="module")
def rules(rules_inputs):
    """The worker's block_rules on a (1, 1, 2) gloo group, and the same loss, gradients
    and ViT output on one device."""
    d, want = rules_inputs
    run_ranks(f"{WORKER}:run", 2, {"workdir": str(d), "scenarios": [["block_rules", {}]]}, timeout_s=240)
    return [torch.load(d / f"rules_rank{r}.pt", weights_only=False) for r in range(2)], want


@pytest.fixture(scope="module")
def rules4(rules_inputs):
    """On a (1, 1, 4) gloo group, where two ranks share each of the tiny decoder's 2 KV
    heads: the worker's share_kv, then block_rules on the tiny trees and on the tree of
    WIDE_CFG; and the one-device results."""
    d, want = rules_inputs
    run_ranks(f"{WORKER}:run", 4, {"workdir": str(d), "scenarios": [
        ["share_kv", {}], ["block_rules", {"shape": [1, 1, 4]}],
        ["block_rules", {"shape": [1, 1, 4], "names": ["wide_params"], "vision_mlp": WIDE_MLP}]]}, timeout_s=240)
    load = lambda name: [torch.load(d / f"{name}_rank{r}.pt", weights_only=False) for r in range(4)]  # noqa: E731
    return load("share_kv"), load("rules114"), want, load(f"rules114_mlp{WIDE_MLP}")


def _close(a, b, what):
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=what)


def test_row_split_biases_are_added_once_after_the_all_reduce(rules):
    """attn/bo, mlp/bd and merger/b1 (replicated by the rules, after a row-split
    product): the ViT's output and the loss on each rank equal the one-device ones,
    with biases large enough that one added on both ranks would show."""
    got, want = rules
    w = want["bias_params"]
    for r in got:
        _close(r["bias_params"]["vision"], w["vision"], "the ViT's output")
        _close(r["bias_params"]["loss"], w["loss"], "the loss")
    # the hazard is live: bo, bd and b1 shift the output by far more than the tolerance
    grads = dict(zip(w["paths"], w["grads"]))
    assert np.abs(grads["vision/merger/b1"]).max() > 1e-3


def test_a_replicated_bias_before_a_column_split_matrix_gets_its_whole_gradient(rules):
    """mlp/bg, mlp/bu and merger/b0 stay whole on every rank while the forward takes
    this rank's columns: each rank's gradient of them, straight from autograd, is the
    whole gradient (SliceLocal's all-gather), equal to the one-device one, whose two
    halves are both nonzero; and every gradient after the reduction equals it."""
    got, want = rules
    w = want["bias_params"]
    grads = dict(zip(w["paths"], w["grads"]))
    for r in got:
        raw = r["bias_params"]["raw"]
        assert set(raw) == {p for p in grads if p.endswith(("mlp/bg", "mlp/bu", "merger/b0"))}
        for p, g in raw.items():
            half = g.shape[0] // 2
            assert np.abs(grads[p][:half]).max() > 1e-4 and np.abs(grads[p][half:]).max() > 1e-4
            _close(g, grads[p], f"rank {r['coord']['tensor']} {p}")
        for i, (a, b) in enumerate(zip(r["bias_params"]["grads"], w["grads"])):
            _close(a, b, f"gradient {w['paths'][i]}")


def test_lora_runs_the_decoder_whole_and_the_vit_and_merger_split(rules):
    """Under LoRA the decoder's wrapped matrices are replicated while its q/k/v biases
    stay split: every decoder block runs whole (its biases gathered over tensor), every
    ViT block and the merger split; loss, ViT output and every gradient equal the
    one-device LoRA run's. Without LoRA every block runs split."""
    got, want = rules
    L, V = CFG.text.num_hidden_layers, CFG.vision.depth
    for r in got:
        blocks = dict(r["lora_bias_params"]["blocks"])
        assert len(blocks) == 2 * L + 2 * V + 1
        assert [p for p, s in blocks.items() if not s] == [f"text/layers/{i}/{k}" for i in range(L)
                                                             for k in ("attn", "mlp")]
        assert all(blocks[f"vision/blocks/{i}/{k}"] for i in range(V) for k in ("attn", "mlp"))
        assert blocks["vision/merger"]
        assert all(s for _, s in r["bias_params"]["blocks"])
        w = want["lora_bias_params"]
        _close(r["lora_bias_params"]["loss"], w["loss"], "LoRA loss")
        _close(r["lora_bias_params"]["vision"], w["vision"], "LoRA ViT output")
        for i, (a, b) in enumerate(zip(r["lora_bias_params"]["grads"], w["grads"])):
            _close(a, b, f"LoRA gradient {w['paths'][i]}")


# ---------------------------------------------------------------------------
# tensor 4 over 2 KV heads: each head shared by two ranks
# ---------------------------------------------------------------------------

def test_share_kv_head_joins_the_pieces_and_sums_the_gradients(rules4):
    """ShareKVHead over the KV-replica groups of a (1, 1, 4) mesh ({0, 1} and {2, 3},
    built with the mesh): the forward gives each rank the whole head its group holds,
    and the backward gives each rank its piece of the group's summed gradient, which
    is one device's gradient of sum over the group's ranks of head * w_rank, split.
    The backward's all-reduce carries the whole head once, and so does the forward's
    all-gather, each counted under its own key of collectives.traffic. Where the KV heads are as many as the ranks (r = 1) the leaves are handed
    back as they are."""
    share = rules4[0]
    full = np.arange(24.0, dtype=np.float32).reshape(3, 8)
    for r, out in enumerate(share):
        h = r // 2
        assert out["group"] == [2 * h, 2 * h + 1] and out["tensor_group"] == [0, 1, 2, 3]
        np.testing.assert_array_equal(out["piece"], full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["head"], full[:, 4 * h:4 * h + 4])
        head_grad = share[2 * h]["w"] + share[2 * h + 1]["w"]
        _close(out["grad"], head_grad[:, 2 * (r % 2):2 * (r % 2) + 2], f"rank {r}'s piece of the head's gradient")
        assert out["traffic"] == {"kv_all_gather": 3 * 4 * 4, "kv_all_reduce": 3 * 4 * 4}
        assert out["whole_heads_untouched"]


def test_tensor_4_shares_each_kv_head_and_equals_one_device(rules4):
    """The tensor-parallel forward and backward on (1, 1, 4) at the tiny config
    (decoder 4 / 2 heads: each rank one query head against a KV head it shares with
    one other rank; ViT 4 heads, one a rank), biases random: every block runs split
    (under LoRA the decoder whole), and the loss, the ViT's output, every gradient
    after reduce_gradients gathered into the JAX layout, and mesh_global_norm of the
    reduced pieces equal one device's to 5e-5: the stored pieces are the JAX pieces,
    so the reduction and the norm need nothing new."""
    _, got, want, _ = rules4
    L, V = CFG.text.num_hidden_layers, CFG.vision.depth
    for r in got:
        assert all(s for _, s in r["bias_params"]["blocks"])
        assert [p for p, s in r["lora_bias_params"]["blocks"] if not s] == [
            f"text/layers/{i}/{k}" for i in range(L) for k in ("attn", "mlp")]
        assert len(r["bias_params"]["blocks"]) == 2 * L + 2 * V + 1
        for name in ("bias_params", "lora_bias_params"):
            w = want[name]
            _close(r[name]["loss"], w["loss"], f"{name} loss")
            _close(r[name]["vision"], w["vision"], f"{name} ViT output")
            _close(r[name]["grad_norm"], w["grad_norm"], f"{name} gradient norm")
            for i, (a, b) in enumerate(zip(r[name]["grads"], w["grads"])):
                _close(a, b, f"{name} gradient {w['paths'][i]}")
    grads = dict(zip(want["bias_params"]["paths"], want["bias_params"]["grads"]))
    assert all(np.abs(grads[f"text/layers/{i}/attn/{n}"]).max() > 1e-4 for i in range(L) for n in ("wk", "bk"))


def test_a_width_the_axis_does_not_split_runs_its_blocks_whole(rules4):
    """The tiny config with the ViT's MLP 66 wide on (1, 1, 4), where 66 does not split 4
    ways: the rules leave the MLP's wg, wu and wd whole, spec for spec as the JAX rules
    place the same tree on a mesh of that shape (no refusal, as in the JAX package); the
    ViT's MLP blocks run whole on every rank and every other block split; the loss, the
    ViT's output, every gradient and the gradient norm equal one device's to 5e-5. The
    3B model at tensor 8 (ViT MLP width 3420) takes this path."""
    *_, want, got = rules4
    with torch.device("meta"):
        tree = init_vlm_params(WIDE_CFG, generator=torch.Generator(), device="meta")
    ours = dict(zip(TM.spec_leaves(tree, TM.map_with_path(lambda p, leaf: p, tree)),
                    TM.spec_leaves(tree, TM.param_shardings(tree, TM.make_mesh(1, 1, 4, world_size=4)))))
    jcfg = dataclasses.replace(JCFG, vision=dataclasses.replace(JCFG.vision, intermediate_size=WIDE_MLP))
    jtree = jax.eval_shape(lambda: jax_init(jax.random.key(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        JM.param_shardings(jtree, JM.make_mesh(1, 1, 4, devices=jax.devices()[:4])))
    assert ours == {JM._path_str(path): tuple(s.spec) for path, s in flat}
    V = WIDE_CFG.vision.depth
    assert all(ours[f"vision/blocks/{i}/mlp/{n}"] == () for i in range(V) for n in ("wg", "wu", "wd"))
    TM.check_tensor_heads(WIDE_CFG, 4)
    w = want["wide_params"]
    for r in got:
        blocks = r["wide_params"]["blocks"]
        assert [p for p, split in blocks if not split] == [f"vision/blocks/{i}/mlp" for i in range(V)], blocks
        _close(r["wide_params"]["loss"], w["loss"], "loss")
        _close(r["wide_params"]["vision"], w["vision"], "ViT output")
        _close(r["wide_params"]["grad_norm"], w["grad_norm"], "gradient norm")
        for i, (a, b) in enumerate(zip(r["wide_params"]["grads"], w["grads"])):
            _close(a, b, f"gradient {w['paths'][i]}")
