"""The port's tensor axis in one process, and its three hazards on a group of two
ranks: the head-aligned layout of the ViT's fused q|k|v (every rule's pieces put back
into the JAX layout bit for bit, at the tiny config and at the 3B tree's shapes), the
refusal of a tensor axis that does not divide the head counts, Megatron's f and g on
a world of one, and on a (1, 1, 2) mesh of gloo ranks (tests/torch_tensor_worker.py)
the row-split biases added once, the replicated column biases' whole gradients, and
LoRA's mixed blocks (the decoder whole, the ViT and merger split), each held to the
one-device forward and backward at 5e-5. The training paths over tensor meshes
against the JAX package are tests/test_torch_tensor_procs.py."""

import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init
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
    """--tensor 4 at the tiny config (decoder 4 / 2 heads, ViT 4): refused by the
    sharded step, train_sft and GRPOTrainer on the host; 2 passes; no refusal names a
    later ROADMAP item any more."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(0), JCFG)))
    mesh = TM.make_mesh(tensor=4, world_size=4)
    msg = "decoder num_attention_heads 4, decoder num_key_value_heads 2, ViT num_heads 4"
    with pytest.raises(ValueError, match=msg):
        TS.make_sharded_train_step(mesh, CFG, TS.SFTConfig(), params)
    with pytest.raises(ValueError, match=msg):
        TL.train_sft(params, CFG, TS.SFTConfig(), TL.SFTLoopConfig(), [], W.processor(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match=msg):
        TG.GRPOTrainer(params, CFG, TG.GRPOConfig(), W.processor(), [], device="cpu", mesh=mesh)
    TM.check_tensor_heads(CFG, 2)
    TM.check_tensor_heads(VLMConfig.qwen2_5_vl_3b(), 2)
    with pytest.raises(ValueError, match="decoder num_key_value_heads 2"):
        TM.check_tensor_heads(VLMConfig.qwen2_5_vl_3b(), 4)
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
def rules(tmp_path_factory):
    """The worker's block_rules on a (1, 1, 2) gloo group, and the same loss, gradients
    and ViT output on one device."""
    d = tmp_path_factory.mktemp("tensor_rules")
    params = _with_random_biases(init_vlm_params(CFG, torch.Generator().manual_seed(0), device="cpu",
                                                 dtype=torch.float32), 1)
    lora = _with_random_biases(TLORA.apply_lora(params, torch.Generator().manual_seed(2), r=4, alpha=8.0), 3)
    torch.save(params, d / "bias_params.pt")
    torch.save(lora, d / "lora_bias_params.pt")
    torch.save(_batch(), d / "batch.pt")
    run_ranks(f"{WORKER}:run", 2, {"workdir": str(d), "scenarios": [["block_rules", {}]]}, timeout_s=240)
    got = [torch.load(d / f"rules_rank{r}.pt", weights_only=False) for r in range(2)]
    batch = TS.batch_to_device(_batch(), "cpu")
    want = {}
    for name, tree in (("bias_params", params), ("lora_bias_params", lora)):
        TL.make_trainable(tree)
        loss, _ = TS.sft_loss(tree, CFG, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        paths = TM.spec_leaves(tree, TM.map_with_path(lambda p, leaf: p, tree))  # in tree_leaves order
        with torch.no_grad():
            vis = TS.compute_vision_embeds(tree, CFG, batch["pixel_values"], batch["vision_meta"])
        want[name] = {"loss": float(loss.detach()), "grads": [g.numpy() for g in grads], "paths": paths, "vision": vis.numpy()}
    return got, want


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
