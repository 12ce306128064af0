"""Hand-written CUDA kernels (K1, K2, K3, K4, P1, P2) and the split merge K3 and P2
share against their plain torch versions, on the card. Marked `cuda`: every test skips where torch.cuda.is_available() is false.

On a machine with an NVIDIA GPU and nvcc:  python -m pytest -m cuda tests/test_torch_cuda.py

fp32 cases hold the kernels to 1e-4 (the kernels sum in another order than the
plain versions); bf16 cases to 2e-2: bf16 roundings of outputs below 2 (of the output
and, in K1/K2's tensor-core variants and P2, of the softmax weights).
"""

import numpy as np
import pytest
import torch

from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu_torch.ops import flash_attention as K1
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_decode as K3
from zoomearth_tpu_torch.ops import _cuda
from zoomearth_tpu_torch.ops import paged_attention as K4
from zoomearth_tpu_torch.scripts import paged_256_test as PT
from zoomearth_tpu_torch.scripts import probe_attn as P

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _randn(shape, dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,D,runs", [(64, 4, 8, (64,)), (300, 2, 16, (100, 37, 120)),
                                        (2600, 16, 80, (1296, 1000)), (200, 4, 128, (50, 150))])
def test_k1_matches_plain(dev, dtype, S, H, D, runs):
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(runs)] + [np.full(S - sum(runs), 2**30)])
    seg = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    qkv = _randn((S, 3, H, D), dev, dtype, 1)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # strided views, as the ViT passes them
    n0 = K1.segment_attention_cuda.launches
    out = K1.segment_attention_cuda(q, k, v, seg)
    torch.cuda.synchronize()
    assert K1.segment_attention_cuda.launches == n0 + 1
    ref = K1.flash_segment_attention_plain(q, k, v, seg)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,Hkv,D", [(2, 24, 64, 4, 2, 16), (3, 100, 300, 16, 2, 128),
                                           (1, 64, 64, 4, 4, 64)])
def test_k2_matches_plain(dev, dtype, B, S, T, H, Hkv, D):
    q = _randn((B, S, H, D), dev, dtype, 2)
    k = _randn((B, Hkv, T, D), dev, dtype, 3)
    v = _randn((B, Hkv, T, D), dev, dtype, 4)
    keep = torch.randint(0, T - S + 1, (B,), device=dev)
    keep[0] = 0
    pos = keep[:, None] + torch.arange(S, device=dev)[None]
    kv_len = keep + S
    kv_len[-1] -= S // 3  # a row whose tail queries lie past kv_len
    out = K2.causal_attention_cuda(q, k, v, pos, kv_len)
    ref = K2.flash_causal_attention_plain(q, k, v, pos, kv_len)
    torch.cuda.synchronize()
    assert _err(out, ref) <= TOL[dtype]


def test_k2_reads_transposed_views_and_int8(dev):
    B, S, H, Hkv, D = 2, 40, 16, 2, 128
    q = _randn((B, S, H, D), dev, torch.bfloat16, 5)
    kf = _randn((B, S, Hkv, D), dev, torch.bfloat16, 6)
    vf = _randn((B, S, Hkv, D), dev, torch.bfloat16, 7)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    kv_len = torch.tensor([S, S - 7], device=dev)
    out = K2.causal_attention_cuda(q, kf.transpose(1, 2), vf.transpose(1, 2), pos, kv_len)
    ref = K2.flash_causal_attention_plain(q, kf.transpose(1, 2), vf.transpose(1, 2), pos, kv_len)
    assert _err(out, ref) <= 2e-2
    k8 = torch.randint(-127, 128, (B, Hkv, S, D), device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (B, Hkv, S, D), device=dev, dtype=torch.int8)
    ks = torch.rand((B, Hkv, S), device=dev) * 0.02 + 0.005
    vs = torch.rand((B, Hkv, S), device=dev) * 0.02 + 0.005
    out = K2.causal_attention_cuda(q, k8, v8, pos, kv_len, ks, vs)
    ref = K2.flash_causal_attention_plain(q, k8, v8, pos, kv_len, ks, vs)
    torch.cuda.synchronize()
    assert _err(out, ref) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,T,attend", [(4, 4, 2, 16, 64, 64), (5, 16, 2, 128, 1280, 1280),
                                                (3, 16, 2, 128, 4096, 1280), (2, 8, 8, 128, 300, 300)])
def test_k3_matches_plain(dev, dtype, B, H, Hkv, D, T, attend):
    q = _randn((B, 1, H, D), dev, dtype, 8)
    kc = _randn((B, Hkv, T, D), dev, dtype, 9)
    vc = _randn((B, Hkv, T, D), dev, dtype, 10)
    k, v = kc[:, :, :attend], vc[:, :, :attend]  # the decoder's prefix view, read in place
    kv_len = torch.randint(1, attend + 1, (B,), device=dev)
    kv_len[0] = 1
    kv_len[-1] = attend
    out = K3.decode_attention_cuda(q, k, v, kv_len)
    ref = K3.flash_decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]


def test_k3_int8(dev):
    B, H, Hkv, D, T = 4, 16, 2, 128, 1000
    q = _randn((B, 1, H, D), dev, torch.bfloat16, 11)
    k8 = torch.randint(-127, 128, (B, Hkv, T, D), device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (B, Hkv, T, D), device=dev, dtype=torch.int8)
    ks = (torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005).to(torch.bfloat16)
    vs = (torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005).to(torch.bfloat16)
    kv_len = torch.tensor([1, T, 517, 3], device=dev)
    out = K3.decode_attention_cuda(q, k8, v8, kv_len, ks, vs)
    ref = K3.flash_decode_attention_plain(q, k8, v8, kv_len, ks, vs)
    torch.cuda.synchronize()
    assert _err(out, ref) <= 2e-2


def _k3_case(dev, case):
    """(q, k, v, kv_len, ks, vs) for one K3 case: B = 6 rows whose kv_len holds 0 (no
    live slot), 1, the split length - 1, + 0 and + 1, and T, with T not a multiple of
    the split length (split_plan)."""
    B, Hkv = 6, 2
    H, D, T, dtype = {"fp32 D=16": (4, 16, 300, torch.float32), "bf16 D=128": (16, 128, 1000, torch.bfloat16),
                      "int8": (16, 128, 1000, torch.bfloat16), "strided view": (16, 128, 1000, torch.bfloat16)}[case]
    split = K3.split_plan(B, Hkv, T)[0]
    assert T % split and split + 1 < T
    kv_len = torch.tensor([0, 1, split - 1, split, split + 1, T], device=dev)
    q = _randn((B, 1, H, D), dev, dtype, 40)
    ks = vs = None
    if case == "int8":
        k = torch.randint(-127, 128, (B, Hkv, T, D), device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Hkv, T, D), device=dev, dtype=torch.int8)
        ks = torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005
        vs = torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005
    elif case == "strided view":  # the decoder's [:, :, :attend_len] view of a longer cache
        k = _randn((B, Hkv, T + 536, D), dev, dtype, 41)[:, :, :T]
        v = _randn((B, Hkv, T + 536, D), dev, dtype, 42)[:, :, :T]
    else:
        k, v = _randn((B, Hkv, T, D), dev, dtype, 41), _randn((B, Hkv, T, D), dev, dtype, 42)
    return q, k, v, kv_len, ks, vs


@pytest.mark.parametrize("case", ["fp32 D=16", "bf16 D=128", "int8", "strided view"])
def test_k3_dead_rows_and_split_boundaries_match_plain(dev, case):
    """kv_len == 0 gives the plain version's mean of v over all T slots; rows ending
    one before, at and one after a split boundary, and a last split cut short by T."""
    q, k, v, kv_len, ks, vs = _k3_case(dev, case)
    n0 = K3.decode_attention_cuda.launches
    out = K3.decode_attention_cuda(q, k, v, kv_len, ks, vs)
    torch.cuda.synchronize()
    assert K3.decode_attention_cuda.launches == n0 + 1
    ref = K3.flash_decode_attention_plain(q, k, v, kv_len, ks, vs)
    assert _err(out, ref) <= TOL[q.dtype]
    vf = v.float() * (vs[..., None] if vs is not None else 1)
    mean = vf.mean(2).repeat_interleave(q.shape[2] // k.shape[1], dim=1)  # (B, H, D)
    assert _err(out[0, 0], mean[0]) <= TOL[q.dtype]


def test_k3_refuses_a_misaligned_view(dev):
    """K3 copies 16-byte vectors: a cache off a 16-byte boundary, or whose slot stride
    is not a whole number of 16-byte vectors, is refused before launch."""
    B, H, Hkv, D, T = 2, 16, 2, 128, 64
    q = _randn((B, 1, H, D), dev, torch.bfloat16, 43)
    flat = _randn((B * Hkv * T * D + 1,), dev, torch.bfloat16, 44)
    off = flat[1:].view(B, Hkv, T, D)  # contiguous, 2 bytes past the allocation's start
    wide = _randn((B, Hkv, T, D + 4), dev, torch.bfloat16, 45)[..., :D]  # slot stride 264 bytes
    kv_len = torch.tensor([3, T], device=dev)
    n0 = K3.decode_attention_cuda.launches
    for k in (off, wide):
        with pytest.raises(ValueError, match="16-byte"):
            K3.decode_attention_cuda(q, k, k, kv_len)
    assert K3.decode_attention_cuda.launches == n0


@pytest.mark.parametrize("B,rb", [(8, 4), (6, 2), (3, 1)])
def test_p2_row_blocks_with_zero_lengths_match_plain(dev, B, rb):
    H, Hkv, D, T = 16, 2, 128, 1024
    assert P.row_block(B) == rb
    q = _randn((B, 1, H, D), dev, torch.bfloat16, 46)
    k = _randn((B, Hkv, T, D), dev, torch.bfloat16, 47)
    v = _randn((B, Hkv, T, D), dev, torch.bfloat16, 48)
    lens = torch.tensor([0, 700, 1, 0, T, 63, 64, 65][:B], device=dev)
    out = P.bigmm_decode_cuda(q, k, v, lens, chunk=256)
    torch.cuda.synchronize()
    assert _err(out, P.bigmm_decode_attention_plain(q, k, v, lens, chunk=256)) <= 2e-2


def test_k3_and_p2_replay_in_a_cuda_graph_to_the_eager_result(dev):
    """Capture fails on a host sync, so a wrapper that captures waits for nothing; the
    replay gives the eager result bit for bit (no atomics in either kernel)."""
    q, k, v, kv_len, ks, vs = _k3_case(dev, "int8")
    qb, kb, vb, lb, _, _ = _k3_case(dev, "strided view")
    kp, vp = kb[:, :, :768].contiguous(), vb[:, :, :768].contiguous()
    lp = lb.clamp(max=768)
    fns = (lambda: K3.decode_attention_cuda(q, k, v, kv_len, ks, vs), lambda: K3.decode_attention_cuda(qb, kb, vb, lb),
           lambda: P.bigmm_decode_cuda(qb, kp, vp, lp, chunk=256))
    eager = [f() for f in fns]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in fns]
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, eager):
        assert torch.equal(out, ref)


def test_cuda_dispatch_never_takes_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(K1, "flash_segment_attention_plain", boom)
    monkeypatch.setattr(K2, "flash_causal_attention_plain", boom)
    monkeypatch.setattr(K3, "flash_decode_attention_plain", boom)
    x = _randn((64, 2, 16), dev, torch.bfloat16, 12)
    K1.flash_segment_attention(x, x, x, torch.zeros(64, dtype=torch.int32, device=dev))
    q = _randn((1, 4, 4, 16), dev, torch.bfloat16, 13)
    kv = _randn((1, 2, 8, 16), dev, torch.bfloat16, 14)
    K2.flash_causal_attention(q, kv, kv, torch.arange(4, device=dev)[None], torch.tensor([4], device=dev))
    K3.flash_decode_attention(q[:, :1], kv, kv, torch.tensor([8], device=dev))
    torch.cuda.synchronize()


def test_tiny_generator_on_card_matches_cpu(dev):
    """The tiny config in fp32 through every kernel on the card gives the CPU plain
    path's greedy tokens."""
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator, prepare_batch

    cfg = VLMConfig.tiny()
    rng = np.random.default_rng(0)
    tok = cfg.tokens
    seqs, imgs = [], []
    for i, g in enumerate([(1, 4, 4), (1, 8, 8)]):
        n = g[1] * g[2] // 4
        seqs.append([tok.im_start, 40 + i, tok.vision_start] + [tok.image_pad] * n + [tok.vision_end, 50, 60 + i])
        imgs.append([(rng.standard_normal((g[1] * g[2], cfg.vision.patch_dim)).astype(np.float32), g)])
    batch = prepare_batch(cfg, seqs, imgs, length_buckets=(64,), patch_buckets=(128,))
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    gen = GenerationConfig(max_new_tokens=12, temperature=0.0)
    cpu = Generator(params, cfg, max_cache_len=128).generate(batch, gen)
    cuda_params = map_tree(lambda t: t.to(dev), params)
    n = [K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches, K3.decode_attention_cuda.launches]
    out = Generator(cuda_params, cfg, max_cache_len=128).generate(batch, gen)
    assert out == cpu
    assert K1.segment_attention_cuda.launches > n[0]
    assert K2.causal_attention_cuda.launches > n[1]
    assert K3.decode_attention_cuda.launches > n[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,page,max_pages", [(3, 4, 2, 32, 16, 5), (4, 16, 2, 128, 64, 6),
                                                      (2, 16, 2, 128, 256, 3)])
def test_k4_matches_plain(dev, dtype, B, H, Hkv, D, page, max_pages):
    P_ = B * max_pages + 2
    q = _randn((B, H, D), dev, dtype, 20)
    kpool = _randn((P_, Hkv, page, D), dev, dtype, 21)
    vpool = _randn((P_, Hkv, page, D), dev, dtype, 22)
    g = torch.Generator().manual_seed(23)
    bt = torch.randperm(P_, generator=g)[: B * max_pages].reshape(B, max_pages).to(torch.int32)
    lens = torch.randint(1, max_pages * page + 1, (B,), generator=g)
    lens[0] = 0  # no live slot: 0, as the Pallas kernel gives
    lens[-1] = max_pages * page
    n = K4.page_counts(lens, page)
    for b in range(B):  # entries past a row's pages are garbage ids the kernel must never read
        bt[b, n[b]:] = torch.tensor([2**30, -5] * max_pages, dtype=torch.int32)[: max_pages - n[b]]
    bt, lens = bt.to(dev), lens.to(dev)
    n0 = K4.paged_decode_cuda.launches
    out = K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=page)
    torch.cuda.synchronize()
    assert K4.paged_decode_cuda.launches == n0 + 1
    ref = K4.paged_decode_attention_plain(q, kpool, vpool, bt, lens, page_size=page)
    assert _err(out, ref) <= TOL[dtype]
    assert bool((out[0] == 0).all())


def _k4_case(dev, page, dtype, D, H=16, Hkv=2):
    """B = 8 rows over a contiguous cache laid out in pages of `page` at shuffled ids:
    lengths 0, 1, either side of a split and of a page boundary, capacity and past it;
    table entries past each row's pages are ids far outside [0, P)."""
    B, T = 8, max(4 * page, 256)
    split = K3.split_plan(B, Hkv, T)[0]
    assert split + 1 < T and page + 1 < T
    q = _randn((B, H, D), dev, dtype, 70)
    k, v = _randn((B, Hkv, T, D), dev, dtype, 71), _randn((B, Hkv, T, D), dev, dtype, 72)
    kpool, vpool, bt = PT.to_pages(k, v, page, np.random.default_rng(73))
    lens = torch.tensor([0, 1, split - 1, split + 1, page - 1, page + 1, T, T + 9], device=dev)
    tail = torch.arange(T // page, device=dev)[None] >= K4.page_counts(lens.clamp(max=T), page)[:, None]
    bt = torch.where(tail, torch.tensor([2**30, -(2**29)], dtype=torch.int32, device=dev).repeat(T // page)[: T // page],
                     bt)
    return q, k, v, kpool, vpool, bt, lens


@pytest.mark.parametrize("dtype,D", [(torch.float32, 32), (torch.bfloat16, 128)])
@pytest.mark.parametrize("page", [16, 64, 256])
def test_k4_edges_match_plain_and_k3_on_the_same_kv(dev, page, dtype, D):
    """A tile of 32 slots crosses pages of 16; a row with no live slot gives 0 and one
    past capacity reads its capacity; a table entry past a row's pages is never read
    (a read of pool[2**30] would fault)."""
    q, k, v, kpool, vpool, bt, lens = _k4_case(dev, page, dtype, D)
    n0 = K4.paged_decode_cuda.launches
    out = K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=page)
    torch.cuda.synchronize()
    assert K4.paged_decode_cuda.launches == n0 + 1
    assert _err(out, K4.paged_decode_attention_plain(q, kpool, vpool, bt, lens, page_size=page)) <= TOL[dtype]
    assert not bool(out[0].any())
    k3 = K3.decode_attention_cuda(q, k, v, lens)
    assert _err(out[1:], k3[1:]) <= TOL[dtype]  # row 0: K3 gives the mean of v, K4 gives 0


def test_k4_refuses_misaligned_pools_and_odd_head_dims(dev):
    """K4 copies 16-byte vectors, as K3 does: a pool off a 16-byte boundary, a slot
    stride that is no whole number of vectors, or D % 8 is refused before launch."""
    B, H, Hkv, D, page = 2, 16, 2, 128, 16
    q = _randn((B, H, D), dev, torch.bfloat16, 74)
    bt = torch.arange(4, dtype=torch.int32, device=dev).reshape(B, 2)
    lens = torch.tensor([3, 2 * page], device=dev)
    off = _randn((4 * Hkv * page * D + 1,), dev, torch.bfloat16, 75)[1:].view(4, Hkv, page, D)
    wide = _randn((4, Hkv, page, D + 4), dev, torch.bfloat16, 76)[..., :D]
    n0 = K4.paged_decode_cuda.launches
    for pool in (off, wide):
        with pytest.raises(ValueError, match="16-byte"):
            K4.paged_decode_cuda(q, pool, pool, bt, lens, page_size=page)
    odd = _randn((4, Hkv, page, 20), dev, torch.float32, 77)
    with pytest.raises(ValueError, match="multiple of 8"):
        K4.paged_decode_cuda(_randn((B, H, 20), dev, torch.float32, 78), odd, odd, bt, lens, page_size=page)
    assert K4.paged_decode_cuda.launches == n0


def test_k4_and_p1_replay_in_a_cuda_graph(dev):
    """Capture fails on a host sync, so neither wrapper waits for the device. K4's
    replay equals the eager result bit for bit (no atomics); P1's out too (each vector
    has one owner), its sums to 1e-6 of the summed magnitudes (atomics in any order)."""
    q, k, v, kpool, vpool, bt, lens = _k4_case(dev, 16, torch.bfloat16, 128)
    fns = (lambda: K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=16),
           lambda: P.stream_only_cuda(q[:, None], k, v, chunk=64, rb=4))
    eager = [f() for f in fns]
    torch.cuda.synchronize()
    n0 = (K4.paged_decode_cuda.launches, P.stream_only_cuda.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in fns]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert n0 == (K4.paged_decode_cuda.launches, P.stream_only_cuda.launches)
    assert torch.equal(outs[0], eager[0])
    assert torch.equal(outs[1][0], eager[1][0])
    mass = (k.double().abs() + v.double().abs()).reshape(2, -1).sum(1)
    assert bool(((outs[1][1].double() - eager[1][1].double()).abs() <= 1e-6 * mass).all())


def test_shared_split_pass_tile_matches_the_plan(dev):
    """split_plan makes splits of whole tiles: the Python constant is the kernels'."""
    assert _cuda.lib().zt_decode_split_tile() == K3.TILE
    assert _cuda.lib().zt_probe_stream_plan(4) == 0  # the wrapper's build leaves no part out


def test_append_to_pages_on_card_drops_at_capacity(dev):
    """A write at capacity is dropped without indexing page P (a device-side assert)."""
    P_, Hkv, page, D = 6, 2, 8, 16
    kpool = _randn((P_, Hkv, page, D), dev, torch.float32, 24)
    vpool = _randn((P_, Hkv, page, D), dev, torch.float32, 25)
    k0, v0 = kpool.clone(), vpool.clone()
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    ones = torch.ones((2, Hkv, D), device=dev)
    K4.append_to_pages(kpool, vpool, ones, ones, bt, torch.tensor([2 * page, 3], device=dev), page_size=page)
    torch.cuda.synchronize()
    assert torch.equal(kpool[:2], k0[:2]) and torch.equal(vpool[:2], v0[:2])
    assert bool((kpool[2, :, 3] == 1).all()) and torch.equal(kpool[3:], k0[3:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,T,chunk,rb", [(8, 16, 2, 128, 1536, 512, 4), (4, 8, 2, 32, 96, 16, 2),
                                                  (4, 4, 1, 16, 200, 40, 4), (6, 16, 2, 128, 1024, 512, 2),
                                                  (3, 16, 2, 64, 1536, 512, 1), (5, 16, 2, 64, 96, 8, 1)])
def test_p1_matches_plain(dev, dtype, B, H, Hkv, D, T, chunk, rb):
    q = _randn((B, 1, H, D), dev, dtype, 26)
    k = _randn((B, Hkv, T, D), dev, dtype, 27)
    v = _randn((B, Hkv, T, D), dev, dtype, 28)
    n0 = P.stream_only_cuda.launches
    out, sums = P.stream_only_cuda(q, k, v, chunk=chunk, rb=rb)
    torch.cuda.synchronize()
    assert P.stream_only_cuda.launches == n0 + 1
    ref, ref_sums = P.stream_only_plain(q, k, v, chunk=chunk, rb=rb)
    # fp32 sums in another order, then one rounding to the output dtype
    step = 2.0**-7 if dtype == torch.bfloat16 else 1e-6
    assert bool(((out.float() - ref.float()).abs() <= step * ref.float().abs() + 1e-5).all())
    mass = (k.double().abs() + v.double().abs()).reshape(B // rb, -1).sum(1)
    assert bool(((sums.double() - ref_sums.double()).abs() <= 1e-6 * mass).all())


@pytest.mark.parametrize("B,lens", [(4, (1, 1536, 700, 0)), (6, (513, 2, 1024, 1536, 40, 1100)),
                                    (5, (300, 1, 1536, 0, 999))])
@pytest.mark.parametrize("q_rank", [3, 4])
def test_p2_matches_plain(dev, B, lens, q_rank):
    H, Hkv, D, T = 16, 2, 128, 1536
    q = _randn((B, 1, H, D), dev, torch.bfloat16, 29)
    q = q if q_rank == 4 else q[:, 0]
    k = _randn((B, Hkv, T, D), dev, torch.bfloat16, 30)
    v = _randn((B, Hkv, T, D), dev, torch.bfloat16, 31)
    lens = torch.tensor(lens, device=dev)
    n0 = P.bigmm_decode_cuda.launches
    out = P.bigmm_decode_cuda(q, k, v, lens, chunk=512)
    torch.cuda.synchronize()
    assert P.bigmm_decode_cuda.launches == n0 + 1
    assert out.shape == q.shape
    ref = P.bigmm_decode_attention_plain(q, k, v, lens, chunk=512)
    assert _err(out, ref) <= 2e-2
    with pytest.raises(TypeError):
        P.bigmm_decode_cuda(q.float(), k.float(), v.float(), lens, chunk=512)


def test_cuda_dispatch_of_k4_p1_p2_never_takes_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(K4, "paged_decode_attention_plain", boom)
    monkeypatch.setattr(P, "stream_only_plain", boom)
    monkeypatch.setattr(P, "bigmm_decode_attention_plain", boom)
    q = _randn((4, 1, 16, 128), dev, torch.bfloat16, 32)
    kv = _randn((4, 2, 64, 128), dev, torch.bfloat16, 33)
    lens = torch.tensor([1, 64, 30, 2], device=dev)
    pool = kv.reshape(4, 2, 4, 16, 128).transpose(1, 2).reshape(16, 2, 16, 128).contiguous()
    bt = torch.arange(16, dtype=torch.int32, device=dev).reshape(4, 4)
    K4.paged_decode_attention(q[:, 0], pool, pool, bt, lens, page_size=16)
    P.stream_only(q, kv, kv, chunk=16, rb=4)
    P.bigmm_decode_attention(q, kv, kv, lens, chunk=16)
    torch.cuda.synchronize()


def test_p2_refuses_a_misaligned_view(dev):
    """P2 loads q, k and v as 16-byte vectors: a contiguous view off a 16-byte
    boundary is refused before launch."""
    H, Hkv, D, T = 16, 2, 128, 512
    q = _randn((4, H, D), dev, torch.bfloat16, 34)
    kv = _randn((4 * Hkv * T * D + 1,), dev, torch.bfloat16, 35)
    k = kv[1:].view(4, Hkv, T, D)  # contiguous, 2 bytes past the allocation's start
    lens = torch.tensor([1, 512, 30, 200], device=dev)
    n0 = P.bigmm_decode_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        P.bigmm_decode_cuda(q, k, k, lens, chunk=512)
    qv = _randn((4 * H * D + 1,), dev, torch.bfloat16, 36)[1:].view(4, H, D)
    aligned = kv[: 4 * Hkv * T * D].view(4, Hkv, T, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        P.bigmm_decode_cuda(qv, aligned, aligned, lens, chunk=512)
    assert P.bigmm_decode_cuda.launches == n0


def test_calls_captured_into_a_cuda_graph_are_not_counted(dev):
    """Capture launches nothing, so the count stays; the replays run the kernels."""
    q = _randn((4, 1, 16, 128), dev, torch.bfloat16, 37)
    kv = _randn((4, 2, 512, 128), dev, torch.bfloat16, 38)
    lens = torch.tensor([1, 512, 300, 77], device=dev)
    wrappers = (K3.decode_attention_cuda, P.bigmm_decode_cuda, P.stream_only_cuda)
    fns = (lambda: K3.decode_attention_cuda(q, kv, kv, lens), lambda: P.bigmm_decode_cuda(q, kv, kv, lens, chunk=512),
           lambda: P.stream_only_cuda(q, kv, kv, chunk=128, rb=4)[0])
    eager = [f() for f in fns]  # warm-up outside capture: counted
    torch.cuda.synchronize()
    n0 = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in fns]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == n0
    for out, ref in zip(outs, eager):  # P1 adds with atomics: in any order, one bf16 step apart
        assert bool(((out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs() + 1e-5).all())


# ---------------------------------------------------------------------------
# K1 and K2 on the tensor cores (csrc/flash_mma.cuh): edges, variants, graph capture
# ---------------------------------------------------------------------------

def _segments(runs, pad, dev):
    return torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                     + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)]).to(dev)


@pytest.mark.parametrize("D", [16, 80, 128])
@pytest.mark.parametrize("runs,pad", [
    ((64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64), 37),  # windows of 16-64 rows: every tile compares
    ((40, 1296, 64, 24), 37),  # one long segment: its inner tiles skip the compare
    ((100, 91), 0),  # a boundary inside a tile, S no multiple of 128, no pad
    ((128, 128), 0),  # blocks and segments coincide
])
def test_k1_tensor_core_edges_match_plain(dev, D, runs, pad):
    S, H = sum(runs) + pad, 4
    seg = _segments(runs, pad, dev)
    qkv = _randn((S, 3, H, D), dev, torch.bfloat16, 50)
    before = dict(K1.segment_attention_cuda.variants)
    for q, k, v in ((qkv[:, 0], qkv[:, 1], qkv[:, 2]), tuple(qkv[:, i].contiguous() for i in range(3))):
        out = K1.segment_attention_cuda(q, k, v, seg)
        torch.cuda.synchronize()
        assert _err(out, K1.flash_segment_attention_plain(q, k, v, seg)) <= TOL[torch.bfloat16]
    assert K1.segment_attention_cuda.variants == {"mma": before["mma"] + 2, "fma": before["fma"]}


def _k2_edge_case(dev, D=128, G=8):
    B, S, Hkv, T, tile = 5, 40, 2, 300, K2.TILE
    ar = torch.arange(S, device=dev)
    pad_pos = torch.cat([100 + ar[:20], torch.tensor([299, 121, 250, 120, 5, 180, 150, 299, 122, 64] * 2, device=dev)])
    pos = torch.stack([ar, tile - S + ar, tile - S + 1 + ar, 2 * tile - S - 1 + ar, pad_pos])
    kv_len = torch.tensor([0, tile, tile + 1, 2 * tile - 1, 120], device=dev)
    return _randn((B, S, G * Hkv, D), dev, torch.bfloat16, 51), pos, kv_len, (B, Hkv, T, D)


def _k2_expected(q, k, v, pos, kv_len, ks=None, vs=None):
    """The plain version, with 0 for a row that has no live key (the kernel's answer)."""
    ref = K2.flash_causal_attention_plain(q, k, v, pos, kv_len, ks, vs)
    dead = torch.minimum(pos + 1, kv_len[:, None]) <= 0
    return torch.where(dead[:, :, None, None], torch.zeros_like(ref), ref)


@pytest.mark.parametrize("case", ["bf16", "int8", "prefix view", "D=16 G=2"])
def test_k2_tensor_core_edges_match_plain(dev, case):
    """kv_len 0, positions ending one before, at and after a tile boundary, S no
    multiple of 16, pad rows past kv_len in no order."""
    q, pos, kv_len, shape = _k2_edge_case(dev, *((16, 2) if case == "D=16 G=2" else ()))
    B, Hkv, T, D = shape
    ks = vs = None
    if case == "int8":
        k = torch.randint(-127, 128, shape, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, device=dev, dtype=torch.int8)
        ks, vs = torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005, torch.rand((B, Hkv, T), device=dev) * 0.02 + 0.005
    elif case == "prefix view":
        k, v = (_randn((B, Hkv, T + 212, D), dev, torch.bfloat16, s)[:, :, :T] for s in (52, 53))
    else:
        k, v = (_randn(shape, dev, torch.bfloat16, s) for s in (52, 53))
    before = dict(K2.causal_attention_cuda.variants)
    out = K2.causal_attention_cuda(q, k, v, pos, kv_len, ks, vs)
    torch.cuda.synchronize()
    assert _err(out, _k2_expected(q, k, v, pos, kv_len, ks, vs)) <= TOL[torch.bfloat16]
    assert not bool(out[0].any())
    assert K2.causal_attention_cuda.variants == {"mma": before["mma"] + 1, "fma": before["fma"]}


def test_k1_k2_variants_follow_the_dtype(dev):
    """bf16 runs the tensor-core variants (K1 only where D is a multiple of 16), fp32
    the fp32-arithmetic ones; the counts say which ran."""
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    pos, kv_len = torch.arange(8, device=dev)[None], torch.tensor([8], device=dev)
    for dtype, D, k1, k2 in ((torch.bfloat16, 16, "mma", "mma"), (torch.bfloat16, 8, "fma", None),
                             (torch.float32, 16, "fma", "fma")):
        b1, b2 = dict(K1.segment_attention_cuda.variants), dict(K2.causal_attention_cuda.variants)
        x = _randn((64, 2, D), dev, dtype, 54)
        K1.segment_attention_cuda(x, x, x, seg)
        b1[k1] += 1
        assert K1.segment_attention_cuda.variants == b1
        if k2 is not None:
            q, kv = _randn((1, 8, 4, D), dev, dtype, 55), _randn((1, 2, 8, D), dev, dtype, 56)
            K2.causal_attention_cuda(q, kv, kv, pos, kv_len)
            b2[k2] += 1
            assert K2.causal_attention_cuda.variants == b2
    torch.cuda.synchronize()


def test_k1_k2_refuse_misaligned_views(dev):
    B, S, H, Hkv, D, T = 2, 16, 16, 2, 128, 64
    q = _randn((B, S, H, D), dev, torch.bfloat16, 57)
    wide = _randn((B, Hkv, T, D + 4), dev, torch.bfloat16, 58)[..., :D]  # slot stride 264 bytes
    off = _randn((B * Hkv * T * D + 1,), dev, torch.bfloat16, 59)[1:].view(B, Hkv, T, D)  # base 2 bytes in
    pos, kv_len = torch.arange(S, device=dev)[None].expand(B, S), torch.tensor([S, S], device=dev)
    n2 = K2.causal_attention_cuda.launches
    for k in (wide, off):
        with pytest.raises(ValueError, match="16-byte"):
            K2.causal_attention_cuda(q, k, k, pos, kv_len)
    assert K2.causal_attention_cuda.launches == n2
    x = _randn((64, 2, 20), dev, torch.bfloat16, 60)[..., :16]  # 40-byte row stride
    n1 = K1.segment_attention_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        K1.segment_attention_cuda(x, x, x, torch.zeros(64, dtype=torch.int32, device=dev))
    assert K1.segment_attention_cuda.launches == n1


def test_k1_and_k2_replay_in_a_cuda_graph_to_the_eager_result(dev):
    """Capture fails on a host sync, so a wrapper that captures waits for nothing; the
    replay gives the eager result bit for bit (no atomics in either kernel), and
    captured calls are not counted."""
    seg = _segments((40, 300, 64, 24), 21, dev)
    qkv = _randn((seg.shape[0], 3, 4, 80), dev, torch.bfloat16, 61)
    q, pos, kv_len, shape = _k2_edge_case(dev)
    k, v = (_randn(shape, dev, torch.bfloat16, s) for s in (62, 63))
    fns = (lambda: K1.segment_attention_cuda(qkv[:, 0], qkv[:, 1], qkv[:, 2], seg),
           lambda: K2.causal_attention_cuda(q, k, v, pos, kv_len))
    eager = [f() for f in fns]
    torch.cuda.synchronize()
    counts = (K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches,
              dict(K1.segment_attention_cuda.variants), dict(K2.causal_attention_cuda.variants))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in fns]
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, eager):
        assert torch.equal(out, ref)
    assert counts == (K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches,
                      K1.segment_attention_cuda.variants, K2.causal_attention_cuda.variants)
