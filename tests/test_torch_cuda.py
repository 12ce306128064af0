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


def test_tiny_internvl_runner_on_card_matches_cpu(dev):
    """The tiny InternVL config in fp32 on the card (InternViT in plain torch ops, K2 and
    K3 for the decoder, K1 never) gives the CPU plain path's embeddings, prefill logits
    and greedy tokens over two images of different aspect."""
    from PIL import Image

    from zoomearth_tpu_torch.config import InternVLVLMConfig
    from zoomearth_tpu_torch.models.internvit import init_internvl_params
    from zoomearth_tpu_torch.models.internvl import InternVLRunner
    from zoomearth_tpu_torch.models.params import map_tree
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    cfg = InternVLVLMConfig.tiny()
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in ((200, 100), (90, 150))]
    questions = ["where is the ship?", "a road?"]
    params = init_internvl_params(cfg, torch.Generator().manual_seed(0))
    tok = FakeTokenizer(cfg.tokens)
    cpu = InternVLRunner(params, cfg, tok, max_cache_len=1024, device="cpu")
    gpu = InternVLRunner(map_tree(lambda t: t.to(dev), params), cfg, tok, max_cache_len=1024, device=dev)
    (ec, counts), (eg, counts_g) = cpu.encode_images(images), gpu.encode_images(images)
    assert counts == counts_g == [9, 7] and eg.device.type == "cuda"
    assert _err(ec, eg.cpu()) <= TOL[torch.float32]
    bc, bg = cpu.prepare(questions, ec, counts), gpu.prepare(questions, eg, counts)
    assert _err(cpu.generator.run_prefill(bc, max_new=12)[0], gpu.generator.run_prefill(bg, max_new=12)[0].cpu()) <= 1e-4
    n = [K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches, K3.decode_attention_cuda.launches]
    gen = GenerationConfig(max_new_tokens=12, temperature=0.0)
    assert gpu.generator.generate(bg, gen) == cpu.generator.generate(bc, gen)
    assert gpu.generate(questions, images, gen) == cpu.generate(questions, images, gen)
    assert K1.segment_attention_cuda.launches == n[0]
    assert K2.causal_attention_cuda.launches > n[1] and K3.decode_attention_cuda.launches > n[2]


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


# ---------------------------------------------------------------------------
# The pair runner, the int8 KV cache and the pinned readback on the card
# ---------------------------------------------------------------------------

def _wave_hooks(cfg, B=2):
    """Text-only two-stage hooks for run_paired_waves (host code, seeded)."""
    from zoomearth_tpu_torch.runtime.generate import prepare_batch, prepare_continuation

    tok = cfg.tokens

    def build_stage1(w):
        rngw = np.random.default_rng(w)
        seqs = [[tok.im_start] + [int(t) for t in rngw.integers(1, 300, size=4 + b)] for b in range(B)]
        return prepare_batch(cfg, seqs, [[] for _ in range(B)], length_buckets=(16,), patch_buckets=(0,))

    def build_stage2(w, out1, base_lengths, base_next):
        rngw = np.random.default_rng(100 + w)
        chunks = [[int(t) for t in rngw.integers(1, 300, size=3)] for _ in range(B)]
        keep = np.asarray([int(base_lengths[b]) + len(out1[b]) for b in range(B)], np.int32)
        starts = [int(base_next[b]) + len(out1[b]) for b in range(B)]
        return prepare_continuation(cfg, chunks, [[] for _ in range(B)], starts, length_buckets=(16,)), keep, None

    return build_stage1, build_stage2


@pytest.mark.parametrize("edges", ["dummy", "solo"])
def test_tiny_pair_runner_on_card_matches_cpu(dev, edges):
    """run_paired_waves, tiny config in fp32: three waves with budgets 7 / 4 on the
    card (K2 for prefill and chunk prefill, K3 twice per layer per pair step, tokens
    read back through pinned buffers) give the CPU plain path's tokens."""
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator
    from zoomearth_tpu_torch.runtime.pipeline import run_paired_waves

    cfg = VLMConfig.tiny()
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    s1, s2 = _wave_hooks(cfg)
    g1, g2 = GenerationConfig(max_new_tokens=7, temperature=0.0), GenerationConfig(max_new_tokens=4, temperature=0.0)
    outs = []
    for p in (params, map_tree(lambda t: t.to(dev), params)):
        n = K3.decode_attention_cuda.launches
        res = run_paired_waves(Generator(p, cfg, max_cache_len=64), 3, s1, s2, gen1=g1, gen2=g2, edges=edges)
        outs.append([(r.wave, r.out1, r.out2) for r in res])
    assert outs[1] == outs[0] and [w for w, _, _ in outs[1]] == [0, 1, 2]
    ran = K3.decode_attention_cuda.launches - n
    if all(len(row) == budget for _, o1, o2 in outs[1] for out, budget in ((o1, 7), (o2, 4)) for row in out):
        # no row stopped early: 4 joint steps a pair loop, stage 1's 3-step tails, the solo bootstrap and drain
        pair_loops, solo_steps = (4, 3 * 3) if edges == "dummy" else (2, 2 * 3 + 7 + 4)
        assert ran == cfg.text.num_hidden_layers * (2 * 4 * pair_loops + solo_steps)
    assert ran > 0


def test_int8_cache_on_card_matches_plain_versions(dev):
    """Generator(cache_dtype=torch.int8), tiny config in bf16 on the card: prefill,
    chunk prefill and decode logits through K2's and K3's int8 entries against the
    same path through their plain versions on the card; the scales go to the kernels
    as the cache's own fp32 views."""
    import dataclasses

    from zoomearth_tpu_torch.models import decoder
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator, prepare_continuation

    cfg = dataclasses.replace(VLMConfig.tiny(), dtype="bfloat16")
    params = map_tree(lambda t: t.to(dev).to(torch.bfloat16), init_vlm_params(cfg, torch.Generator().manual_seed(0)))
    s1, _ = _wave_hooks(cfg, B=3)
    b1 = s1(0)
    chunk = prepare_continuation(cfg, [[7, 8, 9], [10], [11, 12]], [[], [], []], np.asarray(b1.next_pos) + 2,
                                 length_buckets=(16,))

    def path():
        g = Generator(params, cfg, max_cache_len=64, cache_dtype=torch.int8)
        logits, cache, attend = g.run_prefill(b1, max_new=4)
        toks, cache = g.run_decode(logits, cache, b1.next_pos, GenerationConfig(max_new_tokens=2), attend=attend)
        logits2, cache, _ = g.run_chunk_prefill(cache, chunk, np.asarray(b1.lengths) + 2, max_new=4)
        return logits, toks, logits2, cache

    n = [K2.causal_attention_cuda.launches, K2.causal_attention_cuda.int8_launches,
         K3.decode_attention_cuda.launches, K3.decode_attention_cuda.int8_launches]
    l1, toks, l2, cache = path()
    torch.cuda.synchronize()
    m = [K2.causal_attention_cuda.launches, K2.causal_attention_cuda.int8_launches,
         K3.decode_attention_cuda.launches, K3.decode_attention_cuda.int8_launches]
    L = cfg.text.num_hidden_layers
    assert [b - a for a, b in zip(n, m)] == [2 * L, 2 * L, 2 * L, 2 * L]
    assert cache.quantized and cache.k[0].dtype == torch.int8 and cache.kscale[0].dtype == torch.float32
    ks, vs = cache.kscale[0][:, :, :32], cache.vscale[0][:, :, :32]
    assert _cuda.scale_views("test", ks, vs)[0] is ks  # a prefix view goes in as it is
    _cuda.require_aligned16("test", cache.k[0][:, :, :32], cache.v[0][:, :, :32])
    kernels = (decoder.flash_causal_attention, decoder.flash_decode_attention)
    decoder.flash_causal_attention, decoder.flash_decode_attention = (K2.flash_causal_attention_plain,
                                                                      K3.flash_decode_attention_plain)
    try:
        p1, ptoks, p2, pcache = path()
    finally:
        decoder.flash_causal_attention, decoder.flash_decode_attention = kernels
    # bf16 activations through two layers (the bound of the tiny bf16 parity check of the chip smoke)
    assert _err(l1, p1) <= 6e-2 and _err(l2, p2) <= 6e-2
    assert bool(torch.isfinite(l1).all() and torch.isfinite(l2).all())
    assert torch.equal(cache.k[0], pcache.k[0]) and torch.equal(cache.kscale[0], pcache.kscale[0])  # layer 0: same inputs


def test_host_copy_waits_for_its_event(dev):
    """HostCopy of a CUDA tensor: a pinned buffer, filled behind work still queued on
    the stream, read only after the recorded event."""
    from zoomearth_tpu_torch.runtime.generate import HostCopy

    a = _randn((2048, 2048), dev, torch.float32, 1)
    x = a
    for _ in range(20):  # keep the stream busy so the copy is queued behind real work
        x = (x @ a) * 1e-2
    t = (x.abs().sum(1) > 0).to(torch.int64) * torch.arange(2048, device=dev)
    h = HostCopy(t)
    assert h._buf.is_pinned() and h._event is not None
    np.testing.assert_array_equal(h.numpy(), t.cpu().numpy())
    assert h.numpy().tolist() == list(range(2048))


# ---------------------------------------------------------------------------
# The serving engine on the card
# ---------------------------------------------------------------------------

def _engine_traffic(cfg):
    """Prompts for the engine tests: two text rows, an image row, and a 'system + image'
    prefix shared by three suffixes."""
    tok = cfg.tokens
    rng = np.random.default_rng(3)

    def image(grid):
        n = grid[1] * grid[2]
        return (rng.standard_normal((n, cfg.vision.patch_dim)).astype(np.float32), grid), n // cfg.vision.merge_unit

    def text(n):
        return [tok.im_start] + [int(t) for t in rng.integers(1, 400, size=n)]

    img, n_img = image((1, 4, 4))
    burst = [(text(6), []), (text(9) + [tok.vision_start] + [tok.image_pad] * n_img + [tok.vision_end], [img]),
             (text(12), []), (text(4), []), (text(15), [])]
    pimg, n_pimg = image((1, 4, 8))
    prefix = text(4) + [tok.vision_start] + [tok.image_pad] * n_pimg + [tok.vision_end]
    shared = [(prefix + text(5)[1:], [pimg]) for _ in range(3)]
    return burst, prefix, shared


def _engine_run(params, cfg, cache_dtype, compact=True):
    """A burst beyond capacity (rows queue, join and leave), a prefix miss then hits, a
    held row continued with an image chunk: every request's tokens, and the engine."""
    from zoomearth_tpu_torch.serve.engine import Continuation, Request, ServingEngine

    burst, prefix, shared = _engine_traffic(cfg)
    e = ServingEngine(params, cfg, max_slots=4, max_seq_len=128, decode_chunk=3, cache_dtype=cache_dtype,
                      length_buckets=(64, 128), patch_buckets=(0, 16, 64))
    if not compact:
        e.decode_row_buckets = ()
    out = {}
    for i, (ids, imgs) in enumerate(burst):
        e.submit(Request(request_id=f"b{i}", token_ids=ids, images=imgs, max_tokens=(3, 12, 5, 9, 7)[i]))
    e.run_until_idle()
    for i, (ids, imgs) in enumerate(shared):
        e.submit(Request(request_id=f"p{i}", token_ids=ids, images=imgs, max_tokens=6, prefix_key="tile",
                         prefix_len=len(prefix), n_prefix_images=1, hold_slot=i == 2))
        e.run_until_idle()
    tok = cfg.tokens
    crop = (np.random.default_rng(4).standard_normal((8, cfg.vision.patch_dim)).astype(np.float32), (1, 2, 4))
    e.submit_continuation(Continuation(parent_request_id="p2", request_id="p2c", images=[crop], kept_tokens=3,
                                       chunk_ids=[tok.vision_start] + [tok.image_pad] * 2 + [tok.vision_end],
                                       max_tokens=5))
    e.run_until_idle()
    for rid in [f"b{i}" for i in range(5)] + ["p0", "p1", "p2", "p2c"]:
        out[rid] = e.get_completion(rid, timeout=5).token_ids
    assert e.stats["prefix_saves"] == 1 and e.stats["prefix_hits"] == 2 and not e.active.any() and not e.held
    return out, e


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_tiny_engine_on_card_matches_cpu_engine(dev, cache_dtype):
    """The tiny fp32 engine on the card, token for token the port's CPU engine: a fresh
    burst with queueing, prefix hits, a continuation, compact and full-width decode,
    with the fp32 and the int8 KV cache; K1, K2 and K3 launched (the int8 entries with
    the int8 cache)."""
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree

    cfg = VLMConfig.tiny()
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    cpu, _ = _engine_run(params, cfg, cache_dtype)
    cuda_params = map_tree(lambda t: t.to(dev), params)
    wrappers = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)
    before = [w.launches for w in wrappers]
    int8_before = [w.int8_launches for w in wrappers[1:]]
    out, e = _engine_run(cuda_params, cfg, cache_dtype)
    ran = [w.launches - n for w, n in zip(wrappers, before)]
    int8_ran = [w.int8_launches - n for w, n in zip(wrappers[1:], int8_before)]
    assert e.device.type == "cuda" and e.cache.k[0].device.type == "cuda"
    assert out == cpu
    assert all(n > 0 for n in ran) and int8_ran == (ran[1:] if cache_dtype == "int8" else [0, 0])
    assert e.stats["decode_device_row_steps"] < 4 * e.stats["decode_steps"]  # compact chunks ran
    full, e_full = _engine_run(cuda_params, cfg, cache_dtype, compact=False)
    assert full == out and e_full.stats["decode_device_row_steps"] == 4 * e_full.stats["decode_steps"]


def test_engine_pump_thread_on_card_runs_under_inference_mode(dev):
    """The pump thread writes the pool (inference tensors made by another thread) and
    launches the kernels on the engine's device: tokens equal the engine ticked from the
    thread that built it, sampled rows included (one seed, one stream)."""
    from zoomearth_tpu_torch.models.params import init_vlm_params
    from zoomearth_tpu_torch.serve.engine import Request, ServingEngine

    cfg = VLMConfig.tiny()
    params = init_vlm_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    burst, _, _ = _engine_traffic(cfg)

    def run(pump):
        e = ServingEngine(params, cfg, max_slots=4, max_seq_len=128, decode_chunk=3, cache_dtype="float32",
                          length_buckets=(64,), patch_buckets=(0, 16), seed=5)
        e.admit_min_batch = 4  # the first four rows share one admission, pump or not
        assert e.cache.k[0].is_inference()
        seen = []
        e.on_tokens = lambda rid, toks: seen.append(torch.is_inference_mode_enabled())
        for i, (ids, imgs) in enumerate(burst[:4]):
            e.submit(Request(request_id=f"r{i}", token_ids=ids, images=imgs, max_tokens=8,
                             temperature=0.0 if i % 2 == 0 else 1.2))
        if pump:
            e.start()
        else:
            e.run_until_idle()
        try:
            return [e.get_completion(f"r{i}", timeout=60).token_ids for i in range(4)]
        finally:
            e.stop()

    assert run(pump=True) == run(pump=False)


@pytest.mark.parametrize("rows,attend", [(4, 512), (8, 1536), (2, None)])
def test_k2_k3_at_the_engines_row_counts_and_attend_spans(dev, rows, attend):
    """K2 and K3 on gathered copies of pool rows (advanced-index copies, as the pool
    prefill and the compact decode make them) at row counts of 2, 4 and 8 and prefix
    views of 512 and 1536 slots of a 2048-slot pool, bf16 and int8."""
    H, Hkv, D, T, S = 16, 2, 128, 2048, 128
    pool = [_randn((8, Hkv, T, D), dev, torch.bfloat16, 30 + i) for i in range(2)]
    pool8 = [torch.randint(-127, 128, (8, Hkv, T, D), device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((8, Hkv, T), device=dev) * 0.02 + 0.005 for _ in range(2)]
    cidx = torch.as_tensor(([7, 2, 5, 0, 3, 6, 1, 4] * 2)[:rows], device=dev)
    span = attend or T
    keep = torch.as_tensor([(37 * r + 5) % (span - S) for r in range(rows)], device=dev)
    q = _randn((rows, S, H, D), dev, torch.bfloat16, 40)
    pos = keep[:, None] + torch.arange(S, device=dev)[None]
    for (k, v), (ks, vs) in ((pool, (None, None)), (pool8, scales)):
        gk, gv = k[cidx], v[cidx]
        gs = (ks[cidx], vs[cidx]) if ks is not None else (None, None)
        out = K2.causal_attention_cuda(q, gk, gv, pos, keep + S, *gs)
        assert _err(out, K2.flash_causal_attention_plain(q, gk, gv, pos, keep + S, *gs)) <= TOL[torch.bfloat16]
        view = [t[:, :, :span] if t is not None else None for t in (gk, gv, *gs)]
        out = K3.decode_attention_cuda(q[:, :1], view[0], view[1], keep + S, view[2], view[3])
        ref = K3.flash_decode_attention_plain(q[:, :1], view[0], view[1], keep + S, view[2], view[3])
        assert _err(out, ref) <= TOL[torch.bfloat16]
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Training: K1's and K2's backward kernels, the forward's lse, the logits head
# ---------------------------------------------------------------------------

def _grad_tol(ref, dtype):
    """fp32: 1e-4 of the largest gradient (or 1e-4, below 1): the kernels sum in
    another order. bf16: the same fp32 arithmetic on the same bf16 inputs, then one
    rounding of each output to bf16, so one bf16 step (2^-7) of the largest value."""
    scale = max(1.0, ref.abs().max().item())
    return (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale


def _assert_grads(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert _err(a, b) <= _grad_tol(b, dtype), (name, _err(a, b), _grad_tol(b, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,D,runs", [
    (64, 4, 8, (64,)),  # the tiny ViT's head dim
    (300, 2, 16, (100, 37, 120)),  # a pad tail
    (661, 4, 80, (64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64)),  # windows of 16-64 rows + pad tail
    (2600, 16, 80, (1296, 1000)),  # a boundary inside a tile, S no multiple of 32 or 128
    (200, 4, 128, (50, 150)),
])
def test_k1_backward_matches_plain(dev, dtype, S, H, D, runs):
    """K1's forward lse and its backward kernel against the plain versions, on the
    fused-qkv views the ViT passes."""
    seg = _segments(runs, S - sum(runs), dev)
    qkv = _randn((S, 3, H, D), dev, dtype, 70)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
    _, lse_ref = K1.flash_segment_attention_plain(q, k, v, seg, return_lse=True)
    dout = _randn((S, H, D), dev, dtype, 71)
    n0, v0 = K1.segment_attention_bwd_cuda.launches, dict(K1.segment_attention_bwd_cuda.variants)
    got = K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse)
    torch.cuda.synchronize()
    assert K1.segment_attention_bwd_cuda.launches == n0 + 1
    # bf16 at a head dim that is a multiple of 16 takes the tensor cores; fp32 and D = 8 the FMA kernels
    ran = "mma" if dtype == torch.bfloat16 and D % 16 == 0 else "fma"
    assert K1.segment_attention_bwd_cuda.variants[ran] == v0[ran] + 1
    assert K1.bwd_variant_rows(dtype, D) == _cuda.lib().zt_flash_bwd_variant(_cuda.DTYPE_CODES[dtype], D)
    # lse: the plain version's from the same inputs; the kernels sum the same fp32 logits' weights in fp32
    # (the tensor-core variant rounds p to bf16 only for p @ v), in another order
    assert _err(lse, lse_ref) <= (1e-4 if dtype == torch.float32 else 1e-3)
    _assert_grads(got, K1.flash_segment_attention_bwd_plain(q, k, v, seg, out, dout, lse), dtype)


def _k2_train_case(dev, dtype, B, S, H, Hkv, D, kv_len):
    q = _randn((B, S, H, D), dev, dtype, 72)
    k = _randn((B, S, Hkv, D), dev, dtype, 73).transpose(1, 2)  # the decoder's no-cache views
    v = _randn((B, S, Hkv, D), dev, dtype, 74).transpose(1, 2)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    return q, k, v, pos, torch.tensor(kv_len, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D,kv_len", [
    (2, 40, 4, 2, 16, (40, 27)),  # the tiny config's heads; pad queries past kv_len
    (3, 150, 16, 2, 128, (150, 0, 97)),  # the 3B config's heads, a row with no live key
    (1, 300, 8, 8, 64, (300,)),  # G = 1
    (1, 64, 32, 1, 32, (64,)),  # G = 32, the most BWD_TILE allows
])
def test_k2_backward_matches_plain(dev, dtype, B, S, H, Hkv, D, kv_len):
    """K2's forward lse and its backward kernel against the plain versions on the
    transposed no-cache views; dk and dv come back in k's and v's layout, and a row
    with no live key gets zero gradients."""
    q, k, v, pos, kvl = _k2_train_case(dev, dtype, B, S, H, Hkv, D, kv_len)
    out, lse = K2.causal_attention_cuda(q, k, v, pos, kvl, return_lse=True)
    _, lse_ref = K2.flash_causal_attention_plain(q, k, v, pos, kvl, return_lse=True)
    dout = _randn((B, S, H, D), dev, dtype, 75)
    n0, v0 = K2.causal_attention_bwd_cuda.launches, dict(K2.causal_attention_bwd_cuda.variants)
    got = K2.causal_attention_bwd_cuda(q, k, v, pos, kvl, out, dout, lse)
    torch.cuda.synchronize()
    assert K2.causal_attention_bwd_cuda.launches == n0 + 1
    ran = "mma" if dtype == torch.bfloat16 else "fma"
    assert K2.causal_attention_bwd_cuda.variants[ran] == v0[ran] + 1
    assert _err(lse, lse_ref) <= (1e-4 if dtype == torch.float32 else 1e-3)
    assert got[1].stride() == k.stride() and got[2].stride() == v.stride()
    _assert_grads(got, K2.flash_causal_attention_bwd_plain(q, k, v, pos, kvl, out, dout, lse), dtype)
    for b, n in enumerate(kv_len):
        if n == 0:
            assert not any(bool(g[b].any()) for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_give_the_same_bits_every_call(dev, dtype):
    """No atomics: two calls of each backward kernel on the same inputs give equal bits,
    K2's at a shape whose dk/dv blocks split their query tiles (fp32 partials added in
    split order), K1's at a full-attention image and at windows."""
    seg = _segments((1296, 40, 64, 16, 48), 100, dev)
    D = 80 if dtype == torch.bfloat16 else 8
    qkv = _randn((seg.shape[0], 3, 4, D), dev, dtype, 83)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
    dout = _randn(tuple(out.shape), dev, dtype, 84)
    a = K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse)
    b = K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse)
    q, k, v, pos, kvl = _k2_train_case(dev, dtype, 1, 1000, 16, 2, 128, (1000,))
    out, lse = K2.causal_attention_cuda(q, k, v, pos, kvl, return_lse=True)
    dout = _randn(tuple(out.shape), dev, dtype, 85)
    c = K2.causal_attention_bwd_cuda(q, k, v, pos, kvl, out, dout, lse)
    d = K2.causal_attention_bwd_cuda(q, k, v, pos, kvl, out, dout, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a + c, b + d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_output_is_unchanged_by_lse(dev, dtype):
    """The lse output leaves the inference paths' outputs bit for bit as they were."""
    seg = _segments((40, 300, 64, 24), 21, dev)
    D = 80 if dtype == torch.bfloat16 else 8
    qkv = _randn((seg.shape[0], 3, 4, D), dev, dtype, 76)
    a = K1.segment_attention_cuda(qkv[:, 0], qkv[:, 1], qkv[:, 2], seg)
    b, _ = K1.segment_attention_cuda(qkv[:, 0], qkv[:, 1], qkv[:, 2], seg, return_lse=True)
    q, k, v, pos, kvl = _k2_train_case(dev, dtype, 2, 100, 16, 2, 128, (100, 61))
    c = K2.causal_attention_cuda(q, k, v, pos, kvl)
    d, _ = K2.causal_attention_cuda(q, k, v, pos, kvl, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


def test_autograd_on_card_goes_through_the_backward_kernels(dev, monkeypatch):
    """flash_segment_attention / flash_causal_attention under autograd on CUDA tensors:
    the forward kernel with lse, then the backward kernel, never a plain version."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("flash_segment_attention_plain", "flash_segment_attention_bwd_plain"):
        monkeypatch.setattr(K1, name, refuse)
    for name in ("flash_causal_attention_plain", "flash_causal_attention_bwd_plain"):
        monkeypatch.setattr(K2, name, refuse)
    seg = _segments((40, 60), 28, dev)
    x = _randn((128, 3, 4, 80), dev, torch.bfloat16, 77).requires_grad_()
    q, k, v, pos, kvl = _k2_train_case(dev, torch.bfloat16, 2, 64, 16, 2, 128, (64, 50))
    q.requires_grad_()
    n = (K1.segment_attention_cuda.launches, K1.segment_attention_bwd_cuda.launches,
         K2.causal_attention_cuda.launches, K2.causal_attention_bwd_cuda.launches)
    y = K1.flash_segment_attention(x[:, 0], x[:, 1], x[:, 2], seg).float().sum()
    y = y + K2.flash_causal_attention(q, k, v, pos, kvl).float().sum()
    y.backward()
    torch.cuda.synchronize()
    assert (K1.segment_attention_cuda.launches, K1.segment_attention_bwd_cuda.launches,
            K2.causal_attention_cuda.launches, K2.causal_attention_bwd_cuda.launches) == tuple(c + 1 for c in n)
    assert bool(x.grad.abs().sum() > 0) and bool(q.grad.abs().sum() > 0)


def test_backward_refuses_int8_kv_and_cache_paths(dev):
    """Under autograd, int8 K/V and the decoder's cache paths raise before any launch."""
    from zoomearth_tpu_torch.models import decoder as DEC

    B, S, H, Hkv, D = 1, 16, 16, 2, 128
    q = _randn((B, S, H, D), dev, torch.bfloat16, 78).requires_grad_()
    k8 = torch.randint(-127, 128, (B, Hkv, S, D), device=dev, dtype=torch.int8)
    sc = torch.full((B, Hkv, S), 0.01, device=dev)
    pos, kvl = torch.arange(S, device=dev)[None], torch.tensor([S], device=dev)
    n = K2.causal_attention_cuda.launches
    with pytest.raises(NotImplementedError, match="int8"):
        K2.flash_causal_attention(q, k8, k8, pos, kvl, sc, sc)
    from zoomearth_tpu_torch.config import VLMConfig as PortConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params

    cfg = PortConfig.tiny().text
    params = init_vlm_params(PortConfig.tiny(), torch.Generator(device=dev).manual_seed(0), device=dev)["text"]
    params["layers"][0]["attn"]["wq"].requires_grad_()
    cache = DEC.KVCache.create(cfg, 1, 32, dtype=torch.float32, device=dev)
    x = _randn((1, 4, cfg.hidden_size), dev, torch.float32, 79)
    pid = torch.arange(4, device=dev)[None, None].expand(3, 1, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        DEC.decoder_forward(params, cfg, x, pid, cache=cache)
    assert K2.causal_attention_cuda.launches == n and not bool(cache.length.any())


def test_logits_head_gradient_on_card(dev):
    """The bf16 head's fp32-output product under autograd: dh and dw against an fp32
    reference (the gradient is rounded to bf16 for the two products, fp32 accumulation)."""
    from zoomearth_tpu_torch.config import VLMConfig as PortConfig
    from zoomearth_tpu_torch.models.decoder import logits_from_hidden

    cfg = PortConfig.tiny(vocab_size=4096).text
    w = _randn((cfg.vocab_size, cfg.hidden_size), dev, torch.bfloat16, 80).requires_grad_()
    h = _randn((2, 33, cfg.hidden_size), dev, torch.bfloat16, 81).requires_grad_()
    g = _randn((2, 33, cfg.vocab_size), dev, torch.float32, 82)
    logits = logits_from_hidden({"embed": {"weight": w}}, cfg, h)
    assert logits.dtype == torch.float32
    dh, dw = torch.autograd.grad(logits, (h, w), g)
    wf, hf = w.detach().float().requires_grad_(), h.detach().float().requires_grad_()
    rh, rw = torch.autograd.grad(hf @ wf.t(), (hf, wf), g)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    for got, ref in ((dh, rh), (dw, rw)):
        # g rounded to bf16 (2^-9 relative) and the result rounded to bf16 (2^-9): two bf16 half-steps
        assert _err(got, ref) <= 2.0 ** -7 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# GRPO: the backward kernels at the policy pass's shapes, LoRA's product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_at_the_grpo_policy_shape(dev, dtype):
    """The policy pass's decoder attention: B = 4 rows of S = T = 1024, kv_len = S (K2-bwd's dk/dv split plan at
    B > 1, which SFT's batch of one never takes)."""
    q, k, v, pos, kvl = _k2_train_case(dev, dtype, 4, 1024, 16, 2, 128, (1024,) * 4)
    out, lse = K2.causal_attention_cuda(q, k, v, pos, kvl, return_lse=True)
    dout = _randn((4, 1024, 16, 128), dev, dtype, 86)
    got = K2.causal_attention_bwd_cuda(q, k, v, pos, kvl, out, dout, lse)
    torch.cuda.synchronize()
    _assert_grads(got, K2.flash_causal_attention_bwd_plain(q, k, v, pos, kvl, out, dout, lse), dtype)


@pytest.mark.parametrize("which", ["seg_window", "seg_full"])
def test_k1_backward_at_the_grpo_cut_step(dev, which):
    """The cut step's ViT in the policy pass: 4 rows x (stage-1 image + crop) = 8 images of 36 x 36 patches
    (S = 10368), in the window segments and the full-image segments of the port's vision_metadata, bf16 on the
    tensor-core variant."""
    from zoomearth_tpu_torch.config import VLMConfig as PortConfig
    from zoomearth_tpu_torch.models.vit import vision_metadata

    vcfg = PortConfig.qwen2_5_vl_3b().vision
    meta = vision_metadata([(1, 36, 36)] * 8, vcfg, pad_to=10368)
    seg = torch.as_tensor(getattr(meta, which), dtype=torch.int32, device=dev)
    qkv = _randn((10368, 3, vcfg.num_heads, vcfg.head_dim), dev, torch.bfloat16, 87)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
    dout = _randn(tuple(out.shape), dev, torch.bfloat16, 88)
    v0 = dict(K1.segment_attention_bwd_cuda.variants)
    got = K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse)
    torch.cuda.synchronize()
    assert K1.segment_attention_bwd_cuda.variants["mma"] == v0["mma"] + 1
    _assert_grads(got, K1.flash_segment_attention_bwd_plain(q, k, v, seg, out, dout, lse), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_qdot_forward_and_backward_match_the_cpu(dev, dtype):
    """A LoRA weight ({"w", "a", "b", "s"}, 0-d s) through ops.quant.qdot on the card against the CPU in fp32:
    the output and the gradients of x, w, a, b and s."""
    from zoomearth_tpu_torch.ops.quant import qdot

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, 256, generator=g)
    leaf = {"w": torch.randn(256, 512, generator=g) * 0.05, "a": torch.randn(256, 8, generator=g) / 8,
            "b": torch.randn(8, 512, generator=g) * 0.01, "s": torch.tensor(2.0)}
    dy = torch.randn(3, 40, 512, generator=g)
    results = []
    for device, dt in (("cpu", torch.float32), (dev, dtype)):
        xs = x.to(device, dt).requires_grad_()
        w = {k: t.to(device, dt).requires_grad_() for k, t in leaf.items()}
        y = qdot(xs, w)
        grads = torch.autograd.grad(y, [xs] + [w[k] for k in ("w", "a", "b", "s")], dy.to(device, dt))
        results.append([t.float().cpu() for t in (y, *grads)])
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for name, got, ref in zip(("y", "dx", "dw", "da", "db", "ds"), results[1], results[0]):
        assert _err(got, ref) <= tol * max(1.0, ref.abs().max().item()), (name, _err(got, ref))
