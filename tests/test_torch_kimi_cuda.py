"""Kimi-VL's kernels and layers on the card: K5 (the latent-cache decode), K2 at key
width 192 and value width 128, the grouped expert products, and a small Kimi-VL at the
published attention widths through the Generator, against their plain versions and
the CPU. Marked `cuda`: every test skips where torch.cuda.is_available() is false.

On a machine with an NVIDIA GPU and nvcc:  python -m pytest -m cuda tests/test_torch_kimi_cuda.py

bf16 cases hold the kernels to 2e-2, as tests/test_torch_cuda.py does: roundings of
outputs below 2 (of the output, of the softmax weights, and in K5 of the absorbed
query the caller hands it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zoomearth_tpu_torch.config import KimiTextConfig, KimiVLConfig, MoonViTConfig
from zoomearth_tpu_torch.models import mla, moe
from zoomearth_tpu_torch.ops import flash_attention as K1
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_mla_decode as K5

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m cuda tests/test_torch_kimi_cuda.py)")
    return torch.device("cuda")


def _randn(shape, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _k5_case(dev, B, T, attend, lens):
    q = _randn((B, 16, 576), dev, 1)
    cache = _randn((B, 1, T, 576), dev, 2)
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return q, cache[:, :, :attend], kv_len


@pytest.mark.parametrize("B,T,attend,lens", [
    (3, 64, 64, (1, 33, 64)),
    (5, 1536, 1280, (1, 0, 1280, 700, 1000)),
    (96, 1536, 1536, tuple(int(x) for x in np.linspace(400, 1536, 96))),
])
def test_k5_matches_plain(dev, B, T, attend, lens):
    q, cache, kv_len = _k5_case(dev, B, T, attend, lens)
    n0 = K5.mla_decode_cuda.launches
    out = K5.mla_decode_cuda(q, cache, kv_len, 192**-0.5)
    torch.cuda.synchronize()
    assert K5.mla_decode_cuda.launches == n0 + 1
    ref = K5.flash_mla_decode_plain(q, cache, kv_len, 192**-0.5)
    assert _err(out, ref) <= TOL
    assert torch.all(out[kv_len == 0] == 0)


def test_k5_split_boundaries_and_a_captured_replay(dev):
    """Rows whose lengths sit on and next to split and tile boundaries; a graph replay
    gives the eager bits (no atomics)."""
    B, T = 8, 1024
    split, nsplit = K5.split_plan(B, T)
    lens = [split - 1, split, split + 1, 2 * split, K5.TILE, K5.TILE + 1, T, 1]
    q, cache, kv_len = _k5_case(dev, B, T, T, lens)
    eager = K5.mla_decode_cuda(q, cache, kv_len, 0.07)
    assert _err(eager, K5.flash_mla_decode_plain(q, cache, kv_len, 0.07)) <= TOL
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K5.mla_decode_cuda(q, cache, kv_len, 0.07)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_k5_refuses_other_widths(dev):
    q = _randn((2, 8, 576), dev, 3)
    with pytest.raises(ValueError):
        K5.mla_decode_cuda(q, _randn((2, 1, 64, 576), dev, 4), torch.ones(2, dtype=torch.int32, device=dev), 0.1)


@pytest.mark.parametrize("B,S,T,keep", [(2, 100, 300, (0, 150)), (3, 200, 200, (0, 0, 0)), (1, 64, 1000, (700,))])
def test_k2_at_key_width_192_value_width_128(dev, B, S, T, keep):
    """The expanded form's shapes: k and v as the strided views models.mla.expand gives."""
    H = 16
    q = _randn((B, S, H, 192), dev, 5)
    kv = _randn((B, T, H, 256), dev, 6)
    k = torch.cat([kv[..., :128], _randn((B, T, 1, 64), dev, 7).expand(B, T, H, 64)], -1).transpose(1, 2)
    v = kv[..., 128:].transpose(1, 2)
    keep = torch.as_tensor(keep, device=dev)
    positions = keep[:, None] + torch.arange(S, device=dev)[None]
    kv_len = (keep + S).clamp(max=T).to(torch.int32)
    n0 = K2.causal_attention_cuda.launches
    out = K2.causal_attention_cuda(q, k, v, positions, kv_len)
    torch.cuda.synchronize()
    assert K2.causal_attention_cuda.launches == n0 + 1 and out.shape == (B, S, H, 128)
    assert _err(out, K2.flash_causal_attention_plain(q, k, v, positions, kv_len)) <= TOL


def test_k1_at_moonvit_head_width_through_the_tower_padding(dev):
    """MoonViT's 72-wide heads run on K1 at 80 (zero-padded, q pre-scaled): equal to
    the plain 72-wide attention."""
    from zoomearth_tpu_torch.ops.attention import segment_attention

    S, H, D = 1296 * 2 + 64, 16, 72
    seg = torch.as_tensor(np.concatenate([np.zeros(1296), np.ones(1296), np.full(64, K1.PAD_SEG)]),
                          dtype=torch.int32, device=dev)
    q, k, v = (_randn((S, H, D), dev, 8 + i) for i in range(3))
    qp = (q.float() * (80 / 72) ** 0.5).to(torch.bfloat16)
    pad = torch.nn.functional.pad
    out = K1.segment_attention_cuda(pad(qp, (0, 8)), pad(k, (0, 8)), pad(v, (0, 8)), seg)[..., :72]
    ref = segment_attention(q.float(), k.float(), v.float(), seg)
    assert _err(out[:2592], ref[:2592]) <= TOL


def test_grouped_expert_products_match_a_loop_and_capture(dev):
    """torch._grouped_mm over sorted rows equals a loop over the groups, with empty
    groups; a MoE layer with it is captured into a graph and replays to the eager bits."""
    cfg = KimiTextConfig(hidden_size=256, moe_intermediate_size=128, n_routed_experts=16, num_experts_per_tok=6,
                         n_shared_experts=2)
    x = _randn((40, 256), dev, 10)
    w = _randn((16, 256, 128), dev, 11) * 0.05
    offs = torch.as_tensor([0, 5, 5, 12, 20, 20, 20, 25, 30, 31, 33, 36, 36, 38, 40, 40], dtype=torch.int32, device=dev)
    out = moe.grouped_mm(x, w, offs)
    ref = moe.grouped_mm(x.cpu().float(), w.cpu().float(), offs.cpu())
    assert _err(out.cpu(), ref) <= 0.05 * ref.abs().max().item()
    p = {"gate": _randn((256, 16), dev, 12) * 0.06, "bias": _randn((16,), dev, 13) * 0.02,
         "wg": _randn((16, 256, 128), dev, 14) * 0.05, "wu": _randn((16, 256, 128), dev, 15) * 0.05,
         "wd": _randn((16, 128, 256), dev, 16) * 0.05,
         "shared": {"wg": _randn((256, 256), dev, 17) * 0.05, "wu": _randn((256, 256), dev, 18) * 0.05,
                    "wd": _randn((256, 256), dev, 19) * 0.05}}
    h = _randn((96, 1, 256), dev, 20)
    with torch.inference_mode():
        eager = moe.moe_forward(p, cfg, h)
        cpu = moe.moe_forward({k: ({kk: vv.cpu().float() for kk, vv in v.items()} if isinstance(v, dict)
                                   else v.cpu().float()) for k, v in p.items()}, cfg, h.cpu().float())
        assert _err(eager.cpu(), cpu) <= 0.05 * cpu.abs().max().item()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe.moe_forward(p, cfg, h)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


def card_config() -> KimiVLConfig:
    """A small Kimi-VL at the published attention widths (16 heads, latent 512 + 64,
    MoonViT heads of 72) with few layers, experts and a small vocabulary."""
    tiny = KimiVLConfig.tiny(vocab_size=512)
    vision = MoonViTConfig(depth=2, hidden_size=144, intermediate_size=256, num_heads=2, init_pos_emb_height=8,
                           init_pos_emb_width=8, out_hidden_size=512)
    text = dataclasses.replace(KimiTextConfig(), vocab_size=512, hidden_size=512, intermediate_size=1024,
                               moe_intermediate_size=128, num_hidden_layers=3, n_routed_experts=16,
                               max_position_embeddings=4096)
    return dataclasses.replace(tiny, vision=vision, text=text, dtype="bfloat16")


def _card_model(dev, dtype):
    from portbench.harness.weights import make_weights
    from zoomearth_tpu_torch.models.kimi_vl import hf_leaves, params_from_hf

    cfg = card_config()
    W = make_weights(hf_leaves(cfg), 7, torch.device("cpu"), torch.float32)
    # A decisive router (experts 0-5 for every token): at random weights a choice near the
    # sixth expert's boundary flips between bf16 and fp32, and one flip moves a token's
    # logits by tenths; the grouped products still see empty groups.
    for name, t in W.items():
        if name.endswith("e_score_correction_bias"):
            t.copy_(torch.where(torch.arange(t.numel()) < 6, 10.0, -10.0))
    W = {k: v.to(dev, dtype) for k, v in W.items()}
    return cfg, params_from_hf(W, cfg)


def test_small_kimi_generator_on_card_follows_the_cpu(dev):
    """Prefill, chunk prefill over the kept cache and the pair decode of a small Kimi-VL
    at the published attention widths, in bf16 on the card (MoonViT on K1, K2 at
    192 / 128, K5 from captured steps, the grouped products), track the fp32 CPU run
    of the same weights: every step's logits within 5 % of their largest magnitude,
    and each launch counter moves."""
    from zoomearth_tpu_torch.runtime.generate import Generator, prepare_batch, prepare_continuation

    cfg, params = _card_model(dev, torch.bfloat16)
    cpu_params = _card_model(torch.device("cpu"), torch.float32)[1]
    tok = cfg.tokens
    rng = np.random.default_rng(0)

    def seqs(n, grid):
        m = grid[1] * grid[2] // 4
        out, imgs = [], []
        for i in range(n):
            out.append([tok.im_user, 40 + i, tok.media_start] + [tok.image_pad] * m + [tok.media_end, 50, 60 + i])
            imgs.append([(rng.integers(0, 256, (grid[1] * grid[2], 588), dtype=np.uint8), grid)])
        return out, imgs

    s1, i1 = seqs(4, (1, 8, 8))
    b1 = prepare_batch(cfg, s1, i1, length_buckets=(64,), patch_buckets=(256,))
    s2, i2 = seqs(4, (1, 4, 4))
    keep = np.asarray([len(s) for s in s1], np.int32)
    b2 = prepare_continuation(cfg, s2, i2, keep, length_buckets=(32,), patch_buckets=(64,))
    counts = [K1.segment_attention_cuda.launches, K2.causal_attention_cuda.launches, K5.mla_decode_cuda.launches,
              moe.grouped_mm.launches]
    outs = {}
    for name, p in (("card", params), ("cpu", cpu_params)):
        gen = Generator(p, cfg, max_cache_len=128, cache_dtype="bfloat16" if name == "card" else "float32")
        if name == "cpu":  # the card's tokens: both runs see the same inputs at every step
            picks = iter([(outs["card"][1][:4, j], outs["card"][1][4:, j]) for j in range(6)])
            pair = []

            def forced(logits, done, rng, temperature, top_p):
                if not pair:
                    pair.extend(next(picks))
                return pair.pop(0).clone(), done

            gen._pick = forced
        with torch.inference_mode():
            l1, c1, a1 = gen.run_prefill(b1, max_new=8)
            l2, c2, a2 = gen.run_chunk_prefill(c1.clone(), b2, keep, max_new=8)
            st, step, _ = gen.pair_step((l1, c1, b1.next_pos, a1, None), (l2, c2, b2.next_pos, a2, None), steps=8)
            logits = [st.logits.clone()]
            key = ("test", name)
            for _ in range(6):
                gen.graphs.run(key, step)
                logits.append(st.logits.clone())
            gen.graphs.release(key)
        outs[name] = [t.float().cpu() for t in logits], st.tokens.cpu()
    errs = [_err(card, cpu) / cpu.abs().max().item() for card, cpu in zip(outs["card"][0], outs["cpu"][0])]
    assert max(errs) <= 0.05, errs
    assert K1.segment_attention_cuda.launches > counts[0]
    assert K2.causal_attention_cuda.launches > counts[1]
    assert K5.mla_decode_cuda.launches > counts[2]
    assert moe.grouped_mm.launches > counts[3]


def test_cuda_dispatch_never_takes_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(K5, "flash_mla_decode_plain", boom)
    monkeypatch.setattr(K2, "flash_causal_attention_plain", boom)
    q, cache, kv_len = _k5_case(dev, 2, 64, 64, (3, 64))
    K5.flash_mla_decode(q, cache, kv_len, 0.1)
    torch.cuda.synchronize()
