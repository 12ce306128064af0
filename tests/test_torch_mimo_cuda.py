"""MiMo-V2.5's kernels and layers on the card: K2 with the band and the sinks (the window
layers' prefill and chunk), K2 at key width 192 and value width 128 with 16 heads a KV
head (the global layers' prefill), K6 (decode at 192 / 128, 16 heads a KV head, and 8
with the window and the sinks), the held-expert layer's grouped products, and a small
MiMo-V2.5 at the published attention widths through the Generator, against their plain
versions and the CPU. Marked `cuda`: every test skips where torch.cuda.is_available()
is false.

On a machine with an NVIDIA GPU and nvcc:  python -m pytest -m cuda tests/test_torch_mimo_cuda.py

bf16 cases hold the kernels to 2e-2, as tests/test_torch_cuda.py does: roundings of
outputs below 2 (of the output and of the softmax weights).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zoomearth_tpu_torch.config import MiMoTextConfig, MiMoV2Config, VisionConfig
from zoomearth_tpu_torch.models import moe
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_gqa_decode as K6

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m cuda tests/test_torch_mimo_cuda.py)")
    return torch.device("cuda")


def _randn(shape, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _cache(dev, B, Hkv, T, seed):
    """k (B, Hkv, T, 192) and v (B, Hkv, T, 128) as views of one cache tensor a layer."""
    kv = _randn((B, Hkv, T, 320), dev, seed)
    return kv[..., :192], kv[..., 192:]


@pytest.mark.parametrize("B,S,T,keep,window,sink", [
    (2, 300, 300, (0, 0), 128, True),           # prefill: rows read ~window + 16 keys
    (3, 160, 1280, (700, 60, 0), 128, True),    # chunk over kept prefixes, one kept below the window
    (2, 100, 256, (0, 50), 512, True),          # a window above every length: causal with sinks
    (2, 96, 400, (200, 17), 128, False),        # the band alone
    (1, 1, 64, (0,), 128, True),                # one query, nothing before it
])
def test_k2_band_and_sinks_match_plain(dev, B, S, T, keep, window, sink):
    H, Hkv = 64, 8
    q = _randn((B, S, H, 192), dev, 1)
    k, v = _cache(dev, B, Hkv, T, 2)
    s = (_randn((H,), dev, 3, torch.float32) * 2).contiguous() if sink else None
    keep = torch.as_tensor(keep, device=dev)
    positions = keep[:, None] + torch.arange(S, device=dev)[None]
    kv_len = (keep + S).clamp(max=T).to(torch.int32)
    n0 = K2.causal_attention_cuda.launches
    out = K2.causal_attention_cuda(q, k, v, positions, kv_len, window=window, sink=s)
    torch.cuda.synchronize()
    assert K2.causal_attention_cuda.launches == n0 + 1 and out.shape == (B, S, H, 128)
    ref = K2.flash_causal_attention_plain(q, k, v, positions, kv_len, window=window, sink=s)
    assert _err(out, ref) <= TOL


def test_k2_band_gives_zero_to_a_row_with_no_live_key(dev):
    """kv_len 0: no key, the sink alone (value 0) or nothing: 0 either way."""
    H, Hkv, S, T = 64, 8, 20, 64
    q = _randn((2, S, H, 192), dev, 4)
    k, v = _cache(dev, 2, Hkv, T, 5)
    positions = torch.arange(S, device=dev)[None].expand(2, S)
    kv_len = torch.as_tensor([0, 9], dtype=torch.int32, device=dev)
    s = _randn((H,), dev, 6, torch.float32).contiguous()
    out = K2.causal_attention_cuda(q, k, v, positions, kv_len, window=128, sink=s)
    assert torch.all(out[0] == 0)
    assert _err(out, K2.flash_causal_attention_plain(q, k, v, positions, kv_len, window=128, sink=s)) <= TOL


@pytest.mark.parametrize("B,S,T,keep", [(2, 300, 300, (0, 0)), (3, 160, 1280, (700, 60, 0))])
def test_k2_global_layers_at_16_heads_a_kv_head(dev, B, S, T, keep):
    """The global layers' prefill and chunk: K2's 192 / 128 core at H / Hkv = 64 / 4."""
    q = _randn((B, S, 64, 192), dev, 7)
    k, v = _cache(dev, B, 4, T, 8)
    keep = torch.as_tensor(keep, device=dev)
    positions = keep[:, None] + torch.arange(S, device=dev)[None]
    kv_len = (keep + S).to(torch.int32)
    out = K2.causal_attention_cuda(q, k, v, positions, kv_len)
    assert _err(out, K2.flash_causal_attention_plain(q, k, v, positions, kv_len)) <= TOL


def _k6_case(dev, B, Hkv, G, T, attend, lens, sink, seed=10):
    q = _randn((B, Hkv * G, 192), dev, seed)
    k, v = _cache(dev, B, Hkv, T, seed + 1)
    s = (_randn((Hkv * G,), dev, seed + 2, torch.float32) * 2).contiguous() if sink else None
    return q, k[:, :, :attend], v[:, :, :attend], torch.as_tensor(lens, dtype=torch.int32, device=dev), s


@pytest.mark.parametrize("B,Hkv,G,T,attend,lens,window,sink", [
    (4, 8, 8, 256, 256, (1, 0, 100, 256), 128, True),              # window: ragged, one empty, one below it
    (6, 8, 8, 1536, 1280, (1, 127, 128, 129, 700, 1280), 128, True),
    (5, 4, 16, 1536, 1280, (1, 0, 1280, 700, 1000), 0, False),     # global: 16 heads a KV head
    (96, 4, 16, 1536, 1536, tuple(int(x) for x in np.linspace(400, 1536, 96)), 0, False),
    (96, 8, 8, 1536, 1536, tuple(int(x) for x in np.linspace(400, 1536, 96)), 128, True),
    (3, 8, 8, 64, 64, (5, 64, 33), 0, True),                      # a sink without a window
])
def test_k6_matches_plain(dev, B, Hkv, G, T, attend, lens, window, sink):
    q, k, v, kv_len, s = _k6_case(dev, B, Hkv, G, T, attend, lens, sink)
    n0 = K6.gqa_decode_cuda.launches
    out = K6.gqa_decode_cuda(q, k, v, kv_len, 192**-0.5, window, s)
    torch.cuda.synchronize()
    assert K6.gqa_decode_cuda.launches == n0 + 1 and out.shape == (B, Hkv * G, 128)
    ref = K6.flash_gqa_decode_plain(q, k, v, kv_len, 192**-0.5, window, s)
    assert _err(out, ref) <= TOL
    assert torch.all(out[kv_len == 0] == 0)


def test_k6_split_boundaries_and_a_captured_replay(dev):
    """Rows whose lengths sit on and next to split and tile boundaries; a graph replay
    gives the eager bits (no atomics)."""
    B, Hkv, G, T = 8, 4, 16, 1024
    split, nsplit = K6.split_plan(B * Hkv, T)
    lens = [split - 1, split, split + 1, 2 * split, K6.TILE, K6.TILE + 1, T, 1]
    q, k, v, kv_len, _ = _k6_case(dev, B, Hkv, G, T, T, lens, False)
    eager = K6.gqa_decode_cuda(q, k, v, kv_len, 0.07)
    assert _err(eager, K6.flash_gqa_decode_plain(q, k, v, kv_len, 0.07)) <= TOL
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K6.gqa_decode_cuda(q, k, v, kv_len, 0.07)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_k6_refuses_other_shapes(dev):
    q = _randn((2, 24, 192), dev, 3)
    k, v = _cache(dev, 2, 2, 64, 4)
    with pytest.raises(ValueError):  # 12 heads a KV head
        K6.gqa_decode_cuda(q, k, v, torch.ones(2, dtype=torch.int32, device=dev), 0.1)
    with pytest.raises(ValueError):  # equal widths
        K6.gqa_decode_cuda(q[:, :16], k, k, torch.ones(2, dtype=torch.int32, device=dev), 0.1)


def test_held_expert_layer_on_card_matches_the_cpu_and_captures(dev):
    """The held-expert layer (experts 8-15 of 16, top 4): grouped products over the held
    picks only (the absent ones sort past the last group's end), against the CPU's loop
    over groups; captured into a graph, it replays to the eager bits."""
    cfg = MiMoTextConfig(hidden_size=256, moe_intermediate_size=128, n_routed_experts=16, num_experts_per_tok=4,
                         experts_held=(8, 16))
    p = {"gate": _randn((256, 16), dev, 12) * 0.06, "bias": _randn((16,), dev, 13) * 0.02,
         "wg": _randn((8, 256, 128), dev, 14) * 0.05, "wu": _randn((8, 256, 128), dev, 15) * 0.05,
         "wd": _randn((8, 128, 256), dev, 16) * 0.05}
    h = _randn((96, 1, 256), dev, 20)
    with torch.inference_mode():
        eager = moe.moe_forward(p, cfg, h)
        cpu = moe.moe_forward({k: v.cpu().float() for k, v in p.items()}, cfg, h.cpu().float())
        assert _err(eager.cpu(), cpu) <= 0.05 * cpu.abs().max().item()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe.moe_forward(p, cfg, h)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.isfinite(out).all()


def card_config() -> MiMoV2Config:
    """A small MiMo-V2.5 at the published attention widths (64 heads of 192 / 128, 4 KV
    heads in the global layers, 8 with a window of 128 and sinks in the window layers),
    with few layers, experts and a small vocabulary."""
    tiny = MiMoV2Config.tiny(vocab_size=512)
    vision = VisionConfig(depth=2, hidden_size=160, intermediate_size=256, num_heads=2, window_size=56,
                          fullatt_block_indexes=(1,), out_hidden_size=512)
    text = dataclasses.replace(MiMoTextConfig(), vocab_size=512, hidden_size=512, intermediate_size=1024,
                               moe_intermediate_size=128, num_hidden_layers=4, n_routed_experts=32,
                               experts_held=(16, 32), hybrid_layer_pattern=(0, 1, 1, 0),
                               moe_layer_freq=(0, 1, 1, 1), max_position_embeddings=4096)
    return dataclasses.replace(tiny, vision=vision, text=text, dtype="bfloat16")


def _card_model(dev, dtype):
    from portbench.harness.weights import make_weights
    from zoomearth_tpu_torch.models.mimo_v2 import hf_leaves, params_from_hf

    cfg = card_config()
    W = make_weights(hf_leaves(cfg), 7, torch.device("cpu"), torch.float32)
    # A decisive router (experts 12-19 for every token, half of them held): at random
    # weights a choice near the eighth expert's boundary flips between bf16 and fp32.
    for name, t in W.items():
        if name.endswith("e_score_correction_bias"):
            t.copy_(torch.where((torch.arange(t.numel()) >= 12) & (torch.arange(t.numel()) < 20), 10.0, -10.0))
    W = {k: v.to(dev, dtype) for k, v in W.items()}
    return cfg, params_from_hf(W, cfg)


def test_small_mimo_generator_on_card_follows_the_cpu(dev):
    """Prefill (longer than the window), chunk prefill over the kept cache and the pair
    decode of a small MiMo-V2.5 at the published attention widths, in bf16 on the card
    (K2 banded and at 16 heads a KV head, K6 from captured steps, the held experts'
    grouped products), track the fp32 CPU run of the same weights: every step's logits
    within 5 % of their largest magnitude, and each launch counter moves: K6 twice a
    layer a pair step and once a solo step, eager and captured steps alike."""
    from zoomearth_tpu_torch.runtime.generate import (GenerationConfig, Generator, prepare_batch,
                                                      prepare_continuation)

    cfg, params = _card_model(dev, torch.bfloat16)
    cpu_params = _card_model(torch.device("cpu"), torch.float32)[1]
    tok = cfg.tokens
    rng = np.random.default_rng(0)

    def seqs(n, grid, text):
        m = grid[1] * grid[2] // 4
        out, imgs = [], []
        for i in range(n):
            out.append([tok.im_start] + list(rng.integers(32, 288, text + 7 * i)) + [tok.vision_start]
                       + [tok.image_pad] * m + [tok.vision_end, 50, 60 + i])
            imgs.append([(rng.integers(0, 256, (grid[1] * grid[2], 1176), dtype=np.uint8), grid)])
        return out, imgs

    s1, i1 = seqs(4, (1, 8, 8), 140)
    b1 = prepare_batch(cfg, s1, i1, length_buckets=(256,), patch_buckets=(256,))
    s2, i2 = seqs(4, (1, 4, 4), 3)
    keep = np.asarray([len(s) - 2 * j for j, s in enumerate(s1)], np.int32)
    b2 = prepare_continuation(cfg, s2, i2, keep, length_buckets=(64,), patch_buckets=(64,))
    counts = [K2.causal_attention_cuda.launches, K6.gqa_decode_cuda.launches, moe.grouped_mm.launches]
    outs = {}
    for name, p in (("card", params), ("cpu", cpu_params)):
        gen = Generator(p, cfg, max_cache_len=384, cache_dtype="bfloat16" if name == "card" else "float32")
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
            n6 = K6.gqa_decode_cuda.launches
            for _ in range(6):  # the first eager, the second captured, then replays
                gen.graphs.run(key, step)
                logits.append(st.logits.clone())
            gen.graphs.release(key)
            if name == "card":  # then a solo step over wave a's cache, eager, captured and replayed
                pair_launches = K6.gqa_decode_cuda.launches - n6
                _, solo_fn, _ = gen.solo_step(st.logits[:4].clone(), c1, st.pos[:4].cpu().numpy(),
                                              GenerationConfig(max_new_tokens=4))
                n6 = K6.gqa_decode_cuda.launches
                for _ in range(3):
                    gen.graphs.run(("solo", name), solo_fn)
                gen.graphs.release(("solo", name))
                solo_launches = K6.gqa_decode_cuda.launches - n6
        outs[name] = [t.float().cpu() for t in logits], st.tokens.cpu()
    errs = [_err(card, cpu) / cpu.abs().max().item() for card, cpu in zip(outs["card"][0], outs["cpu"][0])]
    assert max(errs) <= 0.05, errs
    assert K2.causal_attention_cuda.launches > counts[0]
    assert K6.gqa_decode_cuda.launches > counts[1]
    assert moe.grouped_mm.launches > counts[2]
    # K6 once a layer and cache in each step, captured replays counted: 2 a layer a pair
    # step, 1 a solo step (on the CPU the plain version runs and nothing is counted)
    layers = cfg.text.num_hidden_layers
    assert (pair_launches, solo_launches) == (6 * 2 * layers, 3 * layers)


def test_cuda_dispatch_never_takes_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(K6, "flash_gqa_decode_plain", boom)
    monkeypatch.setattr(K2, "flash_causal_attention_plain", boom)
    monkeypatch.setattr(K2, "band_sink_attention_plain", boom)
    q, k, v, kv_len, s = _k6_case(dev, 2, 8, 8, 64, 64, (3, 40), True)
    K6.flash_gqa_decode(q, k, v, kv_len, 0.1, 128, s)
    positions = torch.arange(8, device=dev)[None].expand(2, 8)
    K2.flash_causal_attention(_randn((2, 8, 64, 192), dev, 30), k, v, positions, kv_len, window=128, sink=s)
