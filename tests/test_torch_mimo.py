"""MiMo-V2.5 in the port at a tiny configuration (seeded random weights, fp32, on the CPU)
against the plain reference (portbench/reference/mimo_v2.py: torch and numpy only,
nothing of the port): window (8) and global layers side by side through the hybrid
cache, the chunk prefill over a kept prefix, the sinks, the band, the held-expert layer
(16 routed experts, 8 held here), the pair decode, and a whole two-stage pipelined
episode. fp32 activations within 5e-5 (the port's parity bar; the two sides differ by
summation order only); greedy tokens identical."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness.weights import make_weights
from portbench.reference import mimo_episode as RE
from portbench.reference import mimo_v2 as R
from zoomearth_tpu_torch.config import KimiVLConfig, MiMoTextConfig, MiMoV2Config, VLMConfig
from zoomearth_tpu_torch.models import hybrid, moe
from zoomearth_tpu_torch.models.hybrid import HybridCache
from zoomearth_tpu_torch.models.mimo_v2 import hf_leaves, params_from_hf
from zoomearth_tpu_torch.models.vlm import vlm_forward
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_gqa_decode as K6
from zoomearth_tpu_torch.runtime.generate import Generator, prepare_batch, prepare_continuation

torch.set_num_threads(1)
ATOL = 5e-5
CFG = MiMoV2Config.tiny()


def ref_config(cfg: MiMoV2Config) -> dict:
    """The reference's view of a config: the file's keys (decoder keys at the top level,
    n_routed_experts the experts held, expert_parallel the devices and this one's rank)."""
    t = cfg.text
    out = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "experts_held"}
    e0, e1 = t.held
    out.update(n_routed_experts=e1 - e0, expert_parallel={"size": t.n_routed_experts // (e1 - e0),
                                                          "rank": e0 // (e1 - e0)})
    v = cfg.vision
    out["vision_config"] = {"depth": v.depth, "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
                            "num_heads": v.num_heads, "in_chans": v.in_channels, "out_hidden_size": v.out_hidden_size,
                            "patch_size": v.patch_size, "spatial_merge_size": v.spatial_merge_size,
                            "window_size": v.window_size, "fullatt_block_indexes": list(v.fullatt_block_indexes),
                            "temporal_patch_size": v.temporal_patch_size}
    out["special_token_ids"] = {f.name: getattr(cfg.tokens, f.name) for f in dataclasses.fields(cfg.tokens)}
    return out


@pytest.fixture(scope="module")
def model():
    W = make_weights(hf_leaves(CFG), 2 ** 31 + 5, torch.device("cpu"), torch.float32)
    return W, params_from_hf(W, CFG), ref_config(CFG)


def _ids(n, seed):
    return np.random.default_rng(seed).integers(32, 288, n)


def _ref_logits(W, rcfg, ids):
    with torch.no_grad():
        return R.decoder_logits(W, rcfg, R.embed(W, ids, [], []), list(range(len(ids))), R.Precision("fp32"))


# ---------------------------------------------------------------------------
# The decoder through the hybrid cache
# ---------------------------------------------------------------------------

def test_layer_kinds_follow_the_hybrid_pattern():
    t = MiMoTextConfig()
    globals_ = [i for i in range(48) if t.layer_attention(i).window == 0]
    assert globals_ == [0, 5, 11, 17, 23, 29, 35, 41, 47]
    g, w = t.layer_attention(0), t.layer_attention(1)
    assert (g.num_attention_heads, g.num_key_value_heads, g.rope_theta, g.sink) == (64, 4, 1e7, False)
    assert (w.num_attention_heads, w.num_key_value_heads, w.rope_theta, w.sink, w.window) == (64, 8, 1e4, True, 128)
    assert g.qk_head_dim == w.qk_head_dim == 192 and g.v_head_dim == w.v_head_dim == 128 and g.rope_dim == 64
    assert not t.is_moe_layer(0) and all(t.is_moe_layer(i) for i in range(1, 48))


def test_prefill_then_decode_through_the_hybrid_cache_matches_the_full_forward(model):
    """30 tokens (window 8): a prefill of 12 into the cache, then 18 decode steps, in
    logits against the reference's one causal pass; the cache holds each layer's own KV
    heads and widths."""
    W, params, rcfg = model
    ids = _ids(30, 4)
    ref = _ref_logits(W, rcfg, ids)
    idt = torch.as_tensor(ids)[None]
    pos = torch.arange(30)[None].expand(3, 1, 30)
    with torch.no_grad():
        full, _ = vlm_forward(params, CFG, idt, pos)
        cache = HybridCache.create(CFG.text, 1, 64, torch.float32)
        assert [tuple(k.shape[1:]) for k in cache.k] == [(1, 64, 24), (2, 64, 24), (2, 64, 24), (1, 64, 24), (2, 64, 24)]
        assert [v.shape[-1] for v in cache.v] == [16] * 5
        lg, cache = vlm_forward(params, CFG, idt[:, :12], pos[..., :12], attn_positions=torch.arange(12)[None],
                                cache=cache, attend_len=12)
        steps = [lg[0]]
        for t in range(12, 30):
            lg, cache = vlm_forward(params, CFG, idt[:, t:t + 1], pos[..., t:t + 1],
                                    attn_positions=cache.length[:, None], cache=cache, attend_len=32)
            steps.append(lg[0])
    assert (full[0] - ref).abs().max() <= ATOL
    assert (torch.cat(steps) - ref).abs().max() <= ATOL
    assert cache.length.tolist() == [30]


def test_chunk_prefill_over_a_kept_cache_matches_the_reference(model):
    """Stage 2: rows keep different prefixes of their stage-1 cache (one longer than the
    window, one shorter) and continue with chunks of different lengths; the window
    layers see the keys before each row's kept point."""
    W, params, rcfg = model
    gen = Generator(params, CFG, max_cache_len=128)
    first = [list(_ids(20, 5)), list(_ids(14, 6)), list(_ids(9, 7))]
    chunks = [list(_ids(7, 8)), list(_ids(11, 9)), list(_ids(3, 10))]
    keep = np.asarray([16, 14, 5], np.int32)
    b1 = prepare_batch(CFG, first, [[], [], []], length_buckets=(32,))
    b2 = prepare_continuation(CFG, chunks, [[], [], []], keep, length_buckets=(16,))
    with torch.no_grad():
        _, cache, _ = gen.run_prefill(b1, max_new=8)
        logits, cache, _ = gen.run_chunk_prefill(cache, b2, keep, max_new=8)
    for b in range(3):
        ref = _ref_logits(W, rcfg, first[b][:keep[b]] + chunks[b])[-1]
        assert (logits[b] - ref).abs().max() <= ATOL
    assert cache.length.tolist() == [23, 25, 8]


def test_pair_decode_equals_each_group_decoded_alone(model):
    _, params, _ = model
    gen = Generator(params, CFG, max_cache_len=128)
    a = prepare_batch(CFG, [list(_ids(12, 9)), list(_ids(9, 10))], [[], []], length_buckets=(16,))
    b = prepare_batch(CFG, [list(_ids(30, 11)), list(_ids(5, 12))], [[], []], length_buckets=(32,))
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig

    g = GenerationConfig(max_new_tokens=6)
    with torch.no_grad():
        la, ca, aa = gen.run_prefill(a, max_new=6)
        lb, cb, ab = gen.run_prefill(b, max_new=6)
        solo_a, _ = gen.run_decode(la, ca.clone(), a.next_pos, g, attend=aa)
        solo_b, _ = gen.run_decode(lb, cb.clone(), b.next_pos, g, attend=ab)
        out = gen.run_decode_pair((la, ca, a.next_pos, aa, None), (lb, cb, b.next_pos, ab, None), steps=6)
    assert torch.equal(out[0], solo_a) and torch.equal(out[4], solo_b)


# ---------------------------------------------------------------------------
# The sinks and the band
# ---------------------------------------------------------------------------

def _attn_case(seed, B=2, S=11, T=24, H=4, Hkv=2, D=24, DV=16):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, H, D, generator=g), torch.randn(B, Hkv, T, D, generator=g),
               torch.randn(B, Hkv, T, DV, generator=g))
    return q, k, v, torch.randn(H, generator=g) * 2


def test_the_sink_is_a_softmax_with_one_more_column():
    """K2's and K6's plain versions with a sink equal an explicit softmax over the live
    logits and one more column (the head's sink logit) whose value is 0."""
    q, k, v, sink = _attn_case(1)
    B, S, H, D = q.shape
    keep = torch.tensor([0, 9])
    positions = keep[:, None] + torch.arange(S)[None]
    kv_len = keep + S
    out = K2.flash_causal_attention(q, k, v, positions, kv_len, sink=sink)
    dec = K6.flash_gqa_decode(q[:, -1], k, v, kv_len, D**-0.5, 0, sink)
    for b in range(B):
        for h in range(H):
            for s in range(S):
                n = int(positions[b, s]) + 1
                z = torch.cat([q[b, s, h] @ k[b, h // 2, :n].T * D**-0.5, sink[h:h + 1]])
                ref = torch.softmax(z, -1)[:n] @ v[b, h // 2, :n]
                assert (out[b, s, h] - ref).abs().max() <= 1e-5
                if s == S - 1:
                    assert (dec[b, h] - ref).abs().max() <= 1e-5


@pytest.mark.parametrize("window", [1, 4, 11, 40])
def test_the_band_at_windows_below_and_above_the_sequence_length(window):
    """K2's and K6's plain versions see the keys p - window < t <= p: at windows below the
    rows' lengths, equal to the explicit masked softmax; at a window above them, equal to
    plain causal attention."""
    q, k, v, _ = _attn_case(2)
    B, S, H, D = q.shape
    keep = torch.tensor([0, 9])
    positions = keep[:, None] + torch.arange(S)[None]
    kv_len = keep + S
    out = K2.flash_causal_attention(q, k, v, positions, kv_len, window=window)
    dec = K6.flash_gqa_decode(q[:, -1], k, v, kv_len, D**-0.5, window)
    for b in range(B):
        for s in range(S):
            p = int(positions[b, s])
            lo = max(p - window + 1, 0)
            kk, vv = k[b, :, lo:p + 1].repeat_interleave(2, 0), v[b, :, lo:p + 1].repeat_interleave(2, 0)
            ref = torch.einsum("ht,htd->hd", torch.softmax(torch.einsum("hd,htd->ht", q[b, s], kk) * D**-0.5, -1), vv)
            assert (out[b, s] - ref).abs().max() <= 1e-5
            if s == S - 1:
                assert (dec[b] - ref).abs().max() <= 1e-5
    if window > S + 9:
        assert (out - K2.flash_causal_attention(q, k, v, positions, kv_len)).abs().max() <= 1e-6


def test_rows_with_no_live_key_give_zero():
    q, k, v, sink = _attn_case(3)
    kv_len = torch.tensor([0, 5])
    positions = torch.arange(q.shape[1])[None].expand(2, -1)
    assert torch.equal(K2.flash_causal_attention(q, k, v, positions, kv_len, window=4, sink=sink)[0],
                       torch.zeros(q.shape[1], 4, 16))
    assert torch.equal(K6.flash_gqa_decode(q[:, 0], k, v, kv_len, 0.2, 4, sink)[0], torch.zeros(4, 16))
    f, b = K6.work(torch.tensor([1000, 50]), 1280, 64, 8, 192, 128, 128)
    assert f == 2 * 64 * 320 * 178 and b == 2 * (178 * 8 * 320 + 2 * 64 * 320)


# ---------------------------------------------------------------------------
# The held-expert layer
# ---------------------------------------------------------------------------

def _held_case(seed, N=40):
    """One routed layer of 16 experts (top 4), its tensors by the reference's names."""
    cfg = CFG.text
    g = torch.Generator().manual_seed(seed)
    E, F_, n = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts

    def r(*shape, s=0.1):
        return torch.randn(*shape, generator=g) * s

    full = {"gate": r(E, n), "bias": r(n, s=0.3), "wg": r(n, E, F_), "wu": r(n, E, F_), "wd": r(n, F_, E)}
    W = {"x.gate.weight": full["gate"], "x.gate.e_score_correction_bias": full["bias"]}
    for e in range(n):
        W[f"x.experts.{e}.gate_proj.weight"], W[f"x.experts.{e}.up_proj.weight"] = full["wg"][e], full["wu"][e]
        W[f"x.experts.{e}.down_proj.weight"] = full["wd"][e]
    return cfg, full, W, torch.randn(N, E, generator=g)


def test_the_held_shares_of_an_expert_layer_add_up_to_the_uncut_reference():
    """Each of the 4 devices holding 4 of the 16 experts computes its part; the parts
    summed equal the reference's whole layer (every expert held), and each part equals
    the reference given the same share."""
    cfg, full, W, x = _held_case(13)
    rcfg = {"num_experts_per_tok": 4, "norm_topk_prob": True, "routed_scaling_factor": None}
    with torch.no_grad():
        whole = R.moe(W, dict(rcfg, n_routed_experts=16), x, "x.", R.Precision("fp32"), R.Routing())
        parts = []
        for rank in range(4):
            share = dataclasses.replace(cfg, experts_held=(4 * rank, 4 * rank + 4))
            p = dict(full, **{k: full[k][4 * rank: 4 * rank + 4] for k in ("wg", "wu", "wd")})
            part = moe.moe_forward(p, share, x)
            ref = R.moe(W, dict(rcfg, n_routed_experts=4, expert_parallel={"size": 4, "rank": rank}), x, "x.",
                        R.Precision("fp32"), R.Routing())
            assert (part - ref).abs().max() <= ATOL
            parts.append(part)
    assert (sum(parts) - whole).abs().max() <= ATOL
    assert all(p.abs().max() > 0 for p in parts)


def _parent_moe_forward(p, cfg, x):
    """models/moe.py::moe_forward as it was before the held-expert range (every expert
    held, shared experts always there), kept here to hold the layer to it bit for bit."""
    x2 = x.reshape(-1, x.shape[-1])
    N, k = x2.shape[0], cfg.num_experts_per_tok
    idx, w = moe.route(p, cfg, x2)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int64).scatter_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = x2.index_select(0, order // k)
    h = F.silu(moe.grouped_mm(xs, p["wg"], offs)) * moe.grouped_mm(xs, p["wu"], offs)
    ys = moe.grouped_mm(h, p["wd"], offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys).reshape(N, k, -1)
    out = moe.swiglu(p["shared"], x2).float()
    for i in range(k):
        out += w[:, i, None] * y[:, i].float()
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kimi_vl_layer_with_every_expert_held_is_bit_equal_to_the_parents(dtype):
    from zoomearth_tpu_torch.models.kimi_vl import hf_leaves as kimi_leaves
    from zoomearth_tpu_torch.models.kimi_vl import params_from_hf as kimi_tree

    cfg = KimiVLConfig.tiny()
    W = make_weights(kimi_leaves(cfg), 2 ** 31 + 9, torch.device("cpu"), dtype)
    p = kimi_tree(W, cfg)["text"]["layers"][1]["mlp"]
    x = torch.randn(3, 7, cfg.text.hidden_size).to(dtype)
    with torch.no_grad():
        assert torch.equal(moe.moe_forward(p, cfg.text, x), _parent_moe_forward(p, cfg.text, x))


def _full_size_held_forward(p, cfg, x):
    """The held-expert layer as a captured step computes it (sizes fixed before the run):
    every pick gathered, the absent ones past the last group, their rows zeroed."""
    x2 = x.reshape(-1, x.shape[-1])
    N, k = x2.shape[0], cfg.num_experts_per_tok
    (e0, e1), n = cfg.experts_held, cfg.experts_held[1] - cfg.experts_held[0]
    idx, w = moe.route(p, cfg, x2)
    flat = idx.reshape(-1)
    mine = (flat >= e0) & (flat < e1)
    flat = torch.where(mine, flat - e0, n)
    order = torch.argsort(flat, stable=True)
    offs = torch.cumsum(torch.zeros(n + 1, dtype=torch.int64).scatter_add_(0, flat, torch.ones_like(flat))[:n],
                        0).to(torch.int32)
    xs = x2.index_select(0, order // k)
    ys = moe.grouped_mm(F.silu(moe.grouped_mm(xs, p["wg"], offs)) * moe.grouped_mm(xs, p["wu"], offs), p["wd"], offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys).reshape(N, k, -1)
    y = torch.where(mine.reshape(N, k, 1), y, torch.zeros((), dtype=y.dtype))
    out = x2.new_zeros(x2.shape, dtype=torch.float32)
    for i in range(k):
        out += w[:, i, None] * y[:, i].float()
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_eager_held_layer_gathers_only_held_picks_and_equals_the_full_size_form(dtype, monkeypatch):
    """Outside a capture the layer gathers and multiplies only the held picks (rows a
    quarter of the picks here) and adds them back in each token's choice order: bit for
    bit the full-size form a captured step runs."""
    cfg, full, _, x = _held_case(17, N=60)
    rows = []
    mm = moe.grouped_mm
    monkeypatch.setattr(moe, "grouped_mm", lambda a, w, offs: rows.append(a.shape[0]) or mm(a, w, offs))
    for rank in range(4):
        share = dataclasses.replace(cfg, experts_held=(4 * rank, 4 * rank + 4))
        p = {k: v.to(dtype) for k, v in dict(full, **{k: full[k][4 * rank: 4 * rank + 4]
                                                       for k in ("wg", "wu", "wd")}).items()}
        with torch.no_grad():
            held = int(((moe.route(p, share, x.to(dtype))[0] // 4) == rank).sum())
            rows.clear()
            assert torch.equal(moe.moe_forward(p, share, x.to(dtype)), _full_size_held_forward(p, share, x.to(dtype)))
        assert rows[:3] == [held] * 3 and 0 < held < 60 * 4


def test_a_layer_whose_held_experts_get_no_pick_gives_zero():
    cfg, full, _, x = _held_case(19, N=10)
    share = dataclasses.replace(cfg, experts_held=(12, 16))
    p = dict(full, bias=torch.where(torch.arange(16) < 4, 10.0, -10.0),
             **{k: full[k][12:] for k in ("wg", "wu", "wd")})
    with torch.no_grad():
        out = moe.moe_forward(p, share, x)
    assert out.shape == x.shape and torch.all(out == 0)


def test_the_stacked_held_experts_are_views_of_the_buffer(model):
    W, params, _ = model
    wg = params["text"]["layers"][1]["mlp"]["wg"]
    assert wg.shape == (8, CFG.text.hidden_size, CFG.text.moe_intermediate_size)
    assert wg.data_ptr() == W["model.layers.1.mlp.experts.8.gate_proj.weight"].data_ptr()
    assert "model.layers.1.mlp.experts.7.gate_proj.weight" not in W
    assert params["text"]["layers"][1]["attn"]["sink"].dtype == torch.float32
    assert "sink" not in params["text"]["layers"][0]["attn"]


# ---------------------------------------------------------------------------
# The whole episode, the tracer, and what is refused
# ---------------------------------------------------------------------------

def _image(h, w, seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_a_pipelined_two_stage_episode_serves_the_references_greedy_tokens(model, monkeypatch):
    """Two waves of three through run_episodes_pipelined (stage 2 over the kept hybrid
    cache, the pair decode): every served token is the reference's argmax, the
    reference following the program's routing (as the benchmark's check does)."""
    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.models.decoder import decoder_forward
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    W, params, rcfg = model
    instruction = "\nYou are an intelligent remote<|im_end|><|im_start|>assistant\n"
    monkeypatch.setattr(PT, "stage1_prompt", lambda q: PT.PREFIX + q + instruction)
    boxes = iter([[10, 12, 40, 50], [0, 0, 20, 20], [60, 30, 90, 80]] * 2)
    monkeypatch.setattr(EP, "extract_bboxes", lambda text, scale=1.0: [next(boxes)])
    tiles = [_image(140, 168, 20 + i) for i in range(4)]
    waves = [(["what is near a?", "what is near b?", "what is by c?"], [tiles[0], tiles[0], tiles[1]]),
             (["where is the d?", "what is near e?", "what is near f?"], [tiles[2], tiles[3], tiles[3]])]
    gen = Generator(params, CFG, max_cache_len=512)
    served = []
    gen.trim_generated = lambda buf, _fn=gen.trim_generated: (served.append(_fn(buf)), served[-1])[1]
    out = EP.run_episodes_pipelined(gen, Processor(FakeTokenizer(CFG.tokens), CFG), waves,
                                    gen=GenerationConfig(max_new_tokens=6), stage2_gen=GenerationConfig(max_new_tokens=4))
    assert [len(w) for w in out] == [3, 3] and not any(r.error for w in out for r in w)
    traffic = {"stage1_max_size": 512, "crop_min_size": 512, "crop_max_size": 512, "instruction": instruction}

    def program(p):  # the program's choices over a pass, teacher-forced (the driver's own in the benchmark)
        chosen, route = [], moe.route
        monkeypatch.setattr(moe, "route", lambda pp, c, x2: (lambda r: (chosen.append(r[0]), r)[1])(route(pp, c, x2)))
        x = params["text"]["embed"]["weight"][torch.as_tensor(p.ids)].clone()
        for img, start in zip(p.embeds, p.starts):
            x[start:start + img.shape[0]] = img
        with torch.no_grad():
            decoder_forward(params["text"], CFG.text, x[None], torch.arange(len(p.ids))[None, None].expand(3, 1, -1))
        monkeypatch.setattr(moe, "route", route)
        return chosen

    boxes2 = [[10, 12, 40, 50], [0, 0, 20, 20], [60, 30, 90, 80]]
    for w, (questions, images) in enumerate(waves):
        for i in range(3):
            out1, out2 = served[2 * w][i], served[2 * w + 1][i]
            g, routings, _, _ = RE.gaps(W, rcfg, traffic, images[i], questions[i], boxes2[i], out1, out2, program, 0.0)
            assert len(g) == len(out1) + len(out2) and g.max() <= ATOL
            assert sum(r.outside for r in routings) == 0


def test_the_tracer_counts_window_keys_and_held_and_absent_picks(model):
    from zoomearth_tpu_torch.utils.profiling import tracer

    _, params, _ = model
    ids = torch.as_tensor(_ids(20, 3))[None]
    pos = torch.arange(20)[None].expand(3, 1, 20)
    tracer.start()
    try:
        with torch.no_grad():
            vlm_forward(params, CFG, ids, pos)
    finally:
        tracer.stop()
    c = tracer.counters
    # 3 window layers, 2 KV heads, the row's keys from 0 to 19 (its smallest position's window edge is 0)
    assert c["attn.window_keys"] == 3 * 2 * 20
    assert c["moe.tokens_routed"] == 4 * 20 and c["moe.picks_held"] + c["moe.picks_elsewhere"] == 4 * 20 * 4
    assert 0 < c["moe.picks_held"] < 4 * 20 * 4
    assert {"attn.window", "moe.route", "moe.experts"} <= {n for n, *_ in tracer.spans}
    tracer.start()
    tracer.stop()


def test_the_config_reader_takes_the_benchmark_file_and_refuses_other_variants():
    flat = json.load(open("portbench/configs/mimo_v2_5.json"))
    cfg = MiMoV2Config.from_dict(flat)
    t = cfg.text
    assert (t.n_routed_experts, t.held, t.num_hidden_layers, t.vocab_size) == (256, (0, 32), 12, 152576)
    assert cfg.vision.out_hidden_size == 4096 and cfg.vision.depth == 32 and cfg.tokens.image_pad == 151655
    assert t == dataclasses.replace(MiMoTextConfig(), num_hidden_layers=12, experts_held=(0, 32))
    assert MiMoV2Config.from_dict(dict(flat, expert_parallel={"size": 8, "rank": 3})).text.held == (96, 128)
    for bad in ({"attention_chunk_size": 64}, {"hybrid_block_size": 4}, {"scoring_func": "softmax"},
                {"add_full_attention_sink_bias": True}, {"n_shared_experts": 1}):
        with pytest.raises(NotImplementedError):
            MiMoV2Config.from_dict(dict(flat, **bad))


def test_training_int8_tensor_parallel_and_serving_are_refused_before_any_launch(model):
    _, params, _ = model
    ids = torch.as_tensor(_ids(8, 14))[None]
    pos = torch.arange(8)[None].expand(3, 1, 8)
    x = params["text"]["embed"]["weight"][ids].clone().requires_grad_(True)
    from zoomearth_tpu_torch.models.decoder import decoder_forward

    with pytest.raises(NotImplementedError, match="inference only"):
        decoder_forward(params["text"], CFG.text, x, pos)
    with pytest.raises(NotImplementedError, match="int8"):
        HybridCache.create(CFG.text, 1, 16, torch.int8)

    class AnyRank:
        def at(self, *path):
            return self

    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        decoder_forward(params["text"], CFG.text, x.detach(), pos, tp=AnyRank())
    from zoomearth_tpu_torch.serve.engine import ServingEngine

    with pytest.raises(NotImplementedError, match="window and global layers"):
        ServingEngine(params, CFG)


def test_the_family_takes_sequential_positions_the_qwen_tower_and_chat_template():
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.runtime.families import family

    fam = family(CFG)
    assert fam.cache is HybridCache and fam.prompts() == (PT.stage1_prompt, PT.VISION_TOKENS)
    ids = np.array([[1, CFG.tokens.image_pad, CFG.tokens.image_pad, 5, CFG.tokens.pad]])
    pos, nxt = fam.positions(CFG, ids, [[(1, 2, 2)]], np.array([4]))
    assert pos.tolist() == [[[0, 1, 2, 3, 4]]] * 3 and nxt.tolist() == [4]
    assert fam.vision_meta is family(VLMConfig.tiny()).vision_meta
