"""Kimi-VL in the port at a tiny configuration (seeded random weights, fp32, on the CPU)
against the plain reference (portbench/reference/kimi_vl.py: torch and numpy only,
nothing of the port): MoonViT with its 2D RoPE and resized position grid, latent
attention through the latent cache in both forms, the routed experts, the pair decode,
and a whole two-stage pipelined episode. fp32 activations within 5e-5; greedy tokens
identical."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness.weights import make_weights
from portbench.reference import kimi_episode as RE
from portbench.reference import kimi_vl as R
from zoomearth_tpu_torch.config import KimiVLConfig, KimiTextConfig
from zoomearth_tpu_torch.models import mla, moe, moonvit
from zoomearth_tpu_torch.models.kimi_vl import hf_leaves, params_from_hf, stacked
from zoomearth_tpu_torch.models.mla import LatentCache
from zoomearth_tpu_torch.models.vlm import compute_vision_embeds, vlm_forward
from zoomearth_tpu_torch.ops import flash_attention as K1
from zoomearth_tpu_torch.ops import flash_causal as K2
from zoomearth_tpu_torch.ops import flash_mla_decode as K5
from zoomearth_tpu_torch.runtime.generate import Generator, prepare_batch, prepare_continuation

torch.set_num_threads(1)
ATOL = 5e-5
CFG = KimiVLConfig.tiny()


def ref_config(cfg: KimiVLConfig) -> dict:
    """The reference's view of a config: the file's keys (text keys at the top level)."""
    t, v = cfg.text, cfg.vision
    out = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    out["vision_config"] = {"hidden_size": v.hidden_size, "num_attention_heads": v.num_heads,
                            "num_hidden_layers": v.depth, "intermediate_size": v.intermediate_size,
                            "patch_size": v.patch_size, "merge_kernel_size": list(v.merge_kernel_size),
                            "layer_norm_eps": v.layer_norm_eps}
    out["special_token_ids"] = {f.name: getattr(cfg.tokens, f.name) for f in dataclasses.fields(cfg.tokens)}
    return out


@pytest.fixture(scope="module")
def model():
    W = make_weights(hf_leaves(CFG), 2 ** 31 + 3, torch.device("cpu"), torch.float32)
    return W, params_from_hf(W, CFG), ref_config(CFG)


def _image(h, w, seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def _patches(img):
    from zoomearth_tpu_torch.image.preprocess import preprocess_image_u8

    return preprocess_image_u8(img, 14, 1, 2)


# ---------------------------------------------------------------------------
# MoonViT
# ---------------------------------------------------------------------------

def test_moonvit_2d_rope_is_a_complex_rotation_of_adjacent_pairs():
    """Pair 2j turns by column x w_j, pair 2j + 1 by row x w_j, w_j = 10000^(-4j/D)."""
    D, P = 72, 30
    pos = torch.stack([torch.randint(0, 36, (P,)), torch.randint(0, 36, (P,))], -1).to(torch.int32)
    x = torch.randn(P, 3, D)
    cos, sin = moonvit.rope_cos_sin(pos, D)
    out = moonvit.apply_rope_2d(x, cos, sin)
    w = 10000.0 ** (-4.0 * torch.arange(D // 4, dtype=torch.float64) / D)
    ang = torch.empty(P, D // 2, dtype=torch.float64)
    ang[:, 0::2] = pos[:, 1, None].double() * w
    ang[:, 1::2] = pos[:, 0, None].double() * w
    z = torch.view_as_complex(x.double().reshape(P, 3, D // 2, 2).contiguous()) * torch.polar(torch.ones_like(ang), ang)[:, None]
    assert torch.allclose(out.double(), torch.view_as_real(z).reshape(P, 3, D), atol=1e-5)


def test_resized_position_grid():
    """At the grid's own size the rows are the grid's; elsewhere the bicubic
    (align_corners=False) resize, row-major."""
    grid = torch.randn(8, 8, 5)
    assert torch.equal(moonvit.resized_grid(grid, 8, 8), grid.reshape(64, 5))
    out = moonvit.resized_grid(grid, 4, 6).reshape(4, 6, 5)
    ref = F.interpolate(grid.permute(2, 0, 1)[None], size=(4, 6), mode="bicubic", align_corners=False)[0]
    assert torch.allclose(out, ref.permute(1, 2, 0), atol=1e-6)
    meta = moonvit.moonvit_metadata([(1, 4, 6), (1, 8, 8), (1, 4, 6)], pad_to=160)
    assert meta["tables"] == ((4, 6), (8, 8))
    assert meta["pos_idx"][24 + 64:24 + 64 + 24].tolist() == meta["pos_idx"][:24].tolist()
    assert (meta["pos_idx"][-8:] == 24 + 64).all() and (meta["seg"][-8:] == K1.PAD_SEG).all()


def test_moonvit_tower_matches_the_reference_on_a_packed_batch(model):
    """Two images of different grids (one resized from the 8 x 8 position grid, one at
    it) packed with pad rows, through K1's padded heads (24 -> 32) on the CPU."""
    W, params, rcfg = model
    imgs = [_image(56, 84, 1), _image(112, 112, 2)]
    prepped = [_patches(im) for im in imgs]
    pv = np.concatenate([p for p, _ in prepped] + [np.zeros((16, 588), np.uint8)])
    meta = moonvit.moonvit_metadata([g for _, g in prepped], pad_to=pv.shape[0])
    with torch.no_grad():
        out = compute_vision_embeds(params, CFG, torch.as_tensor(pv), moonvit.meta_to_device(meta, "cpu"))
        refs = [R.vision_forward(W, rcfg, *R.patches(im), R.Precision("fp32")) for im in imgs]
    n = [r.shape[0] for r in refs]
    assert n == [6, 16]
    assert (out[:22] - torch.cat(refs)).abs().max() <= ATOL


def test_moonvit_patches_of_a_stage1_image():
    """The episode's stage-1 image (a tile shrunk to 512) reaches the tower as 504 x 504:
    36 x 36 patches of 14 x 14 x 3, 324 decoder tokens."""
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    full = KimiVLConfig()
    proc = Processor(FakeTokenizer(full.tokens), full)
    (pv, grid), = proc.preprocess_images([_image(512, 512, 3)])
    assert pv.shape == (1296, 588) and pv.dtype == np.uint8 and grid == (1, 36, 36)
    ids = proc.expand_image_pads(proc.tokenizer.encode("<|media_pad|>"), [grid])
    assert ids == [full.tokens.media_pad] * 324


# ---------------------------------------------------------------------------
# Latent attention and the latent cache
# ---------------------------------------------------------------------------

def _ids(n, seed):
    return np.random.default_rng(seed).integers(32, 288, n)


def _ref_logits(W, rcfg, ids):
    with torch.no_grad():
        return R.decoder_logits(W, rcfg, R.embed(W, ids, [], -1), list(range(len(ids))), R.Precision("fp32"))


def test_mla_prefill_then_decode_through_the_latent_cache_matches_the_full_forward(model):
    W, params, rcfg = model
    ids = _ids(24, 4)
    ref = _ref_logits(W, rcfg, ids)
    idt = torch.as_tensor(ids)[None]
    pos = torch.arange(24)[None].expand(3, 1, 24)
    with torch.no_grad():
        full, _ = vlm_forward(params, CFG, idt, pos)
        cache = LatentCache.create(CFG.text, 1, 64, torch.float32)
        assert cache.k[0].shape == (1, 1, 64, CFG.text.kv_lora_rank + CFG.text.qk_rope_head_dim) and cache.v == []
        lg, cache = vlm_forward(params, CFG, idt[:, :10], pos[..., :10], attn_positions=torch.arange(10)[None],
                                cache=cache, attend_len=10)
        steps = [lg[0]]
        for t in range(10, 24):
            lg, cache = vlm_forward(params, CFG, idt[:, t:t + 1], pos[..., t:t + 1],
                                    attn_positions=cache.length[:, None], cache=cache, attend_len=32)
            steps.append(lg[0])
    assert (full[0] - ref).abs().max() <= ATOL
    assert (torch.cat(steps) - ref).abs().max() <= ATOL
    assert cache.length.tolist() == [24]


def test_absorbed_and_expanded_forms_agree(model):
    """One layer's attention for a new token: K5's absorbed form over the latent cache
    equals K2's expanded form over the same latents."""
    _, params, _ = model
    p, cfg = params["text"]["layers"][1]["attn"], CFG.text
    S = 9
    x = torch.randn(2, S, cfg.hidden_size)
    positions = torch.arange(S)[None].expand(2, S)
    cos, sin = mla.rope_cos_sin(positions, cfg)
    expanded = mla.attention(p, cfg, x, cos, sin, positions, torch.ones(2, S, dtype=torch.bool))
    cache = LatentCache.create(cfg, 2, 16, torch.float32)
    with torch.no_grad():
        mla.attention(p, cfg, x[:, :S - 1], cos[:, :S - 1], sin[:, :S - 1], positions[:, :S - 1], None,
                      cache.layer(1), cache.length)
        cache.length.fill_(S - 1)
        absorbed = mla.attention(p, cfg, x[:, S - 1:], cos[:, S - 1:], sin[:, S - 1:], positions[:, S - 1:], None,
                                 cache.layer(1), cache.length, attend_len=12)
    assert (absorbed[:, 0] - expanded[:, -1]).abs().max() <= ATOL


def test_chunk_prefill_over_a_kept_cache_matches_the_reference(model):
    """Rows keep different prefixes of their stage-1 cache and continue with chunks
    of different lengths (run_chunk_prefill expands the kept latents layer by layer)."""
    W, params, rcfg = model
    gen = Generator(params, CFG, max_cache_len=128)
    first = [list(_ids(20, 5)), list(_ids(14, 6))]
    chunks = [list(_ids(7, 7)), list(_ids(11, 8))]
    keep = np.asarray([16, 14], np.int32)
    b1 = prepare_batch(CFG, first, [[], []], length_buckets=(32,))
    b2 = prepare_continuation(CFG, chunks, [[], []], keep, length_buckets=(16,))
    with torch.no_grad():
        _, cache, _ = gen.run_prefill(b1, max_new=8)
        logits, cache, _ = gen.run_chunk_prefill(cache, b2, keep, max_new=8)
    for b in range(2):
        ref = _ref_logits(W, rcfg, first[b][:keep[b]] + chunks[b])[-1]
        assert (logits[b] - ref).abs().max() <= ATOL
    assert cache.length.tolist() == [23, 25]


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
    assert gen.decode_steps["pair"] == 6


# ---------------------------------------------------------------------------
# Routed experts
# ---------------------------------------------------------------------------

def _moe_case(seed, bias_scale=0.02):
    cfg = CFG.text
    g = torch.Generator().manual_seed(seed)
    E, F_, n = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts

    def r(*shape, s=0.1):
        return torch.randn(*shape, generator=g) * s

    p = {"gate": r(E, n), "bias": r(n, s=bias_scale), "wg": r(n, E, F_), "wu": r(n, E, F_), "wd": r(n, F_, E),
         "shared": {"wg": r(E, 16), "wu": r(E, 16), "wd": r(16, E)}}
    W = {"x.gate.weight": p["gate"], "x.gate.e_score_correction_bias": p["bias"],
         "x.shared_experts.gate_proj.weight": p["shared"]["wg"], "x.shared_experts.up_proj.weight": p["shared"]["wu"],
         "x.shared_experts.down_proj.weight": p["shared"]["wd"]}
    for e in range(n):
        W[f"x.experts.{e}.gate_proj.weight"], W[f"x.experts.{e}.up_proj.weight"] = p["wg"][e], p["wu"][e]
        W[f"x.experts.{e}.down_proj.weight"] = p["wd"][e]
    return cfg, p, W


def test_moe_layer_matches_the_reference_loop_over_chosen_experts():
    """Tokens share experts, one expert gets no token, and the correction bias decides
    some tokens' choices (the choice without it differs)."""
    cfg, p, W = _moe_case(13, bias_scale=0.3)
    x = torch.randn(2, 5, cfg.hidden_size)
    idx, w = moe.route(p, cfg, x.reshape(-1, cfg.hidden_size))
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_routed_experts)
    assert counts.max() > 1 and (counts == 0).any()
    unbiased = torch.topk(torch.sigmoid(x.reshape(-1, cfg.hidden_size) @ p["gate"]), cfg.num_experts_per_tok).indices
    assert any(set(a.tolist()) != set(b.tolist()) for a, b in zip(idx, unbiased))
    assert torch.allclose(w.sum(-1), torch.full((10,), cfg.routed_scaling_factor))
    rcfg = {"num_experts_per_tok": cfg.num_experts_per_tok, "norm_topk_prob": True,
            "routed_scaling_factor": cfg.routed_scaling_factor}
    with torch.no_grad():
        out = moe.moe_forward(p, cfg, x)
        ref = R.moe(W, rcfg, x.reshape(-1, cfg.hidden_size), "x.", R.Precision("fp32"))
    assert (out.reshape(-1, cfg.hidden_size) - ref).abs().max() <= ATOL


def test_grouped_products_on_the_cpu_loop_over_groups_with_empty_ones():
    x, w = torch.randn(7, 4), torch.randn(3, 4, 5)
    offs = torch.tensor([2, 2, 7], dtype=torch.int32)
    out = moe.grouped_mm(x, w, offs)
    assert torch.allclose(out, torch.cat([x[:2] @ w[0], x[2:] @ w[2]]))


def test_stacked_experts_are_a_view_of_the_buffer_they_are_drawn_in(model):
    W, params, _ = model
    wg = params["text"]["layers"][1]["mlp"]["wg"]
    assert wg.shape == (CFG.text.n_routed_experts, CFG.text.hidden_size, CFG.text.moe_intermediate_size)
    assert wg.data_ptr() == W["language_model.model.layers.1.mlp.experts.0.gate_proj.weight"].data_ptr()
    assert torch.equal(wg[3], W["language_model.model.layers.1.mlp.experts.3.gate_proj.weight"])
    loose = {"a": torch.ones(2, 3), "b": torch.zeros(2, 3)}
    assert torch.equal(stacked(loose, ["a", "b"]), torch.stack([loose["a"], loose["b"]]))


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

def test_k5_plain_version_is_the_absorbed_formula():
    B, H, Dk, Dv, T = 3, 4, 24, 16, 20
    q, cache = torch.randn(B, H, Dk), torch.randn(B, 1, T, Dk)
    kv_len = torch.tensor([20, 7, 0])
    out = K5.flash_mla_decode(q, cache, kv_len, 0.3, Dv)
    for b in range(2):
        kv = cache[b, 0, :kv_len[b]]
        ref = torch.softmax(q[b] @ kv.T * 0.3, -1) @ kv[:, :Dv]
        assert (out[b] - ref).abs().max() <= 1e-5
    assert torch.equal(out[2], torch.zeros(H, Dv))
    f, nbytes = K5.work(torch.tensor([100, 50]), 1536, 16, 576, 512)
    assert f == 2 * 16 * 1088 * 150 and nbytes == 150 * 576 * 2 + 2 * 16 * 1088 * 2


def test_k2_plain_version_at_a_value_width_apart_from_the_key_width():
    B, S, T, H, D, DV = 2, 6, 10, 3, 12, 8
    q, k, v = torch.randn(B, S, H, D), torch.randn(B, H, T, D), torch.randn(B, H, T, DV)
    keep = torch.tensor([0, 4])
    positions = keep[:, None] + torch.arange(S)[None]
    kv_len = keep + S
    out = K2.flash_causal_attention(q, k, v, positions, kv_len)
    assert out.shape == (B, S, H, DV)
    for b in range(B):
        for s in range(S):
            n = int(positions[b, s]) + 1
            p = torch.softmax(torch.einsum("hd,htd->ht", q[b, s], k[b, :, :n]) * D ** -0.5, -1)
            assert (out[b, s] - torch.einsum("ht,htd->hd", p, v[b, :, :n])).abs().max() <= 1e-5


def test_k1_at_a_padded_head_width_with_the_query_prescaled():
    """The tower's way to run a 72-wide head on K1: zero-pad to 80, q times sqrt(80/72)."""
    S, H, D = 50, 2, 72
    seg = torch.as_tensor(np.repeat([0, 1], [30, 20]), dtype=torch.int32)
    q, k, v = torch.randn(S, H, D), torch.randn(S, H, D), torch.randn(S, H, D)
    pad = moonvit.kernel_head_dim(D) - D
    assert pad == 8
    out = K1.flash_segment_attention(F.pad(q * (80 / 72) ** 0.5, (0, pad)), F.pad(k, (0, pad)), F.pad(v, (0, pad)),
                                     seg)[..., :D]
    from zoomearth_tpu_torch.ops.attention import segment_attention

    assert (out - segment_attention(q, k, v, seg)).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# The whole episode, and what is refused
# ---------------------------------------------------------------------------

def test_a_pipelined_two_stage_episode_serves_the_references_greedy_tokens(model, monkeypatch):
    """Two waves of three through run_episodes_pipelined (stage 2 over the kept latent
    cache, the pair decode): every served token is the reference's argmax."""
    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    W, params, rcfg = model
    instruction = "\nYou are an intelligent remote<|im_end|><|im_assistant|>assistant<|im_middle|>"
    monkeypatch.setattr(PT, "kimi_stage1_prompt", lambda q: PT.KIMI_PREFIX + q + instruction)
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
    rcfg = dict(rcfg, special_token_ids={f.name: getattr(CFG.tokens, f.name) for f in dataclasses.fields(CFG.tokens)})
    boxes2 = [[10, 12, 40, 50], [0, 0, 20, 20], [60, 30, 90, 80]]
    for w, (questions, images) in enumerate(waves):
        for i in range(3):
            out1, out2 = served[2 * w][i], served[2 * w + 1][i]
            g, _ = RE.gaps(W, rcfg, traffic, images[i], questions[i], boxes2[i], out1, out2)
            assert len(g) == len(out1) + len(out2) and g.max() <= ATOL


def test_the_config_reader_takes_hf_and_benchmark_layouts(tmp_path):
    flat = json.load(open("portbench/configs/kimi_vl_a3b.json"))
    cfg = KimiVLConfig.from_dict(flat)
    assert cfg.text == KimiTextConfig() and cfg.vision.head_dim == 72 and cfg.tokens.media_pad == 163605
    nested = {"text_config": {k: flat[k] for k in ("hidden_size", "kv_lora_rank", "n_routed_experts", "vocab_size")},
              "vision_config": flat["vision_config"], "media_placeholder_token_id": 7}
    (tmp_path / "config.json").write_text(json.dumps(nested))
    read = KimiVLConfig.from_file(str(tmp_path))
    assert read.text.n_routed_experts == 64 and read.tokens.media_pad == 7 and read.vision.depth == 27
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        KimiVLConfig.from_dict(dict(flat, q_lora_rank=1536))


def test_training_int8_tensor_parallel_and_serving_are_refused_before_any_launch(model):
    _, params, _ = model
    ids = torch.as_tensor(_ids(8, 14))[None]
    pos = torch.arange(8)[None].expand(3, 1, 8)
    x = params["text"]["embed"]["weight"][ids].clone().requires_grad_(True)
    from zoomearth_tpu_torch.models.decoder import decoder_forward

    with pytest.raises(NotImplementedError, match="inference only"):
        decoder_forward(params["text"], CFG.text, x, pos)
    with pytest.raises(NotImplementedError, match="int8"):
        LatentCache.create(CFG.text, 1, 16, torch.int8)
    class AnyRank:  # the decoder asks a tensor-parallel view for its layers' views
        def at(self, *path):
            return self

    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        decoder_forward(params["text"], CFG.text, x.detach(), pos, tp=AnyRank())
    from zoomearth_tpu_torch.serve.engine import ServingEngine

    with pytest.raises(NotImplementedError, match="latent cache"):
        ServingEngine(params, CFG)


def test_kimi_chat_template_and_special_ids():
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    tk = FakeTokenizer(CFG.tokens)
    text = PT.kimi_stage1_prompt("q?")
    ids = tk.encode(text)
    t = CFG.tokens
    assert ids[0] == t.im_system and ids.count(t.media_pad) == 1
    assert ids[-12:] == [t.im_end, t.im_assistant] + tk.encode("assistant") + [t.im_middle]
    assert tk.decode(ids, skip_special_tokens=False) == text
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.runtime.families import family

    assert family(CFG).prompts() == (PT.kimi_stage1_prompt, PT.KIMI_VISION_TOKENS)
    assert family(VLMConfig.tiny()).prompts() == (PT.stage1_prompt, PT.VISION_TOKENS)
