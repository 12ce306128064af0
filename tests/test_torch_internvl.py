"""The port's InternVL family against the JAX package on the CPU: the anyres tiling and
the prompt / batch helpers exactly, InternViT and the embeds-input decoder in fp32 to
5e-5 with the same weights (the JAX package's tiny tree through params_from_numpy),
both HF imports leaf for leaf and against a tiny random-init HF oracle
(InternVLForConditionalGeneration, as tests/test_internvl_parity.py builds it), greedy
InternVLRunner texts identical to the JAX runner's, the reference's refusal of a prompt
that tiles past the 2048-token bucket, and one bf16 comparison that pins the order of
InternViT's logits cast.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.config import InternVLVLMConfig as JInternVLVLMConfig
from zoomearth_tpu.image import anyres as JA
from zoomearth_tpu.models import internvit as JI
from zoomearth_tpu.models import internvl as JL
from zoomearth_tpu.models import vlm as JM
from zoomearth_tpu.runtime.generate import GenerationConfig as JGenerationConfig
from zoomearth_tpu.tokenizer import FakeTokenizer as JFakeTokenizer
from zoomearth_tpu_torch.config import InternVLVLMConfig
from zoomearth_tpu_torch.image import anyres as TA
from zoomearth_tpu_torch.models import internvit as TI
from zoomearth_tpu_torch.models import internvl as TL
from zoomearth_tpu_torch.models import vlm as TM
from zoomearth_tpu_torch.models.params import map_tree, param_count, params_from_numpy, tree_leaves
from zoomearth_tpu_torch.runtime.generate import GenerationConfig
from zoomearth_tpu_torch.tokenizer import FakeTokenizer

torch.set_num_threads(1)
CFG = InternVLVLMConfig.tiny()
JCFG = JInternVLVLMConfig.tiny()
ATOL = 5e-5
# 75 bytes: with the REC template and InternVLVLMConfig()'s 256 tokens a tile, 5 tiles make
# a 1805-token prompt and 10 tiles a 3085-token one under the byte-level FakeTokenizer
QUESTION = "Which vessel is moored closest to the end of the long pier in the harbours?"


def _img(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _letters(cls):
    """The FakeTokenizer class `cls` reading every id that is no special token as a
    letter: the tiny model's random weights pick ids the byte-level tokenizer has no
    text for, and identical empty texts would show nothing."""

    class Letters(cls):
        def decode(self, ids, skip_special_tokens=True):
            return "".join("" if int(i) in self._id_to_special else chr(97 + int(i) % 26) for i in ids)

    return Letters


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = JI.init_internvl_params(jax.random.key(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# anyres tiling and the host helpers (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h,max_num,thumb", [
    (448, 448, 12, False), (1800, 450, 12, False), (1800, 450, 12, True), (448, 448, 12, True),
    (5000, 5000, 6, False), (900, 450, 12, True), (5000, 5000, 12, True), (5000, 5000, 8, True),
    (1024, 768, 12, True), (300, 1700, 7, True),
])
def test_anyres_tiles_and_pixels_equal_reference(w, h, max_num, thumb):
    img = _img(w, h, seed=w + h)
    ours = TA.dynamic_preprocess(img, max_num=max_num, image_size=448, use_thumbnail=thumb)
    theirs = JA.dynamic_preprocess(img, max_num=max_num, image_size=448, use_thumbnail=thumb)
    assert [t.size for t in ours] == [t.size for t in theirs]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ours, theirs))
    pv = TA.load_image_anyres(img, input_size=448, max_num=max_num, use_thumbnail=thumb)
    ref = JA.load_image_anyres(img, input_size=448, max_num=max_num, use_thumbnail=thumb)
    assert pv.dtype == ref.dtype == np.float32 and np.array_equal(pv, ref)
    # the tile counts the InternVL phase of chip_smoke.py and the bucket fault rest on
    expected = {(5000, 5000, 12): 10, (5000, 5000, 8): 5, (1024, 768, 12): 13}.get((w, h, max_num))
    if expected is not None:
        assert pv.shape[0] == expected


@pytest.mark.parametrize("aspect,w,h", [(1.0, 2000, 2000), (1.0, 100, 100), (2.0, 900, 450), (0.75, 768, 1024)])
def test_closest_aspect_ratio_and_normalize_equal_reference(aspect, w, h):
    ratios = sorted({(i, j) for n in range(1, 13) for i in range(1, n + 1) for j in range(1, n + 1)
                     if i * j <= 12}, key=lambda x: x[0] * x[1])
    for rs in (ratios, [(1, 1), (2, 2)]):
        assert TA.find_closest_aspect_ratio(aspect, rs, w, h, 448) == JA.find_closest_aspect_ratio(aspect, rs, w, h, 448)
    # the reference's tie-break: the larger grid wins when the area exceeds half its target
    assert TA.find_closest_aspect_ratio(1.0, [(1, 1), (2, 2)], 2000, 2000, 448) == (2, 2)
    assert TA.find_closest_aspect_ratio(1.0, [(1, 1), (2, 2)], 100, 100, 448) == (1, 1)
    tile = _img(32, 32, seed=int(aspect * 100))
    assert np.array_equal(TA.normalize_imagenet(tile), JA.normalize_imagenet(tile))


def test_patchify_and_pixel_shuffle_equal_reference():
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
    for p in (14, 28):
        assert np.array_equal(TI.patchify_tiles(tiles, p), JI.patchify_tiles(tiles, p))
    feats = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    for sf in (0.5, 0.25):
        ours = TI.pixel_shuffle(torch.from_numpy(feats), sf)
        theirs = np.asarray(JI.pixel_shuffle(jnp.asarray(feats), sf))
        assert ours.shape == theirs.shape and np.array_equal(ours.numpy(), theirs)


def test_prompt_helpers_and_prepare_batch_equal_reference():
    q = TL.get_question_template().format(Question=QUESTION)
    assert q == JL.get_question_template().format(Question=QUESTION)
    for n in (1, 2):
        assert TL.chat_prompt(q, n_images=n) == JL.chat_prompt(q, n_images=n)
        assert TL.chat_prompt(q, "sys", n) == JL.chat_prompt(q, "sys", n)
    text = TL.chat_prompt(q, n_images=2)
    assert TL.expand_image_tokens(text, [3, 5], 4) == JL.expand_image_tokens(text, [3, 5], 4)
    for mod in (TL, JL):
        with pytest.raises(ValueError, match="more <image> markers"):
            mod.expand_image_tokens(text, [3], 4)
    tk = FakeTokenizer(CFG.tokens)
    assert tk.encode(text) == JFakeTokenizer(JCFG.tokens).encode(text)
    rng = np.random.default_rng(1)
    lists = [list(rng.integers(0, 300, n)) for n in (5, 40, 17)]
    emb = rng.standard_normal((6, CFG.text.hidden_size)).astype(np.float32)
    for buckets in ((64,), (16, 32, 48)):
        ours = TL.prepare_internvl_batch(CFG, lists, emb, length_buckets=buckets)
        theirs = JL.prepare_internvl_batch(JCFG, lists, jnp.asarray(emb), length_buckets=buckets)
        for f in ("input_ids", "lengths", "position_ids", "next_pos"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert ours.vision_meta is None and theirs.vision_meta is None
        assert np.array_equal(np.asarray(ours.pixel_values), np.asarray(theirs.pixel_values))
    assert TL.prepare_internvl_batch(CFG, lists, None).pixel_values is None


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_init_and_params_from_numpy_carry_the_reference_tree(params):
    jp, tp = params
    jl = jax.tree.leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, b in zip(jl, tree_leaves(tp)):
        assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
    ours = TI.init_internvl_params(CFG, torch.Generator().manual_seed(3))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, ours, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [tuple(t.shape) for t in tree_leaves(ours)] == [tuple(a.shape) for a in jl]
    assert param_count(ours) == sum(a.size for a in jl)
    bf = TI.init_internvl_params(CFG, torch.Generator().manual_seed(3), dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))
    # layer-scale and the zero CLS token as the reference sets them
    blk = ours["vision"]["blocks"][0]
    assert torch.all(blk["ls1"] == CFG.vision.layer_scale_init) and not ours["vision"]["cls_token"].any()


@pytest.fixture(scope="module")
def oracle():
    from transformers import InternVLConfig, InternVLForConditionalGeneration, InternVLVisionConfig, Qwen2Config

    v, t = CFG.vision, CFG.text
    vcfg = InternVLVisionConfig(
        hidden_size=v.hidden_size, num_hidden_layers=v.depth,
        num_attention_heads=v.num_heads, intermediate_size=v.intermediate_size,
        image_size=[v.image_size, v.image_size], patch_size=[v.patch_size, v.patch_size],
        use_qk_norm=v.use_qk_norm, layer_scale_init_value=v.layer_scale_init,
        norm_type=v.norm_type, attention_bias=v.attention_bias, hidden_act=v.hidden_act,
        use_absolute_position_embeddings=True,
    )
    tcfg = Qwen2Config(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
        num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
        head_dim=t.head_dim, tie_word_embeddings=t.tie_word_embeddings,
        rope_theta=t.rope_theta, max_position_embeddings=t.max_position_embeddings,
        attention_dropout=0.0,
    )
    full = InternVLConfig(
        vision_config=vcfg, text_config=tcfg, image_token_id=CFG.tokens.image_context,
        downsample_ratio=CFG.vision.downsample_ratio,
        vision_feature_layer=-1, vision_feature_select_strategy="default",
    )
    torch.manual_seed(0)
    model = InternVLForConditionalGeneration(full).eval()
    with torch.no_grad():  # random values for the zero-initialized CLS token and positions
        emb = model.model.vision_tower.embeddings
        emb.cls_token.normal_(0, 0.02)
        emb.position_embeddings.normal_(0, 0.02)
    return model


def test_hf_import_equals_reference_leaf_for_leaf(oracle):
    theirs = JI.internvl_params_from_hf(oracle, JCFG)
    for source in (oracle, oracle.state_dict()):
        ours = TI.internvl_params_from_hf(source, CFG)
        assert jax.tree.structure(jax.tree.map(lambda _: 0, theirs)) == jax.tree.structure(
            jax.tree.map(lambda _: 0, ours, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        for a, b in zip(jax.tree.leaves(theirs), tree_leaves(ours)):
            assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
    vis = TI.internvit_params_from_hf(oracle, CFG.vision, dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(vis))


def test_internvit_embeds_against_hf_oracle_and_reference(oracle):
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((3, 3, CFG.vision.image_size, CFG.vision.image_size)).astype(np.float32)
    hf = oracle.model.get_image_features(torch.from_numpy(pixels)).detach().numpy()
    patches = TI.patchify_tiles(pixels, CFG.vision.patch_size)
    ours = TI.internvit_embeds(TI.internvl_params_from_hf(oracle, CFG)["vision"], CFG.vision,
                               torch.from_numpy(patches)).numpy()
    # the reference's own bar against HF (tests/test_internvl_parity.py)
    np.testing.assert_allclose(ours, hf.reshape(-1, hf.shape[-1]), atol=2e-4, rtol=1e-3)
    theirs = JI.internvit_embeds(JI.internvl_params_from_hf(oracle, JCFG)["vision"], JCFG.vision,
                                 jnp.asarray(patches))
    _close(ours, theirs)


@pytest.mark.parametrize("n_tiles,vision", [(3, "tiny"), (2, "bias+rms+silu")])
def test_internvit_embeds_equal_reference_fp32(n_tiles, vision):
    vcfg, jvcfg = CFG.vision, JCFG.vision
    if vision != "tiny":
        kw = dict(image_size=56, attention_bias=True, norm_type="rms_norm", hidden_act="silu", use_qk_norm=False)
        vcfg, jvcfg = dataclasses.replace(vcfg, **kw), dataclasses.replace(jvcfg, **kw)
    jp = JI.init_internvit_params(jax.random.key(n_tiles), jvcfg, CFG.text.hidden_size)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(n_tiles)
    pixels = rng.standard_normal((n_tiles, 3, vcfg.image_size, vcfg.image_size)).astype(np.float32)
    patches = JI.patchify_tiles(pixels, vcfg.patch_size)
    ours = TI.internvit_embeds(tp, vcfg, torch.from_numpy(patches))
    theirs = JI.internvit_embeds(jp, jvcfg, jnp.asarray(patches))
    assert ours.shape == (n_tiles * vcfg.num_image_token, CFG.text.hidden_size)
    _close(ours, theirs)


class _Fp32LogitsTorch:
    """torch, except that InternViT's q.k product takes fp32 inputs: logits computed in
    fp32 from the start instead of cast after a product in the params' dtype."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, a, b):
        if eq == "tshd,tzhd->thsz":
            a, b = a.float(), b.float()
        return torch.einsum(eq, a, b)


def test_internvit_bf16_pins_the_logits_cast_order(monkeypatch):
    """bf16 weights and activations through both packages. The reference takes the q.k
    product in bf16 and casts its result to fp32 for the softmax (internvit.py:119). The
    port must agree to one bf16 step of the largest output (2^-7 * max|ref|). With the
    full config's setting (no qk-norm) and q/k weights large enough that the logits
    matter, logits computed in fp32 from the start depart by 2.5-4 such steps on these
    seeds, so this tolerance tells the two orders apart (checked below)."""
    vcfg = dataclasses.replace(CFG.vision, image_size=56, use_qk_norm=False)
    jvcfg = dataclasses.replace(JCFG.vision, image_size=56, use_qk_norm=False)
    for seed in range(3):
        tree = jax.tree.map(np.asarray, JI.init_internvit_params(jax.random.key(seed), jvcfg, CFG.text.hidden_size))
        rng = np.random.default_rng(seed)
        for blk in tree["blocks"]:
            for k in ("wq", "wk", "wv", "wo"):
                blk["attn"][k] = (rng.standard_normal(blk["attn"][k].shape) * 0.5).astype(np.float32)
            blk["ls1"] = np.ones_like(blk["ls1"])
        pixels = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
        patches = JI.patchify_tiles(pixels, vcfg.patch_size)
        ref = np.asarray(JI.internvit_embeds(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), jvcfg,
                                             jnp.asarray(patches)).astype(jnp.float32))
        tp = params_from_numpy(tree, dtype="bfloat16")
        ours = TI.internvit_embeds(tp, vcfg, torch.from_numpy(patches))
        assert ours.dtype == torch.bfloat16
        tol = 2.0**-7 * np.abs(ref).max()
        err = np.abs(ours.float().numpy() - ref).max()
        assert err <= tol, (seed, err, tol)
        with monkeypatch.context() as m:
            m.setattr(TI, "torch", _Fp32LogitsTorch())
            other = TI.internvit_embeds(tp, vcfg, torch.from_numpy(patches)).float().numpy()
        assert np.abs(other - ref).max() > 2 * tol, seed


# ---------------------------------------------------------------------------
# the embeds-input decoder and the runner
# ---------------------------------------------------------------------------

def test_vlm_forward_logits_on_the_embeds_path_equal_reference(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    tok = CFG.tokens
    pixels = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    patches = JI.patchify_tiles(pixels)
    ids = [[tok.im_start] + list(rng.integers(1, 300, 4)) + [tok.img_start, tok.image_context, tok.image_context,
                                                              tok.img_end] + list(rng.integers(1, 300, 9))]
    S = len(ids[0])
    pos = np.broadcast_to(np.arange(S)[None, None], (3, 1, S)).astype(np.int32)
    jemb = JI.internvit_embeds(jp["vision"], JCFG.vision, jnp.asarray(patches))
    theirs, _ = JM.vlm_forward(jp, JCFG, jnp.asarray(ids, jnp.int32), jnp.asarray(pos), vision_embeds=jemb)
    with torch.inference_mode():
        temb = TI.internvit_embeds(tp["vision"], CFG.vision, torch.from_numpy(patches))
        ours, _ = TM.vlm_forward(tp, CFG, torch.tensor(ids), torch.from_numpy(pos), vision_embeds=temb)
    assert ours.shape == (1, S, CFG.text.vocab_size)
    _close(ours, theirs)


def test_runner_greedy_texts_equal_reference_on_two_aspects(params):
    """Two images of different aspect (9 and 7 tiles at the tiny tile size), greedy,
    through InternViT and the Generator's embeds path in both packages."""
    jp, tp = params
    images = [_img(200, 100, seed=1), _img(90, 150, seed=2)]
    questions = [JL.get_question_template().format(Question=q) for q in ("where is the ship?", "a road?")]
    ours = TL.InternVLRunner(tp, CFG, _letters(FakeTokenizer)(CFG.tokens), max_cache_len=1024, device="cpu")
    theirs = JL.InternVLRunner(jp, JCFG, _letters(JFakeTokenizer)(JCFG.tokens), max_cache_len=1024)
    _, counts = ours.encode_images(images)
    assert counts == [9, 7]
    texts = ours.generate(questions, images, GenerationConfig(max_new_tokens=10))
    ref = theirs.generate(questions, images, JGenerationConfig(max_new_tokens=10))
    assert texts == ref and all(texts), (texts, ref)


def test_runner_takes_cuda_unless_asked_and_refuses_params_on_another_device(params):
    """The runner's device is cuda unless the caller names another: without a CUDA
    device that raises (no move to the CPU on its own); params elsewhere than the
    runner's device are refused before anything runs."""
    _, tp = params
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError):
        TL.InternVLRunner(tp, CFG, FakeTokenizer(CFG.tokens))
    meta = map_tree(lambda t: t.to("meta"), tp)
    with pytest.raises(ValueError, match="must be on cpu"):
        TL.InternVLRunner(meta, CFG, FakeTokenizer(CFG.tokens), device="cpu")


def test_both_runners_refuse_a_prompt_that_tiles_past_the_2048_bucket(params):
    """The reference's fault, kept: max_anyres_num=12 with DEFAULT_LENGTH_BUCKETS. A square
    image makes 10 tiles; at 256 tokens a tile (patches_per_side 32, as InternVLVLMConfig()
    has it, here from 64 px tiles of 2 px patches) the prompt is over 2048 tokens, and both
    runners raise. At the full config with the REC template the prompt is 3085 tokens for
    10 tiles and 1805 for the 5 tiles of max_anyres_num=8."""
    jp, tp = params
    kw = dict(image_size=64, patch_size=2, depth=1)
    cfg = dataclasses.replace(CFG, vision=dataclasses.replace(CFG.vision, **kw))
    jcfg = dataclasses.replace(JCFG, vision=dataclasses.replace(JCFG.vision, **kw))
    assert cfg.vision.num_image_token == 256
    jvis = JI.init_internvit_params(jax.random.key(5), jcfg.vision, CFG.text.hidden_size)
    jpar = {"vision": jvis, "text": jp["text"]}
    tpar = {"vision": params_from_numpy(jax.tree.map(np.asarray, jvis)), "text": tp["text"]}
    image = _img(640, 640, seed=3)
    question = JL.get_question_template().format(Question=QUESTION)
    runners = (TL.InternVLRunner(tpar, cfg, FakeTokenizer(cfg.tokens), max_cache_len=4096, device="cpu"),
               JL.InternVLRunner(jpar, jcfg, JFakeTokenizer(jcfg.tokens), max_cache_len=4096))
    for runner, gen in zip(runners, (GenerationConfig(max_new_tokens=4), JGenerationConfig(max_new_tokens=4))):
        with pytest.raises(ValueError, match="exceeds largest bucket 2048"):
            runner.generate([question], [image], gen)
    assert runners[0].tile_images([image])[1] == [10]
    full = InternVLVLMConfig()
    tk, jtk = FakeTokenizer(full.tokens), JFakeTokenizer(JInternVLVLMConfig().tokens)
    for n_tiles, n_tokens in ((10, 3085), (5, 1805)):
        ours = tk.encode(TL.expand_image_tokens(TL.chat_prompt(question), [n_tiles], full.vision.num_image_token))
        theirs = jtk.encode(JL.expand_image_tokens(JL.chat_prompt(question), [n_tiles], full.vision.num_image_token))
        assert len(ours) == len(theirs) == n_tokens
