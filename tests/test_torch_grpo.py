"""The port's GRPO path against the JAX package on the CPU, at the tiny config in fp32:
the reward functions and their registry, the stop mask, per_token_logps, grpo_loss
with every gradient leaf, greedy rollouts in both reuse_cache modes (text-only,
image and mixed batches, and through a ServingEngine with fewer slots than rows),
the parameters after two steps in five configurations (LoRA with the JAX package's
adapters carried across), rollouts and steps alternating, the completion log, and
`cli.train_grpo --device cpu` with its bit-for-bit resume.

Host outputs (rewards, masks, token ids, positions, pixels, completions,
advantages) are held to exact equality; log-probabilities, losses, gradients and
parameters to atol 5e-5 (the SFT tests' bar). Sampled rollouts draw other numbers
than JAX's from one seed (ops/sampling.py), so parity runs greedy: G equal
completions then give equal rewards, and `_row_reward` adds a reward by row so that
the advantages, and with them the policy gradient, are not zero. The JAX trainers
are built once per configuration and shared through module fixtures.
"""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent import prompts as JPT
from zoomearth_tpu.agent.processor import Processor as JProcessor
from zoomearth_tpu.config import VLMConfig as JVLMConfig
from zoomearth_tpu.models.params import init_vlm_params as jax_init
from zoomearth_tpu.models.params import save_hf_checkpoint as jax_save_hf
from zoomearth_tpu.rewards import generic as JGEN
from zoomearth_tpu.rewards import registry as JREG
from zoomearth_tpu.serve import engine as JE
from zoomearth_tpu.tokenizer import FakeTokenizer as JFakeTokenizer
from zoomearth_tpu.train import grpo as JG
from zoomearth_tpu.train import lora as JLORA
from zoomearth_tpu.train.data import LRSGROSample as JSample
from zoomearth_tpu.utils import mathcheck as JMATH
from zoomearth_tpu_torch.agent import prompts as TPT
from zoomearth_tpu_torch.agent.processor import Processor
from zoomearth_tpu_torch.cli import train_grpo as CLI
from zoomearth_tpu_torch.config import VLMConfig
from zoomearth_tpu_torch.models.params import load_hf_checkpoint, params_from_numpy, tree_leaves
from zoomearth_tpu_torch.rewards import generic as TGEN
from zoomearth_tpu_torch.rewards import registry as TREG
from zoomearth_tpu_torch.serve import engine as TE
from zoomearth_tpu_torch.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.train import grpo as TG
from zoomearth_tpu_torch.train import lora as TLORA
from zoomearth_tpu_torch.train import sft as TS
from zoomearth_tpu_torch.train.checkpoints import CheckpointManager
from zoomearth_tpu_torch.train.data import LRSGROSample
from zoomearth_tpu_torch.utils import mathcheck as TMATH

import torch_parallel_worker as W  # noqa: E402  (tests/ is on sys.path under pytest)

torch.set_num_threads(1)
CFG, JCFG = VLMConfig.tiny(), JVLMConfig.tiny()
ATOL = 5e-5
MAX_PIXELS = 4 * 28 * 28
TRAINER_KW = dict(max_cache_len=512, length_buckets=(256, 384), patch_buckets=(64, 128), cache_dtype="float32")
GRPO_KW = dict(num_generations=2, max_completion_length=6, stage2_max_completion_length=4, rollout_temperature=0.0,
               learning_rate=1e-4, beta=0.04)


def _short_prompt(q):
    return TPT.PREFIX + q + "<|im_end|>\n<|im_start|>assistant\n"


def _text_prompt(q):
    return "<|im_start|>system\nsolve<|im_end|>\n<|im_start|>user\n" + q + "<|im_end|>\n<|im_start|>assistant\n"


@pytest.fixture(scope="module", autouse=True)
def _short_prompts():
    """Both packages' stage-1 templates cut to a tiny config's budget, as the JAX
    package's own GRPO tests cut them."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JPT, TPT):
            mp.setattr(mod, "rl_prompt", _short_prompt)
            mp.setattr(mod, "text_rl_prompt", _text_prompt)
        yield


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

C1_BBOX = '<think>looking</think> [{"bbox_2d": [100, 100, 200, 200], "label": "car"}]'
C2_OK = "<think>closer look</think><answer>car</answer>"
C1_NOCUT = "<think>whole image</think><answer>three</answer>"
# (completion1, completion2, ground truth, dataset bbox, scale): every branch of
# format (cut / uncut, each tag missing), iou (exact match 2.0, no bbox, a 3-number
# box, a 3-number reference, scales) and answer (stage 1 / stage 2, synonyms, none)
REWARD_ROWS = [
    (C1_BBOX, C2_OK, "car", [100.0, 100.0, 200.0, 200.0], 1.0),
    (C1_BBOX, C2_OK, "vehicle", [220, 220, 400, 420], 2.0),
    ('<think>x</think> [{"bbox_2d": [10, 20, 30]}]', "<think>y</think><answer>two</answer>", "2", [1, 2, 3, 4], 1.5),
    ("<think>looking</think>", C2_OK, "car", [10, 10, 40, 40], 1.0),
    (C1_BBOX, "<think>x</think>", "car", [100, 100, 200], 1.0),
    (C1_BBOX, "<answer>car</answer>", "automobile", [90, 95, 210, 190], 9.765625),
    (C1_NOCUT, "", "three", [], 1.0),
    ("<answer>x</answer>", "", "x", [], 1.0),
    ('<think>a</think>[{"bbox_2d": [1.5, 2.5, 300.25, 400]}] <answer>ship</answer>', "", "boat", [0, 0, 50, 50], 3.2),
    ("", "", "", [], 1.0),
]
DET_GT = '```json\n[{"bbox_2d": [10, 10, 50, 50], "label": "car"}, {"bbox_2d": [60, 60, 90, 90], "label": "ship"}]\n```'
DET_PRED = '```json\n[{"bbox_2d": [12, 11, 49, 52], "label": "car"}, {"bbox_2d": [0, 0, 5, 5], "label": "ship"}]\n```'
# (content, solution, accu_reward_method): every dispatch branch of accuracy_reward
ACCURACY_ROWS = [
    ("<answer>B</answer>", "<answer>B</answer>", "mcq"), ("I pick (C)", "<answer>D</answer>", "mcq"),
    ("<answer>yes</answer>", "<answer>Yes</answer>", "yes_no"), ("no", "<answer>yes</answer>", "yes_no"),
    ("<answer>\\boxed{\\frac{1}{2}}</answer>", "<answer>\\frac12</answer>", "math"),
    ("<answer>0.5</answer>", "<answer>\\frac{1}{2}</answer>", "math"),
    ("<answer>a car</answer>", "<answer>a car</answer>", "llm"), ("<answer>car</answer>", "<answer>ship</answer>", "llm"),
    ("<answer>two ships</answer>", "<answer>two ship</answer>", "default"),
    ("<answer>harbour</answer>", "<answer>harbor</answer>", None),
    (DET_PRED, DET_GT, "map"), (f"<answer>{DET_PRED}</answer>", f"<answer>{DET_GT}</answer>", "od_ap"),
    (f"<answer>{DET_GT}</answer>", f"<answer>{DET_GT}</answer>", "od_ap50"),
    (f"<answer>{DET_PRED}</answer>", f"<answer>{DET_GT}</answer>", "odLength"),
    ("<answer>None</answer>", "<answer>None</answer>", "od_ap"),
    (DET_PRED, DET_GT, "weighted_sum"), ("<answer>x</answer>", "<answer>x</answer>", "all_match"),
    ("<answer>x </answer>", "<answer>y</answer>", "all_match"), ("anything", "<answer>3</answer>", "unknown"),
]
MATH_PAIRS = [("3", "3"), ("\\boxed{3}", "3"), ("\\frac{1}{2}", "1/2"), ("0.5", "\\frac12"), ("\\sqrt2", "\\sqrt{2}"),
              ("10\\text{ cm}", "10"), ("x^2", "x^{2}"), ("\\dfrac{3}{4}", "\\frac{3}{4}"), ("", "1"),
              ("\\boxed{\\frac{a}{b}}", "a/b"), (" 7 ", "7.0")]


def _reward_kwargs(rows, *, accuracy=False):
    kw = {"question": [f"q{i}" for i in range(len(rows))], "ground_truth": [r[2] for r in rows],
          "bbox": [r[3] for r in rows], "scale": [r[4] for r in rows], "image_path": [None] * len(rows),
          "category": ["c"] * len(rows), "type": ["object"] * len(rows)}
    if accuracy:
        kw["solution"] = [f"<answer>{r[2]}</answer>" for r in rows]
    return kw


@pytest.mark.parametrize("name", sorted(JREG.REWARD_REGISTRY))
def test_every_registered_reward_equals_reference(name, monkeypatch):
    """Each name of the registry, through get_reward_funcs, on the table: the same
    floats exactly. internvl_iou reads `<answer>[x1,y1,x2,y2]</answer>` solutions."""
    monkeypatch.delenv("JUDGE_BASE_URL", raising=False)
    monkeypatch.delenv("OPENAI_API_BASE", raising=False)
    assert sorted(TREG.REWARD_REGISTRY) == sorted(JREG.REWARD_REGISTRY)
    (ours,), (theirs,) = TREG.get_reward_funcs([name]), JREG.get_reward_funcs([name])
    c1, c2 = [r[0] for r in REWARD_ROWS], [r[1] for r in REWARD_ROWS]
    kw = _reward_kwargs(REWARD_ROWS, accuracy=name == "accuracy")
    if name == "internvl_iou":
        kw["solution"] = ["<answer>[100, 100, 200, 200]</answer>"] * len(REWARD_ROWS)
        c1 = c1[:-1] + ["<think>t</think><answer>[110, 90, 210, 190]</answer>"]
    out = ours(c1, c2, **dict(kw))
    assert out == theirs(c1, c2, **dict(kw)) and all(isinstance(x, float) for x in out)
    if name == "iou":
        assert out[0] == 2.0 and out[2] == out[3] == out[4] == 0.0 and 0.0 < out[1] < 2.0
    with pytest.raises(KeyError):
        TREG.get_reward_funcs([name, "no-such-reward"])


def test_accuracy_by_every_method_and_mathcheck_equal_reference(monkeypatch):
    monkeypatch.delenv("JUDGE_BASE_URL", raising=False)
    monkeypatch.delenv("OPENAI_API_BASE", raising=False)
    contents, sols = [r[0] for r in ACCURACY_ROWS], [r[1] for r in ACCURACY_ROWS]
    methods = [r[2] for r in ACCURACY_ROWS]
    ours = TGEN.accuracy_reward(contents, sols, accu_reward_method=methods)
    assert ours == JGEN.accuracy_reward(contents, sols, accu_reward_method=methods)
    assert len(set(ours)) > 3  # the table reaches more than a couple of values
    assert set(TGEN._ACCURACY_METHODS) == set(JGEN._ACCURACY_METHODS) == {m for m in methods if m} - {"unknown"}
    for a, b in MATH_PAIRS:
        assert TMATH.compute_score(a, b) == JMATH.compute_score(a, b), (a, b)
        assert TMATH.strip_string(a) == JMATH.strip_string(a)
        assert TMATH.last_boxed_only_string(a) == JMATH.last_boxed_only_string(a)
    for c in contents:
        assert TGEN.repetition_penalty_reward(c * 3) == JGEN.repetition_penalty_reward(c * 3)
        assert TGEN.cosine_length_reward(c, len(c), 0.3) == JGEN.cosine_length_reward(c, len(c), 0.3)


def test_first_stop_mask_equals_reference():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 12, (6, 40)).astype(np.int32)
    ids[2] = 5  # a row with no stop token
    start = rng.integers(0, 40, 6).astype(np.int32)
    for stops in ((3,), (3, 7), (11,)):
        ours, theirs = TG._first_stop_mask(ids, start, stops), JG._first_stop_mask(ids, start, stops)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert TG._first_stop_mask(np.array([[5, 6, 7, 99, 8, 9]]), np.array([1]), (99,)).tolist() == [[0, 1, 1, 1, 0, 0]]


# ---------------------------------------------------------------------------
# trainers, built once per configuration
# ---------------------------------------------------------------------------

def _fields(kind):
    img = dict(question_id="1", image_name="a.png", category="c", question="what?", higher_level="p",
               ground_truth="car", bbox=[10, 10, 40, 40], type="object")
    glob = dict(question_id="2", image_name="b.png", category="c", question="count?", higher_level="p",
                ground_truth="3", bbox=[], type="global")
    txt = dict(question_id="3", image_name="", category="m", question="1+2?", higher_level="r", ground_truth="3",
               bbox=[], type="global", image_path=None)
    txt2 = dict(txt, question_id="4", question="2*3?", ground_truth="6")
    return {"img": [img, glob], "text": [txt, txt2], "mixed": [img, txt]}[kind]


def _samples(kind):
    f = _fields(kind)
    return [LRSGROSample(**x) for x in f], [JSample(**x) for x in f]


def _loader():
    """Seeded 600 x 600 tiles, one per image name (the same for both packages)."""
    imgs = {}

    def load(s):
        if s.image_name not in imgs:
            rng = np.random.default_rng(3 + len(imgs))
            imgs[s.image_name] = Image.fromarray(rng.integers(0, 255, (600, 600, 3), dtype=np.uint8))
        return imgs[s.image_name]

    return load


def _row_reward(c1, c2, **kw):
    """A reward by row and completion length: non-zero advantages under greedy rollouts."""
    return [0.5 * (i % 2) + float(len(a) % 7) / 7.0 for i, a in enumerate(c1)]


REWARD_NAMES = ["iou", "format", "answer"]


def _reward_funcs(registry):
    return registry.get_reward_funcs(REWARD_NAMES) + [_row_reward]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(jax.random.key(0), JCFG)


def _port_trainer(jparams, **grpo_kw):
    return TG.GRPOTrainer(params_from_numpy(jax.tree.map(np.asarray, jparams)), CFG,
                          TG.GRPOConfig(**{**GRPO_KW, **grpo_kw}),
                          Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=MAX_PIXELS), _reward_funcs(TREG),
                          reward_names=REWARD_NAMES + ["row"], image_loader=_loader(), device="cpu", **TRAINER_KW)


def _make_trainers(jparams, **grpo_kw):
    """(port trainer, JAX trainer) over the same parameters and rewards."""
    kw = {**GRPO_KW, **grpo_kw}
    names = REWARD_NAMES + ["row"]
    # the JAX trainer's update donates its parameters: give it its own copy
    jt = JG.GRPOTrainer(jax.tree.map(jnp.copy, jparams), JCFG, JG.GRPOConfig(**kw), JProcessor(JFakeTokenizer(JCFG.tokens), JCFG,
                        max_pixels=MAX_PIXELS), _reward_funcs(JREG), reward_names=names, image_loader=_loader(),
                        **TRAINER_KW)
    tt = _port_trainer(jparams, **grpo_kw)
    if kw.get("use_lora"):
        # carry the JAX package's adapters across (jax.random draws other numbers)
        tt.load_state(params_from_numpy(jax.tree.map(np.asarray, jt.params)), None)
    return tt, jt


@pytest.fixture(scope="module")
def rollout_pair(jparams):
    """One pair of trainers for every rollout case (the rollout reads its config at
    call time, as the JAX package's tests use it)."""
    return _make_trainers(jparams)


def _assert_rollouts_equal(trb, jrb):
    for k in ("input_ids", "completion_mask", "position_ids", "pixel_values", "advantages", "rewards_per_func"):
        a, b = getattr(trb, k), getattr(jrb, k)
        if b is None:
            assert a is None, k
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
    assert (trb.vision_meta is None) == (jrb.vision_meta is None)
    if jrb.vision_meta is not None:
        assert trb.vision_meta.keys() == jrb.vision_meta.keys()
        assert all(np.array_equal(trb.vision_meta[k], jrb.vision_meta[k]) for k in jrb.vision_meta)
    assert trb.completions1 == jrb.completions1 and trb.completions2 == jrb.completions2
    for k in ("ref_logps", "old_logps"):
        a, b = getattr(trb, k), getattr(jrb, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind,reuse_cache,scale_rewards", [
    ("img", True, False), ("img", False, True), ("text", True, True), ("text", False, False),
    ("mixed", True, False), ("mixed", False, True),
])
def test_greedy_rollouts_equal_reference(rollout_pair, kind, reuse_cache, scale_rewards):
    tt, jt = rollout_pair
    for t in (tt, jt):
        t.grpo = dataclasses.replace(t.grpo, reuse_cache=reuse_cache, scale_rewards=scale_rewards)
    ts, js = _samples(kind)
    trb, jrb = tt.rollout(ts, seed=1), jt.rollout(js, seed=1)
    _assert_rollouts_equal(trb, jrb)
    G = tt.grpo.num_generations
    if kind != "text":
        assert all(c != "" for c in trb.completions2[:G])  # the bbox sample took stage 2
    assert all(c == "" for c in trb.completions2[G:])
    assert (trb.pixel_values is None) == (kind == "text")
    assert np.abs(trb.advantages).max() > 0 and trb.completion_mask.sum() > 0


def test_engine_backed_rollout_equals_reference(rollout_pair):
    """Through a ServingEngine of 2 slots for 4 rows (queueing and backfill): the
    same batch as the JAX trainer's engine rollout; the engine is stopped again
    and holds no slot afterwards."""
    tt, jt = rollout_pair
    kw = dict(max_slots=2, max_seq_len=512, decode_chunk=2, cache_dtype="float32", length_buckets=(256, 384),
              patch_buckets=(0, 64, 128))
    engines = [TE.ServingEngine(tt.params, CFG, **kw), JE.ServingEngine(jt.params, JCFG, **kw)]
    for t, eng in zip((tt, jt), engines):
        eng.admission_debounce_s = 0.0
        t.rollout_engine = eng
        t.grpo = dataclasses.replace(t.grpo, reuse_cache=True, scale_rewards=False)
    try:
        ts, js = _samples("img")
        trb, jrb = tt.rollout(ts, seed=1), jt.rollout(js, seed=1)
    finally:
        tt.rollout_engine = jt.rollout_engine = None
    _assert_rollouts_equal(trb, jrb)
    assert all(c != "" for c in trb.completions2[:2]) and all(c == "" for c in trb.completions2[2:])
    eng = engines[0]
    assert not eng._running and not eng.held and not eng.results
    assert eng.stats.get("errors", 0) == 0 and eng.stats.get("pump_errors", 0) == 0


# ---------------------------------------------------------------------------
# per_token_logps and the loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_case(jparams):
    """A SAMPLED mixed rollout batch (images and text) from the port, so that the G
    rows of a group differ (greedy rows would be equal, and their mean-centered
    advantages would cancel in the gradient), with old logps that differ from the
    policy's by enough to clip."""
    rb = _port_trainer(jparams, rollout_temperature=1.0).rollout(_samples("mixed")[0], seed=2)
    rng = np.random.default_rng(0)
    old = (rb.ref_logps + rng.normal(0, 0.3, rb.ref_logps.shape)).astype(np.float32)
    return rb, old


def _jax_batch(rb, old=None, ref=None):
    return dict(
        input_ids=jnp.asarray(rb.input_ids), completion_mask=jnp.asarray(rb.completion_mask),
        position_ids=jnp.asarray(rb.position_ids),
        pixel_values=jnp.asarray(rb.pixel_values) if rb.pixel_values is not None else None,
        vision_meta={k: jnp.asarray(v) for k, v in rb.vision_meta.items()} if rb.vision_meta else None,
        advantages=jnp.asarray(rb.advantages),
        old_logps=jnp.asarray(old) if old is not None else None,
        ref_logps=jnp.asarray(ref) if ref is not None else None,
    )


def test_per_token_logps_equal_reference_and_chunk_invariant(jparams, loss_case):
    jrb, _ = loss_case
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    batch = TG.batch_to_device(jrb, "cpu")
    ours = {c: TG.per_token_logps(params, CFG, batch["input_ids"], batch["position_ids"], batch["pixel_values"],
                                  batch["vision_meta"], chunk=c) for c in (4, 16, 256)}
    jb = _jax_batch(jrb)
    theirs = JG.per_token_logps(jparams, JCFG, jb["input_ids"], jb["position_ids"], jb["pixel_values"],
                                jb["vision_meta"])
    np.testing.assert_allclose(ours[256].numpy(), np.asarray(theirs), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours[4].numpy(), ours[16].numpy(), atol=ATOL, rtol=0)
    assert ours[4].dtype == torch.float32 and (ours[4][:, 0] == 0).all()
    # the rollout's reference logps are this function of the same parameters
    np.testing.assert_allclose(ours[256].numpy(), jrb.ref_logps, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_old,with_ref", [(False, False), (False, True), (True, False), (True, True)])
def test_grpo_loss_metrics_and_every_gradient_leaf_equal_reference(jparams, loss_case, with_old, with_ref):
    jrb, old = loss_case
    old = old if with_old else None
    ref = jrb.ref_logps if with_ref else None
    kw = dict(beta=0.04, epsilon_low=0.2, epsilon_high=0.28)
    (jloss, jaux), jgrads = jax.value_and_grad(JG.grpo_loss, has_aux=True)(jparams, JCFG, _jax_batch(jrb, old, ref),
                                                                            **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    rb = dataclasses.replace(jrb, old_logps=old, ref_logps=ref)
    loss, aux = TG.grpo_loss(params, CFG, TG.batch_to_device(rb, "cpu"), **kw)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=0)
    assert aux.keys() == jaux.keys() and ("kl" in aux) == with_ref
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=ATOL, rtol=0, err_msg=k)
    if with_old:
        assert float(aux["clip_ratio"]) > 0
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (a, b) in enumerate(zip(grads, jleaves)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f"gradient leaf {i}")
    assert max(float(g.abs().max()) for g in grads) > 1e-3  # the advantages drive a real gradient


# ---------------------------------------------------------------------------
# steps against the JAX trainer
# ---------------------------------------------------------------------------

STEP_CONFIGS = {
    "default": {},
    "num_iterations_2": {"num_iterations": 2},
    "freeze_vision": {"freeze_vision_modules": True},
    "tr_dpo": {"sync_ref_model": True, "ref_model_sync_steps": 1, "ref_model_mixup_alpha": 0.5},
    "lora": {"use_lora": True, "lora_r": 4, "lora_alpha": 8.0},
}


def _jax_rollout_of(tt, jt, samples, seed=0):
    """The JAX trainer's rollout replaced by the port's sampled one of this step (the
    two packages draw other tokens from one seed), with the old and reference logps
    computed again by the JAX trainer from its own policy and reference."""
    rb = tt._buffered
    jb = _jax_batch(rb)
    args = (JCFG, jb["input_ids"], jb["position_ids"], jb["pixel_values"], jb["vision_meta"])
    fields = {f.name: getattr(rb, f.name) for f in dataclasses.fields(rb)}
    fields["old_logps"] = np.asarray(jt._logps_fn(jt.params, *args)) if jt.grpo.num_iterations > 1 else None
    fields["ref_logps"] = np.asarray(jt._logps_fn(jt.ref_params, *args)) if jt.grpo.beta > 0 else None
    return JG.RolloutBatch(**fields)


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_two_steps_equal_reference(jparams, name):
    """Two steps on the mixed batch (seeds 0 and 1), sampled: the JAX trainer steps
    on the port's rollouts and takes its own old and reference logps, which must equal
    the port's to 5e-5, as must every step's metrics and the parameters after each;
    per configuration what must hold besides (frozen vision leaves and LoRA bases bit
    for bit, the LoRA KL, the reference policy after TR-DPO's mixup)."""
    tt, jt = _make_trainers(jparams, rollout_temperature=1.0, **STEP_CONFIGS[name])
    jt.rollout = partial(_jax_rollout_of, tt, jt)
    ts, js = _samples("mixed")
    before = [t.detach().clone() for t in tree_leaves(tt.params)]
    norms, frozen_norms = [], []

    def on_grads(grads):
        norms.append(float(TS.global_norm(grads)))
        frozen = [g for g, m in zip(grads, tt.optimizer.moving) if not m]
        frozen_norms.append(float(TS.global_norm(frozen)) if frozen else 0.0)

    tt.on_grads = on_grads
    for step in range(2):
        tm, jm = tt.step(ts, seed=step), jt.step(js, seed=step)
        _assert_rollouts_equal(tt._buffered, jt._buffered)
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(tm[k], jm[k], atol=ATOL, rtol=0, err_msg=f"step {step} {k}")
        jleaves = jax.tree.leaves(jt.params)
        for i, (a, b) in enumerate(zip(tree_leaves(tt.params), jleaves)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                       err_msg=f"step {step} parameter leaf {i}")
    after = tree_leaves(tt.params)
    moved = [not torch.equal(a, b) for a, b in zip(after, before)]
    assert all(n > 0 for n in norms)
    if name == "num_iterations_2":
        assert tt._buffered is not None and tt._step_count == 2
    if name == "freeze_vision":
        vis = {id(t) for t in tree_leaves(tt.params["vision"])}
        assert all(m != (id(t) in vis) for t, m in zip(after, moved))  # vision bit for bit, the rest moved
    elif name == "lora":
        lo = tt.params["text"]["layers"][0]["attn"]["wq"]
        assert TLORA.is_lora(lo) and lo["a"].shape == (CFG.text.hidden_size, 4)
        frozen = {id(t) for t in TLORA.frozen_leaves(tt.params)}
        for t, b, m in zip(after, before, moved):
            if id(t) in frozen:
                assert torch.equal(t, b)  # every base w and s bit for bit
        adapted = [w for layer in tt.params["text"]["layers"] for grp in ("attn", "mlp")
                   for w in layer[grp].values() if TLORA.is_lora(w)]
        assert len(adapted) == len(TLORA.DEFAULT_TARGETS) * CFG.text.num_hidden_layers
        assert all(w["b"].abs().max() > 0 for w in adapted)  # every adapter moved off its zero start
        assert abs(tt.metrics_history[0]["kl"]) < 1e-4
        # the frozen bases get gradients, which the clip's norm counts (test_clip_norm_covers_frozen_leaves)
        assert min(frozen_norms) > 0 and tt.ref_params["text"]["layers"][0]["attn"]["wq"] is lo["w"]
        merged = TLORA.merge_lora(tt.params)["text"]["layers"][0]["attn"]["wq"]
        jmerged = JLORA.merge_lora(jt.params)["text"]["layers"][0]["attn"]["wq"]
        np.testing.assert_allclose(merged.detach().numpy(), np.asarray(jmerged), atol=ATOL, rtol=0)
    else:
        assert all(moved)
    if name == "tr_dpo":
        for a, b in zip(tree_leaves(tt.ref_params), jax.tree.leaves(jt.ref_params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["freeze_vision", "lora"])
def test_clip_norm_covers_frozen_leaves(jparams, name):
    """The optimizer's global norm is taken over every gradient, frozen ones included
    (optax's clip runs before the update mask): scaling only the frozen leaves'
    gradients changes how far the moving leaves step."""
    moved = []
    for scale in (1.0, 1e9):
        tt = _port_trainer(jparams, **STEP_CONFIGS[name])
        frozen = {id(t) for t in (tree_leaves(tt.params["vision"]) if name == "freeze_vision"
                                  else TLORA.frozen_leaves(tt.params))}
        before = [t.detach().clone() for t in tree_leaves(tt.params)]
        grads = [torch.full_like(t, 1e-3) * (scale if id(t) in frozen else 1.0) for t in tree_leaves(tt.params)]
        tt.optimizer.step(grads)
        after = tree_leaves(tt.params)
        assert all(torch.equal(a, b) for a, b in zip(after, before) if id(a) in frozen)
        moved.append([(a.detach() - b).abs().max().item() for a, b in zip(after, before)
                      if id(a) not in frozen and a.dim() > 1])
    # AdamW's first step is lr * g / (|g| + eps): clipped by the frozen leaves' huge norm, the moving
    # leaves' gradients drop to ~1e-12, below eps, and they barely move
    assert min(moved[0]) > 0.5 * GRPO_KW["learning_rate"] and max(moved[1]) < 0.01 * GRPO_KW["learning_rate"]


def test_rollout_step_rollout_step_alternates_without_inference_tensors(jparams):
    """Generation under inference_mode, then autograd over the same parameters, twice,
    through the Generator and through an engine: no inference tensor reaches the
    policy step, the parameters stay trainable leaves, and a sampled run is
    reproducible within the port."""
    runs = []
    for _ in range(2):
        tt = _port_trainer(jparams, rollout_temperature=0.9)
        eng = TE.ServingEngine(tt.params, CFG, max_slots=2, max_seq_len=512, decode_chunk=2, cache_dtype="float32",
                               length_buckets=(256, 384), patch_buckets=(0, 64, 128))
        eng.admission_debounce_s = 0.0
        ts, _ = _samples("mixed")
        ms = []
        for step in range(4):
            tt.rollout_engine = eng if step >= 2 else None
            ms.append(tt.step(ts, seed=step))
            assert all(t.requires_grad and not t.is_inference() for t in tree_leaves(tt.params) if t.is_floating_point())
        assert all(np.isfinite(m["loss"]) for m in ms)
        runs.append((ms[:2], [t.detach().clone() for t in tree_leaves(tt.params)]))
    assert runs[0][0] == runs[1][0]


def test_lora_tree_and_optimizer_state_round_trip_through_a_checkpoint(jparams, tmp_path):
    """A LoRA trainer's tree (dict leaves with a 0-d s) and its optimizer's state through
    CheckpointManager in the reference's layout: a trainer resumed from the step-1
    checkpoint takes step 2 to the same metrics and bits as the one that never stopped."""
    kw = dict(STEP_CONFIGS["lora"], rollout_temperature=1.0)
    ts, _ = _samples("mixed")
    a = _port_trainer(jparams, **kw)
    a.step(ts, seed=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, a.params, a.state_dict(), extra={"epoch": 0})
    assert sorted(p.name for p in (tmp_path / "checkpoint-1").iterdir()) == ["meta.json", "opt_state.pt", "params.pt"]
    b = _port_trainer(jparams, **kw)
    params, opt_state, meta = mgr.restore(1, b.params)
    assert meta["step"] == 1 and TLORA.is_lora(params["text"]["layers"][0]["mlp"]["wd"])
    b.load_state(params, opt_state)
    assert a.step(ts, seed=1) == b.step(ts, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


def test_log_completions_lines_equal_reference(jparams, tmp_path):
    tt, jt = _make_trainers(jparams)
    for t, name in ((tt, "ours"), (jt, "theirs")):
        t.grpo = dataclasses.replace(t.grpo, log_completions=True, completions_path=str(tmp_path / f"{name}.jsonl"))
    tt.step(_samples("img")[0], seed=3)
    jt.step(_samples("img")[1], seed=3)
    ours = [json.loads(line) for line in (tmp_path / "ours.jsonl").read_text().splitlines()]
    theirs = [json.loads(line) for line in (tmp_path / "theirs.jsonl").read_text().splitlines()]
    assert len(ours) == 2 * GRPO_KW["num_generations"] and ours == theirs


def test_lora_wrapping_strip_and_frozen_leaves():
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(jax.random.key(1), JCFG)))
    g = torch.Generator().manual_seed(0)
    lp = TLORA.apply_lora(params, g, r=4, alpha=8.0)
    wq = lp["text"]["layers"][0]["attn"]["wq"]
    assert TLORA.is_lora(wq) and wq["w"] is params["text"]["layers"][0]["attn"]["wq"]
    assert wq["s"].dim() == 0 and float(wq["s"]) == 2.0 and not wq["b"].any()
    assert lp["vision"] is params["vision"] and "bq" in lp["text"]["layers"][0]["attn"]
    again = TLORA.apply_lora(lp, torch.Generator().manual_seed(1), r=4)
    assert again["text"]["layers"][0]["attn"]["wq"] is wq  # an adapted leaf is skipped
    stripped = TLORA.strip_lora(lp)
    assert all(a is b for a, b in zip(tree_leaves(stripped), tree_leaves(params)))
    n_targets = len(TLORA.DEFAULT_TARGETS) * CFG.text.num_hidden_layers
    assert len(TLORA.frozen_leaves(lp)) == 2 * n_targets
    assert len(tree_leaves(lp)) == len(tree_leaves(params)) + 3 * n_targets


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_CLI_BASE = ["--model_name_or_path", "m", "--data_file_paths", "d.jsonl", "--image_folders", "i", "--device", "cpu"]


@pytest.mark.parametrize("extra,env", [(["--num_processes", "2"], None),
                                       (["--coordinator_address", "localhost:1234", "--num_processes", "2",
                                         "--process_id", "0"], None), ([], "2")])
def test_cli_refuses_multi_process_launches(monkeypatch, extra, env):
    """A multi-process launch (--num_processes with torchrun's RANK and MASTER_ADDR, the
    JAX CLI's three flags, or WORLD_SIZE) joins the process group as the JAX CLI does:
    it reaches the rendezvous with the arguments it gave, over gloo for --device cpu,
    before anything is loaded (the two-process run is tests/test_torch_parallel_procs.py)."""
    backend, init_method, world, rank = W.reach_rendezvous(monkeypatch, CLI, _CLI_BASE + extra, env)
    address = "localhost:1234" if "--coordinator_address" in extra else "127.0.0.1:29512"
    assert (backend, init_method, world, rank) == ("gloo", f"tcp://{address}", 2, 0 if "--process_id" in extra else 1)


def test_cli_trains_two_steps_and_resumes_bit_for_bit(jparams, tmp_path, monkeypatch):
    """python -m zoomearth_tpu_torch.cli.train_grpo --device cpu over the JAX
    package's tiny HF export: two steps with a checkpoint each; then a run resumed from
    the step-1 checkpoint, whose step-2 metrics and parameters equal the uninterrupted
    run's bit for bit."""
    hf = tmp_path / "hf"
    jax_save_hf(jparams, JCFG, str(hf))
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rows = []
    for i, f in enumerate(_fields("img")):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (300, 280, 3), dtype=np.uint8)).save(
            imgs / f["image_name"])
        rows.append({k: f[k] for k in ("question_id", "image_name", "category", "question", "higher_level",
                                       "ground_truth", "bbox", "type")})
    data = tmp_path / "rl.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    seen = []

    def load(path, *, device=None, **kw):
        seen.append((path, device))
        return (load_hf_checkpoint(path, CFG, device=device, dtype="float32"), CFG,
                Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=MAX_PIXELS))

    monkeypatch.setattr(CLI, "load_model_and_processor", load)

    def run(out, *extra):
        CLI.main(["--model_name_or_path", str(hf), "--data_file_paths", str(data), "--image_folders", str(imgs),
                  "--output_dir", str(out), "--per_device_train_batch_size", "1", "--num_generations", "2",
                  "--max_completion_length", "6", "--learning_rate", "1e-4", "--num_train_epochs", "1",
                  "--save_steps", "1", "--log_completions", "--device", "cpu", *extra])
        return [json.loads(line) for line in open(out / "metrics.jsonl")]

    full = run(tmp_path / "full")
    assert [r["step"] for r in full] == [1, 2] and all(np.isfinite(r["loss"]) for r in full)
    assert seen == [(str(hf), "cpu")] and CheckpointManager(str(tmp_path / "full")).latest() == 2
    assert len((tmp_path / "full" / "completions.jsonl").read_text().splitlines()) == 4
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    import shutil

    shutil.copytree(tmp_path / "full" / "checkpoint-1", resumed / "checkpoint-1")
    again = run(resumed, "--resume_from_checkpoint")
    assert [r["step"] for r in again] == [2] and again[0] == full[1]
    saved = [torch.load(d / "checkpoint-2" / "params.pt", weights_only=True) for d in (tmp_path / "full", resumed)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(saved[0]), tree_leaves(saved[1])))
    opt = [torch.load(d / "checkpoint-2" / "opt_state.pt", weights_only=True) for d in (tmp_path / "full", resumed)]
    states = [o["adamw"]["state"] for o in opt]
    assert states[0].keys() == states[1].keys()
    assert all(torch.equal(states[0][k][m], states[1][k][m]) for k in states[0] for m in states[0][k])
