"""The port's inference slice against the JAX package on the CPU: Generator
(generate / continue_generate, run_decode_pair, the int8 KV cache), run_episodes in
both stage-2 modes, run_episodes_pipelined, run_inference's jsonl in both modes and
the cli.infer / cli.eval entry points.

Greedy decoding must be token-identical: both packages get the JAX package's tiny
random parameters (fp32) and the same host-prepared batches.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent import episode as JE
from zoomearth_tpu.agent import prompts as PT
from zoomearth_tpu.agent.processor import Processor
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.eval import infer as JI
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.runtime import generate as JG
from zoomearth_tpu.tokenizer import FakeTokenizer
from zoomearth_tpu.train.data import LRSGROSample
from zoomearth_tpu_torch.agent import episode as TE
from zoomearth_tpu_torch.agent import prompts as TPT
from zoomearth_tpu_torch.eval import infer as TI
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.runtime import generate as TG

torch.set_num_threads(1)
CFG = VLMConfig.tiny()
GREEDY = TG.GenerationConfig(max_new_tokens=8, temperature=0.0)


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _gens(params, max_cache_len=256, cache_dtype="float32", **kw):
    jp, tp = params
    return (JG.Generator(jp, CFG, max_cache_len=max_cache_len, cache_dtype=cache_dtype, **kw),
            TG.Generator(tp, CFG, max_cache_len=max_cache_len, cache_dtype=cache_dtype, **kw))


def _image(grid, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((grid[0] * grid[1] * grid[2], CFG.vision.patch_dim)).astype(np.float32), grid


def _stage1(seed, grid=(1, 4, 4), n_text=4):
    rng = np.random.default_rng(seed)
    tok = CFG.tokens
    pv, g = _image(grid, seed)
    n = (g[0] * g[1] * g[2]) // CFG.vision.merge_unit
    ids = ([tok.im_start] + list(rng.integers(1, 400, size=5)) + [tok.vision_start]
           + [tok.image_pad] * n + [tok.vision_end] + list(rng.integers(1, 400, size=n_text)))
    return [int(i) for i in ids], [(pv, g)]


def _vision_chunk(grid, seed):
    tok = CFG.tokens
    pv, g = _image(grid, seed)
    n = (g[0] * g[1] * g[2]) // CFG.vision.merge_unit
    return [tok.vision_start] + [tok.image_pad] * n + [tok.vision_end], [(pv, g)]


def test_generate_greedy_batched_mixed_lengths(params):
    jg, tg = _gens(params)
    seqs = [_stage1(1), _stage1(2, grid=(1, 2, 6), n_text=11), _stage1(3, grid=(1, 4, 6), n_text=1)]
    b = TG.prepare_batch(CFG, [s[0] for s in seqs], [s[1] for s in seqs],
                         length_buckets=(64,), patch_buckets=(64,))
    ref = jg.generate(b, GREEDY)
    out = tg.generate(b, GREEDY)
    assert out == ref
    assert all(len(r) > 0 for r in out)


def test_continue_generate_mixed_keep(params):
    jg, tg = _gens(params)
    s1 = [_stage1(21), _stage1(22, grid=(1, 2, 6))]
    b1 = TG.prepare_batch(CFG, [s[0] for s in s1], [s[1] for s in s1],
                          length_buckets=(64,), patch_buckets=(64,))
    ref1, jcache = jg.generate(b1, GREEDY, return_cache=True)
    out1, tcache = tg.generate(b1, GREEDY, return_cache=True)
    assert out1 == ref1
    keeps = [out1[0][:3], out1[1]]
    chunks = [_vision_chunk((1, 2, 4), 23), _vision_chunk((1, 4, 4), 24)]
    keep_len = np.asarray([len(s1[i][0]) + len(keeps[i]) for i in range(2)], np.int32)
    starts = [int(b1.next_pos[i]) + len(keeps[i]) for i in range(2)]
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks], starts,
                                 length_buckets=(32,), patch_buckets=(64,))
    ref2 = jg.continue_generate(jcache, bc, keep_len, GREEDY)
    out2 = tg.continue_generate(tcache, bc, keep_len, GREEDY)
    assert out2 == ref2


def test_chunk_prefill_grows_prefix_holder(params):
    """A [system + image] prefix cache from a small generator, chunk-prefilled with
    each wave's text and grown to the full size (grow_to): tokens equal the JAX
    package's, and the holder survives for the next wave."""
    jg, tg = _gens(params, max_cache_len=256)
    jg_pfx, tg_pfx = _gens(params, max_cache_len=32)
    tok = CFG.tokens
    rng = np.random.default_rng(77)
    pv, grid = _image((1, 4, 4), 77)
    prefix = [tok.im_start, 5, 6, 7, tok.vision_start] + [tok.image_pad] * 4 + [tok.vision_end]
    pb = TG.prepare_batch(CFG, [prefix, prefix], [[(pv, grid)], [(pv, grid)]],
                          length_buckets=(32,), patch_buckets=(32,))
    _, jholder, _ = jg_pfx.run_prefill(pb, max_new=0)
    _, tholder, _ = tg_pfx.run_prefill(pb, max_new=0)
    keep = np.asarray(pb.lengths, np.int32)
    for wave in range(2):
        texts = [[int(i) for i in rng.integers(1, 300, size=5 + 4 * r + wave)] for r in range(2)]
        bc = TG.prepare_continuation(CFG, texts, [[], []], np.asarray(pb.next_pos), length_buckets=(32,))
        refs = []
        for g, holder in ((jg, jholder), (tg, tholder)):
            logits, cache, attend = g.run_chunk_prefill(holder, bc, keep, max_new=8, grow_to=g.max_cache_len)
            toks, _ = g.run_decode(logits, cache, bc.next_pos, GREEDY, attend=attend)
            refs.append(g.trim_generated(np.asarray(toks)))
        assert cache.max_len == 256 and tholder.max_len == 32
        assert refs[1] == refs[0]


def test_prefix_holder_survives_grow_to_chunk_prefill(params):
    """A holder whose allocation already equals grow_to is never written: the chunk
    goes into a copy, so a second wave reuses it (the reference never donates it)."""
    _, tg = _gens(params, max_cache_len=64)
    rng = np.random.default_rng(3)
    pfx = [CFG.tokens.im_start] + [int(i) for i in rng.integers(1, 300, size=6)]
    pb = TG.prepare_batch(CFG, [pfx], [[]], length_buckets=(16,), patch_buckets=(0,))
    _, holder, _ = tg.run_prefill(pb, max_new=0)
    assert holder.max_len == tg.max_cache_len
    snapshot = [t.clone() for t in holder.k + holder.v]
    keep = np.asarray(pb.lengths, np.int32)
    chunk = TG.prepare_continuation(CFG, [[int(i) for i in rng.integers(1, 300, size=4)]], [[]],
                                    np.asarray(pb.next_pos), length_buckets=(16,))
    outs = []
    for _ in range(2):
        logits, cache, attend = tg.run_chunk_prefill(holder, chunk, keep, max_new=4,
                                                     grow_to=tg.max_cache_len)
        assert cache is not holder
        toks, _ = tg.run_decode(logits, cache, chunk.next_pos, TG.GenerationConfig(max_new_tokens=4),
                                attend=attend)
        outs.append(tg.trim_generated(toks.numpy()))
    assert outs[0] == outs[1]
    assert all(torch.equal(a, b) for a, b in zip(snapshot, holder.k + holder.v))


def test_attend_bucket_takes_any_span():
    assert TG.Generator._attend_bucket(700, 4096) == 768
    assert TG.Generator._attend_bucket(1100, 4096) == 1280
    assert TG.Generator._attend_bucket(5000, 4096) is None


# ---------------------------------------------------------------------------
# Episodes, run_inference, CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def episode_env(monkeypatch):
    """Short stage-1 template (the byte-level FakeTokenizer makes the verbatim
    instruction ~2300 tokens) and a forced bbox (random weights emit none)."""
    for prompts in (PT, TPT):  # the JAX package's prompts and the port's own copy
        monkeypatch.setattr(prompts, "stage1_prompt",
                            lambda q: PT.PREFIX + q + "\nAnswer.<|im_end|><|im_start|>assistant\n")
    box = lambda text, scale=1.0: [[100, 100, 260, 220]]  # noqa: E731
    monkeypatch.setattr(JE, "extract_bboxes", box)
    monkeypatch.setattr(TE, "extract_bboxes", box)
    return Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)


def _tiles(n, seed=0, size=600):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("reuse_cache", [False, True])
def test_run_episodes_records_match_jax(params, episode_env, reuse_cache):
    jg, tg = _gens(params, max_cache_len=512)
    qs, imgs = ["what is here?", "how many ships?"], _tiles(2, seed=4)
    gen = TG.GenerationConfig(max_new_tokens=6, temperature=0.0)
    ref = JE.run_episodes(jg, episode_env, qs, imgs, gen=JG.GenerationConfig(max_new_tokens=6),
                          reuse_cache=reuse_cache)
    out = TE.run_episodes(tg, episode_env, qs, imgs, gen=gen, reuse_cache=reuse_cache)
    assert [r.__dict__ for r in out] == [r.__dict__ for r in ref]
    assert all(not r.error for r in out)  # the forced bbox took every row to stage 2


def _samples(n):
    return [LRSGROSample(question_id=str(i), image_name=f"t{i % 3}.png", category="cat",
                         question=f"what is at site {i}?", higher_level="perception",
                         ground_truth="car", bbox=[10, 10, 40, 40], type="object",
                         image_path=f"t{i % 3}.png") for i in range(n)]


def test_run_inference_jsonl_matches_jax(params, episode_env, tmp_path):
    jg, tg = _gens(params, max_cache_len=512)
    tiles = dict(zip([f"t{i}.png" for i in range(3)], _tiles(3, seed=5)))
    loader = lambda s: tiles[s.image_name]  # noqa: E731
    gen = TG.GenerationConfig(max_new_tokens=5, temperature=0.0)
    samples = _samples(5)
    jp = JI.run_inference(jg, episode_env, samples, str(tmp_path / "jax.jsonl"), batch_size=2,
                          gen=JG.GenerationConfig(max_new_tokens=5), image_loader=loader)
    tp = TI.run_inference(tg, episode_env, samples, str(tmp_path / "torch.jsonl"), batch_size=2,
                          gen=gen, image_loader=loader)
    ref = [json.loads(line) for line in open(jp)]
    out = [json.loads(line) for line in open(tp)]
    assert len(out) == 5
    for a, b in zip(out, ref):
        assert a.pop("model_id") == TI.DEFAULT_MODEL_ID
        b.pop("model_id")
        assert a == b
    # mode="pipelined" is ported: a batch size no shard fills runs the sequential reuse tail alone
    pp = TI.run_inference(tg, episode_env, samples[:1], str(tmp_path / "p.jsonl"), batch_size=2, gen=gen,
                          image_loader=loader, mode="pipelined")
    assert [json.loads(line)["question_id"] for line in open(pp)] == ["0"]


def test_cli_infer_main_with_stubbed_loader(params, episode_env, tmp_path, monkeypatch):
    from zoomearth_tpu_torch.cli import infer as cli_infer

    _, tp = params
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, t in enumerate(_tiles(3, seed=6, size=300)):
        t.save(img_dir / f"t{i}.png")
    data = tmp_path / "test.jsonl"
    with open(data, "w") as f:
        for s in _samples(4):
            f.write(json.dumps({"question_id": s.question_id, "image_name": s.image_name,
                                "question": s.question, "ground_truth": "car", "type": "object",
                                "bbox": s.bbox, "category": "cat"}) + "\n")
    calls = []

    def fake_loader(path, max_pixels=None, **kw):
        calls.append((path, max_pixels))
        return tp, CFG, episode_env

    monkeypatch.setattr(cli_infer, "load_model_and_processor", fake_loader)
    cli_infer.main(["--model_name", "stub", "--exp_name", "smoke", "--data_file", str(data),
                    "--image_folder", str(img_dir), "--out_dir", str(tmp_path / "res"),
                    "--batch_size", "2", "--max_new_tokens", "3", "--temperature", "0"])
    recs = [json.loads(line) for line in open(tmp_path / "res" / "smoke0.jsonl")]
    assert calls == [("stub", 128 * 128 * 28 * 28)]
    assert sorted(r["question_id"] for r in recs) == ["0", "1", "2", "3"]
    assert all(r["model_id"] == "smoke---LRS-GRO" and r["error"] is False for r in recs)


def test_cli_device_defaults_to_cuda_and_never_moves_to_the_cpu(tmp_path, monkeypatch):
    """`--device` defaults to cuda in both CLIs; without a CUDA device the loader raises
    unless the caller asks for the CPU, which is what a test passes."""
    from zoomearth_tpu_torch.cli import common as cli_common
    from zoomearth_tpu_torch.cli import demo as cli_demo
    from zoomearth_tpu_torch.cli import infer as cli_infer

    args = cli_infer.build_parser().parse_args(["--model_name", "m", "--exp_name", "e", "--data_file", "d",
                                                "--image_folder", "i"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_common.resolve_device("cpu") == torch.device("cpu")
    for device in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_common.resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # before it looks at the checkpoint
        cli_common.load_model_and_processor(str(tmp_path))
    with pytest.raises(SystemExit, match="not a directory"):  # the CPU asked for: goes on to the checkpoint
        cli_common.load_model_and_processor(str(tmp_path / "missing"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli_common.resolve_device(None) == torch.device("cuda")

    seen = []

    def fake_loader(path, **kw):
        seen.append(kw.get("device"))
        raise KeyboardInterrupt  # stop the CLI once the device it asked for is known

    for mod, argv in ((cli_infer, ["--model_name", "m", "--exp_name", "e", "--data_file", "d", "--image_folder", "i"]),
                      (cli_demo, ["--model", "m", "--image", "x.png"])):
        monkeypatch.setattr(mod, "load_model_and_processor", fake_loader)
        for extra in ([], ["--device", "cpu"]):
            with pytest.raises(KeyboardInterrupt):
                mod.main(argv + extra)
    assert seen == ["cuda", "cpu", "cuda", "cpu"]


# ---------------------------------------------------------------------------
# Pair decode, block=False, one length tensor, the int8 cache
# ---------------------------------------------------------------------------

def _ties_only(jg, prompts, outs, refs, bound, buckets=((64,), (64,))):
    """Greedy rows that differ must differ by a TIE: where row r first departs from
    the JAX package's tokens (step t), the JAX package's own logits for
    prompt + its tokens[:t] (a fresh prefill through the same Generator) must hold the
    port's token within `bound` of the one it chose itself. prompts[r] = (ids, images).
    Returns the number of rows that differed."""
    stops = (CFG.tokens.eos, CFG.tokens.endoftext)
    tied = 0
    for (ids, imgs), out, ref in zip(prompts, outs, refs):
        if out == ref:
            continue
        t = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b), min(len(out), len(ref)))
        b = JG.prepare_batch(CFG, [list(ids) + list(ref[:t])], [imgs], length_buckets=buckets[0],
                             patch_buckets=buckets[1])
        logits = np.asarray(jg.run_prefill(b)[0])[0]
        ours = logits[out[t]] if t < len(out) else max(logits[s] for s in stops)
        theirs = logits[ref[t]] if t < len(ref) else max(logits[s] for s in stops)
        assert theirs - ours < bound, (t, float(theirs - ours))
        tied += 1
    return tied


INT8_LOGITS_ATOL = 1e-2  # the size of the int8 quantization's own effect on these logits (max |logit| ~0.5)


def _rows(seeds):
    """[(ids, images)] of the seeded stage-1 prompts, of unequal lengths."""
    return [(ids + [3] * (s % 5), imgs) for s, (ids, imgs) in ((s, _stage1(s)) for s in seeds)]


def _batch(seeds):
    rows = _rows(seeds)
    return TG.prepare_batch(CFG, [r[0] for r in rows], [r[1] for r in rows], length_buckets=(64,), patch_buckets=(64,))


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_run_decode_pair_then_solo_resume_matches_jax_and_solo(params, cache_dtype):
    """Group a decodes 12 tokens (5 paired + 7 in the solo loop it resumes in), group
    b an independent batch of 3 rows decoding 5: tokens equal the port's own solo
    decodes and the JAX Generator's pair + resume. With the int8 cache the port's
    pair equals its solo decode exactly (one arithmetic); against the JAX package,
    whose prefill reads the int8 cache through a dequantized bf16 copy, a row may
    differ only by a tie (_ties_only), and not every row."""
    jg, tg = _gens(params, cache_dtype=cache_dtype)
    ba, bb = _batch((31, 32)), _batch((41, 42, 43))
    ref_a = tg.generate(ba, TG.GenerationConfig(max_new_tokens=12))
    ref_b = tg.generate(bb, TG.GenerationConfig(max_new_tokens=5))
    outs = []
    for g, mod, host in ((tg, TG, lambda t: t.numpy()), (jg, JG, np.asarray)):
        la, ca, aa = g.run_prefill(ba, max_new=12)
        lb, cb, ab = g.run_prefill(bb, max_new=5)
        buf_a, done_a, la2, ca, buf_b, done_b, lb2, cb = g.run_decode_pair(
            (la, ca, ba.next_pos, aa, None), (lb, cb, bb.next_pos, ab, None), steps=5)
        rest, ca = g.run_decode(la2, ca, np.asarray(ba.next_pos) + 5, mod.GenerationConfig(max_new_tokens=7),
                                attend=aa, done0=done_a)
        full = np.concatenate([host(buf_a), host(rest)], axis=1)
        outs.append((g.trim_generated(full), g.trim_generated(host(buf_b))))
        assert lb2.shape == (3, CFG.text.vocab_size)
    assert outs[0] == (ref_a, ref_b)
    if cache_dtype == "float32":
        assert outs[1] == outs[0]
    else:
        tied = (_ties_only(jg, _rows((31, 32)), outs[0][0], outs[1][0], INT8_LOGITS_ATOL)
                + _ties_only(jg, _rows((41, 42, 43)), outs[0][1], outs[1][1], INT8_LOGITS_ATOL))
        assert tied <= 2, f"{tied} of 5 rows differ"


def test_cache_keeps_one_length_tensor_through_generate_and_continue(params):
    """The cache owns one length tensor for its lifetime: prefill, every decode step
    and the chunk prefill write into it."""
    _, tg = _gens(params)
    b1 = _batch((21, 22))
    seen = []
    orig = tg.run_decode
    tg.run_decode = lambda logits, cache, *a, **kw: (seen.append(cache.length.data_ptr()), orig(logits, cache, *a, **kw))[1]
    out1, cache = tg.generate(b1, GREEDY, return_cache=True)
    assert seen == [cache.length.data_ptr()]
    assert cache.length.tolist() == [int(n) + 8 for n in b1.lengths]
    chunks = [_vision_chunk((1, 2, 4), 23), _vision_chunk((1, 4, 4), 24)]
    keep_len = np.asarray([int(n) + 3 for n in b1.lengths], np.int32)
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks],
                                 [int(p) + 3 for p in b1.next_pos], length_buckets=(32,), patch_buckets=(64,))
    _, cache2 = tg.continue_generate(cache, bc, keep_len, GREEDY, return_cache=True)
    assert cache2 is cache and seen == [cache.length.data_ptr()] * 2
    assert cache.length.tolist() == [int(k) + int(n) + 8 for k, n in zip(keep_len, bc.lengths)]
    copy = cache.clone()
    assert copy.length.data_ptr() != cache.length.data_ptr() and torch.equal(copy.length, cache.length)


def test_generate_block_false_hands_back_the_device_buffer(params):
    _, tg = _gens(params)
    b1 = _batch((21, 22))
    ref, _ = tg.generate(b1, GREEDY, return_cache=True)
    tokens, cache = tg.generate(b1, GREEDY, block=False)
    assert isinstance(tokens, torch.Tensor) and tokens.shape == (2, 8)
    assert tg.trim_generated(TG.HostCopy(tokens).numpy()) == ref
    chunks = [_vision_chunk((1, 2, 4), 23), _vision_chunk((1, 4, 4), 24)]
    keep_len = np.asarray([int(n) + 3 for n in b1.lengths], np.int32)
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks],
                                 [int(p) + 3 for p in b1.next_pos], length_buckets=(32,), patch_buckets=(64,))
    toks2, cache2 = tg.continue_generate(cache.clone(), bc, keep_len, GREEDY, block=False)
    assert isinstance(toks2, torch.Tensor)
    assert tg.trim_generated(TG.HostCopy(toks2).numpy()) == tg.continue_generate(cache, bc, keep_len, GREEDY)


def test_host_copy_of_a_cpu_tensor_is_a_copy():
    t = torch.arange(6).reshape(2, 3)
    h = TG.HostCopy(t)
    t[0, 0] = 99
    assert h.numpy().tolist() == [[0, 1, 2], [3, 4, 5]]


def test_precomputed_vision_embeddings_batch(params):
    """pixel_values with vision_meta=None are embeddings: the tokens equal those of
    the batch that carries patches, in both packages."""
    from zoomearth_tpu_torch.models.vit import meta_to_device
    from zoomearth_tpu_torch.models.vlm import compute_vision_embeds

    jg, tg = _gens(params)
    b = _batch((51, 52))
    ref = tg.generate(b, GREEDY)
    meta = meta_to_device(b.vision_meta, "cpu")
    emb = compute_vision_embeds(tg.params, CFG, torch.from_numpy(b.pixel_values), meta, int(b.vision_meta["win_mode"]))
    be = TG.PreparedBatch(b.input_ids, b.lengths, b.position_ids, b.next_pos, emb.numpy(), None)
    assert tg.generate(be, GREEDY) == ref
    assert jg.generate(be, JG.GenerationConfig(max_new_tokens=8)) == ref


def test_int8_cache_generate_and_continue_against_jax(params):
    """Generator(cache_dtype="int8"): generate and the KV-reuse continuation. Not fp32
    parity: the reference's small-size prefill and chunk prefill read the int8 cache
    through a dequantized bf16 copy, K2 applies the scales to fp32 logits. Stated
    rule: the prefill's and the chunk prefill's logits within INT8_LOGITS_ATOL of the
    JAX package's; greedy rows identical, or differing by a tie (_ties_only), and at
    most 2 of the 6 rows differ."""
    jg, tg = _gens(params, cache_dtype="int8")
    seeds = (21, 22, 23)
    rows, b1 = _rows(seeds), _batch(seeds)
    np.testing.assert_allclose(tg.run_prefill(b1, max_new=8)[0].numpy(), np.asarray(jg.run_prefill(b1, max_new=8)[0]),
                               atol=INT8_LOGITS_ATOL)
    ref1, jcache = jg.generate(b1, JG.GenerationConfig(max_new_tokens=8), return_cache=True)
    out1, tcache = tg.generate(b1, GREEDY, return_cache=True)
    assert tcache.quantized and tcache.k[0].dtype == torch.int8
    tied = _ties_only(jg, rows, out1, ref1, INT8_LOGITS_ATOL)
    # stage 2 from the JAX package's kept tokens, in both packages, on the rows whose stage 1 agreed so far
    chunks = [_vision_chunk((1, 2, 4), 23), _vision_chunk((1, 4, 4), 24), _vision_chunk((1, 2, 2), 25)]
    keep_len = np.asarray([int(n) + 3 for n in b1.lengths], np.int32)
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks],
                                 [int(p) + 3 for p in b1.next_pos], length_buckets=(32,), patch_buckets=(64,))
    ref2 = jg.continue_generate(jcache, bc, keep_len, JG.GenerationConfig(max_new_tokens=8))
    out2 = tg.continue_generate(tcache, bc, keep_len, GREEDY)
    same = [r for r in range(3) if out1[r][:3] == ref1[r][:3]]
    assert len(same) >= 2
    stitched = [(rows[r][0] + ref1[r][:3] + chunks[r][0], rows[r][1] + chunks[r][1]) for r in same]
    tied += _ties_only(jg, stitched, [out2[r] for r in same], [ref2[r] for r in same], INT8_LOGITS_ATOL,
                       buckets=((128,), (128,)))
    assert tied <= 2, f"{tied} of 6 rows differ"


# ---------------------------------------------------------------------------
# Pipelined episodes and run_inference(mode="pipelined")
# ---------------------------------------------------------------------------

def test_run_episodes_pipelined_matches_jax_and_sequential_reuse(params, episode_env):
    """Three waves of 2 (the last given as a lazy callable), asymmetric budgets: the
    records equal the JAX package's pipelined runner's and the port's own
    run_episodes(reuse_cache=True), wave by wave."""
    jg, tg = _gens(params, max_cache_len=512)
    tiles = _tiles(6, seed=8)
    waves = [([f"what is at site {w}{i}?" for i in range(2)], tiles[2 * w:2 * w + 2]) for w in range(3)]
    lazy = waves[:2] + [lambda: waves[2]]
    g1, g2 = TG.GenerationConfig(max_new_tokens=7, temperature=0.0), TG.GenerationConfig(max_new_tokens=4, temperature=0.0)
    out = TE.run_episodes_pipelined(tg, episode_env, lazy, gen=g1, stage2_gen=g2)
    ref = JE.run_episodes_pipelined(jg, episode_env, lazy, gen=JG.GenerationConfig(max_new_tokens=7),
                                    stage2_gen=JG.GenerationConfig(max_new_tokens=4))
    as_dicts = lambda res: [[r.__dict__ for r in wave] for wave in res]  # noqa: E731
    assert as_dicts(out) == as_dicts(ref)
    seq = [TE.run_episodes(tg, episode_env, qs, ims, gen=g1, stage2_gen=g2, reuse_cache=True) for qs, ims in waves]
    assert as_dicts(out) == as_dicts(seq)
    assert all(not r.error and r.bbox for wave in out for r in wave)


def _read(path):
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        r.pop("model_id")
    return recs


def test_run_inference_pipelined_matches_jax_and_sequential_reuse(params, episode_env, tmp_path, monkeypatch):
    """Five samples in batches of 2: two pipelined waves and a partial last batch
    through the sequential reuse tail. The jsonl equals the JAX package's
    mode="pipelined" and the port's batches through run_episodes(reuse_cache=True)."""
    jg, tg = _gens(params, max_cache_len=512)
    tiles = dict(zip([f"t{i}.png" for i in range(3)], _tiles(3, seed=5)))
    loader = lambda s: tiles[s.image_name]  # noqa: E731
    samples = _samples(5)
    g1, g2 = TG.GenerationConfig(max_new_tokens=6, temperature=0.0), TG.GenerationConfig(max_new_tokens=4, temperature=0.0)
    tp = TI.run_inference(tg, episode_env, samples, str(tmp_path / "torch.jsonl"), batch_size=2, gen=g1, stage2_gen=g2,
                          image_loader=loader, mode="pipelined")
    jp = JI.run_inference(jg, episode_env, samples, str(tmp_path / "jax.jsonl"), batch_size=2,
                          gen=JG.GenerationConfig(max_new_tokens=6), stage2_gen=JG.GenerationConfig(max_new_tokens=4),
                          image_loader=loader, mode="pipelined")
    out = _read(tp)
    assert len(out) == 5 and out == _read(jp)
    # the port's sequential mode with reuse_cache semantics: run_episodes per batch, in run_inference's order
    order = sorted(samples, key=lambda s: s.image_name)
    seq = []
    for i in range(0, 5, 2):
        chunk = order[i:i + 2]
        res = TE.run_episodes(tg, episode_env, [s.question for s in chunk], [loader(s) for s in chunk], gen=g1,
                              stage2_gen=g2, reuse_cache=True)
        seq += [TI.record_dict(s, r) for s, r in zip(chunk, res)]
    for r in seq:
        r.pop("model_id")
    assert out == seq
    assert all(r["error"] is False for r in out)


def test_run_inference_pipelined_rows_without_a_bbox(params, episode_env, tmp_path, monkeypatch):
    """Rows without a bbox ride the pair loop inert (done0): error records with the
    stage-1 answer, as in the JAX package."""
    jg, tg = _gens(params, max_cache_len=512)
    tiles = dict(zip([f"t{i}.png" for i in range(3)], _tiles(3, seed=9)))
    loader = lambda s: tiles[s.image_name]  # noqa: E731
    samples = _samples(4)
    outs = []
    for mod, ep, g, gen in ((TI, TE, tg, TG.GenerationConfig(max_new_tokens=6, temperature=0.0)),
                            (JI, JE, jg, JG.GenerationConfig(max_new_tokens=6))):
        calls = {"n": -1}

        def boxes(text, scale=1.0, calls=calls):
            calls["n"] += 1
            return [[60, 60, 140, 130]] if calls["n"] % 2 else []

        monkeypatch.setattr(ep, "extract_bboxes", boxes)
        outs.append(_read(mod.run_inference(g, episode_env, samples, str(tmp_path / f"{mod.__name__}.jsonl"),
                                            batch_size=2, gen=gen, image_loader=loader, mode="pipelined")))
    assert outs[0] == outs[1]
    errors = [r["error"] for r in outs[0]]
    assert errors.count(True) == 2 and errors.count(False) == 2
    assert all(r["stage2"] == "" and r["answer2"] is None for r in outs[0] if r["error"])


def test_cli_infer_pipelined_int8_then_cli_eval(params, episode_env, tmp_path, monkeypatch):
    """python -m zoomearth_tpu_torch.cli.infer --mode pipelined --device cpu, its
    Generator given an int8 KV cache (the CLI has no option for it, as the reference's
    has none), then cli.eval over its jsonl."""
    from zoomearth_tpu_torch.cli import eval as cli_eval
    from zoomearth_tpu_torch.cli import infer as cli_infer

    _, tp = params
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, t in enumerate(_tiles(3, seed=6, size=300)):
        t.save(img_dir / f"t{i}.png")
    data = tmp_path / "test.jsonl"
    with open(data, "w") as f:
        for s in _samples(5):
            f.write(json.dumps({"question_id": s.question_id, "image_name": s.image_name,
                                "question": s.question, "ground_truth": "car", "type": "object",
                                "bbox": s.bbox, "category": "cat"}) + "\n")
    seen = []
    monkeypatch.setattr(cli_infer, "load_model_and_processor",
                        lambda path, **kw: (seen.append(kw["device"]), (tp, CFG, episode_env))[1])
    made = []
    orig = cli_infer.Generator
    monkeypatch.setattr(cli_infer, "Generator",
                        lambda *a, **kw: (made.append(orig(*a, cache_dtype=torch.int8, **kw)), made[-1])[1])
    cli_infer.main(["--model_name", "stub", "--exp_name", "pipe", "--data_file", str(data),
                    "--image_folder", str(img_dir), "--out_dir", str(tmp_path / "res"), "--batch_size", "2",
                    "--max_new_tokens", "4", "--stage2_max_new_tokens", "3", "--temperature", "0",
                    "--mode", "pipelined", "--device", "cpu"])
    assert seen == ["cpu"] and made[0].cache_dtype == torch.int8
    results = tmp_path / "res" / "pipe0.jsonl"
    recs = [json.loads(line) for line in open(results)]
    assert sorted(r["question_id"] for r in recs) == ["0", "1", "2", "3", "4"]
    cli_eval.main(["--results_file", str(results), "--json_out", str(tmp_path / "m.json")])
    metrics = json.load(open(tmp_path / "m.json"))
    assert metrics["n"] == 5 and set(metrics["per_type"]) == {"object"}


def test_chunk_prefill_builds_its_write_index_once_from_host_arrays(params, monkeypatch):
    """One chunk prefill, one write index: the Generator builds it from the host
    arrays it already has, and no layer builds another (none waits for the device)."""
    from zoomearth_tpu_torch.models import decoder as TD

    _, tg = _gens(params)
    b1 = _batch((21, 22))
    _, cache = tg.generate(b1, GREEDY, return_cache=True)
    chunks = [_vision_chunk((1, 2, 4), 23), _vision_chunk((1, 4, 4), 24)]
    keep_len = np.asarray([int(n) + 3 for n in b1.lengths], np.int32)
    bc = TG.prepare_continuation(CFG, [c[0] for c in chunks], [c[1] for c in chunks],
                                 [int(p) + 3 for p in b1.next_pos], length_buckets=(32,), patch_buckets=(64,))
    built = {"generator": [], "decoder": []}
    orig = TD.write_index
    monkeypatch.setattr(TG, "write_index", lambda pos, *a, **kw: (built["generator"].append(type(pos)), orig(pos, *a, **kw))[1])
    monkeypatch.setattr(TD, "write_index", lambda pos, *a, **kw: (built["decoder"].append(type(pos)), orig(pos, *a, **kw))[1])
    tg.run_chunk_prefill(cache, bc, keep_len, max_new=8)
    assert built == {"generator": [np.ndarray], "decoder": []}
