"""The port's inference slice against the JAX package on the CPU: Generator
(generate / continue_generate), run_episodes in both stage-2 modes, run_inference's
jsonl and the cli.infer entry point.

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


def _gens(params, max_cache_len=256, **kw):
    jp, tp = params
    return (JG.Generator(jp, CFG, max_cache_len=max_cache_len, cache_dtype="float32", **kw),
            TG.Generator(tp, CFG, max_cache_len=max_cache_len, cache_dtype="float32", **kw))


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TI.run_inference(tg, episode_env, samples, str(tmp_path / "p.jsonl"), mode="pipelined")


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
