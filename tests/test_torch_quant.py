"""The port's int8-weight layouts (ops/quant.py) against the JAX package's on the CPU:
quantize_int8 bit for bit, qdot in its three branches, the quantized and fused trees
leaf for leaf, the decoder and the logits head over them, params_from_numpy keeping the
int8 leaves, and `cli.serve --quantize int8` answering a chat.
"""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoomearth_tpu.agent.processor import Processor
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.models import decoder as JD
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.ops import quant as JQ
from zoomearth_tpu.tokenizer import FakeTokenizer
from zoomearth_tpu_torch.cli import serve as cli_serve
from zoomearth_tpu_torch.models import decoder as TD
from zoomearth_tpu_torch.models.params import params_from_numpy, tree_leaves
from zoomearth_tpu_torch.ops import quant as TQ
from zoomearth_tpu_torch.runtime import generate as TG
from zoomearth_tpu_torch.serve import server as TS

torch.set_num_threads(1)
CFG = VLMConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jp = jax_init_vlm_params(jax.random.key(5), CFG, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_trees_equal(tt, jt):
    """Same nesting, same keys, and every leaf equal bit for bit with the same dtype."""
    if isinstance(jt, dict):
        assert isinstance(tt, dict) and sorted(tt) == sorted(jt), (sorted(tt), sorted(jt))
        for k in jt:
            _assert_trees_equal(tt[k], jt[k])
    elif isinstance(jt, (list, tuple)):
        assert len(tt) == len(jt)
        for a, b in zip(tt, jt):
            _assert_trees_equal(a, b)
    else:
        assert str(tt.dtype).split(".")[1] == str(jt.dtype), (tt.dtype, jt.dtype)
        np.testing.assert_array_equal(_np(tt), np.asarray(jt, np.float32 if jt.dtype == jnp.bfloat16 else None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 128), (48, 24)])
def test_quantize_int8_values_and_scales_equal_reference(dtype, shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 3.0, size=(1, shape[1])).astype(np.float32)
    w[:, 3] = 0.0  # a dead output channel: the scale's floor
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, tq = JQ.quantize_int8(jw), TQ.quantize_int8(tw)
    assert tq["q"].dtype == torch.int8 and tq["s"].dtype == tw.dtype and tq["s"].shape == (1, shape[1])
    _assert_trees_equal(tq, jq)
    assert TQ.is_quantized(tq) and not TQ.is_quantized(tw) and not TQ.is_quantized({"w": tw, "a": tw, "b": tw, "s": tw})
    if dtype == "float32":  # per-channel symmetric: the round trip is within half a step of each column's scale
        assert bool(((tq["q"].float() * tq["s"] - tw).abs() <= tq["s"] * 0.51).all())


def test_qdot_int8_lora_and_plain_branches_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    lora = {"w": w, "a": rng.standard_normal((64, 8)).astype(np.float32),
            "b": rng.standard_normal((8, 32)).astype(np.float32), "s": np.float32(0.25)}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, tq = JQ.quantize_int8(jnp.asarray(w)), TQ.quantize_int8(torch.from_numpy(w))
    for jw, tw in ((jq, tq), (jax.tree.map(jnp.asarray, lora), {k: torch.as_tensor(v) for k, v in lora.items()}),
                   (jnp.asarray(w), torch.from_numpy(w))):
        np.testing.assert_allclose(TQ.qdot(tx, tw).numpy(), np.asarray(JQ.qdot(jx, jw)), rtol=1e-5, atol=1e-5)
    # the int8 branch is the product with the dequantized weight
    ref = x @ (tq["q"].numpy().astype(np.float32) * tq["s"].numpy())
    np.testing.assert_allclose(TQ.qdot(tx, tq).numpy(), ref, rtol=1e-5, atol=1e-5)
    # in bf16 the int8 values are widened to bf16, exactly, and the output keeps x's dtype
    out = TQ.qdot(tx.bfloat16(), TQ.quantize_int8(torch.from_numpy(w).bfloat16()))
    assert out.dtype == torch.bfloat16 and out.shape == (4, 3, 32)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("lm_head", [False, True], ids=["layers", "layers+lm_head"])
def test_quantized_and_fused_trees_equal_reference(params, fused, lm_head):
    jp, tp = params
    if fused:
        jp, tp = JQ.fuse_decoder_matmuls(jp), TQ.fuse_decoder_matmuls(tp)
        l0 = tp["text"]["layers"][0]
        assert "wqkv" in l0["attn"] and "wgu" in l0["mlp"] and "wq" not in l0["attn"]
        _assert_trees_equal(tp, jp)
    jq, tq = JQ.quantize_decoder_int8(jp, lm_head=lm_head), TQ.quantize_decoder_int8(tp, lm_head=lm_head)
    _assert_trees_equal(tq, jq)
    l0 = tq["text"]["layers"][0]
    assert TQ.is_quantized(l0["attn"]["wo"]) and TQ.is_quantized(l0["mlp"]["wd"])
    assert not TQ.is_quantized(l0["attn"]["bqkv" if fused else "bq"])
    assert ("lm_head_q8" in tq["text"]) == lm_head
    # untouched parts share their tensors with the input tree
    assert tq["text"]["embed"]["weight"] is tp["text"]["embed"]["weight"] and tq["vision"] is tp["vision"]
    assert TQ.quantized_bytes(tq) == JQ.quantized_bytes(jq) < TQ.quantized_bytes(tp) + (10**9 if lm_head else 0)


def test_fused_equals_split_bit_for_bit_and_is_idempotent(params):
    """x @ concat(A, B) == concat(x @ A, x @ B), and per-output-column int8 scales
    survive an output-dim concat: plain and int8, fused equals split exactly."""
    _, tp = params
    fused = TQ.fuse_decoder_matmuls(tp)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8, CFG.text.hidden_size)).astype(np.float32))
    pos = torch.arange(8)[None, None].expand(3, 2, 8)
    h_split, _ = TD.decoder_forward(tp["text"], CFG.text, x, pos)
    h_fused, _ = TD.decoder_forward(fused["text"], CFG.text, x, pos)
    assert torch.equal(h_split, h_fused)
    hq_split, _ = TD.decoder_forward(TQ.quantize_decoder_int8(tp)["text"], CFG.text, x, pos)
    hq_fused, _ = TD.decoder_forward(TQ.quantize_decoder_int8(fused)["text"], CFG.text, x, pos)
    assert torch.equal(hq_split, hq_fused) and not torch.equal(hq_split, h_split)
    assert TQ.fuse_decoder_matmuls(fused)["text"]["layers"][0] is fused["text"]["layers"][0]
    refused = TQ.fuse_decoder_matmuls(TQ.quantize_decoder_int8(fused))
    assert TQ.is_quantized(refused["text"]["layers"][0]["attn"]["wqkv"])


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_decoder_forward_and_logits_over_a_quantized_tree_match_reference(params, fused):
    jp, tp = params
    if fused:
        jp, tp = JQ.fuse_decoder_matmuls(jp), TQ.fuse_decoder_matmuls(tp)
    jq, tq = JQ.quantize_decoder_int8(jp, lm_head=True), TQ.quantize_decoder_int8(tp, lm_head=True)
    x = np.random.default_rng(7).standard_normal((2, 8, CFG.text.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None, None], (3, 2, 8))
    jh, _ = JD.decoder_forward(jq["text"], CFG.text, jnp.asarray(x), jnp.asarray(pos))
    th, _ = TD.decoder_forward(tq["text"], CFG.text, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=5e-5)
    jl = JD.logits_from_hidden(jq["text"], CFG.text, jh)
    tl = TD.logits_from_hidden(tq["text"], CFG.text, th)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5)
    # the int8 head really took the head's place
    plain = TD.logits_from_hidden(tp["text"], CFG.text, th)
    assert not torch.equal(plain, tl) and float((plain - tl).abs().max()) < 0.05
    # a bf16 hidden state goes through the widened int8 head in fp32 accumulation
    bf = TD.logits_from_hidden(tq["text"], CFG.text, th.bfloat16())
    assert bf.dtype == torch.float32 and float((bf - tl).abs().max()) < 0.05


def test_decode_pair_step_over_a_quantized_tree_equals_two_solo_steps(params):
    """decoder_forward_pair's matmuls go through qdot too: over int8 weights a pair
    step's tokens are the two solo Generators' tokens."""
    _, tp = params
    tq = TQ.quantize_decoder_int8(TQ.fuse_decoder_matmuls(tp), lm_head=True)
    g = TG.Generator(tq, CFG, max_cache_len=64, cache_dtype="float32")
    rng = np.random.default_rng(2)
    batches = [TG.prepare_batch(CFG, [[CFG.tokens.im_start] + [int(i) for i in rng.integers(1, 400, size=n)]
                                      for n in sizes], [[]] * len(sizes), length_buckets=(32,), patch_buckets=(0,))
               for sizes in ((10, 7), (5, 9, 12))]
    solo = [g.generate(b, TG.GenerationConfig(max_new_tokens=5)) for b in batches]
    (la, ca, aa), (lb, cb, ab) = (g.run_prefill(b, max_new=5) for b in batches)
    out = g.run_decode_pair((la, ca, batches[0].next_pos, aa, None), (lb, cb, batches[1].next_pos, ab, None), steps=5)
    assert [g.trim_generated(out[0].numpy()), g.trim_generated(out[4].numpy())] == solo


def test_params_from_numpy_keeps_integer_leaves_and_casts_float_leaves(params):
    """A quantized JAX tree round-trips: `q` stays int8 whatever `dtype` asks of the
    float leaves, which all take it (the scales too)."""
    jp, _ = params
    jq = JQ.quantize_decoder_int8(JQ.fuse_decoder_matmuls(jp), lm_head=True)
    for dtype, want in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        tq = params_from_numpy(jax.tree.map(np.asarray, jq), dtype=dtype)
        wqkv = tq["text"]["layers"][0]["attn"]["wqkv"]
        assert wqkv["q"].dtype == torch.int8 and wqkv["s"].dtype == want
        assert tq["text"]["lm_head_q8"]["q"].dtype == torch.int8
        assert {t.dtype for t in tree_leaves(tq)} == {torch.int8, want}
        np.testing.assert_array_equal(wqkv["q"].numpy(), np.asarray(jq["text"]["layers"][0]["attn"]["wqkv"]["q"]))
    th, _ = TD.decoder_forward(params_from_numpy(jax.tree.map(np.asarray, jq))["text"], CFG.text,
                               torch.ones((1, 4, CFG.text.hidden_size)), torch.arange(4)[None, None].expand(3, 1, 4))
    ref, _ = TD.decoder_forward(TQ.quantize_decoder_int8(TQ.fuse_decoder_matmuls(params[1]))["text"], CFG.text,
                                torch.ones((1, 4, CFG.text.hidden_size)), torch.arange(4)[None, None].expand(3, 1, 4))
    assert torch.equal(th, ref)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_cli_serve_answers_a_chat_on_the_cpu(params, monkeypatch, quantize):
    """`cli.serve --device cpu` with the checkpoint loading stubbed: the endpoint comes
    up on a free port, answers one chat, and with --quantize int8 it serves the
    quantized tree."""
    proc = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)
    seen = {}

    def load(model_path, *, device=None, **kw):
        seen["device"] = device
        return params[1], CFG, proc

    started = threading.Event()

    class Server(TS.OpenAIServer):
        def start(self):
            super().start()
            seen["server"] = self
            started.set()

    monkeypatch.setattr(cli_serve, "load_model_and_processor", load)
    monkeypatch.setattr(cli_serve, "OpenAIServer", Server)
    result = {}

    def client():
        assert started.wait(timeout=60)
        conn = http.client.HTTPConnection("127.0.0.1", seen["server"].port, timeout=60)
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "messages": [{"role": "user", "content": "Hello"}], "max_tokens": 4}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        result["status"], result["body"] = resp.status, json.loads(resp.read())
        conn.close()

    # the CLI sleeps an hour at a time in its serve-forever loop: that sleep waits for the client and
    # then interrupts, as Ctrl-C would; every other sleep (the pump's, the debounce) stays real
    t = threading.Thread(target=client, daemon=True)
    real_sleep = time.sleep

    def sleep(seconds):
        if seconds < 3600:
            return real_sleep(seconds)
        t.join(timeout=90)
        raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", sleep)
    t.start()
    try:
        cli_serve.main(["--model", "unused", "--host", "127.0.0.1", "--port", "0", "--max_model_len", "256",
                        "--max_slots", "2", "--decode_chunk", "2", "--device", "cpu", "--quantize", quantize])
    finally:
        monkeypatch.undo()
    assert not t.is_alive() and seen["device"] == "cpu"
    assert result["status"] == 200 and result["body"]["choices"][0]["finish_reason"] in ("stop", "length")
    assert result["body"]["usage"]["completion_tokens"] <= 4
    engine = seen["server"].engine
    assert TQ.is_quantized(engine.params["text"]["layers"][0]["attn"]["wq"]) == (quantize == "int8")
    assert engine._pump_thread is None  # KeyboardInterrupt stopped the server and the pump


def test_cli_serve_takes_cuda_by_default_and_raises_without_a_device(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would load a checkpoint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--model", str(tmp_path)])
