"""The port's OpenAI endpoint and its client on the CPU: a live OpenAIServer on a free
port over the port's engine at the tiny config, driven by real HTTP (raw http.client
and the port's own ChatClient / process_item / eval_concurrent), including the
stage-2 assistant-partial-with-image pattern the reference client sends. The pure
functions (render_chat, _decode_data_url, encode_data_url) are held equal to the JAX
package's here on the reference tests' inputs, and in tests/test_torch_host.py on more.
Every wait has a timeout of its own.
"""

import base64
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zoomearth_tpu.agent.processor import Processor
from zoomearth_tpu.config import VLMConfig
from zoomearth_tpu.eval import client as JC
from zoomearth_tpu.models.params import init_vlm_params as jax_init_vlm_params
from zoomearth_tpu.serve import server as JS
from zoomearth_tpu.tokenizer import FakeTokenizer
from zoomearth_tpu.train.data import LRSGROSample
from zoomearth_tpu_torch.eval import client as TC
from zoomearth_tpu_torch.models.params import params_from_numpy
from zoomearth_tpu_torch.serve import server as TS
from zoomearth_tpu_torch.serve.engine import ServingEngine

torch.set_num_threads(1)
CFG = VLMConfig.tiny()


def _data_url(seed=0, size=64):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


CHATS = {
    "simple user": [{"role": "user", "content": "hi"}],
    "image content": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": _data_url()}}, {"type": "text", "text": "what is this?"}]}],
    "assistant partial continued": [
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": _data_url(1)}},
                                     {"type": "text", "text": "q?"}]},
        {"role": "assistant", "content": [{"type": "text", "text": "<think>so far</think>"},
                                          {"type": "image_url", "image_url": {"url": _data_url(2)}}]}],
    "explicit system": [{"role": "system", "content": "custom"}, {"role": "user", "content": "x"}],
}


@pytest.mark.parametrize("name", list(CHATS))
def test_render_chat_equals_reference(name):
    text, images, cont = TS.render_chat(CHATS[name])
    ref_text, ref_images, ref_cont = JS.render_chat(CHATS[name])
    assert (text, cont) == (ref_text, ref_cont)
    assert [np.asarray(i).tobytes() for i in images] == [np.asarray(i).tobytes() for i in ref_images]
    if name == "simple user":
        assert text == ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                        "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n") and images == [] and not cont
    if name == "assistant partial continued":
        assert cont and len(images) == 2 and text.endswith(
            "<|im_start|>assistant\n<think>so far</think><|vision_start|><|image_pad|><|vision_end|>")
    if name == "explicit system":
        assert text.count("<|im_start|>system") == 1 and "custom" in text


def test_data_urls_round_trip_and_equal_reference():
    rng = np.random.default_rng(3)
    rgb = Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
    for image in (rgb, rgb.convert("RGBA"), rgb.convert("P")):
        url = TC.encode_data_url(image)
        assert url == JC.encode_data_url(image)
        assert url.startswith("data:image/jpeg;base64," if image.mode == "RGB" else "data:image/png;base64,")
        back, ref = TS._decode_data_url(url), JS._decode_data_url(url)
        assert back.mode == "RGB" and back.size == image.size and back.tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="base64 data URLs"):
        TS._decode_data_url("http://example.invalid/x.png")


@pytest.fixture(scope="module")
def server():
    jp = jax_init_vlm_params(jax.random.key(0), CFG)
    engine = ServingEngine(
        params_from_numpy(jax.tree.map(np.asarray, jp)), CFG, max_slots=2, max_seq_len=256, decode_chunk=2,
        cache_dtype="float32", length_buckets=(128, 256), patch_buckets=(0, 16, 64),
    )
    proc = Processor(FakeTokenizer(CFG.tokens), CFG, max_pixels=4 * 28 * 28)
    srv = TS.OpenAIServer(engine, proc, port=0)
    srv.start()
    yield srv
    srv.stop()


def _post(server, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _get(server, path):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _stream(server, payload, timeout=120):
    """POST a streaming chat; returns (status, content type, raw body, its `data:` events)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions", json.dumps({**payload, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()  # Connection: close, so read to EOF
    conn.close()
    events = [l[len("data: "):] for l in raw.split("\n\n") if l.startswith("data: ")]
    return resp.status, resp.getheader("Content-Type"), raw, events


def test_models_health_and_unknown_paths(server):
    status, body = _get(server, "/v1/models")
    assert status == 200 and body["data"][0]["id"] == "zoomearth-tpu"
    status, body = _get(server, "/health")
    assert status == 200 and body["status"] == "ok" and "completed" in body["stats"] and "p50_latency_s" in body["stats"]
    assert _get(server, "/nothing")[0] == 404
    assert _post(server, "/v1/nothing", {})[0] == 404


def test_chat_completion_text(server):
    status, body = _post(server, "/v1/chat/completions", {
        "model": "zoomearth-tpu", "messages": [{"role": "user", "content": "Hello"}], "max_tokens": 6,
        "temperature": 0.0})
    assert status == 200
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant" and choice["finish_reason"] in ("stop", "length")
    usage = body["usage"]
    assert usage["completion_tokens"] <= 6
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]


def test_chat_completion_with_image(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": _data_url(3, 64)}}, {"type": "text", "text": "what?"}]}],
        "max_tokens": 4})
    assert status == 200 and isinstance(body["choices"][0]["message"]["content"], str)
    assert body["usage"]["prompt_tokens"] > len("what?")  # the image's pad tokens are in the prompt


def test_two_stage_client_pattern(server):
    """The reference client's two calls: stage 1, then the assistant partial with the crop."""
    user = {"role": "user", "content": [{"type": "image_url", "image_url": {"url": _data_url(4, 64)}},
                                        {"type": "text", "text": "what is it?"}]}
    s1 = _post(server, "/v1/chat/completions", {"messages": [user], "max_tokens": 4})[1]
    partial = s1["choices"][0]["message"]["content"]
    status, s2 = _post(server, "/v1/chat/completions", {"messages": [user, {"role": "assistant", "content": [
        {"type": "text", "text": partial}, {"type": "image_url", "image_url": {"url": _data_url(5, 64)}}]}],
        "max_tokens": 4})
    assert status == 200 and s2["usage"]["prompt_tokens"] > s1["usage"]["prompt_tokens"]


def test_bad_request_schema(server):
    status, body = _post(server, "/v1/chat/completions", {"no_messages": True})
    assert status == 400 and body["error"]["type"] == "KeyError"
    # the engine's own refusal comes back as a 400 too, and the server keeps serving
    status, body = _post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": "w " * 250}],
                                                          "max_tokens": 2})
    assert status == 400 and "exceeds" in body["error"]["message"]
    assert _post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": "ok"}],
                                                  "max_tokens": 2})[0] == 200


def test_concurrent_requests(server):
    results = {}

    def call(i):
        results[i] = _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"request number {i}"}], "max_tokens": 4})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(results) == 4 and all(status == 200 for status, _ in results.values())
    # the answers do not depend on which requests shared a batch
    alone = [_post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": f"request number {i}"}],
                                                    "max_tokens": 4})[1] for i in range(4)]
    assert [results[i][1]["choices"][0]["message"] for i in range(4)] == [a["choices"][0]["message"] for a in alone]


def test_streaming_sse(server):
    """`"stream": true`: chat.completion.chunk events whose deltas concatenate to the
    non-streaming answer for the same prompt, ending with a finish_reason chunk and
    `data: [DONE]`."""
    prompt = {"messages": [{"role": "user", "content": "Stream me"}], "max_tokens": 6, "temperature": 0.0}
    ref_content = _post(server, "/v1/chat/completions", prompt)[1]["choices"][0]["message"]["content"]
    status, ctype, _, events = _stream(server, prompt)
    assert status == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    finish = chunks[-1]["choices"][0]["finish_reason"]
    assert finish in ("stop", "length")
    content = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert content.strip() == ref_content
    # incremental: a full-length 6-token answer arrives over several chunks (the prefill's first token,
    # then decode_chunk=2 at a time), not as one blob
    n_content = sum(1 for c in chunks if c["choices"][0]["delta"].get("content"))
    assert n_content >= (2 if finish == "length" else bool(ref_content))
    assert server._stream_queues == {}


def test_streaming_timeout_terminates_in_protocol(server):
    """A request that exceeds request_timeout after the SSE headers are on the wire ends
    with an in-protocol error event + [DONE], never a JSON 400 status line written into
    the open event stream."""
    orig_submit, orig_timeout = server.engine.submit, server.request_timeout
    server.request_timeout = 0.6
    server.engine.submit = lambda req: None  # the request never progresses
    try:
        status, _, raw, events = _stream(server, {"messages": [{"role": "user", "content": "hang"}], "max_tokens": 4},
                                         timeout=30)
    finally:
        server.engine.submit = orig_submit
        server.request_timeout = orig_timeout
    assert status == 200 and "HTTP/" not in raw and events[-1] == "[DONE]"
    assert json.loads(events[-2])["error"]["type"] == "TimeoutError"
    assert all(json.loads(e) for e in events[:-1])  # every event is valid JSON


def test_streaming_over_bucket_prompt_errors_in_protocol(server):
    """A submit-time rejection lands AFTER the SSE headers: the stream ends with an
    in-protocol error event + [DONE], and the next request is served."""
    status, _, raw, events = _stream(server, {"messages": [{"role": "user", "content": "w " * 250}], "max_tokens": 2},
                                     timeout=30)
    assert status == 200 and "HTTP/" not in raw and events[-1] == "[DONE]"
    last = json.loads(events[-2])
    assert last["error"]["type"] == "ValueError" and "exceeds" in last["error"]["message"]
    assert _post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": "next"}],
                                                  "max_tokens": 2})[0] == 200


# ---------------------------------------------------------------------------
# The client
# ---------------------------------------------------------------------------

def _sample(i):
    return LRSGROSample(question_id=str(i), image_name=f"t{i}.png", category="cat", question=f"what is at site {i}?",
                        higher_level="perception", ground_truth="car", bbox=[10, 10, 40, 40], type="object",
                        image_path=f"t{i}.png")


@pytest.fixture
def short_instruction(monkeypatch):
    """The byte-level FakeTokenizer makes the verbatim instruction ~1900 tokens, over the
    test server's 256-token cache: the client gets a short one."""
    monkeypatch.setattr(TC, "INSTRUCTION_EVAL", "\nAnswer briefly.")


def _tile(sample):
    rng = np.random.default_rng(int(sample.question_id))
    return Image.fromarray(rng.integers(0, 255, (600, 600, 3), dtype=np.uint8))


def test_chat_client_creates_and_raises_the_servers_error(server):
    client = TC.ChatClient(f"http://127.0.0.1:{server.port}", timeout=120)
    assert (client.host, client.port, client.model) == ("127.0.0.1", server.port, "zoomearth-tpu")
    out = client.create([{"role": "user", "content": "Hello"}], max_tokens=6, temperature=0.0)
    ref = _post(server, "/v1/chat/completions", {"messages": [{"role": "user", "content": "Hello"}], "max_tokens": 6,
                                                 "temperature": 0.0})[1]["choices"][0]["message"]["content"]
    assert out == ref.strip()
    with pytest.raises(RuntimeError, match="exceeds"):
        client.create([{"role": "user", "content": "w " * 250}], max_tokens=2)


@pytest.mark.parametrize("with_bbox", [True, False], ids=["two-stage", "no-bbox"])
def test_process_item_record_against_the_live_server(server, monkeypatch, short_instruction, with_bbox):
    """One two-stage episode over HTTP: with a (forced) bbox both stages run and the
    record holds the reference's keys; without one the record is the error record."""
    if with_bbox:
        monkeypatch.setattr(TC, "extract_bboxes", lambda text, scale=1.0: [[100, 100, 260, 220]])
    client = TC.ChatClient(f"http://127.0.0.1:{server.port}", timeout=120)
    sample = _sample(1)
    rec = TC.process_item(sample, client, image_loader=_tile, max_size=56, max_tokens=4, temperature=0.0)
    assert list(rec) == ["question_id", "ground_truth", "answer1", "answer2", "bbox_ref", "bbox", "prompt", "category",
                         "stage1", "stage2", "type", "image", "error", "model_id"]
    assert rec["question_id"] == "1" and rec["prompt"] == sample.question + "\nAnswer briefly." and rec["image"] == "t1.png"
    assert isinstance(rec["stage1"], str) and not rec["stage1"].startswith("Error")
    if with_bbox:
        assert rec["error"] is False and rec["bbox"] == [100, 100, 260, 220]
        assert isinstance(rec["stage2"], str) and not rec["stage2"].startswith("Error")
    else:
        assert rec["error"] is True and rec["bbox"] == [] and rec["stage2"] == ""


def test_eval_concurrent_writes_one_record_per_sample(server, monkeypatch, short_instruction, tmp_path):
    monkeypatch.setattr(TC, "extract_bboxes", lambda text, scale=1.0: [[100, 100, 260, 220]])
    client = TC.ChatClient(f"http://127.0.0.1:{server.port}", timeout=120)
    out = TC.eval_concurrent([_sample(i) for i in range(5)], client, str(tmp_path / "out.jsonl"), max_workers=3,
                             limit=4, image_loader=_tile, max_size=56, max_tokens=3, temperature=0.0)
    records = [json.loads(line) for line in open(out)]
    assert [r["question_id"] for r in records] == ["0", "1", "2", "3"]
    assert all(r["error"] is False and r["model_id"] == "zoomearth-tpu (serve)" for r in records)
    stats = server.engine.stats
    assert not server.engine.active.any() and not server.engine.held and stats.get("errors", 0) == 0
