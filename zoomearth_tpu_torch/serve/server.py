"""OpenAI-compatible HTTP endpoint over the continuous-batching engine (port of
serve/server.py; host code over the port's own engine).

Accepts the exact request shape the reference's vLLM client sends
(src/eval/infer_vllm.py:134-242): /v1/chat/completions with base64 data-URL images,
multi-turn messages including a trailing *assistant partial* message carrying the
stage-2 crop (infer_vllm.py:201-216) — a trailing assistant message is continued
rather than answered. Response follows the OpenAI chat schema so the unmodified client
works (README.md:105-118 serving surface).
"""

from __future__ import annotations

import base64
import io
import json
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from ..agent.processor import Processor
from ..config import VLMConfig
from .engine import Request, ServingEngine

VISION_TOKENS = "<|vision_start|><|image_pad|><|vision_end|>"
DEFAULT_SYSTEM = "You are a helpful assistant."


def _decode_data_url(url: str):
    from PIL import Image

    m = re.match(r"data:image/[^;]+;base64,(.*)", url, re.DOTALL)
    if not m:
        raise ValueError("only base64 data URLs are supported (zero-egress server)")
    raw = base64.b64decode(m.group(1))
    return Image.open(io.BytesIO(raw)).convert("RGB")


def render_chat(messages: List[dict]) -> Tuple[str, List, bool]:
    """messages -> (prompt_text, images, continued_assistant).

    Qwen chat format; image content items become vision-token placeholders in order.
    A trailing assistant message is left open (continued) — the stage-2 pattern."""
    images = []
    parts = []
    has_system = any(m.get("role") == "system" for m in messages)
    if not has_system:
        parts.append(f"<|im_start|>system\n{DEFAULT_SYSTEM}<|im_end|>\n")
    continued = False
    for i, msg in enumerate(messages):
        role = msg.get("role", "user")
        content = msg.get("content", "")
        text_parts = []
        if isinstance(content, str):
            text_parts.append(content)
        else:
            for item in content:
                if item.get("type") == "text":
                    text_parts.append(item.get("text", ""))
                elif item.get("type") == "image_url":
                    images.append(_decode_data_url(item["image_url"]["url"]))
                    text_parts.append(VISION_TOKENS)
        body = "".join(text_parts)
        is_last = i == len(messages) - 1
        if role == "assistant" and is_last:
            parts.append(f"<|im_start|>assistant\n{body}")
            continued = True
        else:
            parts.append(f"<|im_start|>{role}\n{body}<|im_end|>\n")
    if not continued:
        parts.append("<|im_start|>assistant\n")
    return "".join(parts), images, continued


class OpenAIServer:
    """Threaded HTTP server: /v1/chat/completions + /v1/models + /health."""

    def __init__(
        self,
        engine: ServingEngine,
        processor: Processor,
        *,
        model_name: str = "zoomearth-tpu",
        host: str = "127.0.0.1",
        port: int = 8000,
        request_timeout: float = 600.0,
    ):
        self.engine = engine
        self.processor = processor
        self.model_name = model_name
        self.request_timeout = request_timeout
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok",
                                     "stats": {**outer.engine.stats,
                                               **outer.engine.latency_percentiles()}})
                elif self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": outer.model_name, "object": "model", "owned_by": "zoomearth-tpu"}
                    ]})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/chat/completions":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    if payload.get("stream"):
                        outer.handle_chat_stream(payload, self)
                        return
                    resp = outer.handle_chat(payload)
                    self._json(200, resp)
                except Exception as e:  # error schema matches OpenAI
                    self._json(400, {"error": {"message": str(e), "type": type(e).__name__}})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # SSE streaming: per-request token queues fed by the engine's on_tokens hook
        # (pump thread) and drained by the request's handler thread.
        self._stream_lock = threading.Lock()
        self._stream_queues: dict = {}
        engine.on_tokens = self._route_tokens

    def _route_tokens(self, request_id: str, toks: List[int]) -> None:
        with self._stream_lock:
            q = self._stream_queues.get(request_id)
        if q is not None:
            q.put(list(toks))

    def handle_chat(self, payload: dict) -> dict:
        messages = payload["messages"]
        text, pil_images, _continued = render_chat(messages)
        ids, prepped = self.processor.encode(text, pil_images)
        req_id = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        req = Request(
            request_id=req_id,
            token_ids=ids,
            images=prepped,
            max_tokens=int(payload.get("max_tokens", 256)),
            temperature=float(payload.get("temperature", 0.0)),
            top_p=float(payload.get("top_p", 1.0)),
        )
        self.engine.submit(req)
        completion = self.engine.get_completion(req_id, timeout=self.request_timeout)
        content = self.processor.tokenizer.decode(completion.token_ids).strip()
        return {
            "id": req_id,
            "object": "chat.completion",
            "created": int(time.time()),
            "model": payload.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": content},
                "finish_reason": completion.finish_reason,
            }],
            "usage": {
                "prompt_tokens": completion.prompt_tokens,
                "completion_tokens": len(completion.token_ids),
                "total_tokens": completion.prompt_tokens + len(completion.token_ids),
            },
        }

    def handle_chat_stream(self, payload: dict, handler) -> None:
        """SSE streaming (`"stream": true`): OpenAI chat.completion.chunk events.

        The engine's decode loop emits tokens one decode_chunk at a time; each chunk
        becomes one `data:` event whose delta is the newly decoded text (full-prefix
        re-decode diff, so BPE pieces spanning chunk boundaries render correctly).
        The response is raw SSE with `Connection: close` (stream ends at socket close
        — vLLM's server does the same for HTTP/1.1 clients without chunked support)."""
        messages = payload["messages"]
        text, pil_images, _continued = render_chat(messages)
        ids, prepped = self.processor.encode(text, pil_images)
        req_id = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        created = int(time.time())
        model = payload.get("model", self.model_name)

        def chunk(delta: dict, finish=None) -> bytes:
            obj = {
                "id": req_id, "object": "chat.completion.chunk", "created": created,
                "model": model,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
            return f"data: {json.dumps(obj)}\n\n".encode()

        q: "queue.Queue" = queue.Queue()
        with self._stream_lock:
            self._stream_queues[req_id] = q
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.end_headers()
            handler.wfile.write(chunk({"role": "assistant"}))
            handler.wfile.flush()
            try:
                self.engine.submit(Request(
                    request_id=req_id, token_ids=ids, images=prepped,
                    max_tokens=int(payload.get("max_tokens", 256)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_p=float(payload.get("top_p", 1.0)),
                ))
            except ValueError as e:
                # submit-time rejection (over-bucket prompt): the SSE headers are
                # already on the wire, so end the stream in-protocol — re-raising
                # would let do_POST write an HTTP 400 into the open event stream
                err = {
                    "id": req_id, "object": "chat.completion.chunk",
                    "created": created, "model": model, "choices": [],
                    "error": {"message": str(e), "type": "ValueError"},
                }
                handler.wfile.write(f"data: {json.dumps(err)}\n\n".encode())
                handler.wfile.write(b"data: [DONE]\n\n")
                handler.wfile.flush()
                return
            deadline = time.time() + self.request_timeout
            acc: List[int] = []
            sent = ""

            def emit(new_toks: List[int]):
                nonlocal sent
                acc.extend(new_toks)
                full = self.processor.tokenizer.decode(acc)
                delta = full[len(sent):]
                if delta:
                    sent = full
                    handler.wfile.write(chunk({"content": delta}))
                    handler.wfile.flush()

            done = False
            while not done:
                try:
                    emit(q.get(timeout=0.25))
                except queue.Empty:
                    if req_id in self.engine.results:
                        done = True
                    elif time.time() > deadline:
                        # The 200/SSE headers and partial events are already on the
                        # wire — raising here would make do_POST's generic handler
                        # write a JSON 400 status line INTO the open event stream
                        # (malformed SSE for the client). Terminate the stream
                        # in-protocol instead, and cancel the request off-thread so
                        # it stops consuming an engine slot (cancel_prefix waits for
                        # the in-flight row to drain, so it must not block here).
                        err = {
                            "id": req_id, "object": "chat.completion.chunk",
                            "created": created, "model": model, "choices": [],
                            "error": {"message": f"request timed out after "
                                                 f"{self.request_timeout}s",
                                      "type": "TimeoutError"},
                        }
                        handler.wfile.write(f"data: {json.dumps(err)}\n\n".encode())
                        handler.wfile.write(b"data: [DONE]\n\n")
                        handler.wfile.flush()
                        threading.Thread(
                            target=self.engine.cancel_prefix, args=(req_id,),
                            kwargs={"timeout": 60.0}, daemon=True,
                        ).start()
                        return
            completion = self.engine.get_completion(req_id, timeout=1.0)
            # drain tokens that raced the completion notification
            while True:
                try:
                    emit(q.get_nowait())
                except queue.Empty:
                    break
            handler.wfile.write(chunk({}, finish=completion.finish_reason))
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        finally:
            with self._stream_lock:
                self._stream_queues.pop(req_id, None)

    def start(self):
        self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self.engine.stop()
