"""Concurrent two-stage evaluation client against an OpenAI-compatible server (port
of eval/client.py; host code, stdlib only).

Equivalent of the reference's vLLM client (src/eval/infer_vllm.py:134-265): per-sample
two-stage zoom loop over HTTP with ThreadPoolExecutor concurrency, base64 data-URL
images, and the same record schema. Uses stdlib http.client (no openai package
dependency); works against our serve.server or any vLLM-style endpoint.

Reference bugs fixed (SURVEY.md §2.6): extract_bbox is called WITH the back-projection
scale (infer_vllm.py:177 omits it, breaking crops), and the stage-2 user message does
not duplicate the instruction (infer_vllm.py:206 sends cur_prompt + instruction where
cur_prompt already contains it). Pass replicate_reference_bugs=True for exact parity.
"""

from __future__ import annotations

import base64
import io
import json
import http.client
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence
from urllib.parse import urlparse

from ..agent.prompts import INSTRUCTION_EVAL
from ..image.geometry import cut_image, extract_bboxes, resize_image
from ..train.data import LRSGROSample


def encode_data_url(image) -> str:
    buffered = io.BytesIO()
    fmt = "PNG" if image.mode in ("RGBA", "P") else "JPEG"
    image.save(buffered, format=fmt)
    return f"data:image/{fmt.lower()};base64," + base64.b64encode(buffered.getvalue()).decode()


class ChatClient:
    """Minimal OpenAI chat-completions client (stdlib only)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8000", model: str = "zoomearth-tpu",
                 timeout: float = 600.0):
        u = urlparse(base_url)
        self.host = u.hostname
        self.port = u.port or 80
        self.model = model
        self.timeout = timeout

    def create(self, messages, **kw) -> str:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            body = json.dumps({"model": self.model, "messages": messages, **kw})
            conn.request("POST", "/v1/chat/completions", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            if resp.status != 200:
                raise RuntimeError(data.get("error", {}).get("message", f"HTTP {resp.status}"))
            return data["choices"][0]["message"]["content"].strip()
        finally:
            conn.close()


def process_item(
    sample: LRSGROSample,
    client: ChatClient,
    *,
    image_loader=None,
    max_size: int = 512,
    max_tokens: int = 1024,
    temperature: float = 0.01,
    replicate_reference_bugs: bool = False,
    model_id: str = "zoomearth-tpu (serve)",
) -> dict:
    """One two-stage episode over HTTP -> reference record dict (infer_vllm.py:227-242)."""
    from PIL import Image

    if image_loader is None:
        def image_loader(s):
            return Image.open(s.image_path).convert("RGB")

    cur_prompt = sample.question + INSTRUCTION_EVAL

    def rec(a1, a2, bbox, s1, s2, error):
        return {
            "question_id": sample.question_id, "ground_truth": sample.ground_truth,
            "answer1": a1, "answer2": a2, "bbox_ref": sample.bbox, "bbox": bbox,
            "prompt": cur_prompt, "category": sample.category, "stage1": s1,
            "stage2": s2, "type": sample.type, "image": sample.image_name,
            "error": error, "model_id": model_id,
        }

    try:
        image = image_loader(sample)
        scale = max(max(image.width, image.height) / max_size, 1)
        image_resized = resize_image(image, max_size)
        image_url = encode_data_url(image_resized)
        messages1 = [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": image_url}},
            {"type": "text", "text": cur_prompt},
        ]}]
        output1 = client.create(messages1, max_tokens=max_tokens, temperature=temperature)
    except Exception as e:
        return rec(f"Error: {e}", "", "", f"Error: {e}", "", True)

    boxes = extract_bboxes(output1, 1.0 if replicate_reference_bugs else scale)
    if not boxes:
        return rec(output1, "", [], output1, "", True)
    bbox = boxes[0]

    try:
        cropped = resize_image(cut_image(image, bbox), max_size)
        cropped_url = encode_data_url(cropped)
        stage2_text = (cur_prompt + INSTRUCTION_EVAL) if replicate_reference_bugs else cur_prompt
        messages2 = [
            {"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": image_url}},
                {"type": "text", "text": stage2_text},
            ]},
            {"role": "assistant", "content": [
                {"type": "text", "text": output1.split("<answer>")[0]},
                {"type": "image_url", "image_url": {"url": cropped_url}},
            ]},
        ]
        output2 = client.create(messages2, max_tokens=max_tokens, temperature=temperature)
    except Exception as e:
        output2 = f"Error: {e}"
    return rec(output1, output2, bbox, output1, output2, False)


def eval_concurrent(
    samples: Sequence[LRSGROSample],
    client: ChatClient,
    out_path: str,
    *,
    max_workers: int = 100,
    limit: Optional[int] = None,
    image_loader=None,
    **item_kw,
) -> str:
    """ThreadPoolExecutor fan-out (reference eval_model_gpt_concurrent, workers=100,
    infer_vllm.py:244-265); writes records as they complete."""
    work = list(samples)[:limit] if limit else list(samples)
    with open(out_path, "w") as f, ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = [ex.submit(process_item, s, client, image_loader=image_loader, **item_kw)
                   for s in work]
        for fut in futures:
            f.write(json.dumps(fut.result(), ensure_ascii=False) + "\n")
            f.flush()
    return out_path
