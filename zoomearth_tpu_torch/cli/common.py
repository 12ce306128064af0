"""Shared CLI plumbing: model/processor loading from an HF checkpoint directory
(port of cli/common.py)."""

from __future__ import annotations

import os
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names another.
    Raises when a CUDA device is asked for (or implied) and there is none: the port
    never moves to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: zoomearth_tpu_torch runs on the GPU unless the CPU is "
            "asked for (--device cpu, or device='cpu')"
        )
    return device


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", help="torch device to run on (cuda, cuda:1, cpu)")


def load_model_and_processor(model_path: str, *, max_pixels=None, min_pixels=None, dtype=None,
                             device=None):
    """Load (params, cfg, processor) from a local HF Qwen2.5-VL checkpoint dir, the
    weights onto `device` (None: cuda; raises without a CUDA device)."""
    from ..agent.processor import Processor
    from ..config import VLMConfig
    from ..models.params import load_hf_checkpoint
    from ..tokenizer import HFTokenizer

    device = resolve_device(device)
    if not os.path.isdir(model_path):
        sys.exit(
            f"model path {model_path!r} is not a directory — expected a local HF "
            "checkpoint (config.json + *.safetensors + tokenizer files)"
        )
    cfg = VLMConfig.from_hf_dir(model_path)
    params = load_hf_checkpoint(model_path, cfg, device=device, dtype=dtype)
    tokenizer = HFTokenizer(model_path)
    processor = Processor(tokenizer, cfg, min_pixels=min_pixels, max_pixels=max_pixels)
    return params, cfg, processor
