"""Interactive demo: single-image two-stage zoom-QA (port of cli/demo.py).

Usage: python -m zoomearth_tpu_torch.cli.demo --model MODEL_DIR --image IMG --prompt "..." [--device cuda]
Runs on the CUDA device unless --device names another (raises when there is none).
"""

from __future__ import annotations

import argparse

from ..agent.episode import run_episodes
from ..runtime.generate import GenerationConfig, Generator
from .common import add_device_arg, load_model_and_processor


def main(argv=None):
    from PIL import Image

    p = argparse.ArgumentParser(description="ZoomEarth demo (PyTorch port): two-stage zoom QA")
    p.add_argument("--model", required=True, help="local HF checkpoint directory")
    p.add_argument("--image", required=True)
    p.add_argument("--prompt", default="Are there any building on the top-right island?")
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--stage1_max_size", type=int, default=1024)  # demo.py:132 uses 1024
    add_device_arg(p)
    args = p.parse_args(argv)

    params, cfg, processor = load_model_and_processor(args.model, device=args.device)
    generator = Generator(params, cfg, max_cache_len=4096)
    image = Image.open(args.image).convert("RGB")
    (result,) = run_episodes(
        generator, processor, [args.prompt], [image],
        stage1_max_size=args.stage1_max_size,
        gen=GenerationConfig(max_new_tokens=args.max_new_tokens, temperature=0.0),
    )
    # the stage-2 output when a crop happened, else stage 1's
    print(result.stage2 if not result.error else result.stage1)


if __name__ == "__main__":
    main()
