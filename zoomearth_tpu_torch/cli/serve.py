"""Serving CLI: OpenAI-compatible endpoint (port of cli/serve.py).

python -m zoomearth_tpu_torch.cli.serve --model MODEL_DIR --port 8000 --max_model_len 2048 \
    [--device cuda] [--quantize int8]
Runs on the CUDA device unless --device names another; without a CUDA device and
without --device cpu it raises.
"""

from __future__ import annotations

import argparse

from ..serve.engine import ServingEngine
from ..serve.server import OpenAIServer
from .common import add_device_arg, load_model_and_processor


def main(argv=None):
    p = argparse.ArgumentParser(description="ZoomEarth OpenAI-compatible server (PyTorch port)")
    p.add_argument("--model", required=True, help="local HF checkpoint directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_model_len", type=int, default=2048)
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--served_model_name", default="zoomearth-tpu")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="weight-only int8 for the decoder (the layout only: without a W8A16 "
                   "kernel it decodes no faster; validate accuracy for your checkpoint first)")
    add_device_arg(p)
    from .config import parse_with_yaml

    args = parse_with_yaml(p, argv)

    params, cfg, processor = load_model_and_processor(args.model, device=args.device)
    if args.quantize == "int8":
        from ..ops.quant import quantize_decoder_int8

        params = quantize_decoder_int8(params)
    engine = ServingEngine(
        params, cfg, max_slots=args.max_slots, max_seq_len=args.max_model_len,
        decode_chunk=args.decode_chunk,
    )
    server = OpenAIServer(
        engine, processor, model_name=args.served_model_name,
        host=args.host, port=args.port,
    )
    server.start()
    print(f"serving {args.served_model_name} on {args.host}:{server.port}")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
