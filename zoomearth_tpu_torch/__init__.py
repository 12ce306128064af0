"""PyTorch + CUDA port of zoomearth_tpu (the JAX package beside it is the reference).

Module paths mirror zoomearth_tpu: `zoomearth_tpu_torch/models/decoder.py` is the
counterpart of `zoomearth_tpu/models/decoder.py`. The package keeps its own copies of
the reference's framework-free host modules that its paths reach (config, tokenizer,
agent.prompts, agent.processor, image.geometry, image.preprocess, native, train.data,
cli.config), held equal to the reference's by tests/test_torch_host.py. It imports
torch, never jax and nothing of zoomearth_tpu.
"""
