"""Kimi-VL: the leaves the benchmark draws, and the program's config and parameter
tree built from a configuration file (the text keys of HF's `text_config` at the top
level, `vision_config`, `special_token_ids`).

The leaves are the checkpoint's tensors by their published names, each Linear weight
stored (in, out), as the program lists them (zoomearth_tpu_torch/models/kimi_vl.py):
the program's tree is built over these same tensors, the routed experts of each layer
as stacked views of the one buffer they are drawn in, and the plain reference
(portbench/reference/kimi_vl.py) reads them by name.
"""

from __future__ import annotations

from typing import Dict, List

from ..harness.weights import Leaf


def dtype_name(cfg: dict) -> str:
    return cfg.get("torch_dtype", "bfloat16")


def program_config(cfg: dict):
    """The port's KimiVLConfig with the file's numbers."""
    from zoomearth_tpu_torch.config import KimiVLConfig

    return KimiVLConfig.from_dict(cfg)


def leaves(cfg: dict) -> List[Leaf]:
    from zoomearth_tpu_torch.models.kimi_vl import hf_leaves

    return hf_leaves(program_config(cfg))


def program_tree(W: Dict, cfg: dict) -> Dict:
    """The port's parameter tree over the benchmark's tensors (no copy)."""
    from zoomearth_tpu_torch.models.kimi_vl import params_from_hf

    return params_from_hf(W, program_config(cfg))
