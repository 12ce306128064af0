"""MiMo-V2.5: the leaves the benchmark draws, and the program's config and parameter
tree built from a configuration file (the decoder's HF keys at the top level,
`vision_config` with Qwen2.5-VL's keys, `special_token_ids`, `expert_parallel`).

The leaves are the tensors by name, each Linear weight stored (in, out), as the program
lists them (zoomearth_tpu_torch/models/mimo_v2.py): the vision tower under Qwen2.5-VL's
names, of each routed layer only the experts this chip holds. The program's tree is
built over these same tensors (the held experts as stacked views of the buffer they are
drawn in), and the plain reference (portbench/reference/mimo_v2.py) reads them by name.
"""

from __future__ import annotations

from typing import Dict, List

from ..harness.weights import Leaf


def dtype_name(cfg: dict) -> str:
    return cfg.get("torch_dtype", "bfloat16")


def program_config(cfg: dict):
    """The port's MiMoV2Config with the file's numbers."""
    from zoomearth_tpu_torch.config import MiMoV2Config

    return MiMoV2Config.from_dict(cfg)


def leaves(cfg: dict) -> List[Leaf]:
    from zoomearth_tpu_torch.models.mimo_v2 import hf_leaves

    return hf_leaves(program_config(cfg))


def program_tree(W: Dict, cfg: dict) -> Dict:
    """The port's parameter tree over the benchmark's tensors (no copy but the sinks')."""
    from zoomearth_tpu_torch.models.mimo_v2 import params_from_hf

    return params_from_hf(W, program_config(cfg))
