"""Checkpoint / resume with torch files + training_info.json (port of
train/checkpoints.py, where orbax wrote the trees).

The reference's layout and contract (its two mechanisms, accelerate save_state with
training_info.json for SFT, SFT.py:208-226, and HF Trainer checkpoint-* directories
for GRPO, grpo_jsonl.py:1006-1009, in one implementation): save(step) writes
checkpoint-{step}/ with the parameter tree (params.pt), the optimizer's state
(opt_state.pt) and meta.json, and points training_info.json beside them at it;
latest() finds the newest complete checkpoint; restore() loads a checkpoint onto the
templates' devices and dtypes. The trees may hold dict leaves (a LoRA tree's {"w", "a",
"b", "s"}); the optimizer state is SFTOptimizer's state_dict, SFT's or GRPO's.

On a mesh the files hold full values in the JAX layout, as orbax's global arrays do
in the JAX package: the loop gathers the tree and the optimizer's state onto rank 0
(joining a tensor axis's head-aligned pieces of the ViT's fused q|k|v back,
parallel/mesh.py), which alone writes, and restore(mesh=, specs=) keeps each rank's
pieces of what it reads (parallel/mesh.local_slice). A checkpoint written on a mesh
restores on one device and the other way round.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.params import map_tree, tree_leaves
from ..parallel.mesh import local_slice, map_with_spec


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def save(self, step: int, params, opt_state=None, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write checkpoint-{step}/ (params, opt_state when given, then meta.json, whose
        presence marks the checkpoint complete) and training_info.json."""
        ckpt_dir = self._dir(step)
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(map_tree(lambda t: t.detach(), params), os.path.join(ckpt_dir, "params.pt"))
        if opt_state is not None:
            torch.save(opt_state, os.path.join(ckpt_dir, "opt_state.pt"))
        info = {"step": step, "latest_checkpoint": ckpt_dir}
        if extra:
            info.update(extra)
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump(info, f)
        # training_info.json mirrors the reference's resume pointer (SFT.py:211-219)
        with open(os.path.join(self.output_dir, "training_info.json"), "w") as f:
            json.dump(info, f)
        return ckpt_dir

    def latest(self) -> Optional[int]:
        """Newest checkpoint step (reference auto-detect, grpo_jsonl.py:1006-1009)."""
        steps = []
        for d in glob.glob(os.path.join(self.output_dir, "checkpoint-*")):
            m = re.match(r".*checkpoint-(\d+)$", d)
            if m and os.path.exists(os.path.join(d, "meta.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, params_template, load_opt_state: bool = True, *, mesh=None,
                specs=None) -> Tuple[Any, Any, Dict]:
        """Load checkpoint-{step}: (params, opt_state, meta). Each parameter leaf goes
        onto its template leaf's device and dtype (the saved tree must have the
        template's structure and shapes; on a mesh, `specs` from param_shardings, the
        template holds this rank's shards and each saved leaf is sliced to them). The
        optimizer state, where asked for and saved, comes onto the device of the
        template's first leaf, full (SFTOptimizer.load_state_dict keeps a rank's
        slices and casts its moments to each parameter's dtype); else None."""
        ckpt_dir = self._dir(step)
        device = tree_leaves(params_template)[0].device
        saved = torch.load(os.path.join(ckpt_dir, "params.pt"), map_location=device, weights_only=True)
        if mesh is not None:
            saved = map_with_spec(lambda t, s: local_slice(t, s, mesh), saved, specs)
        params = _onto(saved, params_template, ckpt_dir)
        opt_state = None
        opt_path = os.path.join(ckpt_dir, "opt_state.pt")
        if load_opt_state and os.path.exists(opt_path):
            opt_state = torch.load(opt_path, map_location=device, weights_only=True)
        with open(os.path.join(ckpt_dir, "meta.json")) as f:
            meta = json.load(f)
        return params, opt_state, meta


def _onto(saved, template, where: str):
    """The saved tree with each leaf on its template leaf's device and dtype."""
    if isinstance(template, dict):
        if set(saved) != set(template):
            raise ValueError(f"{where}: saved keys {sorted(saved)} differ from the template's {sorted(template)}")
        return {k: _onto(saved[k], v, where) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{where}: a saved list of {len(saved)} where the template has {len(template)}")
        return [_onto(a, b, where) for a, b in zip(saved, template)]
    if saved.shape != template.shape:
        raise ValueError(f"{where}: a saved leaf of shape {tuple(saved.shape)} where the template's is "
                         f"{tuple(template.shape)}")
    return saved.to(device=template.device, dtype=template.dtype)
