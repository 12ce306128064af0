"""Training-metric sinks: jsonl (always), TensorBoard and wandb (optional) (the port's own
copy of zoomearth_tpu/utils/metrics_sinks.py).

The reference logs through accelerate's tensorboard tracker + wandb
(SFT.py:333-339, run_scripts/train_grpo.sh:7,58 WANDB_MODE=offline). Here the jsonl
file stays the source of truth (hermetic, diffable) and the optional sinks mirror it:
TensorBoard via torch.utils.tensorboard when it imports, wandb only when the package
is importable (zero-egress images don't ship it — it degrades to a
no-op with a one-time notice).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence


class MetricsLogger:
    """Fan-out metric writer: jsonl + optional tensorboard/wandb."""

    def __init__(
        self,
        output_dir: str,
        *,
        report_to: Sequence[str] = ("jsonl",),
        run_name: Optional[str] = None,
        wandb_project: Optional[str] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if "jsonl" in report_to:
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if "tensorboard" in report_to:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))
            except Exception as e:  # torch missing/broken: degrade, never crash training
                print(f"[metrics] tensorboard sink unavailable: {e}")
        if "wandb" in report_to:
            try:
                import wandb

                mode = os.environ.get("WANDB_MODE", "offline")
                self._wandb = wandb.init(
                    project=wandb_project or "zoomearth-tpu", name=run_name,
                    dir=output_dir, mode=mode, reinit=True,
                )
            except Exception as e:
                print(f"[metrics] wandb sink unavailable: {e}")

    def log(self, metrics: Dict, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **metrics}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))}, step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
