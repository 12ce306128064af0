"""Checkpoint-save callbacks: HF-format export + benchmark job triggering (port of
train/callbacks.py).

Local-first equivalents of the reference's hub/benchmark plumbing
(utils/callbacks.py:28-85 `PushToHubRevisionCallback`: on_save pushes the checkpoint
to a HF Hub branch, then submits Slurm lighteval jobs via utils/evaluation.py:17-23).
There is no hub and no Slurm here, so:

- `ExportHFCallback` writes an HF-layout checkpoint (safetensors + config) to
  `<export_dir>/<revision>-step<NNN>/`: the "push to a hub revision" with a local
  directory standing in for the hub (read back by `load_hf_checkpoint`).
- `BenchmarkCallback` records a runnable benchmark job per save through the
  `eval.benchmarks` registry (`run_benchmark_jobs`): the port's eval pipeline
  (`zoomearth_tpu_torch.cli.infer`, then `zoomearth_tpu_torch.cli.eval` where the
  suite scores) against the saved checkpoint, appended to `benchmark_jobs.jsonl` for
  an external runner or, with run_now, spawned as a detached subprocess right away
  (the Slurm submission's analog). A suite added with `register_benchmark` reaches it.

Wire into the training loop via `callbacks=[...]`; each is called as
`cb.on_save(step, ckpt_dir, params)`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional, Sequence


@dataclasses.dataclass
class ExportHFCallback:
    """Export an HF-format checkpoint at each save (hub revision push, local)."""

    export_dir: str
    cfg: object  # VLMConfig
    revision: str = "main"
    tokenizer_src: Optional[str] = None  # directory whose tokenizer files are copied

    def on_save(self, step: int, ckpt_dir: str, params) -> str:
        from ..models.params import save_hf_checkpoint

        out = os.path.join(self.export_dir, f"{self.revision}-step{step:06d}")
        save_hf_checkpoint(params, self.cfg, out)
        if self.tokenizer_src and os.path.isdir(self.tokenizer_src):
            for name in ("tokenizer.json", "tokenizer_config.json", "merges.txt", "vocab.json"):
                src = os.path.join(self.tokenizer_src, name)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(out, name))
        return out


@dataclasses.dataclass
class BenchmarkCallback:
    """Queue (or launch) the LRS-GRO eval pipeline against each saved checkpoint.

    The reference submits lighteval Slurm jobs per hub revision
    (utils/evaluation.py:76-91); here the job is the port's own eval CLI pair. With
    run_now the inference subprocess detaches (fire-and-forget, like sbatch); either
    way the job spec lands in `<output_dir>/benchmark_jobs.jsonl`. "all" names every
    registered benchmark; an unknown name raises."""

    output_dir: str
    data_file: str = ""
    image_folder: str = ""
    benchmarks: Sequence[str] = ("lrs_gro",)
    run_now: bool = False

    def on_save(self, step: int, ckpt_dir: str, params=None) -> list:
        """One job per registered benchmark via the eval.benchmarks registry (the
        lighteval task registry equivalent, reference evaluation.py:27-62);
        data_file/image_folder override the registered template paths."""
        from ..eval.benchmarks import run_benchmark_jobs

        return run_benchmark_jobs(
            self.benchmarks, ckpt_dir, step=step, output_dir=self.output_dir,
            run_now=self.run_now,
            data_file=self.data_file or None,
            image_folder=self.image_folder or None,
        )


def run_callbacks(callbacks, step: int, ckpt_dir: str, params=None):
    for cb in callbacks or ():
        cb.on_save(step, ckpt_dir, params)
