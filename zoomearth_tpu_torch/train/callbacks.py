"""Checkpoint-save callbacks: HF-format export + benchmark job triggering (port of
train/callbacks.py).

Local-first equivalents of the reference's hub/benchmark plumbing
(utils/callbacks.py:28-85 `PushToHubRevisionCallback`: on_save pushes the checkpoint
to a HF Hub branch, then submits Slurm lighteval jobs via utils/evaluation.py:17-23).
There is no hub and no Slurm here, so:

- `ExportHFCallback` writes an HF-layout checkpoint (safetensors + config) to
  `<export_dir>/<revision>-step<NNN>/`: the "push to a hub revision" with a local
  directory standing in for the hub (read back by `load_hf_checkpoint`).
- `BenchmarkCallback` records a runnable benchmark job per save: the port's eval
  pipeline (`zoomearth_tpu_torch.cli.infer` then `zoomearth_tpu_torch.cli.eval`)
  against the saved checkpoint, appended to `benchmark_jobs.jsonl` for an external
  runner or, with run_now, spawned as a detached subprocess right away (the Slurm
  submission's analog).

Wire into the training loop via `callbacks=[...]`; each is called as
`cb.on_save(step, ckpt_dir, params)`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional, Sequence

# The benchmarks a save can queue (the reference's lighteval task registry,
# evaluation.py:27-62): the LRS-GRO suite, in full and cut to 256 questions. Data
# paths are templates that data_file / image_folder override.
BENCHMARKS = {
    "lrs_gro": {"data_file": "dataset/LRS_GRO/test.jsonl", "image_folder": "image", "extra_infer_args": ()},
    "lrs_gro_mini": {"data_file": "dataset/LRS_GRO/test.jsonl", "image_folder": "image",
                     "extra_infer_args": ("--limit", "256")},
}


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


def benchmark_job(benchmark: str, ckpt_dir: str, *, step: int = 0, out_dir: str = "results",
                  data_file: Optional[str] = None, image_folder: Optional[str] = None) -> dict:
    """One benchmark x checkpoint job: infer, then score (the reference's
    build_job). cli.infer writes {out_dir}/{exp_name}{rank}.jsonl; a job runs one
    process, so it scores rank 0's file."""
    if benchmark not in BENCHMARKS:
        raise ValueError(f"unknown benchmark {benchmark!r}; supported: {list(BENCHMARKS)}")
    spec = BENCHMARKS[benchmark]
    exp = f"{benchmark}-step{step:06d}"
    cmd = [
        sys.executable, "-m", "zoomearth_tpu_torch.cli.infer",
        "--model_name", ckpt_dir,
        "--data_file", data_file or spec["data_file"],
        "--image_folder", image_folder if image_folder is not None else spec["image_folder"],
        "--exp_name", exp,
        "--out_dir", out_dir,
        *spec["extra_infer_args"],
    ]
    return {"benchmark": benchmark, "step": step, "checkpoint": ckpt_dir, "cmd": cmd, "created_at": time.time(),
            "score_cmd": [sys.executable, "-m", "zoomearth_tpu_torch.cli.eval", "--results_file",
                          os.path.join(out_dir, f"{exp}0.jsonl")]}


@dataclasses.dataclass
class BenchmarkCallback:
    """Queue (or launch) the LRS-GRO eval pipeline against each saved checkpoint.

    The reference submits lighteval Slurm jobs per hub revision
    (utils/evaluation.py:76-91); here the job is the port's own eval CLI pair. With
    run_now the inference subprocess detaches (fire-and-forget, like sbatch); either
    way the job spec lands in `<output_dir>/benchmark_jobs.jsonl`. "all" names every
    benchmark; an unknown name raises."""

    output_dir: str
    data_file: str = ""
    image_folder: str = ""
    benchmarks: Sequence[str] = ("lrs_gro",)
    run_now: bool = False

    def on_save(self, step: int, ckpt_dir: str, params=None) -> list:
        names = list(BENCHMARKS) if list(self.benchmarks) == ["all"] else list(self.benchmarks)
        jobs = [benchmark_job(n, ckpt_dir, step=step, out_dir=self.output_dir, data_file=self.data_file or None,
                              image_folder=self.image_folder or None) for n in names]
        os.makedirs(self.output_dir, exist_ok=True)
        for job in jobs:
            with open(os.path.join(self.output_dir, "benchmark_jobs.jsonl"), "a") as f:
                f.write(json.dumps(job) + "\n")
            if self.run_now:
                subprocess.Popen(job["cmd"], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                                 start_new_session=True)
        return jobs


def run_callbacks(callbacks, step: int, ckpt_dir: str, params=None):
    for cb in callbacks or ():
        cb.on_save(step, ckpt_dir, params)
