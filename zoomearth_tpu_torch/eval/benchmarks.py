"""Benchmark registry + job runner: the lighteval-over-Slurm equivalent, local-first
(the port's own copy of zoomearth_tpu/eval/benchmarks.py, with a registry of its own
whose jobs run the port's CLIs, zoomearth_tpu_torch.cli.infer and .eval).

Reference shape (open_r1/utils/evaluation.py): `register_lighteval_task` builds a
name -> task-spec dict (:27-45), `SUPPORTED_BENCHMARKS`/`get_lighteval_tasks` expose
it (:48-59), and `run_benchmark_jobs` resolves `training_args.benchmarks` (with
"all") and submits one detached job per benchmark via sbatch (:62-104). The port
assumes no Slurm and ships no math-benchmark datasets; the registered tasks are
the repo's own eval pipelines (LRS-GRO infer + score), and "submission" is either a
detached subprocess (the sbatch analog) or a jsonl job queue an external scheduler
can drain (train/callbacks.py::BenchmarkCallback writes through this module).

Custom suites register exactly like reference custom lighteval tasks:

    register_benchmark("my_suite", data_file="my.jsonl", image_folder="imgs/",
                       extra_infer_args=("--limit", "512"))
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class BenchmarkSpec:
    """One registered benchmark: the eval pipeline to run against a checkpoint."""

    name: str
    data_file: str  # LRS-GRO-schema jsonl (train/data.py reader)
    image_folder: str = ""
    extra_infer_args: Sequence[str] = ()
    score: bool = True  # follow inference with the scorer (cli/eval.py)


BENCHMARKS: Dict[str, BenchmarkSpec] = {}


def register_benchmark(name: str, *, data_file: str, image_folder: str = "",
                       extra_infer_args: Sequence[str] = (), score: bool = True) -> None:
    """reference register_lighteval_task (evaluation.py:27-45)."""
    BENCHMARKS[name] = BenchmarkSpec(name, data_file, image_folder,
                                     tuple(extra_infer_args), score)


def get_benchmarks() -> List[str]:
    """reference get_lighteval_tasks/SUPPORTED_BENCHMARKS (evaluation.py:58-62)."""
    return list(BENCHMARKS.keys())


# Default registrations: the LRS-GRO suite (the repo's only on-disk benchmark) at
# full and smoke sizes; data paths resolve at run time relative to --data_file
# overrides, so these are templates more than absolute paths.
register_benchmark("lrs_gro", data_file="dataset/LRS_GRO/test.jsonl", image_folder="image")
register_benchmark("lrs_gro_mini", data_file="dataset/LRS_GRO/test.jsonl",
                   image_folder="image", extra_infer_args=("--limit", "256"))


def build_job(benchmark: str, ckpt_dir: str, *, step: int = 0,
              out_dir: str = "results", data_file: Optional[str] = None,
              image_folder: Optional[str] = None) -> dict:
    """Job spec for one benchmark x checkpoint: infer then (optionally) score.
    data_file/image_folder override the registered template paths (a training run
    points the suite at its own dataset copy)."""
    spec = BENCHMARKS[benchmark]
    exp = f"{benchmark}-step{step:06d}"
    # cli/infer writes {out_dir}/{exp_name}{rank}.jsonl (reference per-rank
    # convention, infer.py:165); jobs run single-process, so score rank 0's file
    results = os.path.join(out_dir, f"{exp}0.jsonl")
    infer_cmd = [
        sys.executable, "-m", "zoomearth_tpu_torch.cli.infer",
        "--model_name", ckpt_dir,
        "--data_file", data_file or spec.data_file,
        "--image_folder", image_folder if image_folder is not None else spec.image_folder,
        "--exp_name", exp,
        "--out_dir", out_dir,
        *spec.extra_infer_args,
    ]
    job = {
        "benchmark": benchmark,
        "step": step,
        "checkpoint": ckpt_dir,
        "cmd": infer_cmd,
        "created_at": time.time(),
    }
    if spec.score:
        job["score_cmd"] = [sys.executable, "-m", "zoomearth_tpu_torch.cli.eval",
                            "--results_file", results]
    return job


def run_benchmark_jobs(benchmarks: Sequence[str], ckpt_dir: str, *, step: int = 0,
                       output_dir: str = ".", run_now: bool = False,
                       queue_file: str = "benchmark_jobs.jsonl",
                       data_file: Optional[str] = None,
                       image_folder: Optional[str] = None) -> List[dict]:
    """reference run_benchmark_jobs (evaluation.py:96-104): resolve "all", then one
    job per benchmark — detached subprocess when run_now (the sbatch analog), else
    appended to the job queue for an external runner. Unknown names raise, like the
    reference's ValueError for unsupported benchmarks."""
    names = list(benchmarks)
    if names == ["all"]:
        names = get_benchmarks()
    unknown = [n for n in names if n not in BENCHMARKS]
    if unknown:
        raise ValueError(f"unknown benchmark(s) {unknown}; supported: {get_benchmarks()}")
    os.makedirs(output_dir, exist_ok=True)
    jobs = []
    for name in names:
        job = build_job(name, ckpt_dir, step=step, out_dir=output_dir,
                        data_file=data_file, image_folder=image_folder)
        with open(os.path.join(output_dir, queue_file), "a") as f:
            f.write(json.dumps(job) + "\n")
        if run_now:
            subprocess.Popen(job["cmd"], stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL, start_new_session=True)
        jobs.append(job)
    return jobs
