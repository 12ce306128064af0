"""Drain the benchmark job queue: the external-scheduler leg of eval/benchmarks.py
(the port's own copy of zoomearth_tpu/cli/run_benchmarks.py).

The reference hands benchmark jobs to Slurm (utils/evaluation.py sbatch submission);
the port assumes no scheduler, so BenchmarkCallback/run_benchmark_jobs append job
specs to `benchmark_jobs.jsonl` and this command plays the scheduler: it executes each
pending job (infer, then score when the spec has one) sequentially and records
{job, rc, wall_s} to a ledger. Already-ledgered jobs are skipped, so the drainer is
idempotent and can run on a cron/timer alongside training.

Usage: python -m zoomearth_tpu_torch.cli.run_benchmarks --queue jobs/benchmark_jobs.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def _job_key(job: dict) -> str:
    return f"{job.get('benchmark')}::{job.get('step')}::{job.get('checkpoint')}"


def main(argv=None):
    p = argparse.ArgumentParser(description="Execute queued benchmark jobs")
    p.add_argument("--queue", required=True, help="benchmark_jobs.jsonl path")
    p.add_argument("--ledger", default=None,
                   help="results ledger (default: <queue dir>/benchmark_results.jsonl)")
    p.add_argument("--max_jobs", type=int, default=0, help="stop after N jobs (0 = all)")
    p.add_argument("--timeout", type=float, default=0, help="per-job seconds (0 = none)")
    p.add_argument("--dry_run", action="store_true", help="list pending jobs, run nothing")
    args = p.parse_args(argv)

    ledger_path = args.ledger or os.path.join(
        os.path.dirname(args.queue) or ".", "benchmark_results.jsonl")
    done = set()
    if os.path.exists(ledger_path):
        with open(ledger_path) as f:
            done = {_job_key(json.loads(l)["job"]) for l in f if l.strip()}

    jobs = []
    with open(args.queue) as f:
        for line in f:
            if line.strip():
                job = json.loads(line)
                if _job_key(job) not in done:
                    jobs.append(job)
    if args.max_jobs:
        jobs = jobs[: args.max_jobs]
    print(f"{len(jobs)} pending job(s) ({len(done)} already done)")
    if args.dry_run:
        for job in jobs:
            print(f"  would run: {_job_key(job)}")
        return

    for job in jobs:
        t0 = time.time()
        rcs = []
        for cmd_key in ("cmd", "score_cmd"):
            cmd = job.get(cmd_key)
            if not cmd:
                continue
            print(f"[{_job_key(job)}] {cmd_key}: {' '.join(cmd)}", flush=True)
            try:
                proc = subprocess.run(cmd, timeout=args.timeout or None)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                # a hung job must be LEDGERED as failed, or a cron-driven drainer
                # re-picks it forever and never progresses past it
                print(f"[{_job_key(job)}] {cmd_key} timed out after {args.timeout}s",
                      flush=True)
                rc = -9
            rcs.append(rc)
            if rc != 0:
                break  # don't score a failed inference
        record = {"job": job, "rcs": rcs, "ok": all(r == 0 for r in rcs),
                  "wall_s": round(time.time() - t0, 1), "finished_at": time.time()}
        with open(ledger_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(f"[{_job_key(job)}] {'OK' if record['ok'] else 'FAILED'} "
              f"in {record['wall_s']}s", flush=True)


if __name__ == "__main__":
    main()
