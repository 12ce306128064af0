"""Score a results jsonl (port of cli/eval.py; host code, touches no device).

python -m zoomearth_tpu_torch.cli.eval --results_file results/NAME0.jsonl [--json_out metrics.json]
"""

from __future__ import annotations

import argparse
import json

from ..eval.score import evaluation_metrics


def main(argv=None):
    p = argparse.ArgumentParser(description="Score LRS-GRO inference results")
    p.add_argument("--results_file", required=True)
    p.add_argument("--json_out", default=None, help="optionally dump metrics as JSON")
    args = p.parse_args(argv)
    metrics = evaluation_metrics(args.results_file, verbose=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics, f, indent=2)


if __name__ == "__main__":
    main()
