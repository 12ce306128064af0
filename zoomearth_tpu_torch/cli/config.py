"""YAML config support for the CLIs (reference TrlParser accepts yaml config files,
grpo_jsonl.py:1017-1019): `--config cfg.yaml` merges yaml keys as argument defaults;
explicit CLI flags still win.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def parse_with_yaml(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None):
    """Parse args with optional `--config file.yaml` providing defaults."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    known, rest = pre.parse_known_args(argv)
    if known.config:
        import yaml

        with open(known.config) as f:
            cfg = yaml.safe_load(f) or {}
        valid = {a.dest for a in parser._actions}
        unknown = set(cfg) - valid
        if unknown:
            raise SystemExit(f"unknown config keys in {known.config}: {sorted(unknown)}")
        parser.set_defaults(**cfg)
        # yaml can't satisfy `required`; drop the flag for keys the yaml provides
        for a in parser._actions:
            if a.dest in cfg:
                a.required = False
    return parser.parse_args(rest)
