"""Run one cell of the port's benchmark once (see portbench/harness/core.py):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Build and kernel caches stay inside the checkout.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("USE_FLAX", "0")  # a library that could load JAX by itself keeps it out
os.environ.setdefault("USE_JAX", "0")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

from portbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
