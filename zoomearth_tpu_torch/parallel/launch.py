"""Start the ranks of one multi-process run on this host, each a fresh Python process,
and bound them: every rank gets a wall limit, and the whole group is killed as soon
as one rank fails or the limit passes, so no rank is left waiting in a collective
for a peer that died.

    run_ranks("package.module:function", world, kwargs, timeout_s=...)

calls function(rank, world, coordinator, **kwargs) in each rank's process, where
coordinator is "127.0.0.1:<port>" on a port bound to 0 first (the module may also
be named by the path of its file, "dir/worker.py:function"). As a module,

    python -m zoomearth_tpu_torch.parallel.launch package.module:function RANK WORLD ADDR JSON

is that call in one process (what run_ranks starts).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, *, timeout_s: float,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> List[str]:
    """Run `target` ("module:function") in `world` processes; returns each rank's
    output (stdout and stderr together). Raises RuntimeError, with the outputs' tails,
    when a rank exits non-zero or the wall limit passes; the other ranks are killed
    first."""
    addr = f"127.0.0.1:{free_port()}"
    payload = json.dumps(kwargs or {})
    full_env = dict(os.environ if env is None else env)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    full_env["PYTHONPATH"] = repo + os.pathsep + full_env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="zt_ranks_") as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, "-m", __name__, target, str(r), str(world), addr, payload],
                                  stdout=f, stderr=subprocess.STDOUT, env=full_env, cwd=cwd,
                                  start_new_session=True)
                 for r, f in enumerate(files)]
        deadline = time.time() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.time() > deadline:
                    failed = f"the ranks ran past their limit of {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            _kill(procs)
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{o[-6000:]}" for r, o in enumerate(outs))
        raise RuntimeError(f"{failed}; the group was killed\n{tails}")
    return outs


def main(argv: List[str]) -> None:
    target, rank, world, addr, payload = argv
    module, name = target.rsplit(":", 1)
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(os.path.basename(module)[:-3], module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    fn = getattr(mod, name)
    fn(int(rank), int(world), addr, **json.loads(payload))


if __name__ == "__main__":
    main(sys.argv[1:])
