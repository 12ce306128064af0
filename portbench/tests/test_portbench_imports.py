"""Nothing the benchmark runs imports JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the plain reference imports
nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from .helpers import bench_root

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zoomearth_tpu"}


def imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_module_names_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in imported_names(PACKAGE / path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "zoomearth_tpu_torch" not in tops


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference.zoom_episode, "
                            "portbench.work.model_flops, portbench.work.attention")
    assert not loaded & (FORBIDDEN | {"zoomearth_tpu_torch"})


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    bench = bench_root(tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench.tests.helpers import run\n"
            f"from pathlib import Path\nrun(Path({str(bench)!r}), 'tiny.lrsgro', trace=1)")
    loaded = _modules_after(code)
    assert "zoomearth_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "qwen3b.lrsgro_pipelined", "--seed",
                          str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
