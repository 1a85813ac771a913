"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference imports nothing of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench.harness import bench

PB = bench.ROOT / "perfbench"
PROGRAM = "rcvpose_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*parts):
    return [p for p in PB.joinpath(*parts).rglob("*.py")
            if "tests" not in p.relative_to(PB).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_tops(path) & set(bench.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert PROGRAM not in tops and not tops & set(bench.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rcvpose_tpu_torch_fake", object())
    assert "rcvpose_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rcvpose_tpu.fake", object())
    assert "rcvpose_tpu" in bench.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """A small serving run in a fresh process, as ``run.py`` makes it."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(bench.ROOT)!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from perfbench.tests import small\n"
        "from perfbench.harness import bench\n"
        "out, _, _ = small.run('serve-fused-lm')\n"
        "print(json.dumps([bench.forbidden_modules(), out['correct'],\n"
        "    'rcvpose_tpu_torch' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=bench.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == [[], True, True]
