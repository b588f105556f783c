"""Nothing the benchmark runs loads JAX or the JAX package, judged by
whole top-level module names; the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("gapartnet_tpu", True), ("gapartnet_tpu.ops.voxelize", True),
    ("gapartnet_tpu_torch", False), ("gapartnet_tpu_torch.ops.subm_conv", False),
    ("jaxtyping", False), ("flaxen", False), ("optaxx.core", False),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name in harness.forbidden_loaded()) is bad


def test_a_run_loads_no_forbidden_module():
    """The harness, the reference, every traffic and metric module and the
    parts of the program a run drives, imported in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import harness, readings, tracing, work, weights, cloud, compare\n"
        "from portbench.reference import model, ops, infer\n"
        "import pathlib\n"
        "for p in sorted(pathlib.Path('portbench').glob('traffic/*.py')) + "
        "sorted(pathlib.Path('portbench').glob('metrics/*.py')):\n"
        "    harness.load_module(p)\n"
        "import gapartnet_tpu_torch.train.loop, gapartnet_tpu_torch.infer.api, "
        "gapartnet_tpu_torch.entry\n"
        "print(harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    tops = {n.split(".", 1)[0] for n in names}
    assert tops <= {"dataclasses", "math", "typing", "numpy", "torch", "portbench"}, tops
