"""The PyTorch port stands alone: it imports neither jax, flax nor the JAX
package, and neither does chip_smoke.py."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gapartnet_tpu_torch"
FORBIDDEN = ("jax", "flax", "gapartnet_tpu")

_IMPORT_ALL = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["yaml"] = None
import importlib, pkgutil
import gapartnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gapartnet_tpu_torch.__path__, "gapartnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [k for k in sys.modules if k == "gapartnet_tpu" or k.startswith("gapartnet_tpu.")]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    # every module of the slices so far was imported
    assert int(r.stdout.strip().splitlines()[-1]) >= 40


def test_training_slice_modules_exist():
    for name in ("constants.py", "ops/iou.py", "models/losses.py", "data/instances.py",
                 "train/loop.py", "csrc/subm_conv_wgrad.cu"):
        assert (PORT / name).exists(), name


def test_inference_slice_modules_exist():
    for name in ("ops/nms.py", "ops/fps.py", "ops/umeyama.py", "ops/cpd.py", "eval/ap.py",
                 "infer/api.py", "data/loader.py", "demo.py"):
        assert (PORT / name).exists(), name


def test_trainer_slice_modules_exist():
    for name in ("train/config.py", "train/yaml_reader.py", "train/trainer.py", "train/cli.py",
                 "train/ckpt_convert.py", "data/capacity.py"):
        assert (PORT / name).exists(), name


def test_train_modules_import_without_jax_or_yaml():
    """Each train/*.py module on its own, PyYAML blocked too (the card's
    machine has none)."""
    mods = sorted(f"gapartnet_tpu_torch.train.{p.stem}" for p in (PORT / "train").glob("*.py")
                  if p.stem != "__init__")
    assert len(mods) >= 6
    code = ("import sys, importlib\n"
            "for m in ('jax', 'flax', 'yaml'):\n    sys.modules[m] = None\n"
            f"for name in {mods!r}:\n    importlib.import_module(name)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_forbidden_import_anywhere_in_source():
    """Function-level imports too, which importing the modules cannot see."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
