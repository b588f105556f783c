"""The PyTorch port stands alone: it imports neither jax, flax nor the JAX
package, and neither do chip_smoke.py and smoke_parity.py; every module also
imports without PyYAML and cv2, which the card's machine lacks, and without
sapien."""

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
sys.modules["cv2"] = None
sys.modules["sapien"] = None
import importlib, pkgutil
import gapartnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gapartnet_tpu_torch.__path__, "gapartnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import smoke_parity
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
    assert int(r.stdout.strip().splitlines()[-1]) >= 63


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


def test_configurations_slice_modules_exist():
    for name in ("ops/ball_query.py", "ops/ccl.py", "models/pointnet.py", "ops/pointnet2.py",
                 "models/pointnet2_modules.py", "utils/visu.py"):
        assert (PORT / name).exists(), name


def test_data_tools_slice_modules_exist():
    for name in ("datagen/__init__.py", "datagen/config.py", "datagen/render_config.json",
                 "datagen/pose.py", "datagen/convert.py", "datagen/render.py", "datagen/assets.py",
                 "datagen/synthetic.py", "data/native_loader.py", "data/native/gapdata.cpp",
                 "utils/profiling.py"):
        assert (PORT / name).exists(), name


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has one of the same name in the port,
    except parallel/mesh.py, whose counterpart is parallel/dist.py, and the
    Pallas kernel ops/pallas_conv.py, whose counterpart is ops/subm_conv.py
    with its CUDA sources."""
    jax_pkg = ROOT / "gapartnet_tpu"
    renamed = {"parallel/mesh.py": "parallel/dist.py", "ops/pallas_conv.py": "ops/subm_conv.py"}
    for f in sorted(jax_pkg.rglob("*.py")) + sorted(jax_pkg.rglob("*.json")):
        rel = f.relative_to(jax_pkg).as_posix()
        assert (PORT / renamed.get(rel, rel)).exists(), rel


def test_checkpoint_tools_slice_modules_exist():
    """The tools that drive a checkpoint, as a subpackage of the port; they
    import nothing of the JAX package's tools/ either."""
    names = ("tools/__init__.py", "tools/eval_parity.py", "tools/visu.py",
             "tools/visualize_render.py")
    for name in names:
        assert (PORT / name).exists(), name
    jax_tools = {p.stem for p in (ROOT / "tools").glob("*.py")} | {"tools"}
    for name in names:
        mods = {m.split(".")[0] for m in _imported_modules(PORT / name)}
        assert not mods & (jax_tools | set(FORBIDDEN)), (name, mods & jax_tools)


def test_sustained_tools_slice_modules_exist():
    """The sustained staged-training tool and the four diagnostics built on
    its make_cfg, beside the checkpoint tools; they import nothing of the
    JAX package's tools/ either."""
    names = ("tools/sustained_run.py", "tools/confusion_diag.py", "tools/margin_diag.py",
             "tools/proposal_diag.py", "tools/valley_probe.py")
    jax_tools = {p.stem for p in (ROOT / "tools").glob("*.py")} | {"tools"}
    for name in names:
        assert (PORT / name).exists(), name
        mods = {m.split(".")[0] for m in _imported_modules(PORT / name)}
        assert not mods & (jax_tools | set(FORBIDDEN)), (name, mods & jax_tools)


# JAX tools with no counterpart in the port: the TPU-era instruments, and
# the two benchmarks that the port's own bench is to replace
UNPORTED_TOOLS = {"attribution_bench", "backbone_bench", "ccl_bench", "cluster_stage_bench",
                  "conv_microbench", "model_cluster_bench", "rulebook_bench", "stage_bench",
                  "watchdog_run", "eval_bench", "train_bench"}


def test_every_jax_tool_has_a_counterpart():
    """Each tool of tools/ that drives the JAX package has a module of the
    same name under the port's tools/, apart from UNPORTED_TOOLS; the tools
    that import nothing of it (make_splits, convert_pth_to_npz) serve the
    port as they are."""
    for f in sorted((ROOT / "tools").glob("*.py")):
        drives = any(m.split(".")[0] == "gapartnet_tpu" for m in _imported_modules(f))
        if drives and f.stem not in UNPORTED_TOOLS:
            assert (PORT / "tools" / f.name).exists(), f.name
    assert all((ROOT / "tools" / f"{name}.py").exists() for name in UNPORTED_TOOLS)


def test_data_parallel_slice_modules_exist():
    for name in ("parallel/__init__.py", "parallel/dist.py"):
        assert (PORT / name).exists(), name


def test_parallel_imports_without_jax():
    """gapartnet_tpu_torch.parallel on its own: torch and the standard
    library only, nothing of the JAX package."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml'):\n    sys.modules[m] = None\n"
            "import gapartnet_tpu_torch.parallel.dist as d\n"
            "assert d.world_size() == 1 and d.rank() == 0 and d.is_primary()\n"
            "leaked = [k for k in sys.modules if k.split('.')[0] == 'gapartnet_tpu']\n"
            "assert not leaked, leaked\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "smoke_parity.py"]
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
