"""The sustained staged-training tool and its four diagnostics
(gapartnet_tpu_torch/tools/: sustained_run, confusion_diag, margin_diag,
proposal_diag, valley_probe) against the JAX package's tools/, at small
widths:

  * sustained_run's pieces: scan_class_alpha on every branch (equal
    floats), make_cfg and dump_cfg (equal configs and JSON), best_ckpt on
    crafted names, build_dataset + append_zoom_views with the renderer
    replaced in both packages by one seeded writer that also skips draws
    (equal split trees: the same files, each array's bytes equal), every
    workflow of main with fit and test replaced by recorders (the same
    configs in the same order, the same files), run_test's zero-overflow
    contract;
  * the diagnostics from one checkpoint (the JAX one written by its
    CkptManager, the port's through params_from_jax): the same text, or
    for margin_diag the same rows; the JAX proposal_diag stops at its
    `state.replace` (tools/proposal_diag.py:98) unless its TrainState is
    given a `replace`, which only this test does;
  * valley_probe with fit replaced by a recorder;
  * (slow) --two-phase for real in both packages.

The JAX tools are imported through sys.path and run as their own command
lines (sys.argv).  The diagnostics and the slow run build their config
through make_cfg with `Config` monkeypatched to the widths of
tests/test_torch_port_tools.py's tiny tree, in float32: the tools' bf16
conv compute is held to the JAX package by tests/test_torch_port_bf16.py,
where the JAX program is compiled to round where it says, which the JAX
tools here do not ask for.  Tolerances: integers, counts and text from
them exactly; floats within 1e-4 (the reduced eval step's and the fit's
tolerance in tests/test_torch_port_trainer.py)."""

import dataclasses
import json
import os
import sys
import unittest.mock
import zipfile
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.datagen import assets as jassets
from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
from gapartnet_tpu.train import config as jconfig
from gapartnet_tpu.train import loop as jloop
from gapartnet_tpu.train import trainer as jtrainer
from gapartnet_tpu_torch.datagen import assets as tassets
from gapartnet_tpu_torch.datagen.synthetic import generate_assets
from gapartnet_tpu_torch.tools import (confusion_diag, margin_diag, proposal_diag, sustained_run,
                                       valley_probe)
from gapartnet_tpu_torch.train import config as tconfig
from gapartnet_tpu_torch.train import trainer as ttrainer
from gapartnet_tpu_torch.utils import invariants
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_torch_port_tools import EVAL_MODEL, jax_tool, run_jax_main
from tests.test_torch_port_train import _random_stats
from tests.test_torch_port_trainer import FIT_TOL, N_POINTS, data_root

assert data_root  # a module fixture of the trainer tests, shared here


@pytest.fixture(autouse=True)
def _environment():
    """Both tools' run_test set GAPARTNET_CHECKS in their own process, and
    monkeypatch.delenv of an unset variable restores nothing: every test
    here gets the environment back as it found it, so that no later test
    (the CLI's subprocess, say) inherits the variable."""
    with unittest.mock.patch.dict(os.environ):
        yield


TOL = 1e-4
SMALL_MODEL = dict(EVAL_MODEL, conv_compute_dtype="float32")
SKIP_SHARE = 0.3          # the share of the seeded writer's draws it skips


def small_configs(monkeypatch):
    """Both packages' Config(...) at SMALL_MODEL and the tiny tree's points."""
    for mod in (jconfig, tconfig):
        orig = mod.Config

        def small(model, data, trainer, orig=orig):
            return orig(model=dataclasses.replace(model, **SMALL_MODEL),
                        data=dataclasses.replace(data, max_points=N_POINTS, max_instances=8),
                        trainer=trainer)

        monkeypatch.setattr(mod, "Config", small)


def _tool_text(out, start):
    """The tool's own lines: `out` from the first line starting with `start`."""
    lines = out.splitlines()
    first = next(i for i, line in enumerate(lines) if line.startswith(start))
    return lines[first:]


# scan_class_alpha, make_cfg, dump_cfg, best_ckpt

@pytest.fixture(scope="module")
def alpha_roots(tmp_path_factory, data_root):
    """Trees for scan_class_alpha: crafted labels (a frequent, a middling,
    two rare and six absent classes, and ignored -1 labels), no train
    split at all, and the tiny synthetic tree."""
    root = tmp_path_factory.mktemp("alpha")
    d = root / "labels" / "train" / "pth"
    d.mkdir(parents=True)
    counts = {-1: 40, 0: 3000, 1: 700, 2: 90, 5: 4}
    for i, (label, n) in enumerate(counts.items()):
        np.savez(d / f"c{i}.npz", sem_labels=np.full(n, label, np.int64))
    np.savez(d / "rare.npz", sem_labels=np.array([3, 0, 0, -1]))
    (root / "empty").mkdir()
    return {"labels": root / "labels", "empty": root / "empty", "synthetic": data_root}


@pytest.mark.parametrize("root", ["labels", "empty", "synthetic"])
@pytest.mark.parametrize("kw", [{}, dict(cap=2.0), dict(power=0.5, background_alpha=0.2),
                                dict(power=0.5, cap=1.5, background_alpha=0.05, num_classes=12)],
                         ids=["default", "cap", "sqrt", "sqrt_cap"])
def test_scan_class_alpha_matches_jax(alpha_roots, monkeypatch, root, kw):
    jtool = jax_tool(monkeypatch, "sustained_run")
    got = sustained_run.scan_class_alpha(alpha_roots[root], **kw)
    want = jtool.scan_class_alpha(alpha_roots[root], **kw)
    assert got == want and all(type(v) is float for v in got)
    if root == "labels" and "cap" in kw:
        assert max(got[1:]) == kw["cap"]        # the cap bites on the rare classes


@pytest.mark.parametrize("kw", [
    {},
    dict(sem_alpha="auto", alpha_cap=3.0, bg_alpha=0.05),
    dict(sem_alpha=0.0, use_focal=False, clustering_impl="exact", schedule=(3, 4), lr=3e-4,
         batch_size=4, n_points=4096, color_jitter=0.3, pos_jitter=0.0, flip_prob=0.5,
         rotate_prob=0.0),
], ids=["default", "auto_alpha", "no_alpha_exact"])
def test_make_cfg_and_dump_cfg_match_jax(data_root, tmp_path, monkeypatch, kw):
    """Every field of the Config, and run_config.json byte for byte."""
    jtool = jax_tool(monkeypatch, "sustained_run")
    got = sustained_run.make_cfg(data_root, tmp_path, 7, "fit.jsonl", **kw)
    want = jtool.make_cfg(data_root, tmp_path, 7, "fit.jsonl", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.conv_compute_dtype == "bfloat16" and got.data.auto_capacity
    for d, tool, cfg in (("jax", jtool, want), ("port", sustained_run, got)):
        (tmp_path / d).mkdir()
        tool.dump_cfg(cfg, tmp_path / d)
    assert ((tmp_path / "port" / "run_config.json").read_bytes()
            == (tmp_path / "jax" / "run_config.json").read_bytes())


def test_best_ckpt_matches_jax(tmp_path, monkeypatch):
    jtool = jax_tool(monkeypatch, "sustained_run")
    names = ["epoch_001_mean_mAP_3.50", "epoch_002_mAP_4.00", "epoch_003_mean_mAP_2.00",
             "epoch_004_recall_gmp_9.00", "epoch_005_recall_gmp_11.50", "epoch_006_mean_mAP_x",
             "epoch_007_recall_min_99.00", "last", "notes_mean_mAP_50.00"]
    for n in names:
        (tmp_path / n).write_text("")
    for monitor, want in (("monitor_metrics/mean_mAP", "epoch_002_mAP_4.00"),
                          ("val/recall_gmp", "epoch_005_recall_gmp_11.50"),
                          ("val/recall_min", "epoch_007_recall_min_99.00"),
                          ("val/pixel_accu", None)):
        got = sustained_run.best_ckpt(tmp_path, monitor)
        ref = jtool.best_ckpt(tmp_path, monitor)
        assert (got and got.name) == (ref and ref.name) == want


# build_dataset + append_zoom_views with one seeded writer in both packages

def fake_render_asset_view(asset_dir, save_path, camera_idx=0, render_idx=0, seed=0,
                           num_points=20000, save_maps=False, device=None, **map_kwargs):
    """A seeded stand-in for render_asset_view: skips a SKIP_SHARE of the
    draws (returns None), else writes `num_points` seeded points named as
    the renderer names them, with the render arguments folded into the
    arrays."""
    rng = np.random.RandomState(seed)
    if rng.rand() < SKIP_SHARE:
        return None
    meta = json.loads((Path(asset_dir) / "meta.json").read_text())
    name = f"{meta['model_cat']}_{meta['anno_id']}_{camera_idx:02d}_{render_idx:03d}"
    tag = zlib.crc32(repr(sorted(map_kwargs.items())).encode()) % 1000
    out = Path(save_path) / "pth"
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"{name}.npz", xyz=rng.rand(num_points, 3).astype(np.float32),
             rgb=rng.rand(num_points, 3).astype(np.float32),
             sem_labels=rng.randint(-1, 10, num_points),
             instance_labels=rng.randint(-1, 5, num_points),
             gt_npcs=(rng.rand(num_points, 3) + tag).astype(np.float32))
    return name


def _tree(root):
    """{split/file: {member: bytes}} of every split's .npz files (the
    arrays' bytes: np.savez stamps each zip member with the time)."""
    tree = {}
    for split in ("train", "val", "test_intra", "test_inter"):
        for f in sorted((root / split / "pth").glob("*.npz")):
            with zipfile.ZipFile(f) as z:
                tree[f"{split}/{f.name}"] = {m: z.read(m) for m in z.namelist()}
    return tree


def _zoom_counts(out):
    """[(rendered, planned), ...] of the `zoom-rendered NAME: n/m` lines."""
    return [tuple(map(int, line.split()[-1].split("/"))) for line in out.splitlines()
            if line.startswith("zoom-rendered")]


@pytest.mark.parametrize("skip_share", [0.0, SKIP_SHARE, 0.6, 0.85])
def test_build_dataset_and_zoom_views_match_jax(tmp_path, monkeypatch, capsys, skip_share):
    """The full view plans, with a `skip_share` of the draws skipped: the
    same split trees (skips cutting the last allocation, the zoom
    shortfalls reallocated: none, partial ones, and at the largest share an
    asset with no close-up at all) and the same printed plan."""
    monkeypatch.setattr(sys.modules[__name__], "SKIP_SHARE", skip_share)
    jtool = jax_tool(monkeypatch, "sustained_run")
    seen, inter = generate_assets(str(tmp_path / "standins"), {"Box": 1, "Microwave": 1}, seed=1)
    for mod in (jtool, sustained_run):
        monkeypatch.setattr(mod, "REAL_SEEN", seen)
        monkeypatch.setattr(mod, "REAL_INTER", inter)
    for mod in (jassets, tassets):
        monkeypatch.setattr(mod, "render_asset_view", fake_render_asset_view)
    outs = {}
    for name, tool, kw in (("jax", jtool, {}), ("port", sustained_run, dict(device="cpu"))):
        root = tmp_path / name
        tool.build_dataset(root, n_points=16, seed=0, **kw)
        tool.append_zoom_views(root, n_points=16, **kw)
        outs[name] = capsys.readouterr().out.replace(str(root), "<root>")
    assert outs["port"] == outs["jax"]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert list(got) == list(want) and got == want
    counts = {s: sum(k.startswith(s + "/") for k in got) for s in ("train", "val", "test_intra",
                                                                     "test_inter")}
    assert all(counts.values()), counts
    zoom = _zoom_counts(outs["port"])
    assert len(zoom) == 7
    if not skip_share:
        assert "skipped" not in outs["port"] and all(n == m for n, m in zoom)
    else:
        # skipped distant views, and zoom shortfalls that were reallocated
        assert "skipped" in outs["port"] and any(0 < n < m for n, m in zoom)
    if skip_share > 0.8:
        assert any(n == 0 for n, _ in zoom)


def test_real_assets_lie_in_the_repository():
    """REAL_SEEN / REAL_INTER name directories inside this checkout."""
    repo = Path(__file__).resolve().parents[1]
    for d in (sustained_run.REAL_SEEN, sustained_run.REAL_INTER):
        assert Path(d).resolve().is_relative_to(repo / "assets"), d


@pytest.mark.parametrize("missing", ["REAL_SEEN", "REAL_INTER"])
def test_missing_real_asset_raises(tmp_path, monkeypatch, missing):
    """A plan's asset directory that does not exist stops build_dataset (the
    distant plan) or append_zoom_views (REAL_SEEN's close-ups) with a
    FileNotFoundError naming it, before anything is rendered."""
    seen, inter = generate_assets(str(tmp_path / "standins"), {"Box": 1, "Microwave": 1}, seed=1)
    monkeypatch.setattr(sustained_run, "REAL_SEEN", seen)
    monkeypatch.setattr(sustained_run, "REAL_INTER", inter)
    gone = str(tmp_path / "not_committed" / missing)
    monkeypatch.setattr(sustained_run, missing, gone)

    def render(*args, **kw):
        raise AssertionError("rendered before the assets were checked")

    monkeypatch.setattr(tassets, "render_asset_view", render)
    with pytest.raises(FileNotFoundError, match="not_committed/" + missing):
        sustained_run.build_dataset(tmp_path / "data", n_points=16, device="cpu")
    if missing == "REAL_SEEN":
        with pytest.raises(FileNotFoundError, match="not_committed/REAL_SEEN"):
            sustained_run.append_zoom_views(tmp_path / "data", n_points=16, device="cpu")


# main's workflows with fit and test replaced by recorders

def _recorders(trainer_module, monkeypatch, calls, wd_of):
    """fit / test recorders: each call records the Config as JSON (the
    workdir named <wd>); fit writes a monitored checkpoint of its last
    epoch and `last`, test returns metrics with zero counters."""

    def record(kind, cfg):
        text = json.dumps(dataclasses.asdict(cfg), default=str).replace(wd_of(cfg), "<wd>")
        calls.append((kind, json.loads(text)))

    def fit(cfg, device=None):
        record("fit", cfg)
        d = Path(cfg.trainer.ckpt_dir)
        d.mkdir(parents=True, exist_ok=True)
        epoch = cfg.trainer.max_epochs - 1
        slug = cfg.trainer.monitor.rsplit("/", 1)[-1]
        (d / f"epoch_{epoch:03d}_{slug}_{epoch + 0.25:.2f}").write_text("fit")
        (d / "last").write_text("fit")

    def test(cfg, device=None):
        record("test", cfg)
        return {"monitor_metrics/mean_mAP": 1.5, "val/AP@50": 2.0,
                "val/counters/ccl_node_overflow": 0.0}

    monkeypatch.setattr(trainer_module, "fit", fit)
    monkeypatch.setattr(trainer_module, "test", test)


def _prepare(wd, files):
    for name in files:
        (wd / name).parent.mkdir(parents=True, exist_ok=True)
        (wd / name).write_text("before")


WORKFLOWS = {
    "fit": ([], []),
    "two_phase": (["--two-phase", "--freeze-trunk-b", "--sem-alpha", "auto", "--epochs-a", "4",
                   "--epochs", "6"], []),
    "two_phase_ce_aug_b": (["--two-phase", "--no-focal-a", "--aug-b", "--lr-b", "5e-5",
                            "--alpha-cap", "2", "--bg-alpha", "0.2"], []),
    "auto_resume_marker": (["--two-phase", "--auto-resume"],
                           ["phase_a_done", "checkpoints_a/epoch_001_recall_gmp_0.40",
                            "checkpoints_a/last", "checkpoints/last"]),
    "auto_resume_last_a": (["--two-phase", "--auto-resume", "--epochs-a", "3"],
                           ["checkpoints_a/last"]),
    "extend": (["--extend", "9", "--schedule", "2", "3", "--color-jitter", "0.3"],
               ["checkpoints/last"]),
    "extend_a": (["--extend-a", "12", "--no-focal-a"], ["checkpoints_a/last"]),
    "test_only": (["--test-only"], ["checkpoints/epoch_003_mean_mAP_1.50",
                                    "checkpoints/epoch_004_mAP_2.00", "checkpoints/last"]),
    "test_only_exact": (["--test-only", "--clustering", "exact"],
                        ["checkpoints/epoch_003_mean_mAP_1.50", "checkpoints/last"]),
}


@pytest.mark.parametrize("workflow", list(WORKFLOWS))
def test_main_workflows_match_jax(data_root, tmp_path, monkeypatch, capsys, workflow):
    """The same fit / test calls with the same Configs, in the same order,
    and the same files written (JSON equal with the workdir named <wd>)."""
    monkeypatch.delenv("GAPARTNET_CHECKS", raising=False)
    monkeypatch.delenv("GAPARTNET_ALLOW_OVERFLOW", raising=False)
    jtool = jax_tool(monkeypatch, "sustained_run")
    flags, files = WORKFLOWS[workflow]
    calls, trees, outs = {}, {}, {}
    for name, module, extra in (("jax", jtrainer, []), ("port", ttrainer, ["--device", "cpu"])):
        wd = tmp_path / name
        wd.mkdir()
        _prepare(wd, files)
        calls[name] = []
        _recorders(module, monkeypatch, calls[name], lambda cfg, wd=wd: str(wd))
        argv = ["--workdir", str(wd), "--data", str(data_root), "--skip-render", *flags, *extra]
        if name == "jax":
            run_jax_main(monkeypatch, jtool, argv)
        else:
            sustained_run.main(argv)
        outs[name] = capsys.readouterr().out.replace(str(wd), "<wd>")
        trees[name] = {
            p.relative_to(wd).as_posix(): (json.loads(p.read_text().replace(str(wd), "<wd>"))
                                           if p.suffix == ".json" else p.read_text())
            for p in sorted(wd.rglob("*")) if p.is_file()}
    assert [k for k, _ in calls["port"]] == [k for k, _ in calls["jax"]]
    for (kind, got), (_, want) in zip(calls["port"], calls["jax"]):
        assert got == want, kind
    assert trees["port"] == trees["jax"]
    assert [line for line in outs["port"].splitlines() if not line.startswith("[")] == [
        line for line in outs["jax"].splitlines() if not line.startswith("[")]
    kinds = [k for k, _ in calls["port"]]
    assert kinds[-2:] == ["test", "test"] or workflow == "extend_a"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_run_test_contract(tmp_path, monkeypatch, capsys, package):
    """A nonzero counter raises RuntimeError after the metrics are written;
    GAPARTNET_ALLOW_OVERFLOW=1 waives it; zero counters pass.  Setting
    GAPARTNET_CHECKS there changes no check mode of the port."""
    monkeypatch.delenv("GAPARTNET_CHECKS", raising=False)
    monkeypatch.delenv("GAPARTNET_ALLOW_OVERFLOW", raising=False)
    tool, trainer = ((jax_tool(monkeypatch, "sustained_run"), jtrainer) if package == "jax"
                     else (sustained_run, ttrainer))
    metrics = {"monitor_metrics/mean_mAP": 1.0, "val/counters/ccl_node_overflow": 3.0,
               "test_inter/counters/dropped_proposals": 0.0}
    monkeypatch.setattr(trainer, "test", lambda cfg, device=None: dict(metrics))
    mode = invariants.mode()

    def cfg_fn(log_name):
        return sustained_run.make_cfg(tmp_path, tmp_path, 1, log_name)

    with pytest.raises(RuntimeError, match="val/counters/ccl_node_overflow"):
        tool.run_test(cfg_fn, tmp_path, tmp_path / "last", "last")
    assert json.loads((tmp_path / "test_metrics_last.json").read_text()) == metrics
    assert json.loads((tmp_path / "run_config.json").read_text())["trainer"]["resume_ckpt"] == str(
        tmp_path / "last")
    monkeypatch.setenv("GAPARTNET_ALLOW_OVERFLOW", "1")
    assert tool.run_test(cfg_fn, tmp_path, tmp_path / "best", "best") == metrics
    assert "OVERFLOW WAIVED" in capsys.readouterr().out
    monkeypatch.delenv("GAPARTNET_ALLOW_OVERFLOW")
    metrics["val/counters/ccl_node_overflow"] = 0.0
    tool.run_test(cfg_fn, tmp_path, tmp_path / "last", "last")
    assert invariants.mode() == mode and (package == "jax" or mode == "off")


# the diagnostics from one checkpoint

def _jax_state(seed):
    """A JAX train state at SMALL_MODEL's widths, seeded, with random
    running statistics."""
    jm = JaxModel(JaxConfig(**SMALL_MODEL))
    example = JaxBatch(**synthetic_batch(np.random.RandomState(seed), batch_size=2,
                                         num_points=N_POINTS, num_parts=3, max_instances=8))
    state = jloop.create_train_state(jm, example, jloop.adam(1e-3), seed=seed)
    stats = _random_stats(jax.tree_util.tree_map(np.asarray, state.batch_stats),
                          np.random.RandomState(seed))
    return state._replace(batch_stats=stats)


@pytest.fixture(scope="module")
def diag_ckpts(tmp_path_factory):
    """Two checkpoints of seeded weights under jax/checkpoints (the JAX
    CkptManager: epoch_000_..., epoch_001_..., last = the second) and the
    same weights under port/checkpoints (torch files of params_from_jax)."""
    root = tmp_path_factory.mktemp("diag")
    jmgr = jtrainer.CkptManager(str(root / "jax" / "checkpoints"))
    (root / "port" / "checkpoints").mkdir(parents=True)
    for epoch, seed in enumerate((3, 4)):
        state = _jax_state(seed)
        jmgr.save(state, epoch, 0.5 * epoch)
        sd = params_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
        for name in (f"epoch_{epoch:03d}_mean_mAP_{0.5 * epoch:.2f}", "last"):
            torch.save({"model": sd}, root / "port" / "checkpoints" / name)
    return root


@pytest.mark.parametrize("splits, focus", [(["val"], 1), (["val", "test_intra"], 2)])
def test_confusion_diag_matches_jax(data_root, diag_ckpts, tmp_path, monkeypatch, capsys, splits,
                                    focus):
    """The printed confusion and per-view table: identical text."""
    small_configs(monkeypatch)
    argv = ["--data", str(data_root), "--splits", *splits, "--focus-class", str(focus)]
    jtool = jax_tool(monkeypatch, "confusion_diag")
    run_jax_main(monkeypatch, jtool, argv + ["--workdir", str(tmp_path / "jax"),
                                             "--ckpt", str(diag_ckpts / "jax" / "checkpoints" / "last")])
    want = _tool_text(capsys.readouterr().out, "===")
    tables = confusion_diag.main(argv + ["--workdir", str(tmp_path / "port"), "--ckpt",
                                         str(diag_ckpts / "port" / "checkpoints" / "last"),
                                         "--device", "cpu"])
    got = _tool_text(capsys.readouterr().out, "===")
    assert got == want
    assert list(tables) == splits
    assert sum(int(agg.sum()) for agg, _ in tables.values()) > 0
    assert any(rows for _, rows in tables.values())            # a per-view table was printed


def test_margin_diag_matches_jax(data_root, diag_ckpts, monkeypatch, capsys):
    """One row per checkpoint (the two epochs, then last): the names
    exactly; mean, p50, p90, frac>0 and predfg% within TOL of the JAX tool's
    printed values, beyond half their printed step."""
    small_configs(monkeypatch)
    argv = ["--data", str(data_root), "--points", str(N_POINTS)]
    jtool = jax_tool(monkeypatch, "margin_diag")
    run_jax_main(monkeypatch, jtool, argv + ["--workdir", str(diag_ckpts / "jax")])
    want = [line.split() for line in _tool_text(capsys.readouterr().out, "ckpt")[1:]]
    rows = margin_diag.main(argv + ["--workdir", str(diag_ckpts / "port"), "--device", "cpu"])
    got = [line.split() for line in _tool_text(capsys.readouterr().out, "ckpt")[1:]]
    assert [r[0] for r in rows] == [w[0] for w in want] == [
        "epoch_000_mean_mAP_0.00", "epoch_001_mean_mAP_0.50", "last"]
    assert [g[0] for g in got] == [w[0] for w in want]
    for row, w in zip(rows, want):
        np.testing.assert_allclose(np.array(row[1:], np.float64), np.array(w[1:], np.float64),
                                   rtol=0, atol=5e-4 + TOL, err_msg=row[0])
    assert rows[0][1:] != rows[-1][1:]      # the two weights differ
    capsys.readouterr()
    assert margin_diag.main(argv + ["--workdir", str(diag_ckpts / "port"), "--device", "cpu",
                                    "--ckpts", "last", "nowhere"])[0][0] == "last"


def _replaceable_create_train_state(monkeypatch):
    """create_train_state of the JAX loop, giving its TrainState a
    `replace` (the NamedTuple's `_replace`), which tools/proposal_diag.py:98
    calls."""
    orig = jloop.create_train_state

    def patched(*args, **kw):
        state = orig(*args, **kw)

        class State(type(state)):
            def replace(self, **changes):
                return self._replace(**changes)

        return State(*state)

    monkeypatch.setattr(jloop, "create_train_state", patched)


@pytest.mark.parametrize("split, batch", [("val", 2), ("test_inter", 4)])
def test_proposal_diag_matches_jax(data_root, diag_ckpts, monkeypatch, capsys, split, batch):
    """The per-class birth/death table: identical text (every column
    counts or a ratio of counts)."""
    small_configs(monkeypatch)
    _replaceable_create_train_state(monkeypatch)
    argv = ["--data", str(data_root), "--split", split, "--batch", str(batch), "--points",
            str(N_POINTS), "--sem-alpha", "0.2"]
    jtool = jax_tool(monkeypatch, "proposal_diag")
    run_jax_main(monkeypatch, jtool, argv + ["--workdir", str(diag_ckpts / "jax")])
    want = _tool_text(capsys.readouterr().out, "split=")
    table = proposal_diag.main(argv + ["--workdir", str(diag_ckpts / "port"), "--device", "cpu"])
    got = _tool_text(capsys.readouterr().out, "split=")
    assert got[0].split(" ckpt=")[0] == want[0].split(" ckpt=")[0] == f"split={split}"
    assert got[1:] == want[1:] and len(got) == len(table) + 2
    assert table and sum(row[2] for row in table.values()) > 0     # proposals were born
    for gt, _, born, iou50, scored, kept, match_gt, _ in table.values():
        assert born >= iou50 >= match_gt and born >= scored >= kept


def test_jax_proposal_diag_stops_at_state_replace(data_root, diag_ckpts, monkeypatch):
    """Unpatched, the JAX tool raises AttributeError at its `state.replace`
    (line 98): its TrainState is a NamedTuple, which has `_replace` only."""
    small_configs(monkeypatch)
    jtool = jax_tool(monkeypatch, "proposal_diag")
    with pytest.raises(AttributeError, match="replace") as info:
        run_jax_main(monkeypatch, jtool, ["--data", str(data_root), "--workdir",
                                          str(diag_ckpts / "jax"), "--points", str(N_POINTS)])
    entry = info.traceback[-1]
    assert Path(str(entry.path)).name == "proposal_diag.py" and entry.lineno + 1 == 98


VALLEY_FLAGS = {
    "default": [],
    "overrides": ["--no-dice", "--no-focal", "--no-offset", "--aug", "--schedule", "3", "4",
                  "--sem-alpha", "auto", "--lr", "3e-4", "--batch", "4", "--epochs", "5"],
}


@pytest.mark.parametrize("flags", list(VALLEY_FLAGS))
def test_valley_probe_matches_jax(data_root, tmp_path, monkeypatch, capsys, flags):
    """fit replaced by a recorder that writes a fit.jsonl: the same Config,
    the same probe_config.json, the same printed trajectory."""
    jtool = jax_tool(monkeypatch, "valley_probe")
    lines = [{"step": 3, "train_pixel_accu": 51.234, "train_loss/loss_sem_seg": 0.5678,
              "epoch": 0},
             {"step": 3, "val/pixel_accu": 40.001, "val/recall_hinge_door": 12.345,
              "val/AP@50": 1.0}]
    calls, outs, configs = {}, {}, {}
    for name, module, extra in (("jax", jtrainer, []), ("port", ttrainer, ["--device", "cpu"])):
        wd = tmp_path / name
        calls[name] = []

        def fit(cfg, device=None, calls=calls[name], wd=wd):
            calls.append(json.loads(json.dumps(dataclasses.asdict(cfg), default=str).replace(
                str(wd), "<wd>")))
            Path(cfg.trainer.log_file).write_text("".join(json.dumps(x) + "\n" for x in lines))

        monkeypatch.setattr(module, "fit", fit)
        argv = ["--data", str(data_root), "--workdir", str(wd), "--tag", "p1",
                *VALLEY_FLAGS[flags], *extra]
        if name == "jax":
            run_jax_main(monkeypatch, jtool, argv)
        else:
            trajectory = valley_probe.main(argv)
        outs[name] = _tool_text(capsys.readouterr().out, "=== probe")
        configs[name] = json.loads((wd / "p1" / "probe_config.json").read_text().replace(
            str(wd), "<wd>"))
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 1
    assert configs["port"] == configs["jax"] == calls["port"][0]
    assert outs["port"] == outs["jax"] and len(trajectory) == 2


@pytest.mark.parametrize("tool, required", [
    ("sustained_run", ["--data", "d"]),
    ("confusion_diag", ["--ckpt", "c", "--data", "d", "--workdir", "w"]),
    ("margin_diag", ["--workdir", "w", "--data", "d"]), ("proposal_diag", ["--data", "d"]),
    ("valley_probe", ["--tag", "t", "--data", "d", "--workdir", "w"]),
])
def test_flags_match_jax_and_cuda_default(tool, required, monkeypatch):
    """Each port tool's options are the JAX tool's (option strings,
    defaults, what the type makes of sample strings, choices, required,
    nargs) plus --device, except that an option the JAX tool defaults to a
    path under /tmp is required in the port (such a default would be
    shared by every checkout on a host); --device defaults to cuda, which
    raises without a card before anything is written."""
    import argparse

    def parser_of(run):
        captured = []

        def capture(self, args=None, namespace=None):
            captured.append(self)
            raise SystemExit(0)

        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", capture)
            with pytest.raises(SystemExit):
                run()
        return captured[0]

    def parsed(type_, text):
        try:
            return type_(text)
        except ValueError:
            return ValueError

    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required, a.nargs,
                         a.type and tuple(parsed(a.type, t) for t in ("auto", "0.5", "3")))
                for a in parser._actions if a.dest != "help"}

    port = {"sustained_run": sustained_run, "confusion_diag": confusion_diag,
            "margin_diag": margin_diag, "proposal_diag": proposal_diag,
            "valley_probe": valley_probe}[tool]
    jtool = jax_tool(monkeypatch, tool)
    want = options(parser_of(lambda: run_jax_main(monkeypatch, jtool, [])))
    got = options(parser_of(lambda: port.parse_args([])))
    assert got.pop("device") == (("--device",), "cuda", None, False, None, None)
    for dest in [d for d, o in want.items() if str(o[1]).startswith("/tmp/")]:
        strings, _, choices, _, nargs, parses = want[dest]
        want[dest] = (strings, None, choices, True, nargs, parses)
    assert got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.main(required)


# the parts of a metric line that the proposal jitter moves: each package
# draws it from its own generator
JITTERED = ("loss_prop_", "total_loss", "AP", "proposal_voxels_dropped", "epoch_time_s")


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _check_close(got, want, skip=()):
    assert list(got) == list(want)
    for k, w in want.items():
        if not any(s in k for s in skip):
            np.testing.assert_allclose(got[k], w, rtol=FIT_TOL, atol=FIT_TOL, err_msg=k)


@pytest.mark.slow
def test_two_phase_run_matches_jax(data_root, tmp_path, monkeypatch):
    """--two-phase --freeze-trunk-b for real in both packages at the small
    widths, from the same initial weights (the JAX fit's first init, loaded
    into the port's first model): phase A's metric lines within FIT_TOL
    (sem and offset only: no proposal jitter); phase B, started in both
    from the JAX phase A's best checkpoint, and both tests: within FIT_TOL
    where the proposal jitter does not reach (the frozen trunk's sem and
    offset metrics, the counters), the same names elsewhere; the same
    phase-A checkpoints and marker."""
    small_configs(monkeypatch)
    monkeypatch.delenv("GAPARTNET_CHECKS", raising=False)
    # at these random weights the eval counters may be nonzero: the same in both
    monkeypatch.setenv("GAPARTNET_ALLOW_OVERFLOW", "1")
    init = []
    orig_create = jtrainer.create_train_state

    def create_train_state(*args, **kw):
        state = orig_create(*args, **kw)
        if not init:
            init.append(jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                             "batch_stats": state.batch_stats}))
        return state

    monkeypatch.setattr(jtrainer, "create_train_state", create_train_state)
    orig_make = ttrainer.make_model
    made = []

    def make_model(cfg, device, seed=0):
        model = orig_make(cfg, device, seed)
        if not made:
            model.load_state_dict(params_from_jax(init[0]))
        made.append(model)
        return model

    monkeypatch.setattr(ttrainer, "make_model", make_model)
    jwd, twd = tmp_path / "jax", tmp_path / "port"
    orig_warm = ttrainer.load_warm_start

    def load_warm_start(model, ckpt_path):
        """Phase B's warm start from the JAX phase A's checkpoint of the same
        name: the two phase A's end apart where Adam turns rounding noise
        into steps of lr (the gradient of offset_mlp0.bias, which offset_bn
        cancels, is noise: the two ends differ by 1.2e-3 there)."""
        if Path(ckpt_path).parent.name != "checkpoints_a":
            return orig_warm(model, ckpt_path)
        r = jtrainer.CkptManager.restore(str(jwd / "checkpoints_a" / Path(ckpt_path).name))
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": r["params"], "batch_stats": r["batch_stats"]})))
        return []

    monkeypatch.setattr(ttrainer, "load_warm_start", load_warm_start)
    flags = ["--data", str(data_root), "--skip-render", "--two-phase", "--freeze-trunk-b",
             "--epochs-a", "2", "--epochs", "3", "--batch", "2"]
    jtool = jax_tool(monkeypatch, "sustained_run")
    run_jax_main(monkeypatch, jtool, ["--workdir", str(jwd), *flags])
    sustained_run.main(["--workdir", str(twd), *flags, "--device", "cpu"])

    assert (twd / "phase_a_done").read_text() == (jwd / "phase_a_done").read_text() == "done"
    assert sorted(p.name for p in (twd / "checkpoints_a").iterdir()) == sorted(
        p.name for p in (jwd / "checkpoints_a").iterdir())
    want_a, got_a = _lines(jwd / "fit_phase_a.jsonl"), _lines(twd / "fit_phase_a.jsonl")
    assert len(got_a) == len(want_a) == 3          # 2 epochs, 1 validation
    for g, w in zip(got_a, want_a):
        _check_close(g, w, skip=("epoch_time_s",))
    want_b, got_b = _lines(jwd / "fit_phase_b.jsonl"), _lines(twd / "fit_phase_b.jsonl")
    assert len(got_b) == len(want_b) == 4          # 3 epochs, 1 validation
    for g, w in zip(got_b, want_b):
        _check_close(g, w, skip=JITTERED)
    for tag in ("last", "best"):
        got = json.loads((twd / f"test_metrics_{tag}.json").read_text())
        want = json.loads((jwd / f"test_metrics_{tag}.json").read_text())
        _check_close(got, want, skip=JITTERED)
    assert len(made) >= 4                            # phase A, phase B, two tests
