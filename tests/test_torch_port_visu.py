"""Test-time visualization: the port's utils/visu.py against the JAX
package's, pixel for pixel; the port trainer's `test` with
`trainer.visualize` on the tiny config writes the panels (its refusal
without cv2 is tests/test_torch_port_cli.py's); the demo writes its
panels, or says in one line why not; the CLI's `test` runs with
`clustering_impl: exact`."""

import sys

import numpy as np
import pytest

from gapartnet_tpu.utils import visu as jvisu
from gapartnet_tpu_torch.train import trainer as ttrainer
from gapartnet_tpu_torch.utils import visu as tvisu
from tests.test_torch_port_cli import _cli
from tests.test_torch_port_trainer import _config_file, _port_cfg, data_root

assert data_root  # a module fixture of the trainer tests, shared here

PANELS = ("pc", "sem_pred", "ins_pred", "npcs_pred", "bbox_pred", "bbox_pred_pure", "sem_gt",
          "ins_gt", "npcs_gt", "bbox_gt", "bbox_gt_pure")


def _scene(seed, n=400):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.rand(n, 3) * 0.3 - 0.15, rng.rand(n, 3)], axis=1).astype(np.float32)
    corners = np.array([[s0, s1, s2] for s0 in (-1, 1) for s1 in (-1, 1) for s2 in (-1, 1)],
                       np.float32)[[0, 4, 2, 1, 6, 5, 3, 7]] * 0.1
    box = corners + np.float32([0.02, -0.01, 0.0])
    return dict(
        points=pts, trans=np.array([1.5, 0.01, -0.02, 2.0]),
        sem_preds=rng.randint(0, 10, n), ins_preds=rng.randint(0, 5, n),
        npcs_preds=rng.rand(n, 3).astype(np.float32), bboxes=[box, box * 0.5],
        sem_gt=rng.randint(0, 10, n), ins_gt=rng.randint(-1, 4, n),
        npcs_gt=rng.rand(n, 3).astype(np.float32), gt_bboxes=[box * 1.2],
        raw_img=(rng.rand(600, 700, 3) * 255).astype(np.uint8),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_panels_equal_jax(tmp_path, seed):
    """Every panel of the 12-option dump (the raw render resized), the
    grid, and the files written: equal arrays, pixel for pixel."""
    import cv2

    scene = _scene(seed)
    want = jvisu.visualize_gapartnet(str(tmp_path / "jax"), "s", "test", **scene)
    got = tvisu.visualize_gapartnet(str(tmp_path / "port"), "s", "test", **scene)
    assert list(got) == list(want) and set(got) == set(PANELS) | {"raw"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        a = cv2.imread(str(tmp_path / "port" / "test" / k / "s.png"))
        b = cv2.imread(str(tmp_path / "jax" / "test" / k / "s.png"))
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "test" / "s.png")),
                                  cv2.imread(str(tmp_path / "jax" / "test" / "s.png")))
    assert (got["bbox_pred_pure"] != 255).any()   # the boxes were drawn


def test_helpers_equal_jax():
    scene = _scene(2)
    xyz, trans = scene["points"][:, :3], scene["trans"]
    for a, b in zip(tvisu.project_points(xyz, trans), jvisu.project_points(xyz, trans)):
        np.testing.assert_array_equal(a, b)
    rgb = (scene["points"][:, 3:] * 255).astype(np.uint8)
    np.testing.assert_array_equal(tvisu.map2image(xyz, rgb, trans), jvisu.map2image(xyz, rgb, trans))
    for f in ("colorize_sem", "colorize_ins"):
        np.testing.assert_array_equal(getattr(tvisu, f)(scene["sem_preds"]),
                                      getattr(jvisu, f)(scene["sem_preds"]))
    np.testing.assert_array_equal(tvisu.colorize_npcs(scene["npcs_gt"]),
                                  jvisu.colorize_npcs(scene["npcs_gt"]))
    blank = np.full((800, 800, 3), 255, np.uint8)
    np.testing.assert_array_equal(tvisu.draw_bbox(blank.copy(), scene["bboxes"], trans),
                                  jvisu.draw_bbox(blank.copy(), scene["bboxes"], trans))
    panels = {"pc": blank, "sem_gt": blank[::-1].copy()}
    np.testing.assert_array_equal(tvisu.montage(panels, tvisu.ALL_SAVE_OPTIONS),
                                  jvisu.montage(panels, jvisu.ALL_SAVE_OPTIONS))
    assert tvisu.ALL_SAVE_OPTIONS == jvisu.ALL_SAVE_OPTIONS and tvisu.have_cv2()


def test_trainer_test_writes_panels(data_root, tmp_path):
    cfg = _port_cfg(tmp_path, data_root, tmp_path)
    cfg.trainer.visualize = True
    cfg.trainer.visualize_dir = str(tmp_path / "visu")
    cfg.trainer.visualize_sample_num = 2
    ttrainer.test(cfg, device="cpu")
    for split in ("val", "test_intra", "test_inter"):
        grids = sorted(p.name for p in (tmp_path / "visu" / split).glob("*.png"))
        assert len(grids) == 2, (split, grids)      # 3 clouds per split, the first 2 rendered
        for option in PANELS:
            assert sorted(p.name for p in (tmp_path / "visu" / split / option).iterdir()) == grids


@pytest.mark.parametrize("cv2_present", [True, False])
def test_demo_writes_panels(tmp_path, capsys, monkeypatch, cv2_present):
    """The demo on a small RGB-D frame: the five panels of the JAX demo and
    their grid; without cv2 one line saying none were written, and the
    result all the same."""
    from gapartnet_tpu_torch import demo

    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.RandomState(3)
    np.save(tmp_path / "depth.npy", np.where(rng.rand(30, 40) > 0.2, rng.rand(30, 40) + 1.0, 0.0))
    np.save(tmp_path / "K.npy", np.array([[50.0, 0, 20], [0, 50.0, 15], [0, 0, 1]]))
    np.save(tmp_path / "rgb.npy", (rng.rand(30, 40, 3) * 255).astype(np.uint8))
    out = tmp_path / "out"
    demo.main(["--depth", str(tmp_path / "depth.npy"), "--K", str(tmp_path / "K.npy"),
               "--rgb", str(tmp_path / "rgb.npy"), "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert (out / "demo_result.npz").exists()
    if cv2_present:
        for option in ("pc", "sem_pred", "ins_pred", "npcs_pred", "bbox_pred"):
            assert (out / "demo" / option / "demo.png").exists(), option
        assert (out / "demo" / "demo.png").exists() and "wrote 5 panels" in printed
    else:
        assert not (out / "demo").exists()
        assert sum("no panels written" in line for line in printed.splitlines()) == 1


def test_cli_test_with_exact_clustering(data_root, tmp_path):
    """`test` through the CLI (jax, flax and PyYAML blocked) with the
    exact clustering: it runs and prints the counters."""
    cfg_file = _config_file(tmp_path, data_root)
    r = _cli(["test", "-c", str(cfg_file), "--model.init_args.clustering_impl", "exact",
              "--model.init_args.training_schedule", "[0,0]", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    printed = dict(line.rsplit(": ", 1) for line in r.stdout.splitlines()
                   if ": " in line and not line.startswith("["))
    assert "monitor_metrics/mean_mAP" in printed
    assert float(printed["val/counters/ccl_node_overflow"]) == 0
