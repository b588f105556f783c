"""The port's dataset generation (gapartnet_tpu_torch/datagen/) against the
JAX package's: the same seeded inputs through both.  Host NumPy is the same
code, so every comparison here is exact (tolerance 0): pose math, the
render helpers, the converter, generated asset files (byte for byte),
rendered maps, and the ingested .npz arrays with their FPS indices (the
port's FPS on the CPU, the JAX one jitted on the CPU, bucket-padded)."""

import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest

from gapartnet_tpu.datagen import assets as jassets
from gapartnet_tpu.datagen import config as jconfig
from gapartnet_tpu.datagen import convert as jconvert
from gapartnet_tpu.datagen import pose as jpose
from gapartnet_tpu.datagen import render as jrender
from gapartnet_tpu.datagen import synthetic as jsynthetic
from gapartnet_tpu_torch.datagen import assets as tassets
from gapartnet_tpu_torch.datagen import config as tconfig
from gapartnet_tpu_torch.datagen import convert as tconvert
from gapartnet_tpu_torch.datagen import pose as tpose
from gapartnet_tpu_torch.datagen import render as trender
from gapartnet_tpu_torch.datagen import synthetic as tsynthetic

PER_CATEGORY = {"Box": 1, "Remote": 1, "Microwave": 1}
SMALL_VIEW = dict(width=160, height=160, num_surface_samples=20000)


def assert_same(got, want, where="value"):
    """Exact equality of nested dicts / lists / arrays / scalars, dtypes too."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), \
            (where, got, want)


def assert_same_tree(got_dir, want_dir):
    """Every file under want_dir exists under got_dir with the same bytes."""
    want_files = sorted(p.relative_to(want_dir) for p in Path(want_dir).rglob("*") if p.is_file())
    got_files = sorted(p.relative_to(got_dir) for p in Path(got_dir).rglob("*") if p.is_file())
    assert got_files == want_files and want_files
    for rel in want_files:
        assert filecmp.cmp(Path(got_dir) / rel, Path(want_dir) / rel, shallow=False), rel


def assert_same_npz(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert_same(got[k], want[k], f"{os.path.basename(str(want_path))}:{k}")


@pytest.fixture(scope="module")
def asset_dirs(tmp_path_factory):
    """The three archetypes, written by the JAX package and by the port."""
    root = tmp_path_factory.mktemp("synth")
    want = jsynthetic.generate_assets(str(root / "jax"), PER_CATEGORY, seed=11)
    got = tsynthetic.generate_assets(str(root / "port"), PER_CATEGORY, seed=11)
    return got, want


def test_config_tables_equal():
    for name in ("TARGET_GAPARTS", "PARTNET_OBJECT_CATEGORIES", "AKB48_OBJECT_CATEGORIES",
                 "PARTNET_CAMERA_POSITION_RANGE", "AKB48_CAMERA_POSITION_RANGE", "BACKGROUND_RGB",
                 "WIDTH", "HEIGHT", "FOV_X_DEG", "FOV_Y_DEG", "NEAR", "FAR", "MAX_INSTANCE_NUM"):
        assert_same(getattr(tconfig, name), getattr(jconfig, name), name)
    # the datagen class list keeps the reference's name for part class 9
    assert tconfig.TARGET_GAPARTS[8] == "hinge_handle"


@pytest.mark.parametrize("seed", [0, 11])
def test_generate_assets_byte_identical(asset_dirs, tmp_path, seed):
    if seed == 11:
        got, want = asset_dirs
    else:
        want = jsynthetic.generate_assets(str(tmp_path / "jax"), PER_CATEGORY, seed=seed)
        got = tsynthetic.generate_assets(str(tmp_path / "port"), PER_CATEGORY, seed=seed)
    assert [os.path.basename(d) for d in got] == [os.path.basename(d) for d in want]
    for g, w in zip(got, want):
        assert_same_tree(g, w)


def test_pose_functions_equal():
    rng = np.random.RandomState(5)
    for _ in range(3):
        axis, angle = rng.randn(3), float(rng.uniform(-3, 3))
        assert_same(tpose.axangle2mat(axis, angle), jpose.axangle2mat(axis, angle))
        b1 = rng.randn(8, 3)
        b2 = b1 @ jpose.axangle2mat(rng.randn(3), 0.7).T + rng.randn(3)
        assert_same(tpose.rotation_from_corresponding_boxes(b1, b2),
                    jpose.rotation_from_corresponding_boxes(b1, b2))
    joints = {
        "j_root": dict(type="fixed", parent="world", child="base"),
        "j1": dict(type="prismatic", parent="base", child="link1"),
        "j2": dict(type="revolute", parent="link1", child="link2"),
        "j3": dict(type="continuous", parent="link2", child="link3"),
        "j4": dict(type="fixed", parent="link1", child="link4"),
    }
    states = {j: dict(origin=rng.randn(3), axis=rng.randn(3)) for j in joints}
    targets = {ln: dict(category_id=i, bbox=rng.randn(8, 3).astype(np.float32))
               for i, ln in enumerate(("link2", "link3", "link4"))}
    qpos = {j: float(rng.uniform(-1, 1)) for j in joints}
    posed = tpose.fk_part_bboxes(targets, joints, states, qpos, "world")
    assert_same(posed, jpose.fk_part_bboxes(targets, joints, states, qpos, "world"))
    for v in posed.values():
        assert_same(tpose.npcs_rts_from_bbox(v["bbox"]), jpose.npcs_rts_from_bbox(v["bbox"]))
    depth = (rng.rand(24, 32) + 1.0).astype(np.float32)
    inst = rng.randint(-2, 3, (24, 32)).astype(np.int32)
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    args = (depth, inst, {0: "link2", 1: "link3", 2: "link4"}, posed, K,
            jpose.axangle2mat(rng.randn(3), 0.4), rng.randn(3))
    assert_same(tpose.npcs_map_from_bboxes(*args), jpose.npcs_map_from_bboxes(*args))


def test_render_helpers_equal(asset_dirs, tmp_path):
    got_dirs, _ = asset_dirs
    ids = tmp_path / "ids.txt"
    ids.write_text("Box 90001\nRemote 90002\nMicrowave 7\n")
    for target in ("90002", 7, "404"):
        assert trender.get_id_category(target, str(ids)) == jrender.get_id_category(target, str(ids))
    for d in got_dirs:
        joints = trender.read_joints_from_urdf_file(d, tassets.ANNOTATION_URDF)
        assert_same(joints, jrender.read_joints_from_urdf_file(d, jassets.ANNOTATION_URDF))
        assert_same(trender.sample_joint_qpos(joints, np.random.RandomState(3)),
                    jrender.sample_joint_qpos(joints, np.random.RandomState(3)))
        assert_same(trender.load_target_links(d, "link_annotation_gapartnet.json"),
                    jrender.load_target_links(d, "link_annotation_gapartnet.json"))
    cam = (10, 40, 120, 240, 2.5, 4.0)
    assert_same(trender.get_cam_pos(*cam, np.random.RandomState(2)),
                jrender.get_cam_pos(*cam, np.random.RandomState(2)))
    rng = np.random.RandomState(4)
    seg = rng.randint(0, 5, (20, 30)).astype(np.uint16)
    depth = np.where(rng.rand(20, 30) > 0.2, 1.5, 0.0)
    vis = {1: "door", 2: "door", 3: "handle", 4: "unseen"}
    link_pose = {"door": {"category_id": 3}, "handle": {"category_id": 0}, "gone": {"category_id": 1}}
    assert_same(trender.seg_maps_from_visual_ids(seg, vis, link_pose, depth),
                jrender.seg_maps_from_visual_ids(seg, vis, link_pose, depth))
    rgb = (rng.rand(20, 30, 3) * 255).astype(np.uint8)
    assert_same(trender.add_background_color(rgb, depth), jrender.add_background_color(rgb, depth))


def test_save_render_equal(tmp_path):
    rng = np.random.RandomState(6)
    rgb = (rng.rand(12, 16, 3) * 255).astype(np.uint8)
    depth = rng.rand(12, 16).astype(np.float32)
    sem = rng.randint(-2, 9, (12, 16)).astype(np.int32)
    ins = rng.randint(-2, 3, (12, 16)).astype(np.int32)
    npcs = rng.rand(12, 16, 3).astype(np.float32)
    boxes = {"link_0": dict(bbox=rng.rand(8, 3), category_id=np.int64(2), instance_id=0)}
    meta = dict(model_id="90001", width=16, height=12, joint_qpos={"j": 0.5})
    for mod, sub in ((trender, "port"), (jrender, "jax")):
        mod.save_render(str(tmp_path / sub), "Box_90001_00_000", rgb, depth, sem, ins, npcs,
                        boxes, meta)
    got, want = tmp_path / "port", tmp_path / "jax"
    for rel in ("bbox/Box_90001_00_000.json", "metafile/Box_90001_00_000.json"):
        assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel
    image = sorted(p.name for p in (want / "rgb").iterdir())
    assert sorted(p.name for p in (got / "rgb").iterdir()) == image
    assert (got / "rgb" / image[0]).read_bytes() == (want / "rgb" / image[0]).read_bytes()
    for sub in ("depth", "segmentation", "npcs"):    # zip members carry a time stamp
        assert_same_npz(got / sub / "Box_90001_00_000.npz", want / sub / "Box_90001_00_000.npz")


def test_sapien_functions_raise_import_error():
    assert not trender.HAVE_SAPIEN
    calls = (
        lambda: trender.set_all_scene("d", "m.urdf", np.ones(3), 8, 8, {}),
        lambda: trender.render_one_image("partnet", 1, 0, 0, "d", "ids.txt", "out"),
        lambda: trender.render_all("partnet", "d", "ids.txt", "out"),
    )
    for call in calls:
        with pytest.raises(ImportError, match="sapien"):
            call()


def _labelled_frame(rng, h=48, w=64):
    depth = np.where(rng.rand(h, w) > 0.1, rng.rand(h, w) + 1.5, 0.0).astype(np.float32)
    sem = np.full((h, w), -1, np.int32)
    ins = np.full((h, w), -1, np.int32)
    sem[: h // 3], ins[: h // 3] = 2, 0
    sem[h // 2: h // 2 + 6, : w // 2], ins[h // 2: h // 2 + 6, : w // 2] = 5, 2
    sem[depth == 0], ins[depth == 0] = -2, -2
    rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    npcs = (rng.rand(h, w, 3) - 0.5).astype(np.float32)
    K = np.array([[70.0, 0, w / 2], [0, 70.0, h / 2], [0, 0, 1]])
    return rgb, depth, sem, ins, npcs, K


def test_convert_functions_equal():
    rng = np.random.RandomState(8)
    frame = _labelled_frame(rng)
    got = tconvert.backproject_labeled(*frame)
    assert_same(got, jconvert.backproject_labeled(*frame))
    assert_same(tconvert.world_space_to_ball_space(got[0]),
                jconvert.world_space_to_ball_space(got[0]))
    ins = np.array([-100, 4, 4, 1, -100, 7, 1], np.int32)
    assert_same(tconvert.recompact_instance_labels(ins), jconvert.recompact_instance_labels(ins))


@pytest.mark.parametrize("n,num_points", [(1024, 256), (3000, 512), (2999, 2999), (100, 128)])
def test_fps_indices_equal(n, num_points):
    """The JAX package pads to a power-of-two bucket; the port does not."""
    pts = np.random.RandomState(n).rand(n, 3) * 2 - 1
    want = jconvert.fps_indices(pts, num_points)
    got = tconvert.fps_indices(pts, num_points, device="cpu")
    if want is None:
        assert got is None
    else:
        assert_same(got, want)


def test_fps_indices_cuda_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.fps_indices(np.zeros((10, 3)), 4)


def test_sample_and_save_equal(tmp_path):
    frame = _labelled_frame(np.random.RandomState(9))
    for mod, sub, kw in ((tconvert, "port", dict(device="cpu")), (jconvert, "jax", {})):
        assert mod.sample_and_save("Box_1_00_000", *frame, str(tmp_path / sub),
                                   num_points=700, save_pth=False, **kw) == 0
        assert mod.sample_and_save("Box_2_00_000", *frame, str(tmp_path / sub),
                                   num_points=10 ** 5, save_pth=False, **kw) == -1
    got, want = tmp_path / "port", tmp_path / "jax"
    assert_same_npz(got / "pth" / "Box_1_00_000.npz", want / "pth" / "Box_1_00_000.npz")
    for rel in ("meta/Box_1_00_000.txt", "gt/Box_1_00_000.txt"):
        assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


def test_sample_and_save_pth(tmp_path):
    import torch

    frame = _labelled_frame(np.random.RandomState(10))
    tconvert.sample_and_save("Box_1_00_000", *frame, str(tmp_path), num_points=300,
                             device="cpu")
    npz = np.load(tmp_path / "pth" / "Box_1_00_000.npz")
    pth = torch.load(tmp_path / "pth" / "Box_1_00_000.pth", weights_only=False)
    for k, v in zip(("xyz", "rgb", "sem_labels", "instance_labels", "gt_npcs", "pixel_idx"), pth):
        assert_same(v, npz[k], k)


@pytest.mark.parametrize("arch", list(PER_CATEGORY))
def test_render_view_maps_equal(asset_dirs, arch):
    i = list(PER_CATEGORY).index(arch)
    got = tassets.render_view_maps(asset_dirs[0][i], seed=3, **SMALL_VIEW)
    want = jassets.render_view_maps(asset_dirs[1][i], seed=3, **SMALL_VIEW)
    assert (want["sem"] >= 0).any() and (want["depth"] > 0).sum() > 1000
    assert_same(got, want)


def test_render_view_maps_focus_equal(asset_dirs):
    kw = dict(SMALL_VIEW, focus_category_ids=(0, 3), distance_scale=0.5)
    got = tassets.render_view_maps(asset_dirs[0][2], seed=4, **kw)
    want = jassets.render_view_maps(asset_dirs[1][2], seed=4, **kw)
    assert want["valid_links"]
    assert_same(got, want)
    # an asset without the requested class: no maps
    assert_same(tassets.render_view_maps(asset_dirs[0][1], seed=4, **kw),
                jassets.render_view_maps(asset_dirs[1][1], seed=4, **kw))


def test_render_asset_view_equal(asset_dirs, tmp_path):
    """The end-to-end ingest at num_points 512: the .npz arrays exactly,
    FPS indices (pixel_idx) included; the rendered maps saved beside them."""
    for i, arch in enumerate(PER_CATEGORY):
        got = tassets.render_asset_view(asset_dirs[0][i], str(tmp_path / "port"), seed=5,
                                        num_points=512, save_maps=True, device="cpu",
                                        **SMALL_VIEW)
        want = jassets.render_asset_view(asset_dirs[1][i], str(tmp_path / "jax"), seed=5,
                                         num_points=512, save_maps=True, **SMALL_VIEW)
        assert got == want and want is not None, arch
        assert_same_npz(tmp_path / "port" / "pth" / f"{got}.npz",
                        tmp_path / "jax" / "pth" / f"{want}.npz")
        for sub in ("depth", "segmentation", "npcs"):
            assert_same_npz(tmp_path / "port" / sub / f"{got}.npz",
                            tmp_path / "jax" / sub / f"{want}.npz")
        for rel in (f"meta/{got}.txt", f"gt/{got}.txt", f"bbox/{got}.json"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    # too few foreground pixels for num_points: no sample
    assert tassets.render_asset_view(asset_dirs[0][0], str(tmp_path / "port"), seed=5,
                                     num_points=10 ** 6, device="cpu", **SMALL_VIEW) is None


def test_ingest_asset_equal(asset_dirs, tmp_path):
    kw = dict(num_views=2, seed=7, num_points=256, width=96, height=96,
              num_surface_samples=8000)
    got = tassets.ingest_asset(asset_dirs[0][0], str(tmp_path / "port"), device="cpu", **kw)
    want = jassets.ingest_asset(asset_dirs[1][0], str(tmp_path / "jax"), **kw)
    assert got == want and len(want) == 2
    for name in want:
        assert_same_npz(tmp_path / "port" / "pth" / f"{name}.npz",
                        tmp_path / "jax" / "pth" / f"{name}.npz")


def _add_point_sample(asset_dir, rng):
    """A PartNet-style point_sample/ and result.json for a synthetic asset:
    one leaf per OBJ file, the points on the OBJ's vertices in the y-up frame."""
    objs = sorted(p.stem for p in (Path(asset_dir) / "textured_objs").glob("*.obj"))
    leaves = [dict(id=i + 1, objs=[o]) for i, o in enumerate(objs)]
    (Path(asset_dir) / "result.json").write_text(json.dumps([dict(id=0, children=leaves)]))
    verts, labels = [], []
    for leaf, obj in zip(leaves, objs):
        v, _, _ = jassets.load_obj_mesh(str(Path(asset_dir) / "textured_objs" / f"{obj}.obj"))
        verts.append(v + rng.randn(*v.shape) * 1e-3)
        labels += [leaf["id"]] * len(v)
    world = np.concatenate(verts)
    yup = world @ np.linalg.inv(jassets.YUP_TO_WORLD.T)
    rgb = rng.rand(len(yup), 3)
    ps = Path(asset_dir) / "point_sample"
    ps.mkdir()
    np.savetxt(ps / "pts-10000.pts", np.concatenate([yup, rgb], axis=1))
    np.savetxt(ps / "label-10000.txt", np.asarray(labels), fmt="%d")


def test_point_sample_ingestion_equal(asset_dirs):
    """leaf_to_link, load_point_sample and canonical_cloud on one asset
    given a point_sample/ directory (written into both trees alike)."""
    for d in (asset_dirs[0][0], asset_dirs[1][0]):
        if not os.path.isdir(os.path.join(d, "point_sample")):
            _add_point_sample(d, np.random.RandomState(12))
    got_dir, want_dir = asset_dirs[0][0], asset_dirs[1][0]
    assert_same(tassets.leaf_to_link(got_dir), jassets.leaf_to_link(want_dir))
    assert_same(tassets.load_point_sample(got_dir), jassets.load_point_sample(want_dir))
    got, want = tassets.canonical_cloud(got_dir), jassets.canonical_cloud(want_dir)
    assert (want["instance_labels"] >= 0).any()
    assert_same(got, want)


def test_demo_asset_branch_on_cpu(asset_dirs, tmp_path, capsys, monkeypatch):
    """`python -m gapartnet_tpu_torch.demo --asset DIR --device cpu` at the
    flagship config, the view rendered at SMALL_VIEW."""
    import functools

    from gapartnet_tpu_torch import demo

    monkeypatch.setattr(tassets, "render_view_maps",
                        functools.partial(tassets.render_view_maps, **SMALL_VIEW))
    demo.main(["--asset", asset_dirs[0][0], "--device", "cpu", "--seed", "3",
               "--out", str(tmp_path / "out")])
    printed = capsys.readouterr().out
    assert "sem agreement vs render labels" in printed
    r = np.load(tmp_path / "out" / "demo_result.npz")
    maps = jassets.render_view_maps(asset_dirs[1][0], seed=3, **SMALL_VIEW)
    assert len(r["sem_preds"]) == len(r["point_index"]) == int((maps["depth"] > 0).sum())
    assert np.isfinite(r["npcs_map"]).all() and r["trans"].shape == (4,)
