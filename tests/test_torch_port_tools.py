"""The port's checkpoint tools (gapartnet_tpu_torch/tools/) against the JAX
package's tools/, at small widths: the same reference-layout .ckpt and data
tree through both eval_parity tools (every metric; a staged checkpoint
stopped by both), the same clouds through both visu tools (results and
panel bytes), the same render directory through both visualize_render
tools (PNG and PLY bytes); the inference API's and the demo's trainer
checkpoints; and the reference-layout writer (train/ckpt_convert.py), the
inverse of the checkpoint converter; and the card-vs-CPU request
comparison (smoke_parity.py) where an offset within tolerance moves a
point into another hash cell.

The JAX tools are imported through sys.path and run as their own command
lines (sys.argv); the config each tool builds is monkeypatched to the
small widths.  Tolerances are those of the reduced eval step's parity
test (tests/test_torch_port_trainer.py): integers and counts exactly,
accuracies within rtol 1e-6, scores, IoUs and the AP metrics computed
from them within 1e-4."""

import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gapartnet_tpu.infer import api as japi
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.train import config as jconfig
from gapartnet_tpu.train import trainer as jtrainer
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.infer import api as tapi
import smoke_parity as parity
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.tools import eval_parity, visu, visualize_render
from gapartnet_tpu_torch.train import config as tconfig
from gapartnet_tpu_torch.train import trainer as ttrainer
from gapartnet_tpu_torch.train.ckpt_convert import (
    convert_reference_state_dict,
    reference_state_dict,
    write_reference_ckpt,
)
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_ckpt_convert import make_reference_state_dict
from tests.test_torch_port_forward import SMALL
from tests.test_torch_port_infer import _check_result, patch_predict_draws
from tests.test_torch_port_trainer import N_POINTS, data_root

assert data_root  # a module fixture of the trainer tests, shared here

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
ACCU_RTOL = 1e-6
# the eval config of tests/test_torch_port_trainer.py's tiny tree
EVAL_MODEL = dict(channels=(8, 16), block_repeat=1, max_points=N_POINTS, max_proposals=16,
                  max_instances=8, level_capacity_divisors=(1, 1), min_num_points_per_proposal=3,
                  ball_query_radius=0.1, max_num_points_per_query=8,
                  max_num_points_per_query_shift=16)


def jax_tool(monkeypatch, name):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    return importlib.import_module(name)


def run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    return module.main()


def small_eval_configs(monkeypatch):
    """Both tools' Config(...) at EVAL_MODEL's widths and the tree's
    points (the data loader's workers cut to 2)."""
    for mod in (jconfig, tconfig):
        orig = mod.Config

        def small(model, data, trainer, orig=orig):
            return orig(model=dataclasses.replace(model, **EVAL_MODEL),
                        data=dataclasses.replace(data, max_points=N_POINTS, max_instances=8,
                                                 num_workers=2),
                        trainer=trainer)

        monkeypatch.setattr(mod, "Config", small)


def spy_ap_records(monkeypatch, trainer_module):
    """Records what each APEvaluator.add of `trainer_module` is given:
    (scores, classes, cloud index, IoUs) of a batch's kept proposals."""
    records = []

    class Spy(trainer_module.APEvaluator):
        def add(self, scores, classes, sample_idx, ious, instance_sem_labels):
            records.append(tuple(np.asarray(a) for a in (scores, classes, sample_idx, ious)))
            return super().add(scores, classes, sample_idx, ious, instance_sem_labels)

    monkeypatch.setattr(trainer_module, "APEvaluator", Spy)
    return records


def init_state_dict(cfg_kw, seed=0):
    """The JAX model's init at `cfg_kw` (seed `seed`, as GAPartNetInference
    draws it) as the port's state_dict."""
    jinf = japi.GAPartNetInference(cfg=JaxConfig(**cfg_kw), seed=seed)
    import jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jinf.variables))


def save_reference_ckpt(path, sd):
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(("all_accu", "pixel_accu")):
            np.testing.assert_allclose(got[k], w, rtol=ACCU_RTOL, err_msg=k)
        elif "AP@50" in k or k.endswith("mAP"):
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.fixture(scope="module")
def eval_ckpts(tmp_path_factory):
    """Reference-layout .ckpt files: make_reference_state_dict's random
    tensors, the JAX init's weights through chip_smoke's writer (proposals
    survive the score filter), and the staged file without the NPCS
    branch."""
    d = tmp_path_factory.mktemp("ckpts")
    sd = make_reference_state_dict(channels=EVAL_MODEL["channels"], block_repeat=1)
    save_reference_ckpt(d / "rand.ckpt", sd)
    save_reference_ckpt(d / "staged.ckpt", {k: v for k, v in sd.items() if not k.startswith("npcs")})
    write_reference_ckpt(d / "init.ckpt", init_state_dict(EVAL_MODEL), EVAL_MODEL["channels"],
                         block_repeat=1)
    return d


@pytest.mark.parametrize("ckpt", ["rand", "init"])
def test_eval_parity_matches_jax_tool(data_root, eval_ckpts, tmp_path, monkeypatch, ckpt, capsys):
    """The same .ckpt and tree, exact clustering (the default), batch 2:
    every metric the JAX tool logs, within the stated tolerances, and the
    kept proposals each batch hands to the AP evaluator (classes and
    clouds exactly, scores and IoUs within 1e-4); both append one line to
    parity_metrics.jsonl and print the sorted metrics."""
    small_eval_configs(monkeypatch)
    want_records = spy_ap_records(monkeypatch, jtrainer)
    got_records = spy_ap_records(monkeypatch, ttrainer)
    argv = ["--data", str(data_root), "--ckpt", str(eval_ckpts / f"{ckpt}.ckpt"), "--batch", "2"]
    jtool = jax_tool(monkeypatch, "eval_parity")
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    run_jax_main(monkeypatch, jtool, argv)
    want = json.loads((tmp_path / "jax" / "parity_metrics.jsonl").read_text())
    jax_out = capsys.readouterr().out
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = eval_parity.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    (line,) = (tmp_path / "port" / "parity_metrics.jsonl").read_text().splitlines()
    assert json.loads(line) == {"step": 0, **got}
    want.pop("step")
    # with exact clustering the port also counts the sets whose CCL its
    # iteration cap cut off, a counter the JAX tool does not have: 0 here
    extra = {f"{split}/counters/ccl_exact_unconverged" for split in ttrainer.SPLITS}
    assert extra <= set(got) and all(got[k] == 0 for k in extra)
    _check_metrics({k: v for k, v in got.items() if k not in extra}, want)
    printed = [s for s in port_out.splitlines()
               if s.startswith("  ") and s.split(":")[0].strip() not in extra]
    assert [s.split(":")[0] for s in printed] == [s.split(":")[0] for s in jax_out.splitlines()
                                                  if s.startswith("  ")]
    assert len(got_records) == len(want_records) == 3 * 2   # 3 splits of 2 batches
    for (gs, gc, gi, gio), (ws, wc, wi, wio) in zip(got_records, want_records):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gio, wio, rtol=TOL, atol=TOL)
    if ckpt == "init":   # proposals were kept and scored
        assert sum(len(r[0]) for r in got_records) > 0


def test_eval_parity_staged_checkpoint_stops_like_jax(data_root, eval_ckpts, tmp_path,
                                                      monkeypatch):
    """Without the NPCS branch the JAX tool fails at its first forward
    (flax finds no npcs_unet parameter) and writes no metrics; the port's
    stops before evaluating, naming the missing modules."""
    small_eval_configs(monkeypatch)
    argv = ["--data", str(data_root), "--ckpt", str(eval_ckpts / "staged.ckpt"), "--batch", "2"]
    jtool = jax_tool(monkeypatch, "eval_parity")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Exception, match="npcs_unet"):
        run_jax_main(monkeypatch, jtool, argv)
    with pytest.raises(ValueError, match=r"\['npcs_head', 'npcs_unet'\]"):
        eval_parity.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "parity_metrics.jsonl").exists()


def test_eval_parity_flags_and_device(monkeypatch, capsys):
    """The JAX tool's flags letter for letter plus --device; --splits is
    parsed and unused; the config is the JAX tool's; cuda without a card
    raises; --help keeps the trust note."""
    args = eval_parity.parse_args(["--data", "d", "--ckpt", "c.ckpt", "--splits", "val",
                                   "--bf16", "--clustering", "hash", "--batch", "3"])
    assert (args.spatial_order, args.splits, args.device) == ("xyz", ["val"], "cuda")
    cfg = eval_parity.build_config(args)
    assert cfg.model.conv_compute_dtype == "bfloat16" and cfg.model.clustering_impl == "hash"
    assert cfg.data.val_batch_size == 3 and cfg.data.nopart_path == str(Path("d") / "nopart.txt")
    assert cfg.data.auto_capacity is False and cfg.model.channels == GAPartNetConfig().channels
    assert eval_parity.build_config(eval_parity.parse_args(
        ["--data", "d", "--ckpt", "c"])).model.clustering_impl == "exact"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_parity.main(["--data", "d", "--ckpt", "c.ckpt"])
    with pytest.raises(SystemExit):
        eval_parity.parse_args(["--help"])
    assert "weights_only=False" in capsys.readouterr().out


# visu: SMALL_CFG of the forward tests, the JAX init's weights on both sides

@pytest.fixture(scope="module")
def visu_inputs(tmp_path_factory):
    """A labelled .npz cloud of max_points points and an OBJ of 700
    colored vertices (FPS to 512) from it, jittered by a seeded draw."""
    from gapartnet_tpu.data.synthetic import synthetic_cloud

    d = tmp_path_factory.mktemp("visu")
    c = synthetic_cloud(np.random.RandomState(2), num_points=SMALL["max_points"], num_parts=4)
    np.savez(d / "Box_7_00_000.npz", xyz=c["points"][:, :3], rgb=c["points"][:, 3:],
             sem_labels=c["sem_labels"], instance_labels=c["instance_labels"],
             gt_npcs=c["gt_npcs"])
    rng = np.random.RandomState(5)
    pick = np.concatenate([np.arange(len(c["points"])), rng.choice(len(c["points"]), 188)])
    xyz = c["points"][pick, :3] * 2.0 + rng.normal(0, 0.01, (len(pick), 3)) + 0.3
    visu.write_obj(d / "scan.obj", xyz, c["points"][pick, 3:])
    with open(d / "scan.obj", "a") as f:
        f.write("vt 0.5 0.5\nv 9 9 9 0 0 0\n")   # vertices after a vt are not read
    return d


def test_load_obj_points_matches_jax(visu_inputs, monkeypatch):
    jtool = jax_tool(monkeypatch, "visu")
    got = visu.load_obj_points(str(visu_inputs / "scan.obj"))
    want = jtool.load_obj_points(str(visu_inputs / "scan.obj"))
    assert got.dtype == want.dtype == np.float32 and got.shape == (700, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["npz", "obj"])
def test_visu_matches_jax_tool(visu_inputs, tmp_path, monkeypatch, source):
    """Both tools at SMALL_CFG with the same weights (the JAX tool's seed-0
    init; the port's from a trainer checkpoint of them, through --ckpt) and
    the same RANSAC draws: the FPS indices, the prediction and every panel
    file, byte for byte."""
    import cv2  # noqa: F401  (this container has it; the panels are compared)

    monkeypatch.setattr(japi, "GAPartNetConfig", lambda: JaxConfig(**SMALL))
    monkeypatch.setattr(tapi, "GAPartNetConfig", lambda: GAPartNetConfig(**SMALL))
    ckpt = tmp_path / "last"
    torch.save({"model": init_state_dict(SMALL)}, ckpt)
    patch_predict_draws(monkeypatch)
    flag = ["--input", str(visu_inputs / "Box_7_00_000.npz")] if source == "npz" else [
        "--obj", str(visu_inputs / "scan.obj")]

    jtool = jax_tool(monkeypatch, "visu")
    seen = {}
    orig_predict, orig_fps = japi.GAPartNetInference.predict, japi.fps_downsample

    def predict(self, pts, *a, **kw):
        seen["points"], seen["result"] = pts, orig_predict(self, pts, *a, **kw)
        return seen["result"]

    def fps(*a, **kw):
        seen["index"] = orig_fps(*a, **kw)
        return seen["index"]

    monkeypatch.setattr(japi.GAPartNetInference, "predict", predict)
    monkeypatch.setattr(japi, "fps_downsample", fps)
    run_jax_main(monkeypatch, jtool, flag + ["--out", str(tmp_path / "jax")])

    got = visu.main(flag + ["--ckpt", str(ckpt), "--device", "cpu", "--out", str(tmp_path / "port")])
    np.testing.assert_array_equal(got.points, seen["points"])
    if source == "obj":
        np.testing.assert_array_equal(got.index, seen["index"])
        assert got.name == "scan" and len(got.index) == SMALL["max_points"] and not got.gt
    else:
        assert got.index is None and got.name == "Box_7_00_000" and set(got.gt) == {
            "sem_gt", "ins_gt", "npcs_gt"}
    _check_result(got.result, seen["result"])
    assert len(got.result.proposal_scores) > 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert len(files) == (7 if source == "obj" else 10)
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_visu_without_cv2_or_card(visu_inputs, tmp_path, monkeypatch):
    """Without cv2 the writing step raises naming cv2 (it never skips in
    silence) after the prediction; without a card cuda raises."""
    monkeypatch.setattr(tapi, "GAPartNetConfig", lambda: GAPartNetConfig(**SMALL))
    r = visu.run(input=str(visu_inputs / "Box_7_00_000.npz"), device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        visu.write_panels(str(tmp_path / "out"), r)
    assert not (tmp_path / "out").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            visu.run(input=str(visu_inputs / "Box_7_00_000.npz"))


# the inference API and the demo with a trainer checkpoint

def _trainer_ckpt(tmp_path, cfg, seed):
    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.train.loop import adam

    model = make_model(cfg, "cpu", seed=seed)
    mgr = ttrainer.CkptManager(str(tmp_path / "checkpoints"))
    mgr.save(model, adam(model.named_parameters(), 1e-3), epoch=0, score=1.0)
    return model, tmp_path / "checkpoints" / "last"


def test_inference_ckpt_path_equals_warm_start(tmp_path):
    cfg = GAPartNetConfig(**SMALL)
    model, last = _trainer_ckpt(tmp_path, cfg, seed=4)
    inf = tapi.GAPartNetInference(cfg, ckpt_path=str(last), device="cpu")
    warm = GAPartNet(cfg)
    assert ttrainer.load_warm_start(warm, str(last)) == []
    got, want = inf.model.state_dict(), warm.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], model.state_dict()[k]), k
    with pytest.raises(ValueError, match="not both"):
        tapi.GAPartNetInference(cfg, state_dict=want, ckpt_path=str(last), device="cpu")
    with pytest.raises(RuntimeError, match=r"Error\(s\) in loading state_dict"):   # strict
        tapi.GAPartNetInference(GAPartNetConfig(**dict(SMALL, channels=(8, 16))),
                                ckpt_path=str(last), device="cpu")


def test_demo_ckpt_equals_weights(tmp_path):
    """The demo with --ckpt (a trainer checkpoint at the flagship widths)
    writes the result of --weights with the same model's state_dict; the
    two flags exclude each other."""
    from gapartnet_tpu_torch import demo

    model, last = _trainer_ckpt(tmp_path, GAPartNetConfig(), seed=6)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    rng = np.random.RandomState(3)
    np.save(tmp_path / "depth.npy", np.where(rng.rand(30, 40) > 0.2, rng.rand(30, 40) + 1.0, 0.0))
    np.save(tmp_path / "K.npy", np.array([[50.0, 0, 20], [0, 50.0, 15], [0, 0, 1]]))
    frame = ["--depth", str(tmp_path / "depth.npy"), "--K", str(tmp_path / "K.npy"),
             "--device", "cpu"]
    demo.main(frame + ["--ckpt", str(last), "--out", str(tmp_path / "ckpt")])
    demo.main(frame + ["--weights", str(tmp_path / "model.pt"), "--out", str(tmp_path / "pt")])
    got, want = (np.load(tmp_path / d / "demo_result.npz") for d in ("ckpt", "pt"))
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(SystemExit):
        demo.main(frame + ["--ckpt", str(last), "--weights", str(tmp_path / "model.pt")])


# visualize_render

@pytest.fixture(scope="module")
def render_dir(tmp_path_factory):
    """One rendered view in the converter's layout: depth, segmentation,
    NPCS, metafile, bbox and rgb."""
    import cv2

    d = tmp_path_factory.mktemp("rendered")
    rng = np.random.RandomState(11)
    h, w, name = 48, 64, "Box_100_0_0"
    depth = np.where(rng.rand(h, w) > 0.3, rng.rand(h, w) + 1.0, 0.0).astype(np.float32)
    sem = rng.randint(-2, 4, (h, w))
    ins = rng.randint(-2, 6, (h, w))
    for sub in ("depth", "segmentation", "npcs", "metafile", "bbox", "rgb"):
        (d / sub).mkdir()
    np.savez(d / "depth" / f"{name}.npz", depth_map=depth)
    np.savez(d / "segmentation" / f"{name}.npz", semantic_segmentation=sem,
             instance_segmentation=ins)
    np.savez(d / "npcs" / f"{name}.npz", npcs_map=(rng.rand(h, w, 3) * 2 - 1).astype(np.float32))
    K = [60.0, 0, w / 2, 0, 60.0, h / 2, 0, 0, 1]
    meta = {"camera_intrinsic": K, "world2camera_rotation": np.eye(3).ravel().tolist(),
            "camera2world_translation": [0.05, -0.02, -1.5]}
    (d / "metafile" / f"{name}.json").write_text(json.dumps(meta))
    corners = rng.rand(8, 3) * 0.4 - 0.2
    (d / "bbox" / f"{name}.json").write_text(json.dumps(
        {"link_0": {"bbox": corners.tolist()}, "link_1": {"bbox": (corners * 0.5).tolist()}}))
    cv2.imwrite(str(d / "rgb" / f"{name}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return d, name


def test_visualize_render_matches_jax_tool(render_dir, tmp_path, monkeypatch):
    """Both tools on the same render directory with --view3d (headless:
    PLY export): every PNG and PLY byte-equal."""
    d, name = render_dir
    jtool = jax_tool(monkeypatch, "visualize_render")
    argv = ["--render_dir", str(d), "--name", name, "--view3d"]
    run_jax_main(monkeypatch, jtool, argv + ["--out", str(tmp_path / "jax")])
    visualize_render.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert {f"{name}_{k}" for k in ("depth.png", "sem.png", "ins.png", "npcs.png", "bbox.png",
                                    "pc_world.ply", "bboxes.ply")} == set(files)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    np.testing.assert_array_equal(visualize_render.COLOR20, jtool.COLOR20)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            visualize_render.main(argv + ["--out", str(tmp_path / "cuda")])


# the reference-layout writer (train/ckpt_convert.py)

@pytest.mark.parametrize("spatial_order", ["xyz", "zyx"])
@pytest.mark.parametrize("channels,block_repeat", [((8, 16), 2), ((8, 16, 24), 1)])
def test_reference_writer_round_trips(channels, block_repeat, spatial_order, tmp_path):
    """The writer is the inverse of convert_reference_state_dict, bit for
    bit, in both spatial orders; its names and shapes are
    make_reference_state_dict's, and so is a round trip of that."""
    ref = make_reference_state_dict(channels=channels, block_repeat=block_repeat)
    port = convert_reference_state_dict(ref, channels=channels, block_repeat=block_repeat,
                                        spatial_order=spatial_order)
    model = GAPartNet(GAPartNetConfig(channels=channels, block_repeat=block_repeat))
    model.load_state_dict(port, strict=True)
    written = reference_state_dict(model.state_dict(), channels, block_repeat, spatial_order)
    assert {k: tuple(v.shape) for k, v in written.items()} == {
        k: v.shape for k, v in ref.items()}
    for k, v in ref.items():
        assert written[k].dtype == torch.float32 and np.array_equal(written[k].numpy(), v), k
    path = tmp_path / "ref.ckpt"
    write_reference_ckpt(path, port, channels, block_repeat, spatial_order)
    back = eval_parity.load_weights(str(path), tconfig.Config(
        model=GAPartNetConfig(channels=channels, block_repeat=block_repeat),
        data=tconfig.DataConfig(), trainer=tconfig.TrainerConfig()), spatial_order)
    assert sorted(back) == sorted(port)
    for k, v in port.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_reference_writer_staged_and_leftovers():
    """Without the NPCS branch the writer writes none of it; a tensor it
    cannot place raises."""
    sd = convert_reference_state_dict(make_reference_state_dict(channels=(8, 16)),
                                      channels=(8, 16))
    staged = {k: v for k, v in sd.items() if not k.startswith("npcs")}
    written = reference_state_dict(staged, (8, 16))
    assert not any(k.startswith("npcs") for k in written) and "score_head.weight" in written
    with pytest.raises(ValueError, match="not written"):
        reference_state_dict({**sd, "extra.weight": torch.zeros(2)}, (8, 16))


# the card-vs-CPU request comparison (smoke_parity.py), when an offset within the
# forward's tolerance moves a shifted point into another hash cell

@pytest.fixture(scope="module")
def overflowing_request():
    """A CPU request of the SMALL model whose hash node table overflows (64
    nodes per set), and the smallest offset change, below the forward's
    tolerance, that moves one shifted point into another cell and changes
    the node count: (inference, points, request, (point, axis, signed
    step), tolerance)."""
    from gapartnet_tpu_torch.data.synthetic import synthetic_cloud
    from gapartnet_tpu_torch.ops.voxelize import div_const

    cfg = GAPartNetConfig(**{**SMALL, "hash_node_capacity": 64})
    inf = tapi.GAPartNetInference(cfg, seed=0, auto_capacity=True, device="cpu")
    pts = synthetic_cloud(np.random.RandomState(2), num_points=SMALL["max_points"],
                          num_parts=4)["points"].astype(np.float32)
    req = inf._request(pts)
    assert int(req.out.counters["ccl_node_overflow"].sum()) > 0
    n = len(pts)
    xyz = torch.from_numpy(pts[:, :3])
    lab = req.out.sem_preds[0, :n].tolist()
    valid = (req.out.sem_preds[0, :n] > 0).repeat(2)
    side = cfg.ball_query_radius / 3.0 ** 0.5
    both = torch.cat([xyz, xyz + req.out.offset_preds[0, :n]])
    lo = torch.where(valid[:, None], both, torch.tensor(1e9)).amin(dim=0) - side
    q = div_const(both - lo, side)[n:]
    cells = torch.floor(q).int()
    frac = q - cells
    nodes = {}
    for i in range(n):
        if valid[n + i]:
            key = tuple(cells[i].tolist()) + (lab[i],)
            nodes[key] = nodes.get(key, 0) + 1
    tol = parity.FORWARD_RTOL * float(req.out.offset_preds.abs().max())
    moves = sorted((float(f if s < 0 else 1 - f) * side, i, a, s)
                   for i in range(n) if valid[n + i]
                   for a in range(3) for s, f in ((-1, frac[i, a]), (1, frac[i, a])))
    for dist, i, a, s in moves:
        old = tuple(cells[i].tolist()) + (lab[i],)
        new = list(old)
        new[a] += s
        if dist > 0 and (nodes[old] > 1) != (tuple(new) in nodes):
            step = s * (dist + 1e-7)
            assert abs(step) < tol / 2
            return inf, pts, req, (i, a, step), tol
    raise AssertionError("no point within the tolerance of a cell face changes the node count")


def _fake_card_request(inf, pts, offsets, reported=None, proposals=None):
    """A request whose clustering ran on `offsets` (the CPU model's heads
    otherwise), reporting `reported` offsets (default `offsets`) and, if
    given, other `proposals`."""
    with torch.no_grad():
        out = inf.model(inf._wrap_points(pts), do_cluster=True, do_score=True, do_npcs=True,
                        cluster_offset_override=offsets)
    out = dataclasses.replace(out, offset_preds=offsets if reported is None else reported)
    if proposals is not None:
        out = dataclasses.replace(out, proposals=proposals)
    keep, result, jobs, fits = parity.cpu_post(inf, pts, out, None)
    return tapi.Request(out, keep, result, jobs, fits, None, None)


@pytest.mark.parametrize("case", ["moved", "beyond_tolerance", "unreported", "other_proposals"])
def test_compare_requests_replays_the_clustering(overflowing_request, case, capsys):
    """A shifted point moved into another hash cell by an offset change
    within the forward's tolerance changes the node overflow: the
    comparison then holds the card's integers against the CPU's clustering
    of the card's offsets and passes.  It fails on an offset change beyond
    the tolerance, on an overflow change with no point moved (the card
    clustered on offsets it did not report), and on proposals that the CPU's
    clustering of the card's offsets does not give."""
    inf, pts, req, (i, a, step), tol = overflowing_request
    offs = req.out.offset_preds.clone()
    offs[0, i, a] += step if case != "beyond_tolerance" else 3 * tol * np.sign(step)
    card = _fake_card_request(
        inf, pts, offs, reported=req.out.offset_preds if case == "unreported" else None,
        proposals=req.out.proposals if case == "other_proposals" else None)
    assert not torch.equal(card.out.counters["ccl_node_overflow"],
                           req.out.counters["ccl_node_overflow"])
    if case == "moved":
        assert parity.compare_requests(case, card, inf, pts) == "replay"
        log = capsys.readouterr().out
        assert "another hash cell on the card: 1 of" in log
        assert "equal the CPU's clustering of the card's sem_preds and offsets" in log
        return
    match = {"beyond_tolerance": "offset_preds: card vs CPU",
             "unreported": "no point in another cell",
             "other_proposals": "CPU clustering of the card's"}[case]
    with pytest.raises(AssertionError, match=match):
        parity.compare_requests(case, card, inf, pts)
