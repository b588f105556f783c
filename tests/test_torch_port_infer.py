"""The whole slice: the port's inference API against the JAX package's.

SMALL_CFG of tests/test_model_forward.py, the JAX weights carried over by
params_from_jax, the port on the CPU.  The JAX package draws the RANSAC
samples with jax.random.choice, which torch cannot reproduce, so the
port's `ransac_samples` is patched here to return the JAX package's own
draws; given the same draws, integers must match exactly and floats (NPCS,
scores, boxes) within 1e-4.  Both sides fit their level capacities to the
input (auto_capacity) and must grow them alike on a larger cloud.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_cloud
from gapartnet_tpu.infer import api as japi
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.train.trainer import eval_capacity_config as jax_eval_capacity_config
from gapartnet_tpu_torch.config import GAPartNetConfig, eval_capacity_config
from gapartnet_tpu_torch.infer import api as tapi
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_torch_port_forward import SMALL

TOL = 1e-4
ITERS = 100


def jax_draws(mask: np.ndarray, keys, iters: int) -> np.ndarray:
    """jax.random.choice as ops/umeyama.py:84-86 draws it: one key per
    row, probabilities = the row's mask / its count."""
    def one(key, m):
        fm = m.astype(jnp.float32)
        probs = fm / jnp.maximum(fm.sum(), 1.0)
        return jax.random.choice(key, m.shape[0], shape=(iters, 5), replace=True, p=probs)

    return np.stack([np.asarray(jax.jit(one)(k, jnp.asarray(m))) for k, m in zip(keys, mask)])


def patch_predict_draws(monkeypatch, seed=0):
    """predict: keys = split(PRNGKey(seed), jobs), each row over the padded
    job width (infer/api.py:276-281)."""
    def draws(mask, max_iters, generator):
        m = mask.numpy()
        keys = jax.random.split(jax.random.PRNGKey(seed), len(m))
        return torch.from_numpy(jax_draws(m, keys, max_iters))

    monkeypatch.setattr(tapi, "ransac_samples", draws)


def patch_mask_draws(monkeypatch, owners, seed=0):
    """predict_with_masks: mask i draws with PRNGKey(seed + i) over its own
    points only (infer/api.py:372-379); the port pads them to one width."""
    def draws(mask, max_iters, generator):
        m = mask.numpy()
        out = np.zeros(m.shape[:1] + (max_iters, 5), np.int64)
        for j, (row, i) in enumerate(zip(m, owners)):
            k = int(row.sum())
            out[j] = jax_draws(np.ones((1, k), bool), [jax.random.PRNGKey(seed + i)], max_iters)[0]
        return torch.from_numpy(out)

    monkeypatch.setattr(tapi, "ransac_samples", draws)


@pytest.fixture(scope="module")
def pair():
    jinf = japi.GAPartNetInference(cfg=JaxConfig(**SMALL), auto_capacity=True)
    variables = jax.tree_util.tree_map(np.asarray, jinf.variables)
    tinf = tapi.GAPartNetInference(cfg=GAPartNetConfig(**SMALL), state_dict=params_from_jax(variables),
                                   auto_capacity=True, device="cpu")
    c = synthetic_cloud(np.random.RandomState(2), num_points=SMALL["max_points"], num_parts=4)
    return jinf, tinf, c


def _check_result(got, want):
    np.testing.assert_array_equal(got.sem_preds, np.asarray(want.sem_preds))
    np.testing.assert_array_equal(got.ins_preds, want.ins_preds)
    np.testing.assert_array_equal(got.proposal_classes, want.proposal_classes)
    np.testing.assert_allclose(got.npcs_map, want.npcs_map, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.proposal_scores, want.proposal_scores, rtol=TOL, atol=TOL)
    assert len(got.bboxes) == len(want.bboxes)
    for a, b in zip(got.bboxes, want.bboxes):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_predict_matches(pair, monkeypatch):
    """predict on two clouds: the second, 1.5 times larger, grows the level
    capacities and the grid extent on both sides alike."""
    jinf, tinf, c = pair
    patch_predict_draws(monkeypatch)
    pts = c["points"]
    big = pts.copy()
    big[:, :3] *= 1.5
    caps = []
    for cloud in (pts, big):
        want = jinf.predict(cloud, ransac_iters=ITERS)
        got = tinf.predict(cloud, ransac_iters=ITERS)
        _check_result(got, want)
        assert tinf.cfg.input_capacities() == jinf.cfg.input_capacities()
        assert tinf.cfg.input_grid_extent == jinf.cfg.input_grid_extent
        assert len(got.proposal_scores) > 0 and len(got.bboxes) > 0
        caps.append((tinf.cfg.input_capacities(), tinf.cfg.input_grid_extent))
    assert caps[1] != caps[0] and all(b >= a for a, b in zip(caps[0][0], caps[1][0]))


def test_predict_with_masks_matches(pair, monkeypatch):
    jinf, tinf, c = pair
    ins = c["instance_labels"]
    masks = np.stack([ins == i for i in range(ins.max() + 1)] + [np.zeros_like(ins, bool)])
    owners = [i for i, mk in enumerate(masks) if mk.sum() > 10]
    patch_mask_draws(monkeypatch, owners)
    js, jc, jn, jb = jinf.predict_with_masks(c["points"], masks, ransac_iters=ITERS)
    ts, tc, tn, tb = tinf.predict_with_masks(c["points"], masks, ransac_iters=ITERS)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tn, jn, rtol=TOL, atol=TOL)
    assert [b is None for b in tb] == [b is None for b in jb]
    assert sum(b is not None for b in tb) > 0
    for a, b in zip(tb, jb):
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flip_yz", [False, True])
def test_backproject_and_normalize_match(flip_yz):
    rng = np.random.RandomState(4)
    K = np.array([[120.0, 0, 40], [0, 110.0, 30], [0, 0, 1]])
    depth = np.where(rng.rand(60, 80) > 0.3, rng.rand(60, 80) + 0.5, 0.0).astype(np.float32)
    rgb = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
    for a, b in zip(tapi.backproject_depth(depth, K, rgb, flip_yz),
                    japi.backproject_depth(depth, K, rgb, flip_yz)):
        np.testing.assert_array_equal(a, b)
    xyz = tapi.backproject_depth(depth, K, None, flip_yz)[0]
    for a, b in zip(tapi.ball_space_normalize(xyz), japi.ball_space_normalize(xyz)):
        np.testing.assert_array_equal(a, b)


def test_knn_classifier_matches(tmp_path):
    rng = np.random.RandomState(5)
    feats, labels = rng.randn(40, 8).astype(np.float32), rng.randint(0, 4, 40)
    q = rng.randn(15, 8).astype(np.float32)
    np.testing.assert_array_equal(tapi.KNNPartClassifier(feats, labels, k=5).predict(q),
                                  japi.KNNPartClassifier(feats, labels, k=5).predict(q))
    np.savez(tmp_path / "bank.npz", features=feats, labels=labels)
    tapi.relabel_feature_bank(str(tmp_path / "bank.npz"), str(tmp_path / "t.npz"), {1: 7})
    japi.relabel_feature_bank(str(tmp_path / "bank.npz"), str(tmp_path / "j.npz"), {1: 7})
    np.testing.assert_array_equal(np.load(tmp_path / "t.npz")["labels"],
                                  np.load(tmp_path / "j.npz")["labels"])


@pytest.mark.parametrize("over", [{}, SMALL, dict(max_proposals=40, dense_grid_capacity=48)])
def test_eval_capacity_config_matches(over):
    """The eval capacities equal train/trainer.py's eval_capacity_config."""
    want = jax_eval_capacity_config(JaxConfig(**over))
    got = eval_capacity_config(GAPartNetConfig(**over))
    for f in ("hash_node_capacity", "hash_cand_cap", "hash_max_degree", "max_proposals",
              "dense_grid_capacity", "max_points"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.slow
def test_flagship_bench_cloud_matches(monkeypatch):
    """predict and predict_with_masks at the flagship config (at
    eval_capacity_config, as chip_smoke.py runs them) on assets/bench_cloud.npz."""
    from gapartnet_tpu_torch.entry import BENCH_CLOUD

    d = np.load(BENCH_CLOUD)
    pts = np.concatenate([d["xyz"], d["rgb"]], axis=1).astype(np.float32)
    jinf = japi.GAPartNetInference(cfg=jax_eval_capacity_config(JaxConfig()), auto_capacity=True)
    variables = jax.tree_util.tree_map(np.asarray, jinf.variables)
    tinf = tapi.GAPartNetInference(cfg=eval_capacity_config(GAPartNetConfig()),
                                   state_dict=params_from_jax(variables), auto_capacity=True,
                                   device="cpu")
    patch_predict_draws(monkeypatch)
    _check_result(tinf.predict(pts), jinf.predict(pts))
    ins = d["instance_labels"]
    masks = np.stack([ins == i for i in range(ins.max() + 1)])
    patch_mask_draws(monkeypatch, list(range(len(masks))))
    js, jc, jn, jb = jinf.predict_with_masks(pts, masks)
    ts, tc, tn, tb = tinf.predict_with_masks(pts, masks)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tn, jn, rtol=TOL, atol=TOL)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_weights_from_a_saved_state_dict(pair, tmp_path):
    """A .pt path holding a state_dict (the demo's --weights) gives the
    same model; without weights the seed draws them."""
    _, tinf, _ = pair
    torch.save(tinf.model.state_dict(), tmp_path / "model.pt")
    loaded = tapi.GAPartNetInference(tinf.cfg, state_dict=str(tmp_path / "model.pt"), device="cpu")
    for (k, a), b in zip(tinf.model.state_dict().items(), loaded.model.state_dict().values()):
        assert torch.equal(a, b), k
    seeded = [tapi.GAPartNetInference(tinf.cfg, seed=s, device="cpu").model.sem_seg_head.weight
              for s in (0, 0, 1)]
    assert torch.equal(seeded[0], seeded[1]) and not torch.equal(seeded[0], seeded[2])


def test_load_cloud_file_matches(tmp_path):
    from gapartnet_tpu.data.loader import load_cloud_file as jax_load
    from gapartnet_tpu_torch.data.loader import load_cloud_file

    c = synthetic_cloud(np.random.RandomState(3), num_points=300, num_parts=3)
    path = str(tmp_path / "Box_1_00_000.npz")
    np.savez(path, xyz=c["points"][:, :3], rgb=c["points"][:, 3:], sem_labels=c["sem_labels"],
             instance_labels=c["instance_labels"], gt_npcs=c["gt_npcs"])
    got, want = load_cloud_file(path), jax_load(path)
    assert got.keys() == want.keys() and got["obj_cat"] == want["obj_cat"] == 0
    for k in ("points", "sem_labels", "instance_labels", "gt_npcs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_demo_runs_on_cpu(tmp_path, capsys):
    """`python -m gapartnet_tpu_torch.demo` at the flagship config on a
    small RGB-D frame (predict_depth, then predict)."""
    from gapartnet_tpu_torch import demo

    rng = np.random.RandomState(3)
    np.save(tmp_path / "depth.npy", np.where(rng.rand(40, 50) > 0.2, rng.rand(40, 50) + 1.0, 0.0))
    np.save(tmp_path / "K.npy", np.array([[60.0, 0, 25], [0, 60.0, 20], [0, 0, 1]]))
    np.save(tmp_path / "rgb.npy", (rng.rand(40, 50, 3) * 255).astype(np.uint8))
    demo.main(["--depth", str(tmp_path / "depth.npy"), "--K", str(tmp_path / "K.npy"),
               "--rgb", str(tmp_path / "rgb.npy"), "--device", "cpu", "--out", str(tmp_path / "out")])
    assert "[demo]" in capsys.readouterr().out
    r = np.load(tmp_path / "out" / "demo_result.npz")
    n = len(r["sem_preds"])
    assert n == len(r["point_index"]) > 0
    assert r["npcs_map"].shape == (n, 3) and np.isfinite(r["npcs_map"]).all()
    assert r["bboxes"].shape[1:] == (8, 3) and len(r["proposal_scores"]) == len(r["proposal_classes"])
