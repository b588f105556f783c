"""The port's trainer: checkpoints, warm start, the Prefetcher, the
reduced eval step and the metric names against the JAX trainer, and (slow)
a whole fit against the JAX fit.  tests/test_torch_port_cli.py runs fit and
test through the CLI and a resumed fit.

The tiny synthetic dataset of tests/test_train_smoke.py (256 points,
channels (8, 16)), with three clouds per eval split against a batch of 2, so
every split ends in a padded batch."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gapartnet_tpu.data.synthetic import synthetic_batch, synthetic_cloud
from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
from gapartnet_tpu.train import config as jconfig
from gapartnet_tpu.train import loop as jloop
from gapartnet_tpu.train import trainer as jtrainer
from gapartnet_tpu_torch.config import GAPartNetConfig, eval_capacity_config
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train import config as tconfig
from gapartnet_tpu_torch.train import trainer as ttrainer
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_torch_port_train import SMALL, _random_stats

ROOT = Path(__file__).resolve().parent.parent
N_POINTS = 256
SCORE_TOL = 1e-4
FIT_TOL = 1e-4


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    rng = np.random.RandomState(0)
    names = ["Box_100_00_000", "Box_101_00_000", "Remote_102_00_000", "Remote_103_00_000"]
    for split in ("train", "val", "test_intra", "test_inter"):
        d = root / split / "pth"
        d.mkdir(parents=True)
        for name in names[: 4 if split == "train" else 3]:
            c = synthetic_cloud(rng, num_points=N_POINTS, num_parts=3)
            np.savez(d / f"{name}.npz", xyz=c["points"][:, :3], rgb=c["points"][:, 3:],
                     sem_labels=c["sem_labels"], instance_labels=c["instance_labels"],
                     gt_npcs=c["gt_npcs"])
    return root


def _raw(root, schedule=(0, 1), max_epochs=2):
    return {
        "model": {"init_args": {
            "backbone_type": "SparseUNet",
            "backbone_cfg": {"channels": [8, 16], "block_repeat": 1},
            "instance_seg_cfg": {"ball_query_radius": 0.1, "max_num_points_per_query": 8,
                                 "min_num_points_per_proposal": 3,
                                 "max_num_points_per_query_shift": 16},
            "learning_rate": 0.001, "training_schedule": list(schedule),
            "max_points": N_POINTS, "max_proposals": 16, "max_instances": 8}},
        "data": {"init_args": {
            "root_dir": str(root), "max_points": N_POINTS, "train_batch_size": 2,
            "val_batch_size": 2, "num_workers": 2, "max_instances": 8,
            "auto_capacity": True}},
        "trainer": {"max_epochs": max_epochs},
        "seed_everything": 233,
    }


def _config_file(tmp_path, root, **kw):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(_raw(root, **kw)))
    return path


def _port_cfg(tmp_path, root, workdir, **kw):
    cfg = tconfig.load_config(str(_config_file(tmp_path, root, **kw)))
    cfg.trainer.ckpt_dir = str(workdir / "checkpoints")
    cfg.trainer.log_file = str(workdir / "metrics.jsonl")
    return cfg


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _check_metric_names(lines, cfg_model_classes=10):
    """Train lines carry exactly the train names; eval lines a subset of the
    eval names that lacks only per-class recalls of absent classes."""
    cfg = tconfig.Config(model=GAPartNetConfig(num_part_classes=cfg_model_classes),
                         data=tconfig.DataConfig(), trainer=tconfig.TrainerConfig())
    for line in lines:
        keys = set(line) - {"step"}
        if "epoch" in line:
            assert keys == set(ttrainer.train_metric_names(bool(
                "train_counters/dropped_proposals" in line)))
        else:
            do_instance = any(k.startswith("val/AP@50_") for k in keys)
            want = set(ttrainer.eval_metric_names(cfg, do_instance))
            assert keys <= want, keys - want
            assert all("/recall_" in k for k in want - keys), want - keys


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_ckpt_manager_top_k_and_last(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    mgr = ttrainer.CkptManager(str(tmp_path), save_top_k=2)
    for epoch in range(5):
        with torch.no_grad():
            model.weight.fill_(float(epoch))
        mgr.save(model, opt, epoch, 0.0, gstep=epoch, step=epoch)
    # ties: the newest epochs stay; `last` is the newest epoch
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch_003_mean_mAP_0.00", "epoch_004_mean_mAP_0.00", "last"]
    restored = ttrainer.CkptManager.restore(str(tmp_path / "last"))
    assert restored["epoch"] == 4 and restored["gstep"] == 4
    assert torch.equal(restored["model"]["weight"], torch.full((2, 3), 4.0))
    # a better score outlives later worse ones
    mgr = ttrainer.CkptManager(str(tmp_path / "m"), save_top_k=2, monitor="val/recall_min")
    for epoch, score in enumerate((5.0, 9.0, 1.0, 7.0)):
        mgr.save(model, opt, epoch, score)
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
        "epoch_001_recall_min_9.00", "epoch_003_recall_min_7.00", "last"]


def test_warm_start_keeps_missing_keys(tmp_path, capsys):
    cfg = GAPartNetConfig(**SMALL)
    src = GAPartNet(cfg)
    with torch.no_grad():
        for p in src.parameters():
            p.fill_(0.5)
    dst = GAPartNet(cfg)
    init = _state(dst)
    model_sd = {k: v for k, v in src.state_dict().items() if not k.startswith("npcs_head")}
    torch.save({"model": model_sd, "extra_key": 1}, tmp_path / "ck")
    missing = ttrainer.load_warm_start(dst, str(tmp_path / "ck"))
    assert sorted(missing) == ["npcs_head.bias", "npcs_head.weight"]
    out = capsys.readouterr().out
    assert "missing key (kept init): npcs_head.weight" in out
    after = dst.state_dict()
    for k, v in after.items():
        assert torch.equal(v, init[k] if k.startswith("npcs_head") else src.state_dict()[k]), k


def test_prefetcher_order_transform_and_errors():
    out = list(ttrainer.Prefetcher(iter(range(10)), transform=lambda x: x * 2))
    assert out == [2 * i for i in range(10)]

    def boom(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for item in ttrainer.Prefetcher(iter(range(10)), transform=boom):
            got.append(item)
    assert got == [0, 1, 2]

    def gen():
        yield 1
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(ttrainer.Prefetcher(gen()))


def test_host_copy_keeps_values_and_dtypes():
    tree = [{"a": torch.tensor([1.5, -2.0]), "b": torch.tensor([[True, False]]),
             "c": torch.tensor(7, dtype=torch.int64)}, (torch.tensor([3], dtype=torch.int32), "x")]
    got = ttrainer.host_copy(tree)
    np.testing.assert_array_equal(got[0]["a"], np.array([1.5, -2.0], np.float32))
    assert got[0]["b"].dtype == np.bool_ and got[0]["b"].tolist() == [[True, False]]
    assert got[0]["c"].dtype == np.int64 and int(got[0]["c"]) == 7
    assert got[1][0].dtype == np.int32 and got[1][1] == "x"


def test_cpu_tree_keeps_structure():
    """cpu_tree rebuilds dicts, lists, tuples, NamedTuples and dataclasses
    around detached CPU copies of their tensors."""
    from gapartnet_tpu_torch.models.grouping import SampleProposals

    w = torch.ones(3, requires_grad=True)
    props = SampleProposals(*[torch.full((1, 2), float(i)) for i in range(len(SampleProposals._fields))])
    batch = PointCloudBatch(points=w * 2, point_mask=torch.tensor([True, False, True]))
    got = ttrainer.cpu_tree({"p": props, "b": batch, "l": [w, (w, "x")]})
    assert type(got["p"]) is SampleProposals and type(got["b"]) is PointCloudBatch
    for i, t in enumerate(got["p"]):
        assert torch.equal(t, torch.full((1, 2), float(i)))
    assert not got["b"].points.requires_grad and got["b"].points.tolist() == [2.0, 2.0, 2.0]
    assert got["b"].point_mask.tolist() == [True, False, True]
    assert isinstance(got["l"], list) and got["l"][1][1] == "x"
    assert not got["l"][0].requires_grad and got["l"][0].device.type == "cpu"


def _eval_batch(cfg):
    """Three labelled clouds and one padded cloud (no valid point)."""
    d = synthetic_batch(np.random.RandomState(1), batch_size=4, num_points=cfg["max_points"],
                        num_parts=4, max_instances=cfg["max_instances"])
    d["point_mask"][3] = False
    d["num_points_per_instance"][3] = 0
    d["instance_sem_labels"][3] = -1
    return d


@pytest.mark.parametrize("do_instance", [False, True])
def test_reduced_eval_step_matches_jax(do_instance):
    d = _eval_batch(SMALL)
    ids = d.pop("pc_ids")
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids)
    jcfg = eval_capacity_config(GAPartNetConfig(**SMALL))
    jm = JaxModel(JaxConfig(**dataclasses.asdict(jcfg)))
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(2))}
    state = jloop.TrainState(variables["params"], variables["batch_stats"], None, 0)
    cfg_j = jconfig.Config(model=jm.cfg, data=jconfig.DataConfig(), trainer=jconfig.TrainerConfig())
    want = jax.tree_util.tree_map(
        np.asarray, jtrainer.make_reduced_eval_step(jm, cfg_j, do_instance)(state, jbatch))

    train_model = GAPartNet(GAPartNetConfig(**SMALL))
    train_model.load_state_dict(params_from_jax(variables), strict=True)
    tm = train_model.with_config(jcfg)        # the eval view shares the weights
    assert tm.backbone is train_model.backbone
    cfg_t = tconfig.Config(model=jcfg, data=tconfig.DataConfig(), trainer=tconfig.TrainerConfig())
    got = ttrainer.host_copy(ttrainer.make_reduced_eval_step(tm, cfg_t, do_instance)(
        PointCloudBatch.from_numpy(d, "cpu")))

    assert set(got) == set(want)
    for k, w in want.items():
        if k in ("scores", "ious"):
            np.testing.assert_allclose(got[k], w, rtol=SCORE_TOL, atol=SCORE_TOL, err_msg=k)
        elif k in ("all_accu", "pixel_accu"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    if do_instance:
        assert got["keep"].any() and np.asarray(got["keep"][3]).sum() == 0
        rec_t = ttrainer._records_from_reduced(got)
        rec_j = jtrainer._records_from_reduced(want)
        for a, b in zip(rec_t, rec_j):
            np.testing.assert_allclose(a, b, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("do_instance", [False, True])
def test_eval_metric_names_equal_jax(do_instance):
    tiny = dict(channels=(8, 16), max_points=N_POINTS, max_proposals=16, max_instances=8,
                level_capacity_divisors=(1, 2))
    jm = JaxModel(JaxConfig(**tiny))
    cfg_j = jconfig.Config(model=jm.cfg, data=dataclasses.replace(jconfig.DataConfig(),
                                                                   val_batch_size=2),
                           trainer=jconfig.TrainerConfig())
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=N_POINTS,
                        max_instances=8)
    ids = d.pop("pc_ids")
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids)
    variables = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True), jbatch)
    state = jloop.TrainState(variables["params"], variables["batch_stats"], None, 0)
    want = jtrainer._expected_eval_keys(
        jtrainer.make_reduced_eval_step(jm, cfg_j, do_instance), state, cfg_j, do_instance)
    cfg_t = tconfig.Config(model=GAPartNetConfig(**tiny), data=tconfig.DataConfig(),
                           trainer=tconfig.TrainerConfig())
    assert ttrainer.eval_metric_names(cfg_t, do_instance) == want


@pytest.mark.slow
def test_fit_matches_jax_fit(data_root, tmp_path, monkeypatch):
    """The JAX fit and the port's from the same warm-start weights, with no
    proposal stage (schedule [2, 2]: no jitter drawn), two epochs: every
    metric line within 1e-4 (epoch_time_s aside)."""
    from gapartnet_tpu.train.loop import adam as jadam
    from gapartnet_tpu.train.loop import create_train_state

    raw = _raw(data_root, schedule=(2, 2))
    raw["data"]["init_args"]["auto_capacity"] = False
    raw["model"]["init_args"]["max_points"] = N_POINTS
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jcfg = jconfig.load_config(str(path))
    jcfg.model = dataclasses.replace(jcfg.model, level_capacity_divisors=(1, 2))
    jm = JaxModel(jcfg.model)
    datasets = jtrainer.build_datasets(jcfg, "fit")
    example = jtrainer._np_batch_to_device(
        next(jtrainer._iter_batches(datasets["train"], 2, True, 0)))
    state = create_train_state(jm, example, jadam(1e-3), seed=5)
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    jtrainer.CkptManager(str(jdir / "init")).save(state, 0, 0.0)
    jcfg.trainer.resume_ckpt = str(jdir / "init" / "last")
    jcfg.trainer.ckpt_dir = str(jdir / "checkpoints")
    jcfg.trainer.log_file = str(jdir / "metrics.jsonl")
    jtrainer.fit(jcfg)

    torch.save({"model": params_from_jax(variables)}, tdir / "init.pt")
    tcfg = tconfig.load_config(str(path))
    tcfg.model = dataclasses.replace(tcfg.model, level_capacity_divisors=(1, 2))
    tcfg.trainer.resume_ckpt = str(tdir / "init.pt")
    tcfg.trainer.ckpt_dir = str(tdir / "checkpoints")
    tcfg.trainer.log_file = str(tdir / "metrics.jsonl")
    ttrainer.fit(tcfg, device="cpu")

    want, got = _lines(jdir / "metrics.jsonl"), _lines(tdir / "metrics.jsonl")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g.pop("epoch_time_s", None)
        w.pop("epoch_time_s", None)
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=FIT_TOL, atol=FIT_TOL, err_msg=k)
