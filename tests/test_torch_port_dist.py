"""Data-parallel training of the port on the CPU: 2 gloo ranks, each a
subprocess without jax, against the one-process port and the JAX package.

  * the step (SMALL_CFG of tests/test_torch_port_train.py with every level
    at max_points voxels and hash_max_degree 32, so that every counter is
    zero; 4 labelled synthetic clouds, all three stages, clustering
    overrides sliced per rank, one jitter): 2 ranks x B = 2 against the one-process port step and
    the JAX step on B = 4, also with one rank whose clouds hold no
    foreground (no offset-loss point, no proposal);
  * world size 1 with a process group (made by `init_from_env` from the
    launcher's variables) against no group: bitwise;
  * the file shards against the JAX build_datasets(process_index,
    process_count), and the capacities the ranks agree on;
  * the eval metrics of a 2-rank `test` (one rank's val shard empty)
    against np.nanmean of the two shards' one-process metrics;
  * a 2-rank fit through the CLI: rank 0 alone writes, the ranks end
    bitwise equal, and a resumed fit ends bitwise equal to an uninterrupted
    one.

The ranks meet in a file store under tmp_path (no port, so parallel test
workers cannot collide) and exchange inputs and results through files.
This module imports no jax at its top: the rank processes import it with
jax blocked, and the tests import the JAX side where they use it.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.entry import make_model
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.parallel import dist as pdist
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train import loop as tloop
from gapartnet_tpu_torch.train import trainer as ttrainer
from gapartnet_tpu_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
RANK_TIMEOUT_S = 300
B_RANK = 2                      # clouds per rank in the step cases
# the tolerances of tests/test_torch_port_train.py, and the rank-vs-port
# loss tolerance (the same port, sums split at the rank boundary)
LOSS_TOL = 1e-4
PORT_LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-4
STATS_TOL = 1e-5
ADAM_TOL = 1e-6
N_POINTS = 256
# the tiny dataset: 5 train clouds (3 and 2 per rank: the ranks' shards
# fill different numbers of batches of 1), one val cloud (rank 1's val
# shard is empty), 3 per test split
SPLIT_CLOUDS = {"train": 5, "val": 1, "test_intra": 3, "test_inter": 3}

_RANK = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
from tests.test_torch_port_dist import rank_main
rank_main(*sys.argv[1:])
leaked = [k for k in sys.modules if k == "gapartnet_tpu" or k.startswith("gapartnet_tpu.")]
assert not leaked, leaked
"""


# --------------------------------------------------------------------------
# the rank processes


def _join(rank: int, world: int, workdir: Path) -> None:
    torch.distributed.init_process_group("gloo", init_method=f"file://{workdir}/store",
                                         rank=rank, world_size=world)


def _batch(arrays: dict, clouds: slice) -> PointCloudBatch:
    return PointCloudBatch.from_numpy({k: v[clouds] for k, v in arrays.items()}, "cpu")


def _step(inp: dict, scenario: dict, clouds: slice) -> dict:
    """One train_step of the shared model on `clouds` of the scenario's
    batch, the jitter pinned to the scenario's; the model's output, the
    metrics, the gradients (after the all-reduce), and the state after
    Adam."""
    model = GAPartNet(GAPartNetConfig(**inp["cfg"]))
    model.load_state_dict(inp["state"])
    opt = tloop.adam(model.named_parameters(), 1e-3)
    seen = {}
    forward = model.forward
    model.forward = lambda *a, **kw: seen.setdefault("out", forward(*a, **kw))
    draw = tloop.draw_jitter
    tloop.draw_jitter = lambda generator: torch.from_numpy(scenario["jitter"])
    try:
        metrics = tloop.train_step(
            model, opt, _batch(scenario["batch"], clouds), torch.Generator(), True, True, True,
            torch.from_numpy(scenario["sem"][clouds]), torch.from_numpy(scenario["off"][clouds]))
    finally:
        tloop.draw_jitter = draw
    out = seen["out"]
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        ints={"sem_preds": out.sem_preds, "proposal_sem": out.proposal_sem,
              "npcs_valid": out.npcs_valid, "ious": out.ious.detach(),
              **{f"proposals.{f}": getattr(out.proposals, f) for f in out.proposals._fields},
              **{f"counters/{k}": v for k, v in out.counters.items()}},
        grads={k: p.grad.clone() for k, p in model.named_parameters()},
        state={k: v.clone() for k, v in model.state_dict().items()},
    )


def _job_step(rank: int, world: int, workdir: Path) -> dict:
    _join(rank, world, workdir)
    inp = torch.load(workdir / "step_in.pt", weights_only=False)
    clouds = slice(rank * B_RANK, (rank + 1) * B_RANK)
    return {name: _step(inp, sc, clouds) for name, sc in inp["scenarios"].items()}


def _job_world1(rank: int, world: int, workdir: Path) -> dict:
    """The step on two clouds without a group, then in a group of one that
    init_from_env makes from the launcher's variables."""
    inp = torch.load(workdir / "step_in.pt", weights_only=False)
    sc = inp["scenarios"]["even"]
    alone = _step(inp, sc, slice(0, B_RANK))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device, created = pdist.init_from_env("cpu")
    assert created and pdist.is_initialized() and pdist.world_size() == 1
    assert str(device) == "cpu" and torch.distributed.get_backend() == "gloo"
    grouped = _step(inp, sc, slice(0, B_RANK))
    return dict(alone=alone, grouped=grouped)


def _job_test(rank: int, world: int, workdir: Path) -> dict:
    """`trainer.test` of the tiny config, recording the file shards and the
    capacities after the scan."""
    _join(rank, world, workdir)
    seen = {}
    build, apply = ttrainer.build_datasets, ttrainer._apply_auto_capacity

    def record_build(cfg, stage, *a, **kw):
        datasets = build(cfg, stage, *a, **kw)
        seen["paths"] = {k: list(ds.paths) for k, ds in datasets.items()}
        return datasets

    def record_apply(cfg, datasets):
        apply(cfg, datasets)
        seen["model"] = cfg.model

    ttrainer.build_datasets, ttrainer._apply_auto_capacity = record_build, record_apply
    from gapartnet_tpu_torch.train.config import load_config

    cfg = load_config(str(workdir / "config.yaml"))
    cfg.trainer.log_file = str(workdir / f"rank{rank}" / "metrics.jsonl")
    metrics = ttrainer.test(cfg, device="cpu")
    return dict(metrics=metrics, eval_model=cfg.model, **seen)


def _job_cli(rank: int, world: int, workdir: Path) -> dict:
    """`cli.main` in this rank's own directory, under a group made here and
    the launcher's rank variables; the state that `fit` ends with."""
    _join(rank, world, workdir)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    from gapartnet_tpu_torch.train import cli

    ends = []
    fit = ttrainer.fit
    ttrainer.fit = lambda *a, **kw: ends.append(fit(*a, **kw)) or ends[-1]
    rundir = workdir / f"rank{rank}"
    rundir.mkdir(exist_ok=True)
    os.chdir(rundir)
    cli.main(json.loads((workdir / "argv.json").read_text()))
    (res,) = ends
    return dict(state=res.model.state_dict(), optimizer=res.optimizer.state_dict()["state"],
                generator=res.generator.get_state(), step=res.step, gstep=res.gstep)


JOBS = {"step": _job_step, "world1": _job_world1, "test": _job_test, "cli": _job_cli}


def rank_main(job: str, rank: str, world: str, workdir: str) -> None:
    rank, world, workdir = int(rank), int(world), Path(workdir)
    try:
        result = JOBS[job](rank, world, workdir)
    finally:
        pdist.close()
    torch.save(result, workdir / f"{job}_rank{rank}.pt")


def start_ranks(job: str, workdir: Path, world: int = WORLD) -> list:
    """`job` started in `world` processes, each logging to a file."""
    # one intra-op thread per rank: the ranks share the test's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in pdist.LAUNCHER_VARS + ("LOCAL_RANK",):
        env.pop(k, None)
    procs = []
    for r in range(world):
        with open(workdir / f"{job}_rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _RANK, job, str(r), str(world),
                                           str(workdir)], cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs: list, job: str, workdir: Path) -> list:
    """The ranks' results; fails as soon as one of them fails (the others
    are killed, since they would wait in a collective)."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"{job} rank {r} exit {p.returncode}:\n"
            + (workdir / f"{job}_rank{r}.log").read_text()[-6000:])
    return [torch.load(workdir / f"{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_ranks(job: str, workdir: Path, world: int = WORLD) -> list:
    return wait_ranks(start_ranks(job, workdir, world), job, workdir)


# --------------------------------------------------------------------------
# the step: 2 ranks x 2 clouds against one process and JAX on 4


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The shared inputs, the ranks' steps, and per scenario the one-process
    port step and the JAX step (value_and_grad of make_train_step's loss,
    one jit for both scenarios) on the whole batch."""
    import jax
    import jax.numpy as jnp

    from gapartnet_tpu.data.synthetic import synthetic_batch
    from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
    from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
    from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
    from tests.test_torch_port_train import SMALL, _random_stats, jax_jitter

    workdir = tmp_path_factory.mktemp("dp_step")
    d = synthetic_batch(np.random.RandomState(0), batch_size=WORLD * B_RANK, num_points=512,
                        num_parts=4, max_instances=8)
    d.pop("pc_ids")
    inst = d["instance_labels"]
    off = np.where((inst >= 0)[..., None],
                   d["instance_regions"][..., :3] - d["points"][..., :3], 0).astype(np.float32)
    sem = d["sem_labels"].astype(np.int32)
    # rank 1's clouds without foreground: no offset-loss point, no proposal
    bg = {k: v.copy() for k, v in d.items()}
    bg["sem_labels"][B_RANK:] = 0
    bg_sem = sem.copy()
    bg_sem[B_RANK:] = 0

    small = dict(SMALL, level_capacity_divisors=(1, 1, 1), hash_max_degree=32)
    jm = JaxModel(JaxConfig(**small))
    jb = {name: JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
          for name, arrays in (("even", d), ("no_foreground", bg))}
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jb["even"])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(5))}
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jb["even"], key).astype(np.float32)
    state = params_from_jax(variables)
    scenarios = {"even": dict(batch=d, sem=sem, off=off, jitter=jitter),
                 "no_foreground": dict(batch=bg, sem=bg_sem, off=off, jitter=jitter)}
    inp = dict(cfg=small, state=state, scenarios=scenarios)
    torch.save(inp, workdir / "step_in.pt")
    procs = start_ranks("step", workdir)       # they run while JAX compiles

    def loss_fn(params, batch_stats, b, k, cs, co):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats}, b, train=True, do_cluster=True,
            do_score=True, do_npcs=True, rngs={"proposal_jitter": k}, mutable=["batch_stats"],
            cluster_sem_override=cs, cluster_offset_override=co)
        return out.total_loss, (out, mutated["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    cases = {}
    steps = {name: (fn(variables["params"], variables["batch_stats"], jb[name], key,
                       jnp.asarray(sc["sem"]), jnp.asarray(sc["off"])), _step(inp, sc, slice(None)))
             for name, sc in scenarios.items()}
    ranks = wait_ranks(procs, "step", workdir)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)   # noqa: E731
    for name, (((_, (jo, new_bs)), grads), whole) in steps.items():
        cases[name] = dict(ranks=[r[name] for r in ranks], port=whole, jax_out=jo,
                           jax_grads=params_from_jax({"params": host(grads)}),
                           jax_stats=params_from_jax({"params": {}, "batch_stats": host(new_bs)}),
                           params0={k: v for k, v in state.items() if "running_" not in k})
    cases["inputs"] = workdir / "step_in.pt"
    return cases


def _check_grads(got: dict, want: dict, what: str) -> None:
    """Per tensor max|d| <= GRAD_RTOL * max|want|, max|want| floored at
    GRAD_FLOOR of the largest gradient (test_torch_port_train.check_grads)."""
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    bad = []
    for k, w in want.items():
        scale = max(float(w.abs().max()), GRAD_FLOOR * top)
        err = float((got[k] - w).abs().max())
        if not err <= GRAD_RTOL * scale:
            bad.append(f"{what} {k}: max|d| {err:.3e} > {GRAD_RTOL} * {scale:.3e}")
    assert not bad, bad


def _jax_adam(params0: dict, grads: dict) -> dict:
    """One optax.adam(1e-3) step (the JAX package's `adam`) from `params0`
    on `grads`."""
    import jax
    import jax.numpy as jnp
    import optax

    from gapartnet_tpu.train import loop as jloop

    tx = jloop.adam(1e-3)
    step = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    p = {k: jnp.asarray(v.numpy()) for k, v in params0.items()}
    return {k: np.asarray(v) for k, v in step(p, {k: jnp.asarray(grads[k].numpy())
                                                 for k in p}).items()}


@pytest.mark.parametrize("scenario", ["even", "no_foreground"])
def test_dp_step_matches_whole_batch(step_case, scenario):
    case = step_case[scenario]
    ranks, port, jo = case["ranks"], case["port"], case["jax_out"]
    # every counter zero: the regime where capacities change nothing
    for r in ranks + [port]:
        assert all(int(v.sum()) == 0 for k, v in r["ints"].items() if k.startswith("counters/"))
    # integer outputs per cloud, against the port and JAX
    for ri, r in enumerate(ranks):
        clouds = slice(ri * B_RANK, (ri + 1) * B_RANK)
        for k, v in r["ints"].items():
            np.testing.assert_array_equal(v.numpy(), port["ints"][k][clouds].numpy(), err_msg=k)
        for k in ("sem_preds", "proposal_sem", "npcs_valid", "ious"):
            np.testing.assert_array_equal(r["ints"][k].numpy(), np.asarray(getattr(jo, k))[clouds],
                                          err_msg=k)
        for f in jo.proposals._fields:
            np.testing.assert_array_equal(r["ints"][f"proposals.{f}"].numpy(),
                                          np.asarray(getattr(jo.proposals, f))[clouds], err_msg=f)
    if scenario == "no_foreground":
        assert int(ranks[1]["ints"]["proposals.num_proposals"].sum()) == 0
        assert int(ranks[0]["ints"]["proposals.num_proposals"].sum()) > 0
    # losses and accuracies: the sum of the ranks' parts
    for k in ["loss/total_loss"] + [f"loss/{n}" for n in ("loss_sem_seg", "loss_offset_dist",
                                                         "loss_offset_dir", "loss_prop_score",
                                                         "loss_prop_npcs")] + ["all_accu",
                                                                               "pixel_accu"]:
        total = sum(r["metrics"][k] for r in ranks)
        np.testing.assert_allclose(total, port["metrics"][k], rtol=PORT_LOSS_TOL,
                                   atol=PORT_LOSS_TOL, err_msg=k)
        name = k.split("/")[-1]
        want = float(jo.total_loss if name == "total_loss" else getattr(jo, name))
        want *= 100.0 if name in ("all_accu", "pixel_accu") else 1.0
        np.testing.assert_allclose(total, want, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    assert min(port["metrics"][f"loss/loss_prop_{k}"] for k in ("npcs", "score")) > 0
    # the ranks end bitwise equal
    for k in ranks[0]["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    for k in ranks[0]["grads"]:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    r0 = ranks[0]
    # gradients (after the all-reduce) against the port's and JAX's
    _check_grads(r0["grads"], port["grads"], "vs port")
    _check_grads(r0["grads"], case["jax_grads"], "vs jax")
    # running statistics
    for k, w in case["jax_stats"].items():
        np.testing.assert_allclose(r0["state"][k].numpy(), port["state"][k].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL, err_msg=k)
        np.testing.assert_allclose(r0["state"][k].numpy(), w.numpy(), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=k)
    # Adam: optax's step on the reduced gradients.  (Adam's first step is
    # lr * g / (|g| + 1e-8); it turns a rounding-level difference of a
    # gradient that is zero up to rounding, such as offset_mlp0.bias before
    # offset_bn, into up to 2e-3, so the updated parameters are held to the
    # update of this run's own gradients, which are held above.)
    want = _jax_adam(case["params0"], r0["grads"])
    for k, w in want.items():
        np.testing.assert_allclose(r0["state"][k].numpy(), w, rtol=ADAM_TOL, atol=ADAM_TOL,
                                   err_msg=k)


def test_world_size_one_group_is_bitwise(step_case, tmp_path):
    """A group of one (gloo, init_from_env) steps bitwise as no group."""
    import shutil

    shutil.copy(step_case["inputs"], tmp_path / "step_in.pt")
    (res,) = run_ranks("world1", tmp_path, world=1)
    a, b = res["alone"], res["grouped"]
    assert a["metrics"] == b["metrics"]
    for part in ("grads", "state", "ints"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


# --------------------------------------------------------------------------
# the trainer: shards, capacities, the eval mean, the fit through the CLI


@pytest.fixture(scope="module")
def dp_data(tmp_path_factory):
    """The tiny dataset and config of tests/test_torch_port_trainer.py with
    the SPLIT_CLOUDS counts, one cloud per train batch and 4 proposals."""
    import yaml

    from gapartnet_tpu.data.synthetic import synthetic_cloud
    from tests.test_torch_port_trainer import _raw

    root = tmp_path_factory.mktemp("dp_data")
    rng = np.random.RandomState(0)
    for split, n in SPLIT_CLOUDS.items():
        d = root / split / "pth"
        d.mkdir(parents=True)
        for i in range(n):
            c = synthetic_cloud(rng, num_points=N_POINTS, num_parts=3)
            np.savez(d / f"{'Box' if i % 2 else 'Remote'}_{100 + i}_00_000.npz",
                     xyz=c["points"][:, :3], rgb=c["points"][:, 3:], sem_labels=c["sem_labels"],
                     instance_labels=c["instance_labels"], gt_npcs=c["gt_npcs"])
    raw = _raw(root)
    raw["data"]["init_args"]["train_batch_size"] = 1
    # 4 proposals (8 at the eval capacities): the dense proposal UNets of
    # every evaluation are most of a fit's time on the CPU
    raw["model"]["init_args"]["max_proposals"] = 4
    (root / "config.yaml").write_text(yaml.safe_dump(raw))
    return root


@pytest.mark.parametrize("k", [2, 3])
def test_shards_equal_jax_build_datasets(dp_data, k):
    from gapartnet_tpu.train import config as jconfig
    from gapartnet_tpu.train import trainer as jtrainer
    from gapartnet_tpu_torch.train.config import load_config

    cfg_path = str(dp_data / "config.yaml")
    whole = {s: list(ds.paths) for s, ds in ttrainer.build_datasets(
        load_config(cfg_path), "fit", 0, 1).items()}
    shards = []
    for i in range(k):
        got = {s: list(ds.paths) for s, ds in ttrainer.build_datasets(
            load_config(cfg_path), "fit", i, k).items()}
        want = {s: list(ds.paths) for s, ds in jtrainer.build_datasets(
            jconfig.load_config(cfg_path), "fit", process_index=i, process_count=k).items()}
        assert got == want
        shards.append(got)
    for split, paths in whole.items():
        parts = [sh[split] for sh in shards]
        assert sorted(p for part in parts for p in part) == sorted(paths)   # disjoint, covering
        assert len(set(p for part in parts for p in part)) == len(paths)


@pytest.fixture(scope="module")
def eval_run(dp_data, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp_test")
    (workdir / "config.yaml").write_text((dp_data / "config.yaml").read_text())
    return run_ranks("test", workdir)


def test_ranks_agree_on_the_capacities(dp_data, eval_run):
    """After auto_capacity both ranks hold the same model config, the
    maximum of their shards' own scans."""
    from gapartnet_tpu_torch.train.config import load_config

    fields = ("level_capacities", "input_grid_extent", "hash_node_capacity", "hash_cand_cap",
              "hash_max_degree")
    assert eval_run[0]["model"] == eval_run[1]["model"]
    own = []
    for i in range(WORLD):
        cfg = load_config(str(dp_data / "config.yaml"))
        ttrainer._apply_auto_capacity(cfg, ttrainer.build_datasets(cfg, "test", i, WORLD))
        own.append(cfg.model)
    for f in fields:
        got = np.asarray(getattr(eval_run[0]["model"], f))
        mine = [np.asarray(getattr(m, f)) for m in own]
        assert (got >= mine[0]).all() and (got >= mine[1]).all(), f
        np.testing.assert_array_equal(got, np.maximum(*mine), err_msg=f)


def test_eval_metrics_are_the_nanmean_over_ranks(dp_data, eval_run, tmp_path):
    """Each rank's shard evaluated alone, then np.nanmean over the ranks on
    eval_metric_names (the JAX trainer's rule, trainer.py:790-807)."""
    from gapartnet_tpu_torch.train.config import load_config

    assert eval_run[1]["paths"]["val"] == []          # rank 1's val shard is empty
    keys = ttrainer.eval_metric_names(load_config(str(dp_data / "config.yaml")), True)
    vecs = []
    for i in range(WORLD):
        cfg = load_config(str(dp_data / "config.yaml"))
        cfg.model = eval_run[i]["eval_model"]
        model = make_model(cfg.model, "cpu", seed=cfg.trainer.seed)
        logger = ttrainer.MetricLogger(str(tmp_path / f"shard{i}.jsonl"))
        _, m = ttrainer.evaluate_splits(model, cfg, ttrainer.build_datasets(cfg, "test", i, WORLD),
                                        0, logger, 0, do_instance=True, device="cpu")
        vecs.append([m.get(k, np.nan) for k in keys])
    assert all(np.isnan(v) for k, v in zip(keys, vecs[1]) if k.startswith("val/"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)     # all-NaN columns
        means = np.nanmean(np.asarray(vecs, np.float64), axis=0)
    want = {k: float(v) for k, v in zip(keys, means) if not np.isnan(v)}
    for r in eval_run:
        assert list(r["metrics"]) == list(want)
        np.testing.assert_allclose([r["metrics"][k] for k in want], list(want.values()),
                                   rtol=1e-12, atol=0)
    assert "val/AP@50" in want and "monitor_metrics/mean_mAP" in want


def _cli_run(dp_data, workdir: Path, *extra) -> list:
    workdir.mkdir()
    argv = ["fit", "-c", str(dp_data / "config.yaml"), "--device", "cpu", *extra]
    (workdir / "argv.json").write_text(json.dumps(argv))
    return run_ranks("cli", workdir)


def _lines(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_fit_two_ranks_resume_bitwise(dp_data, tmp_path):
    """A 2-rank fit through the CLI: rank 0 alone writes the metrics log and
    the checkpoints; the ranks end bitwise equal; 2 steps per epoch (the
    fewer batches of the two shards); a fit resumed from its epoch-0
    checkpoint ends bitwise equal to the uninterrupted two-epoch fit."""
    full = _cli_run(dp_data, tmp_path / "full")
    ck = next(p for p in (tmp_path / "full" / "rank0" / "checkpoints").iterdir()
              if p.name.startswith("epoch_000"))
    resumed = _cli_run(dp_data, tmp_path / "resumed", "--trainer.ckpt_path", str(ck))

    for run in ("full", "resumed"):
        assert sorted(p.name for p in (tmp_path / run / "rank1").iterdir()) == [], run
        assert (tmp_path / run / "rank0" / "metrics.jsonl").exists(), run
        assert "data parallel: rank 1 of 2 (gloo)" in (tmp_path / run / "cli_rank1.log").read_text()
    names = sorted(p.name for p in (tmp_path / "full" / "rank0" / "checkpoints").iterdir())
    assert names[-1] == "last" and len(names) == 3
    assert [(r["step"], r["gstep"]) for r in full + resumed] == [(4, 4)] * 4
    assert torch.load(ck, weights_only=True)["step"] == 2

    def same(a, b):
        assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
        assert a["optimizer"].keys() == b["optimizer"].keys()
        assert all(torch.equal(a["optimizer"][i][k], b["optimizer"][i][k])
                   for i in a["optimizer"] for k in a["optimizer"][i])
        assert torch.equal(a["generator"], b["generator"])

    same(full[0], full[1])
    same(resumed[0], resumed[1])
    same(full[0], resumed[0])
    want = _lines(tmp_path / "full" / "rank0" / "metrics.jsonl")
    got = _lines(tmp_path / "resumed" / "rank0" / "metrics.jsonl")
    assert [line.get("epoch") for line in want] == [0, None, 1, None]
    assert [line.get("epoch") for line in got] == [1, None]
    for g, w in zip(got, want[2:]):
        g.pop("epoch_time_s", None)
        w.pop("epoch_time_s", None)
        assert g == w
    assert all(np.isfinite(v) for line in want for v in line.values())
