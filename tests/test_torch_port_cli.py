"""The port's trainer as users run it: `fit` then `test` through the CLI
in a subprocess with jax, flax and PyYAML blocked (metric names,
checkpoints, printed test metrics), the CLI's default device, the refused
`trainer.visualize`, and a resumed CPU fit bitwise equal to an
uninterrupted one."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.train import trainer as ttrainer
from tests.test_torch_port_trainer import (
    ROOT,
    _check_metric_names,
    _config_file,
    _lines,
    _port_cfg,
    _state,
    data_root,
)

assert data_root  # a module fixture of the trainer tests, shared here


_RUN_CLI = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["yaml"] = None
from gapartnet_tpu_torch.train.cli import main
main(sys.argv[1:])
leaked = [k for k in sys.modules if k == "gapartnet_tpu" or k.startswith("gapartnet_tpu.")]
assert not leaked, leaked
"""


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", _RUN_CLI, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cli_fit_then_test_without_jax(data_root, tmp_path):
    cfg_file = _config_file(tmp_path, data_root)
    r = _cli(["fit", "-c", str(cfg_file), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names[-1] == "last" and len(names) == 3
    assert names[0].startswith("epoch_000_mean_mAP_") and names[1].startswith("epoch_001_mean_mAP_")
    lines = _lines(tmp_path / "metrics.jsonl")
    assert [line.get("epoch") for line in lines] == [0, None, 1, None]
    assert "monitor_metrics/mean_mAP" in lines[-1] and "val/AP@50_hinge_door" in lines[-1]
    assert all(np.isfinite(v) for line in lines for v in line.values())
    _check_metric_names(lines)

    r = _cli(["test", "-c", str(cfg_file), "--model.init_args.ckpt", "checkpoints/last",
              "--model.init_args.training_schedule", "[0,0]", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    printed = dict(line.rsplit(": ", 1) for line in r.stdout.splitlines()
                   if ": " in line and not line.startswith("["))
    assert "monitor_metrics/mean_mAP" in printed and "test_inter/counters/dropped_proposals" in printed


def test_cli_defaults_to_the_card(data_root, tmp_path):
    """Without --device the CLI runs on cuda and fails loudly without a card."""
    from gapartnet_tpu_torch.train import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["test", "-c", str(_config_file(tmp_path, data_root))])


def test_visualize_is_refused(data_root, tmp_path):
    cfg = _port_cfg(tmp_path, data_root, tmp_path)
    cfg.trainer.visualize = True
    with pytest.raises(NotImplementedError, match="item 14"):
        ttrainer.test(cfg, device="cpu")


def test_resume_is_bitwise(data_root, tmp_path):
    """Two epochs in one run against one epoch plus a full resume: the same
    train lines, eval lines, parameters, statistics and Adam state.  (Without
    auto_capacity: the evaluations run the train model itself.)"""
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()

    def cfg_of(workdir, **kw):
        cfg = _port_cfg(tmp_path, data_root, workdir, **kw)
        cfg.data.auto_capacity = False
        return cfg

    res_full = ttrainer.fit(cfg_of(full), device="cpu")
    ttrainer.fit(cfg_of(part, max_epochs=1), device="cpu")
    ck = next(p for p in (part / "checkpoints").iterdir() if p.name.startswith("epoch_000"))
    cfg = cfg_of(part)
    cfg.trainer.ckpt_path = str(ck)
    cfg.trainer.log_file = str(part / "resumed.jsonl")
    res = ttrainer.fit(cfg, device="cpu")

    assert (res.step, res.gstep) == (res_full.step, res_full.gstep) == (4, 4)
    a, b = _state(res_full.model), _state(res.model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = res_full.optimizer.state_dict()["state"], res.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert torch.equal(res_full.generator.get_state(), res.generator.get_state())
    want = _lines(full / "metrics.jsonl")[2:]
    got = _lines(part / "resumed.jsonl")
    assert [line.get("epoch") for line in got] == [1, None]
    for g, w in zip(got, want):
        g.pop("epoch_time_s", None)
        w.pop("epoch_time_s", None)
        assert g == w


