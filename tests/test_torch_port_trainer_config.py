"""The port's trainer config and YAML reader against the JAX package's
`load_config` / `parse_cli` and PyYAML.

The port parses with PyYAML blocked (`sys.modules["yaml"] = None`): its
reader must stand alone, and resolve every scalar as `yaml.safe_load`."""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import yaml

from gapartnet_tpu.train import config as jconfig
from gapartnet_tpu_torch.train import config as tconfig
from gapartnet_tpu_torch.train import yaml_reader

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = ROOT / "configs" / "gapartnet.yaml"

# the tiny config of the verify recipe (flow lists, no quoting)
VERIFY_YAML = """\
model:
  init_args:
    backbone_type: SparseUNet
    backbone_cfg:
      channels: [8, 16]
      block_repeat: 1
    max_points: 256
    max_proposals: 16
    training_schedule: [0, 1]
data:
  init_args:
    root_dir: /tmp/verify_ds
    max_points: 256
    train_batch_size: 2
    val_batch_size: 2
    num_workers: 0
trainer:
  max_epochs: 2
  ckpt_dir: /tmp/verify_run/checkpoints   # ignored by the schema
  log_file: /tmp/verify_run/metrics.jsonl
  seed: 233
"""


def _iseg():
    return {"ball_query_radius": 0.1, "max_num_points_per_query": 8,
            "min_num_points_per_proposal": 3, "max_num_points_per_query_shift": 16,
            "score_fullscale": 28, "score_scale": 50}


def _smoke_raw(root="/data/smoke"):
    """tests/test_train_smoke.py's config (test_real_fit.py's has this shape)."""
    return {
        "model": {"class_path": "network.model.GAPartNet", "init_args": {
            "debug": True, "in_channels": 6, "num_part_classes": 10,
            "backbone_type": "SparseUNet",
            "backbone_cfg": {"channels": [8, 16], "block_repeat": 1},
            "instance_seg_cfg": _iseg(), "learning_rate": 0.001,
            "training_schedule": [0, 1], "max_points": 256, "max_proposals": 16,
            "max_instances": 8}},
        "data": {"class_path": "dataset.gapartnet.GAPartNetInst", "init_args": {
            "root_dir": root, "max_points": 256, "train_batch_size": 2, "val_batch_size": 2,
            "pos_jitter": 0.1, "color_jitter": 0.3, "flip_prob": 0.3, "rotate_prob": 0.3,
            "max_instances": 8}},
        "trainer": {"max_epochs": 2},
        "seed_everything": 233,
    }


def _resume_raw(root="/data/resume"):
    """tests/test_resume.py's config."""
    return {
        "model": {"init_args": {
            "in_channels": 6, "num_part_classes": 10, "backbone_type": "SparseUNet",
            "backbone_cfg": {"channels": [8, 16], "block_repeat": 1},
            "instance_seg_cfg": _iseg(), "learning_rate": 0.001, "training_schedule": [1, 2],
            "max_points": 256, "max_proposals": 16, "max_instances": 8}},
        "data": {"init_args": {"root_dir": root, "max_points": 256, "train_batch_size": 2,
                               "val_batch_size": 2, "max_instances": 8}},
        "trainer": {"max_epochs": 4},
        "seed_everything": 77,
    }


def _yaml_sources():
    return {
        "configs/gapartnet.yaml": FLAGSHIP.read_text(),
        "smoke": yaml.safe_dump(_smoke_raw()),
        "resume": yaml.safe_dump(_resume_raw()),
        "verify": VERIFY_YAML,
        "smoke, one-line flow style": yaml.safe_dump(_smoke_raw(), default_flow_style=True,
                                                     width=10 ** 6),
    }


def _port_parse(fn, *args):
    """fn(*args) with PyYAML blocked."""
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None
    try:
        return fn(*args)
    finally:
        sys.modules["yaml"] = saved


@pytest.mark.parametrize("name", list(_yaml_sources()))
def test_reader_equals_pyyaml(name):
    src = _yaml_sources()[name]
    assert _port_parse(yaml_reader.safe_load, src) == yaml.safe_load(src)


@pytest.mark.parametrize("text", [
    "True", "true", "False", "false", "yes", "No", "on", "OFF", "1e-3", "1.0e-3", "1.0e3",
    "0.01", "-0.5", ".5", "3.", "1_000", "010", "08", "0x1F", "0b101", "12:30", "1:30.5",
    "~", "null", "", ".inf", "-.Inf", "+5", "-0", "abc def", "'1e-3'", '"True"', "'it''s'",
    '"a\\tb"', "[1, 2.5, x, 'y']", "{}", "[]", "{a: 1, b: [2, 3]}", "monitor_metrics/mean_mAP",
    "x # comment", "a#b",
])
def test_scalars_resolve_as_pyyaml(text):
    src = f"k: {text}\n"
    got = _port_parse(yaml_reader.safe_load, src)["k"]
    want = yaml.safe_load(src)["k"]
    assert type(got) is type(want)
    assert got == want or (isinstance(want, float) and math.isnan(want) and math.isnan(got))


@pytest.mark.parametrize("src", ["k: &a 1", "k: *a", "k: !!str 1", "k: |\n  text", "k: [1,\n  2]",
                                 "k: 2001-12-14", "---\nk: 1", "k:\n\tv: 1"])
def test_reader_refuses_what_it_does_not_read(src):
    with pytest.raises(ValueError):
        yaml_reader.safe_load(src)


def _assert_same_config(port, ref):
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(port.data) == dataclasses.asdict(ref.data)
    assert dataclasses.asdict(port.trainer) == dataclasses.asdict(ref.trainer)


OVERRIDES = [
    [],
    [("model.init_args.training_schedule", "[0,0]"), ("data.init_args.train_batch_size", "8")],
    [("data.init_args.root_dir", "/tmp/ds"), ("data.init_args.auto_capacity", "True"),
     ("trainer.max_epochs", "2"), ("trainer.ckpt_path", "/tmp/run/last"),
     ("model.init_args.ckpt", "/tmp/run/last"), ("model.init_args.backbone_cfg.channels", "[8, 16]"),
     ("model.init_args.learning_rate", "1e-3"), ("seed_everything", "7")],
    # quirks kept: top-level channels and trainer.ckpt_dir / log_file are not read
    [("model.init_args.channels", "[8, 16]"), ("trainer.ckpt_dir", "/x"),
     ("trainer.log_file", "/x.jsonl"), ("model.init_args.unknown", "1")],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("name", ["configs/gapartnet.yaml", "smoke", "resume", "verify"])
def test_load_config_equals_jax(tmp_path, name, overrides):
    path = tmp_path / "config.yaml"
    path.write_text(_yaml_sources()[name])
    ref = jconfig.load_config(str(path), overrides)
    port = _port_parse(tconfig.load_config, str(path), overrides)
    _assert_same_config(port, ref)


def test_no_file_and_schema_quirks(tmp_path):
    _assert_same_config(tconfig.load_config(None), jconfig.load_config(None))
    path = tmp_path / "c.yaml"
    path.write_text(VERIFY_YAML)
    cfg = _port_parse(tconfig.load_config, str(path))
    assert cfg.model.channels == (8, 16)
    assert cfg.trainer.ckpt_dir == "checkpoints" and cfg.trainer.log_file == "metrics.jsonl"
    assert cfg.trainer.seed == 23333        # trainer.seed is not a read key
    flag = _port_parse(tconfig.load_config, str(FLAGSHIP))
    assert flag.trainer.save_top_k == 5 and flag.trainer.monitor == "monitor_metrics/mean_mAP"


@pytest.mark.parametrize("argv", [
    ["fit", "-c", "configs/gapartnet.yaml"],
    ["test", "--config", "c.yaml", "--model.init_args.ckpt", "last",
     "--model.init_args.training_schedule", "[0,0]"],
    ["fit", "--trainer.max_epochs", "3"],
])
@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_parse_cli_equals_jax(argv, device):
    full = argv if device is None else argv[:1] + ["--device", device] + argv[1:]
    sub, path, overrides, dev = tconfig.parse_cli(full)
    assert (sub, path, overrides) == jconfig.parse_cli(argv)
    assert dev == (device or "cuda")


@pytest.mark.parametrize("argv", [[], ["train"], ["fit", "stray"], ["fit", "--device"]])
def test_parse_cli_refuses(argv):
    with pytest.raises(SystemExit):
        tconfig.parse_cli(argv)
