"""Trainer configuration (counterpart of train/config.py): the reference's
gapartnet.yaml schema (LightningCLI layout: model.class_path / init_args,
data.init_args, trainer, seed_everything) read into dataclasses, with the
reference CLI's dotted overrides (`--model.init_args.X value`).

The schema is read exactly as the JAX package reads it, quirks included:
`channels` and `block_repeat` count only under `model.init_args.backbone_cfg`,
and of the trainer keys only `max_epochs`, `ckpt_path` and the
ModelCheckpoint callback's `save_top_k` / `monitor` are read (so a yaml's
`trainer.ckpt_dir` or `trainer.log_file` is ignored).  The file is parsed
by the port's own YAML reader (`yaml_reader`), never by PyYAML.
"""

import ast
import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.train import yaml_reader


@dataclasses.dataclass
class DataConfig:
    root_dir: str = "data/GAPartNet_All"
    max_points: int = 20000
    voxel_size: Tuple[float, float, float] = (0.01, 0.01, 0.01)
    train_batch_size: int = 64
    val_batch_size: int = 32
    test_batch_size: int = 32
    num_workers: int = 16
    pos_jitter: float = 0.1
    color_jitter: float = 0.3
    flip_prob: float = 0.3
    rotate_prob: float = 0.3
    train_few_shot: bool = False
    val_few_shot: bool = False
    intra_few_shot: bool = False
    inter_few_shot: bool = False
    few_shot_num: int = 640
    train_with_all: bool = False
    nopart_path: str = "data/nopart.txt"
    max_instances: int = 64
    # size the model's level capacities, grid extent and hash-CCL tables
    # from a scan of the datasets at setup (data/capacity.py)
    auto_capacity: bool = False


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 700
    learning_rate: float = 1e-3
    training_schedule: Tuple[int, int] = (5, 10)
    seed: int = 23333
    ckpt_dir: str = "checkpoints"
    save_top_k: int = 5
    monitor: str = "monitor_metrics/mean_mAP"
    log_file: str = "metrics.jsonl"
    resume_ckpt: str = ""           # warm start (strict=False)
    # top-level modules kept fixed: no update, no Adam moments, and their
    # BatchNorm running statistics pinned (train.loop)
    freeze_prefixes: Tuple[str, ...] = ()
    ckpt_path: str = ""             # full resume: weights, optimizer, jitter generator, epoch
    val_every_n_epochs: int = 1
    use_wandb: bool = False
    debug: bool = True
    # test-time renders (trainer.visualize_samples; writing them needs cv2)
    visualize: bool = False
    visualize_dir: str = "visu"
    visualize_sample_num: int = 10
    visualize_raw_root: str = ""


@dataclasses.dataclass
class Config:
    model: GAPartNetConfig
    data: DataConfig
    trainer: TrainerConfig


_MODEL_KEY_MAP = {
    # init_args name (reference) -> GAPartNetConfig field
    "in_channels": "in_channels",
    "num_part_classes": "num_part_classes",
    "ignore_sem_label": "ignore_sem_label",
    "use_sem_focal_loss": "use_sem_focal_loss",
    "sem_focal_alpha": "sem_focal_alpha",
    "use_sem_dice_loss": "use_sem_dice_loss",
    "symmetry_indices": "symmetry_indices",
    "val_score_threshold": "val_score_threshold",
    "val_min_num_points_per_proposal": "val_min_num_points_per_proposal",
    "val_nms_iou_threshold": "val_nms_iou_threshold",
    "val_ap_iou_threshold": "val_ap_iou_threshold",
    "max_points": "max_points",
    "max_proposals": "max_proposals",
    "max_instances": "max_instances",
    "voxel_size": "voxel_size",
    "backbone_type": "backbone_type",
    "clustering_impl": "clustering_impl",
    "hash_node_capacity": "hash_node_capacity",
    "hash_cand_cap": "hash_cand_cap",
    "hash_max_degree": "hash_max_degree",
    "conv_compute_dtype": "conv_compute_dtype",
    "rulebook_impl": "rulebook_impl",
    "input_grid_extent": "input_grid_extent",
    "proposal_voxel_capacity": "proposal_voxel_capacity",
    "dense_grid_capacity": "dense_grid_capacity",
    "remat_blocks": "remat_blocks",
}

_INSTANCE_SEG_KEYS = {
    "ball_query_radius",
    "max_num_points_per_query",
    "min_num_points_per_proposal",
    "max_num_points_per_query_shift",
    "score_fullscale",
    "score_scale",
}


def _coerce(value: Any):
    """A CLI override's value: a Python literal where it parses as one."""
    if isinstance(value, str):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    return value


def _to_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


def config_from_yaml_dict(raw: Dict[str, Any]) -> Config:
    model_args = dict((raw.get("model") or {}).get("init_args") or {})
    data_args = dict((raw.get("data") or {}).get("init_args") or {})
    trainer_args = dict(raw.get("trainer") or {})

    mkw: Dict[str, Any] = {}
    if "backbone_type" in model_args:
        mkw["backbone_type"] = model_args["backbone_type"]
    backbone_cfg = model_args.pop("backbone_cfg", {}) or {}
    if "channels" in backbone_cfg:
        mkw["channels"] = _to_tuple(backbone_cfg["channels"])
    if "block_repeat" in backbone_cfg:
        mkw["block_repeat"] = backbone_cfg["block_repeat"]
    iseg = model_args.pop("instance_seg_cfg", {}) or {}
    for k, v in iseg.items():
        if k in _INSTANCE_SEG_KEYS:
            mkw[k] = v
    for k, v in model_args.items():
        if k in _MODEL_KEY_MAP:
            mkw[_MODEL_KEY_MAP[k]] = _to_tuple(v)
    model = GAPartNetConfig(**mkw)

    dkw = {
        f.name: _to_tuple(data_args[f.name])
        for f in dataclasses.fields(DataConfig)
        if f.name in data_args
    }
    dkw.setdefault("max_points", model.max_points)
    data = DataConfig(**dkw)

    tkw: Dict[str, Any] = {}
    if "max_epochs" in trainer_args:
        tkw["max_epochs"] = trainer_args["max_epochs"]
    tkw["learning_rate"] = model_args.get("learning_rate", 1e-3)
    tkw["training_schedule"] = _to_tuple(model_args.get("training_schedule", (5, 10)))
    tkw["seed"] = raw.get("seed_everything", 23333)
    tkw["resume_ckpt"] = model_args.get("ckpt", "")
    tkw["ckpt_path"] = trainer_args.get("ckpt_path", "")
    tkw["debug"] = model_args.get("debug", True)
    vcfg = model_args.get("visualize_cfg", {}) or {}
    if vcfg:
        tkw["visualize"] = bool(vcfg.get("visualize", False))
        tkw["visualize_dir"] = vcfg.get("SAVE_ROOT", vcfg.get("visualize_dir", "visu"))
        tkw["visualize_sample_num"] = vcfg.get("sample_num", 10)
        tkw["visualize_raw_root"] = vcfg.get("RAW_IMG_ROOT", vcfg.get("visualize_raw_root", ""))
    for cb in trainer_args.get("callbacks", []) or []:
        if "ModelCheckpoint" in str(cb.get("class_path", "")):
            ia = cb.get("init_args", {}) or {}
            tkw["save_top_k"] = ia.get("save_top_k", 5)
            tkw["monitor"] = ia.get("monitor", "monitor_metrics/mean_mAP")
    trainer = TrainerConfig(**tkw)

    return Config(model=model, data=data, trainer=trainer)


def load_config(path: Optional[str], overrides: Optional[List[Tuple[str, str]]] = None) -> Config:
    """Read the yaml at `path` (if any), apply the dotted overrides, e.g.
    ("model.init_args.training_schedule", "[0,0]"), and build the Config."""
    raw: Dict[str, Any] = {}
    if path:
        raw = yaml_reader.safe_load(Path(path).read_text()) or {}
    for key, value in overrides or []:
        parts = key.lstrip("-").split(".")
        node = raw
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _coerce(value)
    return config_from_yaml_dict(raw)


def parse_cli(argv: List[str]):
    """(subcommand, config_path, [(dotted_key, value), ...], device).

    `--device cuda|cpu` (default cuda) is the port's one extra argument; it
    is taken out before the rest is read as dotted overrides."""
    usage = ("usage: python -m gapartnet_tpu_torch.train.cli {fit,test} [-c config.yaml] "
             "[--dotted.key value ...] [--device cuda|cpu]")
    if not argv or argv[0] not in ("fit", "test"):
        raise SystemExit(usage)
    sub = argv[0]
    cfg_path = None
    device = "cuda"
    overrides = []
    i = 1
    while i < len(argv):
        a = argv[i]
        if i + 1 >= len(argv):
            raise SystemExit(f"{a} needs a value\n{usage}")
        if a in ("-c", "--config"):
            cfg_path = argv[i + 1]
        elif a == "--device":
            device = argv[i + 1]
        elif a.startswith("--"):
            overrides.append((a[2:], argv[i + 1]))
        else:
            raise SystemExit(f"unexpected argument {a}\n{usage}")
        i += 2
    return sub, cfg_path, overrides, device
