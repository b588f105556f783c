"""Fit and test (counterpart of train/trainer.py).

  * fit: staged training (schedule [start_scorenet, start_npcs]), a
    validation over the three splits (val / test_intra / test_inter) every
    `val_every_n_epochs`, top-k checkpoints on `monitor`
    (monitor_metrics/mean_mAP) plus an always-current `last`;
  * test: warm-start a checkpoint, evaluate the three splits and print the
    metrics.

Metrics go to a JSONL file under the JAX trainer's names, letter for letter
(`eval_metric_names`, `train_metric_names`).  Every entry point runs on
`device` ("cuda" unless the caller passes "cpu"), in fp32 with TF32 off.
Metrics stay on the device as tensors and come to the host once per epoch
(training) and once per split (evaluation), in one transfer each.

Checkpoints are `torch.save` files (model and optimizer state_dicts, step,
epoch, gstep and the jitter generator's state), read with
`torch.load(weights_only=True)`.  Not ported: the test-time renders
(`trainer.visualize`; ROADMAP Queue 1 item 14) and the multi-process
paths (sharded datasets, the cross-process metric mean; item 12).
"""

import dataclasses
import json
import os
import time
import zlib
from datetime import datetime
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gapartnet_tpu_torch.config import eval_capacity_config
from gapartnet_tpu_torch.constants import PART_ID2NAME
from gapartnet_tpu_torch.data.loader import GAPartNetDataset, collate
from gapartnet_tpu_torch.entry import make_model, use_fp32_math
from gapartnet_tpu_torch.eval.ap import APEvaluator, _proposal_pred_classes, select_eval_proposals
from gapartnet_tpu_torch.ops.segment import segment_sum
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train.config import Config
from gapartnet_tpu_torch.train.loop import adam, eval_step, stage_flags, train_step

SPLITS = ("val", "test_intra", "test_inter")
# the counters of an eval forward without and with the instance stages
EVAL_COUNTERS = {
    False: ("backbone_voxels_dropped",),
    True: ("backbone_voxels_dropped", "ccl_cand_truncated", "ccl_node_overflow",
           "dense_grids_dropped", "dropped_proposals", "proposal_voxels_dropped"),
}
TRAIN_COUNTERS = {
    False: ("backbone_voxels_dropped",),
    True: ("backbone_voxels_dropped", "ccl_cand_truncated", "ccl_node_overflow",
           "dropped_proposals", "proposal_voxels_dropped"),
}


def run_name(cfg: Config) -> str:
    """Config-derived run name (reference train.py:7-41): backbone tag,
    focal/dice flags, batch size, augmentation parameters, timestamp."""
    model_str = {"SparseUNet": "SU", "PointNet": "PN"}.get(
        cfg.model.backbone_type, cfg.model.backbone_type
    )
    model_str += "_" + ("T" if cfg.model.use_sem_focal_loss else "F")
    model_str += "T" if cfg.model.use_sem_dice_loss else "F"
    d = cfg.data
    data_str = (
        f"BS{d.train_batch_size}_"
        f"Aug{d.pos_jitter}-{d.color_jitter}-{d.flip_prob}-{d.rotate_prob}"
    )
    return f"{model_str}_{data_str}_{datetime.now().strftime('%m-%d-%H-%M')}"


class MetricLogger:
    """Appends one JSON line per `log` call (and logs to wandb when asked
    and importable)."""

    def __init__(self, log_file: str, use_wandb: bool = False, run_name: str = ""):
        self.path = Path(log_file)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project="gapartnet_tpu", name=run_name or None)
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)


def host_copy(tree):
    """`tree` (nested dicts, lists and tuples) with every tensor replaced by
    a numpy array of its dtype, in one device-to-host transfer: the tensors
    travel as one float64 vector, which holds every int32, bool and float32
    value exactly."""
    leaves = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves]).cpu().numpy()
    arrays, at = [], 0
    for t in leaves:
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        arrays.append(flat[at:at + t.numel()].astype(dtype).reshape(tuple(t.shape)))
        at += t.numel()
    it = iter(arrays)

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


class Prefetcher:
    """Runs a batch generator (and `transform`, e.g. the copy to the
    device) in a producer thread, `depth` batches ahead, so the next batch
    is loaded while the device computes this one.  Order is kept; an
    exception in the producer is raised again in the consumer.

    The trainer's transform is PointCloudBatch.from_numpy: a plain,
    synchronous copy, which the legacy default stream orders before any
    kernel the consumer launches later."""

    def __init__(self, gen, depth: int = 2, transform=None):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._done = object()

        def run():
            try:
                for item in gen:
                    self._q.put(item if transform is None else transform(item))
                self._q.put(self._done)
            except BaseException as e:  # re-raised on the consumer side
                self._q.put(e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def _pad_trailing(samples, batch_size):
    """Pad a trailing partial batch with copies of the last sample whose
    points are all masked out (no valid point, no instance), so every batch
    has `batch_size` clouds."""
    while len(samples) < batch_size:
        filler = {k: np.copy(v) if isinstance(v, np.ndarray) else v
                  for k, v in samples[-1].items()}
        filler["point_mask"] = np.zeros_like(filler["point_mask"])
        filler["num_points_per_instance"] = np.zeros_like(filler["num_points_per_instance"])
        filler["instance_sem_labels"] = np.full_like(filler["instance_sem_labels"], -1)
        filler["pc_id"] = "__pad__"
        samples.append(filler)
    return samples


def _iter_batches(dataset: GAPartNetDataset, batch_size: int, drop_last: bool,
                  shuffle_seed: Optional[int] = None, workers: int = 0,
                  lookahead: int = 3):
    """Collated batches; `workers` > 1 threads load samples in parallel,
    `lookahead` batches ahead.  A shuffle_seed shuffles the order with a
    NumPy RandomState and sets the dataset's augmentation epoch to it, so
    the stream does not depend on the worker count."""
    order = np.arange(len(dataset))
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(order)
        if hasattr(dataset, "epoch"):
            dataset.epoch = shuffle_seed
    n = len(order)
    end = n - (n % batch_size) if drop_last else n
    starts = list(range(0, end, batch_size))
    if workers and workers > 1:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = deque()
            bi = 0
            while bi < len(starts) or pending:
                while bi < len(starts) and len(pending) <= lookahead:
                    idxs = order[starts[bi]: starts[bi] + batch_size]
                    pending.append([pool.submit(dataset.__getitem__, int(i)) for i in idxs])
                    bi += 1
                yield collate(_pad_trailing([f.result() for f in pending.popleft()], batch_size))
        return
    for s in starts:
        idxs = order[s: s + batch_size]
        yield collate(_pad_trailing([dataset[int(i)] for i in idxs], batch_size))


def cpu_tree(x):
    """`x` (nested dicts, lists, tuples, NamedTuples and dataclasses) with
    every tensor detached and copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: cpu_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[cpu_tree(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(cpu_tree(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: cpu_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _save(payload: dict, path: str, tmp: str) -> None:
    """torch.save to `tmp`, then an atomic rename onto `path`."""
    torch.save(payload, tmp)
    os.replace(tmp, path)


@dataclasses.dataclass
class CkptManager:
    """Top-k checkpoints on a monitored metric (ModelCheckpoint semantics,
    gapartnet.yaml:77-84), later epochs winning ties, plus `last`, swapped
    in atomically after every save.  The monitor's last name component is
    part of each file name, so scores of different monitors are never
    compared by name."""

    ckpt_dir: str
    save_top_k: int = 5
    save_last: bool = True
    monitor: str = "monitor_metrics/mean_mAP"
    kept: List = dataclasses.field(default_factory=list)  # (score, epoch, path)

    def __post_init__(self):
        Path(self.ckpt_dir).mkdir(parents=True, exist_ok=True)

    def save(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, epoch: int,
             score: float, generator: Optional[torch.Generator] = None, gstep: int = 0,
             step: int = 0) -> str:
        slug = self.monitor.rsplit("/", 1)[-1]
        path = os.path.abspath(os.path.join(self.ckpt_dir, f"epoch_{epoch:03d}_{slug}_{score:.2f}"))
        payload = dict(model=cpu_tree(model.state_dict()),
                       optimizer=cpu_tree(optimizer.state_dict()),
                       step=int(step), epoch=int(epoch), gstep=int(gstep))
        if generator is not None:
            payload["generator"] = generator.get_state()
        _save(payload, path, path + ".tmp")
        self.kept.append((score, epoch, path))
        self.kept.sort(key=lambda t: (-t[0], -t[1]))
        while len(self.kept) > self.save_top_k:
            worst = self.kept.pop()[-1]
            if os.path.exists(worst):
                os.remove(worst)
        if self.save_last:
            last = os.path.abspath(os.path.join(self.ckpt_dir, "last"))
            _save(payload, last, last + f".tmp_{epoch:03d}")
        return path

    @staticmethod
    def restore(path: str) -> dict:
        return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_warm_start(model: torch.nn.Module, ckpt_path: str) -> List[str]:
    """strict=False warm start (reference model.py:132-143): the
    checkpoint's matching weights are loaded, missing keys keep their values
    (each is printed), unexpected ones are ignored.  Returns the missing
    keys."""
    sd = CkptManager.restore(ckpt_path)["model"]
    missing, _ = model.load_state_dict(sd, strict=False)
    for k in missing:
        print(f"missing key (kept init): {k}")
    return list(missing)


def build_datasets(cfg: Config, stage: str) -> Dict[str, GAPartNetDataset]:
    """The split datasets of `stage` ("fit" adds the augmenting train
    split), one process."""
    d = cfg.data
    root = Path(d.root_dir)
    common = dict(max_points=d.max_points, max_instances=d.max_instances,
                  few_shot_num=d.few_shot_num, nopart_path=d.nopart_path)
    datasets = {}
    if stage == "fit":
        roots = ([root / s / "pth" for s in ("train", "val", "test_intra", "test_inter")]
                 if d.train_with_all else root / "train" / "pth")
        datasets["train"] = GAPartNetDataset(
            roots, shuffle=True, augmentation=True, few_shot=d.train_few_shot,
            pos_jitter=d.pos_jitter, color_jitter=d.color_jitter,
            flip_prob=d.flip_prob, rotate_prob=d.rotate_prob, **common,
        )
    for split, few in (("val", d.val_few_shot), ("test_intra", d.intra_few_shot),
                       ("test_inter", d.inter_few_shot)):
        datasets[split] = GAPartNetDataset(root / split / "pth", shuffle=False,
                                           augmentation=False, few_shot=few, **common)
    return datasets


def reduce_eval_outputs(out, batch: PointCloudBatch, model_cfg, do_instance: bool) -> dict:
    """The small per-batch results an evaluation needs, from an eval
    forward's outputs, on their device: accuracies, the (C, C) confusion
    matrix of valid points, the counters, and with `do_instance` the keep
    mask of the score / size filter and NMS (at `model_cfg`'s capacities
    and thresholds), each proposal's predicted class (the sem pred at its
    lowest-index point, model.py:825), scores and IoUs."""
    c = model_cfg.num_part_classes
    labels = batch.sem_labels
    valid = batch.point_mask & (labels >= 0)
    fused = labels.clamp(0, c - 1) * c + out.sem_preds.clamp(0, c - 1)
    ones = torch.ones(fused.numel(), dtype=torch.float32, device=fused.device)
    conf = segment_sum(ones, fused.reshape(-1), c * c, mask=valid.reshape(-1)).reshape(c, c)
    res = dict(all_accu=out.all_accu, pixel_accu=out.pixel_accu, conf=conf)
    for cname in sorted(out.counters or ()):
        res[f"counters/{cname}"] = out.counters[cname].sum().to(torch.float32)
    if do_instance:
        res.update(
            keep=select_eval_proposals(out, model_cfg, model_cfg.max_points),
            rep_cls=_proposal_pred_classes(out.proposals, out.sem_preds),
            scores=out.score_preds, ious=out.ious,
        )
    return res


def make_reduced_eval_step(model, cfg: Config, do_instance: bool):
    """`step(batch)` -> `reduce_eval_outputs` of the model's eval forward
    (make_reduced_eval_step of the JAX trainer).  Capacities come from the
    model's own cfg (the eval model may carry the eval ones)."""
    flags = dict(do_cluster=do_instance, do_score=do_instance, do_npcs=do_instance)

    def step(batch: PointCloudBatch) -> dict:
        return reduce_eval_outputs(eval_step(model, batch, **flags), batch, model.cfg, do_instance)

    return step


def _records_from_reduced(r) -> tuple:
    """One reduced eval batch (on the host) as the arguments of
    APEvaluator.add (eval/ap.batch_to_records' semantics)."""
    keep, scores, rep_cls = (np.asarray(r[k]) for k in ("keep", "scores", "rep_cls"))
    ious = np.asarray(r["ious"]) if r.get("ious") is not None else None
    flat_scores, flat_cls, flat_sample, flat_ious = [], [], [], []
    for bi in range(keep.shape[0]):
        sel = np.nonzero(keep[bi])[0]
        flat_scores.append(scores[bi, sel])
        flat_cls.append(rep_cls[bi, sel])
        flat_sample.append(np.full(len(sel), bi))
        if ious is not None:
            flat_ious.append(ious[bi, sel])
    return (np.concatenate(flat_scores), np.concatenate(flat_cls), np.concatenate(flat_sample),
            np.concatenate(flat_ious) if ious is not None else None)


def eval_metric_names(cfg: Config, do_instance: bool) -> List[str]:
    """Every name an evaluation can log, in the order of the JAX trainer's
    `_expected_eval_keys` (trainer.py:574-625); a per-class recall is
    logged only when its class has points in the split."""
    per_split = ["AP@50", "mAP", "all_accu", "pixel_accu", "miou"]
    per_split += [f"recall_{PART_ID2NAME[ci]}" for ci in range(1, cfg.model.num_part_classes)]
    per_split += ["recall_macro", "recall_min", "recall_gmp"]
    if do_instance:
        per_split += [f"AP@50_{PART_ID2NAME[ci]}" for ci in range(1, cfg.model.num_part_classes)]
    keys = []
    for split in SPLITS:
        keys += [f"{split}/{m}" for m in per_split]
        keys += [f"{split}/counters/{c}" for c in EVAL_COUNTERS[do_instance]]
    keys += [f"monitor_metrics/mean_{m}" for m in ("all_accu", "pixel_accu", "imou", "AP@50", "mAP")]
    return keys


def train_metric_names(do_cluster: bool) -> List[str]:
    """The names of an epoch's training line (besides `step`)."""
    names = ["train_loss/total_loss"] + [
        f"train_loss/{k}" for k in ("loss_sem_seg", "loss_offset_dist", "loss_offset_dir",
                                    "loss_prop_score", "loss_prop_npcs")]
    names += ["train_all_accu", "train_pixel_accu"]
    names += [f"train_counters/{c}" for c in TRAIN_COUNTERS[do_cluster]]
    return names + ["epoch", "epoch_time_s"]


def _check_supported(cfg: Config) -> None:
    if cfg.trainer.visualize:
        raise NotImplementedError(
            "trainer.visualize: the test-time renders need utils/visu.py, which is not ported "
            "yet (ROADMAP Queue 1 item 14)")


def evaluate_splits(model, cfg: Config, datasets, epoch: int, logger: MetricLogger, step: int,
                    do_instance: bool, device="cuda", step_cache: Optional[dict] = None):
    """Validation / test over the three splits; logs the metrics and
    returns (the monitor metric, the metrics).  Names and definitions are
    the JAX trainer's (model.py:694-805, 859-1049): AP@50, mAP, accuracies,
    mIoU over one confusion matrix per split, per-class recalls and their
    macro / min / balance-gated monitors, per-class AP@50, counters, and
    the monitor means over test_intra and test_inter."""
    _check_supported(cfg)
    if step_cache is None:
        step_cache = {}
    if ("reduced", do_instance) not in step_cache:
        step_cache[("reduced", do_instance)] = make_reduced_eval_step(model, cfg, do_instance)
    reduced_step = step_cache[("reduced", do_instance)]
    num_classes = cfg.model.num_part_classes

    split_stats: Dict[str, Dict[str, float]] = {}
    metrics: Dict[str, float] = {}
    for split in SPLITS:
        ds = datasets[split]
        evaluator = APEvaluator(num_classes)
        conf = np.zeros((num_classes, num_classes), np.int64)
        accu_sum, pix_sum, batches = 0.0, 0.0, 0
        counter_sums: Dict[str, float] = {}
        pending = []
        for batch in Prefetcher(
            _iter_batches(ds, cfg.data.val_batch_size, drop_last=False,
                          workers=cfg.data.num_workers),
            transform=lambda raw: PointCloudBatch.from_numpy(raw, device),
        ):
            pending.append((reduced_step(batch), batch.instance_sem_labels))
            batches += 1
        if batches == 0:
            continue
        for r, inst_sem_labels in host_copy(pending):
            accu_sum += float(r["all_accu"])
            pix_sum += float(r["pixel_accu"])
            conf += r["conf"].astype(np.int64)
            for k in r:
                if k.startswith("counters/"):
                    counter_sums[k] = counter_sums.get(k, 0.0) + float(r[k])
            if do_instance and r.get("ious") is not None:
                s, c, si, io = _records_from_reduced(r)
                evaluator.add(s, c, si, io, inst_sem_labels)
        all_accu = accu_sum / batches
        pixel_accu = pix_sum / batches
        # one confusion matrix over the split's valid points; a class absent
        # from predictions and labels counts as IoU 1
        tp = np.diag(conf)
        total = conf.sum(0) + conf.sum(1) - tp
        iou = np.where(total > 0, tp / np.maximum(total, 1e-8), 1.0)
        miou = float(iou.mean())
        gt_count = conf.sum(1)
        class_recalls = []
        for ci in range(1, num_classes):
            if gt_count[ci] > 0:
                rec = float(tp[ci] / gt_count[ci]) * 100
                metrics[f"{split}/recall_{PART_ID2NAME[ci]}"] = rec
                class_recalls.append(rec)
        if class_recalls:
            metrics[f"{split}/recall_macro"] = float(np.mean(class_recalls))
            metrics[f"{split}/recall_min"] = float(np.min(class_recalls))
            metrics[f"{split}/recall_gmp"] = float(
                np.exp(np.mean(np.log1p(class_recalls))) * pixel_accu
            )
        if do_instance:
            m = evaluator.compute_map()
            ap50, mAP, per_class = m["AP50"], m["mAP"], m["AP50_per_class"]
            for ci in range(1, num_classes):
                metrics[f"{split}/AP@50_{PART_ID2NAME[ci]}"] = per_class[ci - 1] * 100
        else:
            ap50, mAP = 0.0, 0.0
        for k, v in counter_sums.items():
            metrics[f"{split}/{k}"] = v
            if v > 0:
                print(f"[gapartnet_tpu_torch] WARNING {split}/{k} = {v:.0f}: a fixed-shape "
                      "capacity clipped real data this eval")
        metrics[f"{split}/AP@50"] = ap50 * 100
        metrics[f"{split}/mAP"] = mAP * 100
        metrics[f"{split}/all_accu"] = all_accu * 100
        metrics[f"{split}/pixel_accu"] = pixel_accu * 100
        metrics[f"{split}/miou"] = miou * 100
        split_stats[split] = dict(all_accu=all_accu, pixel_accu=pixel_accu, miou=miou,
                                  ap50=ap50, mAP=mAP)

    # monitor metrics: the mean of test_intra and test_inter (model.py:1024-1046)
    if "test_intra" in split_stats and "test_inter" in split_stats:
        intra, inter = split_stats["test_intra"], split_stats["test_inter"]
        for name, key in (("all_accu", "all_accu"), ("pixel_accu", "pixel_accu"),
                          ("imou", "miou"), ("AP@50", "ap50"), ("mAP", "mAP")):
            metrics[f"monitor_metrics/mean_{name}"] = (intra[key] + inter[key]) / 2 * 100

    logger.log(metrics, step)
    return metrics.get(cfg.trainer.monitor, 0.0), metrics


def _apply_auto_capacity(cfg: Config, datasets) -> None:
    """Size cfg.model's level capacities, grid extent and hash-CCL tables
    from the datasets (data/capacity.py) when `data.auto_capacity` is on."""
    if not cfg.data.auto_capacity or cfg.model.backbone_type != "SparseUNet":
        return
    from gapartnet_tpu_torch.data.capacity import scan_dataset_shapes, scan_hash_capacities

    sets = [d for d in datasets.values() if d is not None]
    caps, extent = scan_dataset_shapes(sets, cfg.model.voxel_size,
                                       len(cfg.model.level_capacity_divisors), cfg.model.max_points)
    node_cap, cand_cap, degree = scan_hash_capacities(sets, cfg.model.ball_query_radius,
                                                      max_points=cfg.model.max_points)
    cfg.model = dataclasses.replace(
        cfg.model, level_capacities=caps, input_grid_extent=extent,
        hash_node_capacity=node_cap, hash_cand_cap=cand_cap, hash_max_degree=degree,
    )
    print(f"[gapartnet_tpu_torch] auto_capacity: level capacities {caps}, grid extent {extent}, "
          f"hash nodes/set {node_cap}, hash cand cap {cand_cap}, max degree {degree}", flush=True)


def _setup(cfg: Config, device) -> torch.device:
    _check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available (torch.cuda.is_available() "
                           "is false); pass device='cpu' (--device cpu) to run on the CPU")
    use_fp32_math()
    return device


def generator_crc(generator: torch.Generator) -> int:
    """CRC-32 of a generator's state (printed on resume)."""
    return zlib.crc32(generator.get_state().numpy().tobytes())


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int
    gstep: int


def fit(cfg: Config, device="cuda") -> TrainState:
    """Train from cfg (seeded random weights; `trainer.ckpt_path` resumes a
    run at the epoch after its checkpoint's; `model.init_args.ckpt` warm
    starts).  The per-epoch evaluations run a view of the model with the
    eval capacities (config.eval_capacity_config) when auto_capacity is on:
    it shares the model's parameters and buffers."""
    device = _setup(cfg, device)
    datasets = build_datasets(cfg, "fit")
    _apply_auto_capacity(cfg, datasets)
    model = make_model(cfg.model, device, seed=cfg.trainer.seed)
    eval_model = model.with_config(eval_capacity_config(cfg.model)) if cfg.data.auto_capacity else model
    logger = MetricLogger(cfg.trainer.log_file, cfg.trainer.use_wandb, run_name=run_name(cfg))
    freeze = tuple(cfg.trainer.freeze_prefixes)
    optimizer = adam(model.named_parameters(), cfg.trainer.learning_rate, freeze)
    generator = torch.Generator().manual_seed(cfg.trainer.seed)

    step = gstep = start_epoch = 0
    if cfg.trainer.ckpt_path:
        restored = CkptManager.restore(cfg.trainer.ckpt_path)
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        if "generator" in restored:
            generator.set_state(restored["generator"])
        step, gstep = int(restored["step"]), int(restored.get("gstep", 0))
        start_epoch = int(restored["epoch"]) + 1
        print(f"[gapartnet_tpu_torch] full resume from {cfg.trainer.ckpt_path} at epoch "
              f"{start_epoch} (step {step}, gstep {gstep}, jitter generator state crc32 "
              f"{generator_crc(generator):08x})", flush=True)
    if cfg.trainer.resume_ckpt:
        load_warm_start(model, cfg.trainer.resume_ckpt)

    ckpts = CkptManager(cfg.trainer.ckpt_dir, cfg.trainer.save_top_k, monitor=cfg.trainer.monitor)
    eval_cache: dict = {}
    for epoch in range(start_epoch, cfg.trainer.max_epochs):
        flags = stage_flags(epoch, cfg.trainer.training_schedule)
        t0 = time.time()
        losses = []
        for batch in Prefetcher(
            _iter_batches(datasets["train"], cfg.data.train_batch_size, drop_last=True,
                          shuffle_seed=cfg.trainer.seed + epoch, workers=cfg.data.num_workers),
            transform=lambda raw: PointCloudBatch.from_numpy(raw, device),
        ):
            losses.append(train_step(model, optimizer, batch, generator, **flags,
                                      freeze_prefixes=freeze))
            step += 1
            gstep += 1
        if losses:
            losses = host_copy(losses)
            mean = {
                ("train_" + k if not k.startswith("loss") else f"train_loss/{k.split('/')[-1]}"):
                    float(np.mean([float(x[k]) for x in losses]))
                for k in sorted(losses[0])      # the JAX line's order (a pytree's keys)
            }
            mean["epoch"] = epoch
            mean["epoch_time_s"] = time.time() - t0
            for k, v in mean.items():
                if "counters/" in k and v > 0:
                    print(f"[gapartnet_tpu_torch] WARNING {k} = {v:.1f}/step: a fixed-shape "
                          "capacity clipped real data this epoch")
            logger.log(mean, gstep)

        if (epoch + 1) % cfg.trainer.val_every_n_epochs == 0:
            monitor, _ = evaluate_splits(eval_model, cfg, datasets, epoch, logger, gstep,
                                         do_instance=flags["do_score"], device=device,
                                         step_cache=eval_cache)
            ckpts.save(model, optimizer, epoch, monitor, generator=generator, gstep=gstep,
                       step=step)
    return TrainState(model, optimizer, generator, step, gstep)


def test(cfg: Config, device="cuda") -> Dict[str, float]:
    """Evaluate the three splits with the weights of `model.init_args.ckpt`
    (warm start; seeded random weights without one); with auto_capacity,
    at the eval capacities.  Prints and returns the metrics."""
    device = _setup(cfg, device)
    datasets = build_datasets(cfg, "test")
    _apply_auto_capacity(cfg, datasets)
    if cfg.data.auto_capacity:
        cfg.model = eval_capacity_config(cfg.model)
    model = make_model(cfg.model, device, seed=cfg.trainer.seed)
    logger = MetricLogger(cfg.trainer.log_file, cfg.trainer.use_wandb)
    if cfg.trainer.resume_ckpt:
        load_warm_start(model, cfg.trainer.resume_ckpt)
    _, metrics = evaluate_splits(model, cfg, datasets, 0, logger, 0, do_instance=True,
                                 device=device)
    for k in sorted(metrics):
        print(f"{k}: {metrics[k]:.2f}")
    return metrics
