"""One training step (counterpart of train/loop.py).

`train_step` is `make_train_step` of the JAX package without
`freeze_prefixes`: the train-mode forward with the stage flags, the
backward of the total loss, one Adam update, and the metrics under the
reference's logging names.  The BatchNorm running statistics move inside
the forward, in place.
"""

from typing import Dict, Iterable, Optional, Tuple

import torch

from gapartnet_tpu_torch.models.gapartnet import GAPartNet, ModelOutput
from gapartnet_tpu_torch.structures import PointCloudBatch


def stage_flags(epoch: int, training_schedule: Tuple[int, int]) -> Dict[str, bool]:
    """Reference gating: clustering and ScoreNet from start_scorenet
    (= schedule[0]; start_clustering = min of both), NPCS from start_npcs
    (= schedule[1])."""
    start_scorenet, start_npcs = training_schedule
    start_clustering = min(start_scorenet, start_npcs)
    return dict(
        do_cluster=epoch >= start_clustering,
        do_score=epoch >= start_scorenet,
        do_npcs=epoch >= start_npcs,
    )


def loss_metrics(out: ModelOutput) -> Dict[str, torch.Tensor]:
    """The reference's metric names, as detached tensors; capacity-overflow
    counters under counters/* (nonzero means a fixed capacity clipped real
    data)."""
    metrics = {"loss/total_loss": out.total_loss}
    for k in ModelOutput.LOSSES:
        metrics[f"loss/{k}"] = getattr(out, k)
    metrics["all_accu"] = out.all_accu * 100.0
    metrics["pixel_accu"] = out.pixel_accu * 100.0
    for k in sorted(out.counters or ()):
        metrics[f"counters/{k}"] = out.counters[k].sum().to(torch.float32)
    return {k: v.detach() for k, v in metrics.items()}


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3) -> torch.optim.Adam:
    """Adam over `params` with the reference's settings (b1 0.9, b2 0.999,
    eps 1e-8), as `adam` of train/loop.py:162-177 builds with optax."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    model: GAPartNet,
    optimizer: torch.optim.Optimizer,
    batch: PointCloudBatch,
    generator: torch.Generator,
    do_cluster: bool,
    do_score: bool,
    do_npcs: bool,
    cluster_sem_override: Optional[torch.Tensor] = None,
    cluster_offset_override: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Forward (train mode), backward, one optimizer step; returns the
    metrics as tensors on the model's device (nothing is synchronised).

    The cube-placement jitter is drawn as torch.rand((2, 3)) from
    `generator` on the CPU, so the card and the CPU place the cubes alike."""
    model.train()
    jitter = torch.rand((2, 3), generator=generator)
    optimizer.zero_grad(set_to_none=True)
    out = model(
        batch, do_cluster=do_cluster, do_score=do_score, do_npcs=do_npcs,
        cluster_sem_override=cluster_sem_override,
        cluster_offset_override=cluster_offset_override, jitter=jitter,
    )
    out.total_loss.backward()
    optimizer.step()
    return loss_metrics(out)
