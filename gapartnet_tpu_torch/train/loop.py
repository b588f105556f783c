"""Training and evaluation steps (counterpart of train/loop.py).

`train_step` is `make_train_step` of the JAX package: the train-mode
forward with the stage flags, the backward of the total loss, one Adam
update, and the metrics under the reference's logging names.  The
BatchNorm running statistics move inside the forward, in place.

With `freeze_prefixes` (top-level module names, e.g. the trunk: backbone,
sem_seg_head, offset_mlp0, offset_bn, offset_mlp1) the frozen modules stay
exactly as they are: `adam` gives their parameters no update and no
moments, the forward normalizes the backbone and offset_bn with their
running statistics (the model's `frozen_bn`), and the running statistics
of every frozen module are restored after the step.

In a data-parallel run (parallel/dist.py) each rank steps on its own
clouds: the forward's statistics and loss counts are global, the
gradients are SUM-reduced over the ranks before Adam, and every rank draws
the same jitter from its identically seeded generator, as the JAX step
draws one key for the whole batch.  The metrics stay the rank's own: its
loss (local sum over the global count) and its counter sums, which add up
over the ranks to the global batch's.
"""

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from gapartnet_tpu_torch.models.gapartnet import GAPartNet, ModelOutput
from gapartnet_tpu_torch.parallel.dist import sum_gradients
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.utils.profiling import span


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


def top_module(name: str) -> str:
    """The top-level module of a parameter or buffer name."""
    return name.split(".", 1)[0]


def adam(
    named_params: Iterable[Tuple[str, nn.Parameter]],
    learning_rate: float = 1e-3,
    freeze_prefixes: Tuple[str, ...] = (),
) -> torch.optim.Adam:
    """Adam with the reference's settings (b1 0.9, b2 0.999, eps 1e-8), as
    `adam` of train/loop.py:162-190 builds with optax.

    `named_params`: (name, parameter) pairs, `model.named_parameters()`;
    the parameters of the `freeze_prefixes` top-level modules are left out
    (no update, no moments, as optax's set_to_zero)."""
    params = [p for n, p in named_params if top_module(n) not in freeze_prefixes]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """`optimizer.step()`, with a zero gradient for every parameter that
    got none.  optax updates a parameter the loss did not reach: its moments
    decay, it moves on its momentum, and its step count stays the others'.
    torch's Adam would skip it instead."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()


def draw_jitter(generator: torch.Generator) -> torch.Tensor:
    """The (2, 3) uniform draws that place the proposal cubes in training,
    on the CPU, so the card and the CPU draw alike."""
    return torch.rand((2, 3), generator=generator)


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
    freeze_prefixes: Tuple[str, ...] = (),
) -> Dict[str, torch.Tensor]:
    """Forward (train mode), backward, the gradients summed over the ranks
    of a data-parallel run, one optimizer step; returns the metrics as
    tensors on the model's device (nothing is synchronised).

    The jitter is drawn from `generator` every step (`draw_jitter`).  The
    parameters of the `freeze_prefixes` modules get no gradient
    (requires_grad is set here, every step), and their running statistics
    are put back after the forward.

    Spans (utils/profiling.py): `step`, and in it `step:prepare` (modes,
    flags, the jitter draw, zeroed gradients), `step:forward`,
    `step:backward`, `step:optimizer` (the missing-gradient fill, the sum
    over the ranks and Adam) and `step:metrics` (restored statistics, the
    metrics, the step's tensors freed)."""
    with span("step"):
        with span("step:prepare"):
            model.train()
            jitter = draw_jitter(generator)
            for name, p in model.named_parameters():
                p.requires_grad_(top_module(name) not in freeze_prefixes)
            pinned = [(buf, buf.clone()) for name, mod in model.named_children()
                      if name in freeze_prefixes for buf in mod.buffers()]
            optimizer.zero_grad(set_to_none=True)
        with span("step:forward"):
            out = model(
                batch, do_cluster=do_cluster, do_score=do_score, do_npcs=do_npcs,
                cluster_sem_override=cluster_sem_override,
                cluster_offset_override=cluster_offset_override, jitter=jitter,
                frozen_bn=tuple(freeze_prefixes),
            )
        with span("step:backward"):
            if out.total_loss.requires_grad:
                out.total_loss.backward()
        with span("step:optimizer"):
            sum_gradients(p for group in optimizer.param_groups for p in group["params"])
            optimizer_step(optimizer)
        with span("step:metrics"):
            with torch.no_grad():
                for buf, value in pinned:
                    buf.copy_(value)
            metrics = loss_metrics(out)
            del out    # the step's tensors are freed here, inside its span
        return metrics


def eval_step(model: GAPartNet, batch: PointCloudBatch, do_cluster: bool, do_score: bool,
              do_npcs: bool) -> ModelOutput:
    """The eval-mode forward without autograd (make_eval_step)."""
    model.eval()
    with torch.no_grad():
        return model(batch, do_cluster=do_cluster, do_score=do_score, do_npcs=do_npcs)
