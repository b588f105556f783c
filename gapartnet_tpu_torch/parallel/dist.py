"""Data parallelism over processes, one per card (counterpart of
parallel/mesh.py).

The JAX package trains data parallel as one jit over a batch sharded on a
1-D "dp" mesh, with the parameters replicated.  There every mean over the
batch is global: the BatchNorm statistics and every masked loss mean are
taken over all clouds, so a step on k shards of B clouds equals the
one-device step on the k * B clouds.  The port keeps that objective with
explicit collectives, one process per card (`torchrun`):

  * MaskedBatchNorm all-reduces its masked sums and counts in training
    (`all_reduce_sum`, differentiable);
  * each rank's loss is its local numerator over the global count, so the
    sum of the ranks' losses is the JAX loss; autograd through
    `AllReduceSum` differentiates exactly that sum;
  * the parameter gradients are SUM-reduced in one flat buffer before the
    optimizer step (`sum_gradients`), so the parameters stay bitwise equal
    on every rank.  DDP would average per-card means over per-card
    statistics: another model.

The backend is NCCL for a card and gloo for the CPU.  Without a process
group every function here is the identity and issues no collective.
"""

import os
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
# what torchrun sets in every process it starts
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def init_from_env(device="cuda") -> Tuple[torch.device, bool]:
    """Join the process group that a launcher (`torchrun`) describes in
    RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT, with NCCL
    for "cuda" and gloo for "cpu".  Returns (device, created): "cuda"
    becomes `cuda:LOCAL_RANK`, made the current device; `created` says
    whether this call made the group (its caller then destroys it with
    `close`).  A group that already exists is used as it is.  Without the
    launcher's variables and without a group it does nothing."""
    device = torch.device(device)
    launched = all(v in os.environ for v in LAUNCHER_VARS)
    if not (launched or is_initialized()):
        return device, False
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if is_initialized():
        return device, False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device, True


def close() -> None:
    """Destroy the default process group."""
    if is_initialized():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where a host value (a count, a capacity, a metric) travels for a
    collective: the current card under NCCL, the CPU under gloo."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce ("sum", "max" or "min") over every process, no
    gradient; returns `tensor`.  Without a group it is left as it is."""
    if is_initialized():
        dist.all_reduce(tensor, op=_OPS[op])
    return tensor


def barrier() -> None:
    if is_initialized():
        dist.barrier()


class AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; backward: the sum over ranks of dy.  Every
    rank's y feeds its own loss L_r, so the gradient that reaches x on rank
    r is d(sum_q L_q)/dx: autograd through it differentiates the sum of the
    ranks' losses."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx)
        return dx


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum over ranks (`AllReduceSum`); the identity,
    with no collective, without a group or at world size 1."""
    if world_size() == 1:
        return x
    return AllReduceSum.apply(x)


def sum_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """SUM-reduce the gradients of `params` over every process in one flat
    buffer, a zero standing in for a missing gradient; each `.grad` becomes
    its slice of the reduced buffer.  Without a group: nothing."""
    if not is_initialized():
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    all_reduce_(flat)
    at = 0
    for p in params:
        p.grad = flat[at: at + p.numel()].view_as(p)
        at += p.numel()


def nanmean_over_processes(values: Sequence[float]) -> np.ndarray:
    """The mean over processes of each entry, NaN entries left out; NaN
    where every process has NaN (np.nanmean of the gathered vectors, as
    trainer.py:801-807 of the JAX package takes it).  One SUM all-reduce
    of the values with NaN set to 0 stacked on the non-NaN counts, since
    gloo has no all_gather for CUDA tensors.  Without a group: `values`."""
    v = torch.tensor(np.asarray(values, np.float64), device=collective_device())
    ok = ~torch.isnan(v)
    both = torch.stack([torch.where(ok, v, torch.zeros_like(v)), ok.to(v.dtype)])
    all_reduce_(both)
    return (both[0] / both[1]).cpu().numpy()
