"""Masked batch normalization (counterpart of models/norm.py).

The reference uses nn.BatchNorm1d(eps=1e-4, momentum=0.1); note that eps
differs from torch's default of 1e-5.  Normalization is over the last
(channel) axis of (..., C).  Padded rows carry no data, so in training the
batch statistics are taken over the rows the mask marks valid (all rows
without a mask).  In eval the running statistics normalize and the mask
plays no part, as in the JAX module with train=False.  A bf16 input (the
dense proposal grids at bf16) meets the float32 mask, statistics and
parameters in float32, so the output is float32, as in the JAX module.

Under data parallelism (parallel/dist.py) the training statistics are
global, as the JAX module's are under a sharded jit (its norm.py:6-8): the
masked sums and counts are summed over the ranks, differentiably, so every
rank normalizes with, and moves its running statistics towards, the
statistics of the whole global batch.
"""

import contextlib
from typing import Optional

import torch
from torch import nn

from gapartnet_tpu_torch.parallel.dist import all_reduce_sum


class MaskedBatchNorm(nn.Module):
    """Parameters `weight` / `bias` (flax `scale` / `bias`) and buffers
    `running_mean` / `running_var` (flax batch_stats `mean` / `var`).

    Training: biased batch variance to normalize; the running statistics
    move by `momentum` towards the batch mean and the *unbiased* variance,
    as torch's BatchNorm1d updates them.  The update is in place."""

    def __init__(self, num_features: int, eps: float = 1e-4, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            c = x.shape[-1]
            xf = x.reshape(-1, c)
            one = torch.ones((), device=x.device)
            if mask is None:
                # the row count, sum x and sum x^2, over every rank in one call
                rows = torch.full((1,), float(xf.shape[0]), device=x.device)
                sums = all_reduce_sum(torch.cat([rows, xf.sum(0), (xf * xf).sum(0)]))
                cnt = torch.maximum(sums[0].detach(), one)
                mean = sums[1:c + 1] / cnt
                var = sums[c + 1:] / cnt - mean * mean
            else:
                # two passes, as the JAX module: the count and sum x w, then
                # sum (x - mean)^2 w; the f32 mask promotes a bf16 x to f32,
                # as the JAX module's `mask.astype(float32)` does
                w = mask.reshape(-1).to(torch.promote_types(x.dtype, torch.float32))
                sums = all_reduce_sum(torch.cat([w.sum()[None], (xf * w[:, None]).sum(0)]))
                cnt = torch.maximum(sums[0].detach(), one)
                mean = sums[1:] / cnt
                var = all_reduce_sum(((xf - mean) ** 2 * w[:, None]).sum(0)) / cnt
            # maximum with a tensor splits the gradient at a tie, as jnp.maximum
            var = torch.maximum(var, torch.zeros((), device=x.device))
            with torch.no_grad():
                unbiased = var * cnt / torch.maximum(cnt - 1.0, one)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        return (x - mean) * (inv * self.weight) + self.bias


@contextlib.contextmanager
def bn_ulp_probe(seed):
    """Within the block every MaskedBatchNorm output of the port moves by a
    seeded -1, 0 or +1 fp32 ulp of its magnitude (another fp32 rounding,
    as a fused multiply-add or a sum in another order gives)."""
    gen = torch.Generator().manual_seed(seed)
    orig = MaskedBatchNorm.forward

    def moved(self, x, mask=None):
        y = orig(self, x, mask)
        r = torch.randint(-1, 2, y.shape, generator=gen).to(device=y.device, dtype=y.dtype)
        return y + r * torch.finfo(torch.float32).eps * y.abs().detach()

    MaskedBatchNorm.forward = moved
    try:
        yield
    finally:
        MaskedBatchNorm.forward = orig
