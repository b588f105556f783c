"""Masked batch normalization (counterpart of models/norm.py).

The reference uses nn.BatchNorm1d(eps=1e-4, momentum=0.1); note that eps
differs from torch's default of 1e-5.  Normalization is over the last
(channel) axis of (..., C).  Padded rows carry no data, so in training the
batch statistics are taken over the rows the mask marks valid (all rows
without a mask).  In eval the running statistics normalize and the mask
plays no part, as in the JAX module with train=False.
"""

from typing import Optional

import torch
from torch import nn


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
            if mask is None:
                cnt = torch.tensor(float(xf.shape[0]), device=x.device)
                mean = xf.mean(0)
                var = (xf * xf).mean(0) - mean * mean
            else:
                w = mask.reshape(-1).to(x.dtype)
                cnt = torch.maximum(w.sum(), torch.ones((), device=x.device))
                mean = (xf * w[:, None]).sum(0) / cnt
                var = ((xf - mean) ** 2 * w[:, None]).sum(0) / cnt
            # maximum with a tensor splits the gradient at a tie, as jnp.maximum
            var = torch.maximum(var, torch.zeros((), device=x.device))
            with torch.no_grad():
                unbiased = var * cnt / torch.maximum(cnt - 1.0, torch.ones((), device=x.device))
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        return (x - mean) * (inv * self.weight) + self.bias
