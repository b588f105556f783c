"""Masked batch normalization (counterpart of models/norm.py).

The reference uses nn.BatchNorm1d(eps=1e-4, momentum=0.1); note that eps
differs from torch's default of 1e-5.  Normalization is over the last
(channel) axis of (..., C).  The port has the eval path only: it
normalizes with the running statistics, as the JAX module does with
train=False (where the validity mask plays no part).  Batch statistics
belong to the training slice.
"""

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Parameters `weight` / `bias` (flax `scale` / `bias`) and buffers
    `running_mean` / `running_var` (flax batch_stats `mean` / `var`)."""

    def __init__(self, num_features: int, eps: float = 1e-4, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm has the eval path only; call .eval() first"
            )
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        return (x - self.running_mean) * (inv * self.weight) + self.bias
