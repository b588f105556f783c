"""Weights: seeded initialization and conversion from the JAX model's tree.

`params_from_jax` takes the JAX model's variables, `{"params": ...,
"batch_stats": ...}` as nested dicts of numpy arrays, and returns the
port's state_dict.  A JAX gradient tree given as `{"params": grads}` maps
the same way onto the names of `named_parameters()`, which is how the
tests compare gradients.  The port's module tree mirrors the flax tree, so a flax
path `backbone/ublock/enc0/conv1/kernel` becomes
`backbone.ublock.enc0.conv1.kernel`, with these renamings:

  * flax Dense `kernel` (in, out) -> nn.Linear `weight` (out, in), transposed;
  * MaskedBatchNorm `scale` -> `weight`; batch_stats `mean` / `var` ->
    buffers `running_mean` / `running_var`;
  * conv kernels keep their (27, Cin, Cout) / (8, Cin, Cout) / (Cin, Cout)
    layout and names.
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from gapartnet_tpu_torch.models.norm import MaskedBatchNorm


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(variables["params"]):
        mod, _, leaf = path.rpartition(".")
        if leaf == "kernel" and arr.ndim == 2:      # flax Dense
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "scale":                       # MaskedBatchNorm
            sd[f"{mod}.weight"] = torch.from_numpy(arr.copy())
        else:                                       # conv kernels, biases
            sd[path] = torch.from_numpy(arr.copy())
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _flatten(variables.get("batch_stats", {})):
        mod, _, leaf = path.rpartition(".")
        sd[f"{mod}.{stats[leaf]}"] = torch.from_numpy(arr.copy())
    return sd


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init, drawn on the CPU from `generator`.

    Conv kernels: He-uniform over fan_in = prod(shape[:-1]) (the JAX
    package's `_kernel_init`); Linear weights: normal with std
    1 / sqrt(fan_in) and zero bias; batch norms: unit scale, zero shift,
    running statistics (0, 1)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator) / mod.in_features ** 0.5
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, MaskedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        for name, p in model.named_parameters():
            if name.endswith("kernel"):
                fan_in = int(np.prod(p.shape[:-1]))
                bound = (6.0 / fan_in) ** 0.5
                u = torch.rand(p.shape, generator=generator) * (2 * bound) - bound
                p.copy_(u)
    return model
