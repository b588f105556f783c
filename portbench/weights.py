"""Seeded weights, made on the device in two draws.

The reference model's state dict names every tensor; both the program and
the reference load the same values.  Submanifold, strided and pointwise
kernels (names ending in `kernel`): He-uniform over fan_in = the product
of all but the last axis; linear weights: normal with std 1 / sqrt(fan_in),
biases zero, but zero for the last layer of a PointNet transformer
(`fc3`, identity transforms at the start); batch norms: unit scale, zero
shift, running statistics (0, 1).
"""

from typing import Dict

import numpy as np
import torch


def make_state(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the names and shapes of a state dict."""
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    uni = [k for k in shapes if k.endswith("kernel")]
    nrm = [k for k in shapes if k.endswith(".weight") and len(shapes[k]) == 2
           and not k.endswith("fc3.weight")]
    u = torch.rand(sum(int(np.prod(shapes[k])) for k in uni), generator=gen, device=device)
    z = torch.randn(sum(int(np.prod(shapes[k])) for k in nrm), generator=gen, device=device)
    state, ou, on = {}, 0, 0
    for k, shape in shapes.items():
        size = int(np.prod(shape))
        if k in uni:
            bound = (6.0 / int(np.prod(shape[:-1]))) ** 0.5
            state[k] = (u[ou:ou + size] * (2 * bound) - bound).reshape(shape)
            ou += size
        elif k in nrm:
            state[k] = (z[on:on + size] / shape[1] ** 0.5).reshape(shape)
            on += size
        elif k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            state[k] = torch.ones(shape, device=device)
        else:
            state[k] = torch.zeros(shape, device=device)
    return state
