"""SparseUNet backbone over rulebook sparse convolutions.

Counterpart of models/backbone.py: submanifold ResBlocks and a recursive U
of stride-2 downsamples and inverse-conv upsamples with skip concatenation.
Geometry (GridHierarchy) is built once per forward outside the modules.

  * block_repeat encoder ResBlocks per level;
  * decoder: dec0 takes concat(up, skip) = 2C -> C, then block_repeat - 1
    ResBlocks C -> C;
  * ResBlock: conv1 + BN + ReLU, conv2 + BN, add the shortcut (identity, or
    a pointwise conv + BN), final ReLU;
  * stem: SubMConv(in, C0) + BN + ReLU; without_stem (the Score / NPCS
    UNets): BN + ReLU on the input only;
  * all convs bias-free.

Every MaskedBatchNorm follows the module's train / eval mode
(`nn.Module.train()`), which carries the JAX package's `train` flag.

Parameters keep the JAX package's names and layouts: submanifold kernels
(27, Cin, Cout) and strided kernels (8, Cin, Cout), tap-major, x-major with
dz fastest; pointwise kernels (Cin, Cout).
"""

from typing import Sequence

import torch
from torch import nn

from gapartnet_tpu_torch.models.norm import MaskedBatchNorm
from gapartnet_tpu_torch.ops.sparse_conv import (
    GridHierarchy,
    downsample_conv_apply,
    inverse_conv_apply,
    linear_conv_apply,
)
from gapartnet_tpu_torch.ops.subm_conv import subm_conv


def _kernel(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class SubMConv(nn.Module):
    """Submanifold conv (k=3) on one grid level; weights (27, Cin, Cout)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = _kernel(27, in_channels, out_channels)

    def forward(self, features: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        return subm_conv(features, nbr, self.kernel)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        if in_channels != out_channels:
            self.shortcut_kernel = _kernel(in_channels, out_channels)
            self.shortcut_bn = MaskedBatchNorm(out_channels)
        else:
            self.shortcut_kernel = None
        self.conv1 = SubMConv(in_channels, out_channels)
        self.bn1 = MaskedBatchNorm(out_channels)
        self.conv2 = SubMConv(out_channels, out_channels)
        self.bn2 = MaskedBatchNorm(out_channels)

    def forward(self, features, nbr, mask):
        if self.shortcut_kernel is None:
            shortcut = features
        else:
            shortcut = self.shortcut_bn(linear_conv_apply(features, self.shortcut_kernel), mask)
        x = torch.relu(self.bn1(self.conv1(features, nbr), mask))
        x = self.bn2(self.conv2(x, nbr), mask)
        return torch.relu(x + shortcut)


class UBlock(nn.Module):
    """Recursive U over the prebuilt GridHierarchy starting at `level`."""

    def __init__(self, channels: Sequence[int], block_repeat: int, level: int = 0):
        super().__init__()
        self.level = level
        self.block_repeat = block_repeat
        c0 = channels[0]
        for r in range(block_repeat):
            self.add_module(f"enc{r}", ResBlock(c0, c0))
        self.has_child = len(channels) > 1
        if self.has_child:
            c1 = channels[1]
            self.down_kernel = _kernel(8, c0, c1)
            self.down_bn = MaskedBatchNorm(c1)
            self.ublock = UBlock(channels[1:], block_repeat, level + 1)
            self.up_kernel = _kernel(8, c1, c0)
            self.up_bn = MaskedBatchNorm(c0)
            self.add_module("dec0", ResBlock(2 * c0, c0))
            for r in range(1, block_repeat):
                self.add_module(f"dec{r}", ResBlock(c0, c0))

    def forward(self, features: torch.Tensor, hierarchy: GridHierarchy) -> torch.Tensor:
        li = self.level
        lv = hierarchy.levels[li]
        nbr, mask = lv.subm_nbr, lv.voxel_mask
        x = features
        for r in range(self.block_repeat):
            x = getattr(self, f"enc{r}")(x, nbr, mask)
        if not self.has_child:
            return x
        skip = x
        ds = hierarchy.downsamples[li]
        nxt = hierarchy.levels[li + 1]
        x = downsample_conv_apply(x, ds, self.down_kernel, nxt.keys.shape[-1])
        x = torch.relu(self.down_bn(x, nxt.voxel_mask))
        x = self.ublock(x, hierarchy)
        x = inverse_conv_apply(x, ds, self.up_kernel)
        x = torch.relu(self.up_bn(x, mask))
        x = torch.cat([x, skip], dim=-1).contiguous()
        for r in range(self.block_repeat):
            x = getattr(self, f"dec{r}")(x, nbr, mask)
        return x


class SparseUNet(nn.Module):
    """Stem + UBlock.  Returns (B, V0, channels[0]) voxel features."""

    def __init__(self, in_channels: int, channels: Sequence[int], block_repeat: int = 2,
                 without_stem: bool = False):
        super().__init__()
        self.stem_conv = None if without_stem else SubMConv(in_channels, channels[0])
        self.stem_bn = MaskedBatchNorm(channels[0])
        self.ublock = UBlock(tuple(channels), block_repeat, 0)

    def forward(self, features: torch.Tensor, hierarchy: GridHierarchy) -> torch.Tensor:
        lv0 = hierarchy.levels[0]
        x = features if self.stem_conv is None else self.stem_conv(features, lv0.subm_nbr)
        x = torch.relu(self.stem_bn(x, lv0.voxel_mask))
        return self.ublock(x, hierarchy)
