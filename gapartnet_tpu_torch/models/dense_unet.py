"""Dense 3D-conv proposal UNet: the eval ScoreNet / NPCSNet.

Counterpart of models/dense_unet.py.  The Score/NPCS UNets run as dense
convs over per-proposal S^3 grids (S = score_fullscale = 28), G grids at a
time, with the layout (G, S, S, S, C) at the module's boundary as in the
JAX package.  With features zeroed at unoccupied sites a dense SAME conv
equals the submanifold conv at the occupied sites, so every block re-masks
unoccupied sites after its pointwise tail; downsampled occupancy is a
2x2x2 any-pool and the up conv is the exact adjoint of the k2 s2 conv.

The JAX package computes these convs through XLA's conv, outside any
Pallas kernel, so the port uses `F.conv3d` for the 3x3x3 and the k2 s2
convs (the (G, S, S, S, C) tensor permuted to (G, C, S, S, S) is already in
channels_last_3d memory format) and an einsum for the up conv.  Kernels
keep the JAX tap-major (27, Cin, Cout) / (8, Cin, Cout) layout, x-major
with dz fastest, and are converted to (Cout, Cin, k, k, k) at apply time.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gapartnet_tpu_torch.models.backbone import _kernel
from gapartnet_tpu_torch.models.norm import MaskedBatchNorm


def _mask(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Zero unoccupied sites: occ (G,S,S,S) bool, x (G,S,S,S,C)."""
    return torch.where(occ[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def conv_weight(w: torch.Tensor, k: int) -> torch.Tensor:
    """(k^3, Cin, Cout) tap-major -> (Cout, Cin, k, k, k) for F.conv3d."""
    _, cin, cout = w.shape
    return w.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2)


def _conv3d(x: torch.Tensor, w: torch.Tensor, k: int, stride: int, padding: int):
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv_weight(w, k), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def dense_subm_conv(x: torch.Tensor, w27: torch.Tensor) -> torch.Tensor:
    """k=3 'submanifold' conv as a dense SAME conv (input pre-masked)."""
    return _conv3d(x, w27, 3, 1, 1)


def dense_down_conv(x: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """k=2 s=2 strided conv (S^3 -> (S/2)^3), no padding."""
    return _conv3d(x, w8, 2, 2, 0)


def dense_up_conv(x: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Adjoint of the k=2 s=2 conv: out[2p + k] = W[k]^T in[p]."""
    g, sx, sy, sz, cin = x.shape
    cout = w8.shape[-1]
    w = w8.reshape(2, 2, 2, cin, cout)
    y = torch.einsum("gxyzi,abcio->gxaybzco", x, w)
    return y.reshape(g, 2 * sx, 2 * sy, 2 * sz, cout)


def downsample_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """(G, S, S, S) -> (G, S/2, S/2, S/2): parent occupied iff any child is."""
    g, sx, sy, sz = occ.shape
    o = occ.reshape(g, sx // 2, 2, sy // 2, 2, sz // 2, 2)
    return o.permute(0, 1, 3, 5, 2, 4, 6).reshape(g, sx // 2, sy // 2, sz // 2, 8).any(dim=-1)


class DenseSubMConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = _kernel(27, in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_subm_conv(x, self.kernel)


class DenseResBlock(nn.Module):
    """Parameter twin of backbone.ResBlock over a dense grid."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        if in_channels != out_channels:
            self.shortcut_kernel = _kernel(in_channels, out_channels)
            self.shortcut_bn = MaskedBatchNorm(out_channels)
        else:
            self.shortcut_kernel = None
        self.conv1 = DenseSubMConv(in_channels, out_channels)
        self.bn1 = MaskedBatchNorm(out_channels)
        self.conv2 = DenseSubMConv(out_channels, out_channels)
        self.bn2 = MaskedBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        if self.shortcut_kernel is None:
            shortcut = x
        else:
            shortcut = self.shortcut_bn(torch.matmul(x, self.shortcut_kernel), occ)
        h = self.bn1(self.conv1(x), occ)
        h = _mask(torch.relu(h), occ)
        h = self.bn2(self.conv2(h), occ)
        return _mask(torch.relu(h + shortcut), occ)


class DenseUBlock(nn.Module):
    """Parameter twin of backbone.UBlock over a dense grid."""

    def __init__(self, channels: Sequence[int], block_repeat: int):
        super().__init__()
        self.block_repeat = block_repeat
        c0 = channels[0]
        for r in range(block_repeat):
            self.add_module(f"enc{r}", DenseResBlock(c0, c0))
        self.has_child = len(channels) > 1
        if self.has_child:
            c1 = channels[1]
            self.down_kernel = _kernel(8, c0, c1)
            self.down_bn = MaskedBatchNorm(c1)
            self.ublock = DenseUBlock(channels[1:], block_repeat)
            self.up_kernel = _kernel(8, c1, c0)
            self.up_bn = MaskedBatchNorm(c0)
            self.add_module("dec0", DenseResBlock(2 * c0, c0))
            for r in range(1, block_repeat):
                self.add_module(f"dec{r}", DenseResBlock(c0, c0))

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        for r in range(self.block_repeat):
            x = getattr(self, f"enc{r}")(x, occ)
        if not self.has_child:
            return x
        skip = x
        occ2 = downsample_occupancy(occ)
        x = dense_down_conv(x, self.down_kernel)
        x = _mask(torch.relu(self.down_bn(x, occ2)), occ2)
        x = self.ublock(x, occ2)
        x = dense_up_conv(x, self.up_kernel)
        x = _mask(torch.relu(self.up_bn(x, occ)), occ)
        x = torch.cat([x, skip], dim=-1)
        for r in range(self.block_repeat):
            x = getattr(self, f"dec{r}")(x, occ)
        return x


class DenseProposalUNet(nn.Module):
    """Dense twin of SparseUNet(channels, without_stem=True).

    Input x (G, S, S, S, C) with zeros at unoccupied sites and occ
    (G, S, S, S) bool.  Returns (G, S, S, S, channels[0])."""

    def __init__(self, channels: Sequence[int], block_repeat: int = 2):
        super().__init__()
        self.stem_bn = MaskedBatchNorm(channels[0])
        self.ublock = DenseUBlock(tuple(channels), block_repeat)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        x = _mask(torch.relu(self.stem_bn(x, occ)), occ)
        return self.ublock(x, occ)
