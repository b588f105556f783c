"""The Score / NPCS proposal UNet: one parameter tree, a sparse and a dense forward.

Counterpart of models/dense_unet.py and of `SparseUNet(without_stem=True)`
in models/backbone.py.  The flax tree holds one `score_unet` and one
`npcs_unet` whose names (`stem_bn`, `ublock.enc0.conv1.kernel`, ...) serve
both forwards, so the port keeps one module, `ProposalUNet`:

  * `forward(features, hierarchy)`: the sparse UNet over the proposal
    voxels through the submanifold kernels (the train path);
  * `dense(x, occ)`: the same network as dense convs over per-proposal S^3
    grids (S = score_fullscale = 28), G grids at a time, layout
    (G, S, S, S, C) at the boundary as in the JAX package (the eval path).
    With features zeroed at unoccupied sites a dense SAME conv equals the
    submanifold conv at the occupied sites, so every block re-masks
    unoccupied sites after its pointwise tail; downsampled occupancy is a
    2x2x2 any-pool and the up conv is the exact adjoint of the k2 s2 conv.

The JAX package computes the dense convs through XLA's conv, outside any
Pallas kernel, so the port uses `F.conv3d` for the 3x3x3 and the k2 s2
convs (the (G, S, S, S, C) tensor permuted to (G, C, S, S, S) is already in
channels_last_3d memory format) and an einsum for the up conv.  Kernels
keep the JAX tap-major (27, Cin, Cout) / (8, Cin, Cout) layout, x-major
with dz fastest, and are converted to (Cout, Cin, k, k, k) at apply time.
"""

from typing import Sequence

import torch
import torch.nn.functional as F

from gapartnet_tpu_torch.models.backbone import ResBlock, SparseUNet, UBlock


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


def _dense_res_block(blk: ResBlock, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    if blk.shortcut_kernel is None:
        shortcut = x
    else:
        shortcut = blk.shortcut_bn(torch.matmul(x, blk.shortcut_kernel), occ)
    h = blk.bn1(dense_subm_conv(x, blk.conv1.kernel), occ)
    h = _mask(torch.relu(h), occ)
    h = blk.bn2(dense_subm_conv(h, blk.conv2.kernel), occ)
    return _mask(torch.relu(h + shortcut), occ)


def _dense_ublock(ub: UBlock, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    for r in range(ub.block_repeat):
        x = _dense_res_block(getattr(ub, f"enc{r}"), x, occ)
    if not ub.has_child:
        return x
    skip = x
    occ2 = downsample_occupancy(occ)
    x = dense_down_conv(x, ub.down_kernel)
    x = _mask(torch.relu(ub.down_bn(x, occ2)), occ2)
    x = _dense_ublock(ub.ublock, x, occ2)
    x = dense_up_conv(x, ub.up_kernel)
    x = _mask(torch.relu(ub.up_bn(x, occ)), occ)
    x = torch.cat([x, skip], dim=-1)
    for r in range(ub.block_repeat):
        x = _dense_res_block(getattr(ub, f"dec{r}"), x, occ)
    return x


class ProposalUNet(SparseUNet):
    """SparseUNet(channels, without_stem=True) with a dense twin forward."""

    def __init__(self, channels: Sequence[int], block_repeat: int = 2):
        super().__init__(channels[0], channels, block_repeat, without_stem=True)

    def dense(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        """x (G, S, S, S, C) with zeros at unoccupied sites, occ (G, S, S, S)
        bool -> (G, S, S, S, channels[0])."""
        x = _mask(torch.relu(self.stem_bn(x, occ)), occ)
        return _dense_ublock(self.ublock, x, occ)
