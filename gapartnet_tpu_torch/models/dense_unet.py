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

With `compute_dtype=torch.bfloat16` the dense path rounds where the JAX
package's does (models/dense_unet.py:48-94):

  * the 3x3x3 and down convs take both operands and return their output in
    bf16 (fp32 accumulation), then widen it to f32; their gradients round
    the same way (the output gradient, dgrad and wgrad in bf16).  On the
    card that is `F.conv3d` in bf16 (cuDNN); on the CPU its plain form, an
    fp32 conv on the rounded operands with the output rounded (CPU bf16
    conv3d accumulates differently);
  * the up conv rounds its operands and keeps its f32 output;
  * `act_dtype` (eval only; AD needs f32) rounds every BatchNorm output to
    it, as the JAX `act_dtype`.  A bf16 input meets f32 BatchNorm
    statistics and f32 shortcut kernels in f32, as JAX promotes them.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from gapartnet_tpu_torch.models.backbone import ResBlock, SparseUNet, UBlock
from gapartnet_tpu_torch.utils.profiling import span


def _mask(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Zero unoccupied sites: occ (G,S,S,S) bool, x (G,S,S,S,C)."""
    return torch.where(occ[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def conv_weight(w: torch.Tensor, k: int) -> torch.Tensor:
    """(k^3, Cin, Cout) tap-major -> (Cout, Cin, k, k, k) for F.conv3d."""
    _, cin, cout = w.shape
    return w.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2)


def _conv3d(x: torch.Tensor, w: torch.Tensor, k: int, stride: int, padding: int,
            compute_dtype: Optional[torch.dtype] = None):
    if compute_dtype is None:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv_weight(w, k), stride=stride,
                     padding=padding)
        return y.permute(0, 2, 3, 4, 1)
    xc, wc = x.to(compute_dtype), conv_weight(w, k).to(compute_dtype)
    if x.device.type == "cuda":
        y = F.conv3d(xc.permute(0, 4, 1, 2, 3), wc, stride=stride, padding=padding)
    else:
        y = F.conv3d(xc.float().permute(0, 4, 1, 2, 3), wc.float(), stride=stride,
                     padding=padding).to(compute_dtype)
    return y.float().permute(0, 2, 3, 4, 1)


def dense_subm_conv(x: torch.Tensor, w27: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """k=3 'submanifold' conv as a dense SAME conv (input pre-masked)."""
    return _conv3d(x, w27, 3, 1, 1, compute_dtype)


def dense_down_conv(x: torch.Tensor, w8: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """k=2 s=2 strided conv (S^3 -> (S/2)^3), no padding."""
    return _conv3d(x, w8, 2, 2, 0, compute_dtype)


def dense_up_conv(x: torch.Tensor, w8: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Adjoint of the k=2 s=2 conv: out[2p + k] = W[k]^T in[p]; with a
    compute dtype, on operands rounded to it, with an f32 output."""
    g, sx, sy, sz, cin = x.shape
    cout = w8.shape[-1]
    if compute_dtype is not None:
        x, w8 = x.to(compute_dtype).float(), w8.to(compute_dtype).float()
    w = w8.reshape(2, 2, 2, cin, cout)
    y = torch.einsum("gxyzi,abcio->gxaybzco", x, w)
    return y.reshape(g, 2 * sx, 2 * sy, 2 * sz, cout)


def downsample_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """(G, S, S, S) -> (G, S/2, S/2, S/2): parent occupied iff any child is."""
    g, sx, sy, sz = occ.shape
    o = occ.reshape(g, sx // 2, 2, sy // 2, 2, sz // 2, 2)
    return o.permute(0, 1, 3, 5, 2, 4, 6).reshape(g, sx // 2, sy // 2, sz // 2, 8).any(dim=-1)


def _cast(t: torch.Tensor, act_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if act_dtype is None else t.to(act_dtype)


def _dense_res_block(blk: ResBlock, x: torch.Tensor, occ: torch.Tensor, cd, act) -> torch.Tensor:
    if blk.shortcut_kernel is None:
        shortcut = x
    else:
        # a bf16 activation meets the f32 kernel in f32 (JAX promotes it)
        sc = torch.matmul(x.to(blk.shortcut_kernel.dtype), blk.shortcut_kernel)
        shortcut = _cast(blk.shortcut_bn(sc, occ), act)
    h = _cast(blk.bn1(dense_subm_conv(x, blk.conv1.kernel, cd), occ), act)
    h = _mask(torch.relu(h), occ)
    h = _cast(blk.bn2(dense_subm_conv(h, blk.conv2.kernel, cd), occ), act)
    return _mask(torch.relu(h + shortcut.to(h.dtype)), occ)


def _dense_ublock(ub: UBlock, x: torch.Tensor, occ: torch.Tensor, cd, act) -> torch.Tensor:
    with span("unet:encoder"):
        for r in range(ub.block_repeat):
            x = _dense_res_block(getattr(ub, f"enc{r}"), x, occ, cd, act)
        if not ub.has_child:
            return x
        skip = x
        occ2 = downsample_occupancy(occ)
        x = dense_down_conv(x, ub.down_kernel, cd)
        x = _mask(torch.relu(_cast(ub.down_bn(x, occ2), act)), occ2)
    x = _dense_ublock(ub.ublock, x, occ2, cd, act)
    with span("unet:decoder"):
        x = dense_up_conv(x, ub.up_kernel, cd)
        x = _mask(torch.relu(_cast(ub.up_bn(x, occ), act)), occ)
        x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        for r in range(ub.block_repeat):
            x = _dense_res_block(getattr(ub, f"dec{r}"), x, occ, cd, act)
    return x


class ProposalUNet(SparseUNet):
    """SparseUNet(channels, without_stem=True) with a dense twin forward;
    `compute_dtype` as in SparseUNet, for both forwards."""

    def __init__(self, channels: Sequence[int], block_repeat: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(channels[0], channels, block_repeat, without_stem=True,
                         compute_dtype=compute_dtype)

    def dense(self, x: torch.Tensor, occ: torch.Tensor,
              act_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x (G, S, S, S, C) with zeros at unoccupied sites, occ (G, S, S, S)
        bool -> (G, S, S, S, channels[0]), in `act_dtype` if given (the
        BatchNorm outputs rounded to it, as the JAX eval path does), else
        float32."""
        x = _mask(torch.relu(_cast(self.stem_bn(x, occ), act_dtype)), occ)
        return _dense_ublock(self.ublock, x, occ, self.compute_dtype, act_dtype)
