"""Reference (spconv / Lightning) checkpoint -> the port's state_dict
(counterpart of train/ckpt_convert.py followed by weights.params_from_jax).

The reference names its modules backbone / sem_seg_head / offset_head /
score_unet / score_head / npcs_unet / npcs_head, with spconv
SparseSequential indices; the port's names follow the JAX package's tree
(`backbone.ublock.enc0.conv1.kernel`, ...).  Layouts:

  * spconv SubMConv3d k=3 weights (out, k0, k1, k2, in), kernel axis i on
    coordinate column i (x, y, z in the reference's voxelization) -> the
    port's (27, in, out), taps x-major with dz fastest ("xyz", the default;
    "zyx" reads the stored axes as (kz, ky, kx));
  * SparseConv3d / SparseInverseConv3d k=2 weights -> (8, in, out), and a
    k=1 shortcut conv (out, 1, 1, 1, in) -> (in, out);
  * nn.Linear weights (out, in) stay as they are (the port's heads are
    nn.Linear);
  * BatchNorm weight / bias / running_mean / running_var keep their names
    (num_batches_tracked is dropped).
"""

from typing import Dict

import numpy as np
import torch


def _conv_kernel(w: np.ndarray, spatial_order: str = "xyz") -> np.ndarray:
    """(out, k, k, k, in) -> (k^3, in, out) with x-major tap enumeration."""
    assert w.ndim == 5, w.shape
    out_c, k0, k1, k2, in_c = w.shape
    axes = (3, 2, 1, 0, 4) if spatial_order == "zyx" else (1, 2, 3, 0, 4)
    w = np.transpose(w, axes).reshape(k0 * k1 * k2, out_c, in_c)
    return np.transpose(w, (0, 2, 1))


class _Converter:
    def __init__(self, sd: Dict[str, np.ndarray], spatial_order: str):
        self.sd = sd
        self.spatial_order = spatial_order
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, name: str, value: np.ndarray):
        self.out[name] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))

    def conv(self, ref: str, port: str):
        self.put(port, _conv_kernel(self.sd[ref], self.spatial_order))

    def linear(self, ref: str, port: str):
        self.put(f"{port}.weight", self.sd[f"{ref}.weight"])
        self.put(f"{port}.bias", self.sd[f"{ref}.bias"])

    def bn(self, ref: str, port: str):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.put(f"{port}.{leaf}", self.sd[f"{ref}.{leaf}"])

    def resblock(self, ref: str, port: str):
        """ResBlock (backbone.py:8-49): conv1 / conv2 SparseSequential(SubM,
        BN); the shortcut Identity or SparseSequential(SubM k=1, BN)."""
        self.conv(f"{ref}.conv1.0.weight", f"{port}.conv1.kernel")
        self.bn(f"{ref}.conv1.1", f"{port}.bn1")
        self.conv(f"{ref}.conv2.0.weight", f"{port}.conv2.kernel")
        self.bn(f"{ref}.conv2.1", f"{port}.bn2")
        if f"{ref}.shortcut.0.weight" in self.sd:
            w = self.sd[f"{ref}.shortcut.0.weight"]
            self.put(f"{port}.shortcut_kernel", np.transpose(w.reshape(w.shape[0], w.shape[-1])))
            self.bn(f"{ref}.shortcut.1", f"{port}.shortcut_bn")

    def ublock(self, ref: str, port: str, num_levels: int, block_repeat: int):
        for r in range(block_repeat):
            self.resblock(f"{ref}.encoder_blocks.{r}", f"{port}.enc{r}")
        if num_levels > 1:
            self.conv(f"{ref}.downsample.0.weight", f"{port}.down_kernel")
            self.bn(f"{ref}.downsample.1", f"{port}.down_bn")
            self.ublock(f"{ref}.ublock", f"{port}.ublock", num_levels - 1, block_repeat)
            self.conv(f"{ref}.upsample.0.weight", f"{port}.up_kernel")
            self.bn(f"{ref}.upsample.1", f"{port}.up_bn")
            for r in range(block_repeat):
                self.resblock(f"{ref}.decoder_blocks.{r}", f"{port}.dec{r}")

    def sparse_unet(self, name: str, num_levels: int, block_repeat: int, without_stem: bool):
        if without_stem:
            self.bn(f"{name}.stem.0", f"{name}.stem_bn")
        else:
            self.conv(f"{name}.stem.0.weight", f"{name}.stem_conv.kernel")
            self.bn(f"{name}.stem.1", f"{name}.stem_bn")
        self.ublock(f"{name}.ublock", f"{name}.ublock", num_levels, block_repeat)


def convert_reference_state_dict(
    sd: Dict[str, np.ndarray],
    channels=(16, 32, 48, 64, 80, 96, 112),
    block_repeat: int = 2,
    spatial_order: str = "xyz",
) -> Dict[str, torch.Tensor]:
    """The port's state_dict (float32 tensors) of a reference state_dict.
    A staged checkpoint without the score or NPCS head yields no entries
    for that branch (load it with strict=False)."""
    c = _Converter({k: np.asarray(v) for k, v in sd.items()}, spatial_order)
    c.sparse_unet("backbone", len(channels), block_repeat, without_stem=False)
    c.linear("sem_seg_head", "sem_seg_head")
    c.linear("offset_head.0", "offset_mlp0")
    c.bn("offset_head.1", "offset_bn")
    c.linear("offset_head.3", "offset_mlp1")
    for unet, head in (("score_unet", "score_head"), ("npcs_unet", "npcs_head")):
        if f"{head}.weight" not in c.sd:
            continue  # staged checkpoints may lack the late heads
        c.sparse_unet(unet, 2, block_repeat, without_stem=True)
        c.linear(head, head)
    return c.out


def load_reference_ckpt(path: str, **kw) -> Dict[str, torch.Tensor]:
    """Convert a Lightning .ckpt (its `state_dict`) or a bare state_dict.
    The file is unpickled (torch.load with weights_only=False): load only
    checkpoints from a trusted source."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    return convert_reference_state_dict({k: v.numpy() for k, v in sd.items()}, **kw)
