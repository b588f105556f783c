"""Command-line tools of the PyTorch port that drive a checkpoint
(counterparts of the JAX package's tools/eval_parity.py, tools/visu.py and
tools/visualize_render.py).  Each runs as
`python -m gapartnet_tpu_torch.tools.<name>`, with the JAX tool's flags
and `--device` (default cuda)."""

import torch


def resolve_device(name: str) -> torch.device:
    """`--device` as a torch.device; cuda without a card raises (there is
    no CPU fallback: the CPU is used only when asked for)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available (torch.cuda.is_available() "
                           "is false); pass --device cpu to run on the CPU")
    return device
