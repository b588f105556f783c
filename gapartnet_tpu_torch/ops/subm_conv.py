"""Submanifold 3x3x3 conv: the hand-written CUDA kernel and its plain version.

`subm_conv` replaces the Pallas TPU kernel of
gapartnet_tpu/ops/pallas_conv.py (`_kernel` at :32, launched by
`_subm_conv_pallas_single` at :57) and computes what
`_subm_conv_forward` (ops/sparse_conv.py:250-271) computes:

    out[b, v] = sum_k W[k]^T x[b, nbr[b, k, v]]     (zero row where nbr = -1)

On a CUDA tensor it launches the kernel of `csrc/subm_conv.cu` or raises;
on a CPU tensor it computes the plain version `subm_conv_reference`.  The
kernel's design and its bound are described in the CUDA source.

The kernel is compiled at first use with nvcc for sm_90a into
`gapartnet_tpu_torch/_build/` (keyed by a hash of source and flags) and
bound through ctypes to a plain `extern "C"` launcher.  Only the forward is
ported: a CUDA input that requires grad raises NotImplementedError (the
backward kernels belong to the training slice).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCE = CSRC_DIR / "subm_conv.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
K_TAPS = 27


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel's library unless an up-to-date one exists; return
    its path.  The compiler's output (with the ptxas register and
    shared-memory report) is kept beside it as `<library>.log`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    )
    Path(str(lib) + ".log").write_text(proc.stdout)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: nvcc exit {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler's report of the current library build ('' if none)."""
    log = Path(str(library_path()) + ".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.gapartnet_subm_conv_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_splits.argtypes = [ctypes.c_int] * 4
    lib.gapartnet_subm_conv_splits.restype = ctypes.c_int
    lib.gapartnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gapartnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor) -> None:
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(
            f"subm_conv takes float32 features and weights, got "
            f"{features.dtype} and {weights.dtype}"
        )
    if nbr.dtype != torch.int32:
        raise TypeError(f"subm_conv takes an int32 neighbour table, got {nbr.dtype}")
    if features.ndim != 3 or nbr.ndim != 3 or weights.ndim != 3:
        raise ValueError(
            "subm_conv takes features (B, V, Cin), nbr (B, 27, V) and weights "
            f"(27, Cin, Cout); got {tuple(features.shape)}, {tuple(nbr.shape)}, "
            f"{tuple(weights.shape)}"
        )
    b, v, cin = features.shape
    if tuple(nbr.shape) != (b, K_TAPS, v) or tuple(weights.shape[:2]) != (K_TAPS, cin):
        raise ValueError(
            f"subm_conv shape mismatch: features {tuple(features.shape)}, "
            f"nbr {tuple(nbr.shape)}, weights {tuple(weights.shape)}"
        )
    if not (features.device == nbr.device == weights.device):
        raise ValueError(
            f"subm_conv inputs on different devices: {features.device}, "
            f"{nbr.device}, {weights.device}"
        )
    if not (features.is_contiguous() and nbr.is_contiguous() and weights.is_contiguous()):
        raise ValueError("subm_conv takes contiguous tensors")


def subm_conv_reference(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: gather (B, V, 27*Cin) with zeros for -1, then
    one matmul.  The CPU path and the yardstick the kernel is held to."""
    b, v, cin = features.shape
    k, _, cout = weights.shape
    bidx = torch.arange(b, device=features.device)[:, None, None]
    g = features[bidx, nbr.clamp(min=0).long()]                  # (B, K, V, Cin)
    g = torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    g = g.permute(0, 2, 1, 3).reshape(b, v, k * cin)
    return torch.matmul(g, weights.reshape(k * cin, cout))


def subm_conv(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """features (B, V, Cin) f32, nbr (B, 27, V) int32, weights (27, Cin, Cout)
    f32 -> (B, V, Cout) f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in `subm_conv.launches`) or raise."""
    _check(features, nbr, weights)
    if features.device.type == "cpu":
        return subm_conv_reference(features, nbr, weights)
    if features.device.type != "cuda":
        raise ValueError(f"subm_conv runs on cpu or cuda, not {features.device}")
    if torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad):
        raise NotImplementedError(
            "subm_conv has no backward kernel yet; run the CUDA forward under "
            "torch.no_grad()"
        )
    lib = _library()
    b, v, cin = features.shape
    cout = weights.shape[2]
    device = features.device.index or 0
    out = torch.empty((b, v, cout), dtype=torch.float32, device=features.device)
    # small grids split their taps over blocks; the partial sums need scratch
    splits = lib.gapartnet_subm_conv_splits(b, v, cout, device)
    if splits < 1:
        raise RuntimeError(f"subm_conv: cannot query CUDA device {device}")
    partial = (
        torch.empty((splits, b, v, cout), dtype=torch.float32, device=features.device)
        if splits > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_forward(
        features.data_ptr(), nbr.data_ptr(), weights.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, splits, device, stream,
    )
    if rc != 0:
        msg = lib.gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv kernel launch failed: {msg} (CUDA error {rc})")
    subm_conv.launches += 1
    return out


subm_conv.launches = 0
