"""Submanifold 3x3x3 conv: the hand-written CUDA kernels and their plain versions.

`subm_conv` replaces the Pallas TPU kernel of
gapartnet_tpu/ops/pallas_conv.py (`_kernel` at :32, launched by
`_subm_conv_pallas_single` at :57) and its custom VJP (`_bwd`, :95-111).
It computes what `_subm_conv` (ops/sparse_conv.py:250-317) computes:

    out[b, v]  = sum_k W[k]^T x[b, nbr[b, k, v]]       (zero row where nbr = -1)
    d_x        = the same conv of g with W tap-reversed and transposed
    d_W[k]     = sum_b sum_v x[b, nbr[b, k, v]]^T g[b, v]

The dgrad is the flipped-weight conv, exactly as the JAX package's VJP
computes it, and not the adjoint of the forward: the two differ where the
rulebook is not symmetric (a voxel outside the grid extent reads its
in-extent neighbours, but they do not read it).

Three wrappers launch the kernels, each counted in `LAUNCHES`
(`subm_conv.launches` is the same dict):

  * `subm_conv_forward` -> csrc/subm_conv.cu ("fwd");
  * `subm_conv_dgrad`   -> csrc/subm_conv.cu on g with flip(W, 0)^T ("dgrad");
  * `subm_conv_wgrad`   -> csrc/subm_conv_wgrad.cu ("wgrad").

On a CUDA tensor each launches its kernel or raises; on a CPU tensor each
computes its plain version (`subm_conv_reference`,
`subm_conv_dgrad_reference`, `subm_conv_wgrad_reference`) and counts
nothing.  `subm_conv` is the autograd-aware entry: it saves only
(features, nbr, weights) for the backward, as the JAX VJP does.

The kernels are compiled at first use with nvcc for sm_90a into
`gapartnet_tpu_torch/_build/` (one library per source, keyed by a hash of
source and flags, the sources compiled in parallel) and bound through ctypes
to plain `extern "C"` launchers.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (CSRC_DIR / "subm_conv.cu", CSRC_DIR / "subm_conv_wgrad.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
K_TAPS = 27
LAUNCHES: Dict[str, int] = {"fwd": 0, "dgrad": 0, "wgrad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all started together; return {source stem: library path}.  The
    compiler's output (with the ptxas register and shared-memory report) is
    kept beside each library as `<library>.log`."""
    libs = {src.stem: library_path(src) for src in SOURCES}
    jobs = []
    for src in SOURCES:
        lib = libs[src.stem]
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((lib, tmp, proc))
    failed = []
    for lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        Path(str(lib) + ".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{lib.name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def build_log() -> str:
    """The compiler's reports of the current library builds ('' if none)."""
    logs = [Path(str(library_path(src)) + ".log") for src in SOURCES]
    return "".join(log.read_text() for log in logs if log.exists())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["subm_conv"]))
    fn = lib.gapartnet_subm_conv_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_splits.argtypes = [ctypes.c_int] * 4
    lib.gapartnet_subm_conv_splits.restype = ctypes.c_int
    lib.gapartnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gapartnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["subm_conv_wgrad"]))
    fn = lib.gapartnet_subm_conv_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_wgrad_chunks.argtypes = [ctypes.c_int] * 5
    lib.gapartnet_subm_conv_wgrad_chunks.restype = ctypes.c_int
    return lib


def _check(features: torch.Tensor, nbr: torch.Tensor, weights=None, grad=None) -> None:
    """features (B, V, Cin) f32 and nbr (B, 27, V) int32, with weights
    (27, Cin, Cout) f32 or an output gradient (B, V, Cout) f32: types,
    shapes, one device, contiguous."""
    others = [t for t in (weights, grad) if t is not None]
    if any(t.dtype != torch.float32 for t in [features, *others]):
        raise TypeError(
            f"subm_conv takes float32 features, weights and gradients, got "
            f"{[t.dtype for t in [features, *others]]}"
        )
    if nbr.dtype != torch.int32:
        raise TypeError(f"subm_conv takes an int32 neighbour table, got {nbr.dtype}")
    shapes = [tuple(t.shape) for t in (features, nbr, *others)]
    if any(len(sh) != 3 for sh in shapes):
        raise ValueError(
            "subm_conv takes features (B, V, Cin), nbr (B, 27, V) and weights "
            f"(27, Cin, Cout) or a gradient (B, V, Cout); got {shapes}"
        )
    b, v, cin = features.shape
    if (tuple(nbr.shape) != (b, K_TAPS, v)
            or (weights is not None and tuple(weights.shape[:2]) != (K_TAPS, cin))
            or (grad is not None and tuple(grad.shape[:2]) != (b, v))):
        raise ValueError(f"subm_conv shape mismatch: {shapes}")
    if any(t.device != features.device for t in (nbr, *others)):
        raise ValueError(
            f"subm_conv inputs on different devices: "
            f"{[t.device for t in (features, nbr, *others)]}"
        )
    if not all(t.is_contiguous() for t in (features, nbr, *others)):
        raise ValueError("subm_conv takes contiguous tensors")


def _on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (plain version), True for CUDA, else raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def _gather_taps(features: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(B, V, Cin) at nbr (B, 27, V) -> (B, V, 27 * Cin), zeros where -1."""
    b, v, cin = features.shape
    bidx = torch.arange(b, device=features.device)[:, None, None]
    g = features[bidx, nbr.clamp(min=0).long()]                  # (B, K, V, Cin)
    g = torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.permute(0, 2, 1, 3).reshape(b, v, K_TAPS * cin)


def subm_conv_reference(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch forward: gather (B, V, 27*Cin) with zeros for -1, then
    one matmul.  The CPU path and the yardstick the kernel is held to."""
    k, cin, cout = weights.shape
    return torch.matmul(_gather_taps(features, nbr), weights.reshape(k * cin, cout))


def reversed_weights(weights: torch.Tensor) -> torch.Tensor:
    """flip(W, 0) transposed: (27, Cin, Cout) -> (27, Cout, Cin), the
    weights of the dgrad conv (pallas_conv.py:100, sparse_conv.py:294)."""
    return weights.flip(0).transpose(1, 2).contiguous()


def subm_conv_dgrad_reference(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain dgrad: the forward conv of the output gradient (B, V, Cout)
    with tap-reversed, transposed weights -> (B, V, Cin)."""
    return subm_conv_reference(grad, nbr, reversed_weights(weights))


def subm_conv_wgrad_reference(
    features: torch.Tensor, nbr: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """Plain wgrad: the forward's gather, contracted with the output
    gradient over B and V -> (27, Cin, Cout)."""
    cin, cout = features.shape[-1], grad.shape[-1]
    gathered = _gather_taps(features, nbr)                          # (B, V, 27*Cin)
    return torch.einsum("bvk,bvd->kd", gathered, grad).reshape(K_TAPS, cin, cout)


def _launch_forward(features, nbr, weights, counter: str) -> torch.Tensor:
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
        raise RuntimeError(f"subm_conv {counter} launch failed: {msg} (CUDA error {rc})")
    LAUNCHES[counter] += 1
    return out


def subm_conv_forward(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The forward alone, with no autograd: features (B, V, Cin) f32, nbr
    (B, 27, V) int32, weights (27, Cin, Cout) f32 -> (B, V, Cout) f32."""
    _check(features, nbr, weights)
    if not _on_card(features, "subm_conv"):
        return subm_conv_reference(features, nbr, weights)
    return _launch_forward(features, nbr, weights, "fwd")


def subm_conv_dgrad(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """d_features (B, V, Cin) from the output gradient (B, V, Cout): the
    forward kernel on flip(W, 0)^T, counted as "dgrad"."""
    w_rev = reversed_weights(weights)
    _check(grad, nbr, weights=w_rev)
    if not _on_card(grad, "subm_conv_dgrad"):
        return subm_conv_reference(grad, nbr, w_rev)
    return _launch_forward(grad, nbr, w_rev, "dgrad")


def subm_conv_wgrad(
    features: torch.Tensor, nbr: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """d_weights (27, Cin, Cout) from the inputs (B, V, Cin) and the output
    gradient (B, V, Cout), through csrc/subm_conv_wgrad.cu."""
    _check(features, nbr, grad=grad)
    b, v, cin = features.shape
    cout = grad.shape[-1]
    if not _on_card(features, "subm_conv_wgrad"):
        return subm_conv_wgrad_reference(features, nbr, grad)
    lib = _wgrad_library()
    device = features.device.index or 0
    dw = torch.empty((K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
    chunks = lib.gapartnet_subm_conv_wgrad_chunks(b, v, cin, cout, device)
    if chunks < 1:
        raise RuntimeError(f"subm_conv_wgrad: cannot query CUDA device {device}")
    partial = (
        torch.empty((chunks, K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
        if chunks > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_wgrad(
        features.data_ptr(), nbr.data_ptr(), grad.data_ptr(), dw.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, chunks, device, stream,
    )
    if rc != 0:
        msg = _library().gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv wgrad launch failed: {msg} (CUDA error {rc})")
    LAUNCHES["wgrad"] += 1
    return dw


class _SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, nbr, weights):
        # only the inputs are saved: the (B, V, 27*Cin) gather is recomputed
        # by the wgrad instead of stored, as in sparse_conv.py:279-283
        ctx.save_for_backward(features, nbr, weights)
        return subm_conv_forward(features, nbr, weights)

    @staticmethod
    def backward(ctx, grad):
        features, nbr, weights = ctx.saved_tensors
        grad = grad.contiguous()
        d_features = subm_conv_dgrad(grad, nbr, weights) if ctx.needs_input_grad[0] else None
        d_weights = subm_conv_wgrad(features, nbr, grad) if ctx.needs_input_grad[2] else None
        return d_features, None, d_weights


def subm_conv(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """features (B, V, Cin) f32, nbr (B, 27, V) int32, weights (27, Cin, Cout)
    f32 -> (B, V, Cout) f32, differentiable in features and weights.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels (counted
    in `subm_conv.launches`) or raise."""
    _check(features, nbr, weights)
    if torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad):
        return _SubmConv.apply(features, nbr, weights)
    return subm_conv_forward(features, nbr, weights)


subm_conv.launches = LAUNCHES
