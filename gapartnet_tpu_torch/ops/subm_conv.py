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
  * `subm_conv_dgrad`   -> csrc/subm_conv.cu on g, reading W tap-reversed
                           and transposed in place ("dgrad");
  * `subm_conv_wgrad`   -> csrc/subm_conv_wgrad.cu ("wgrad").

What bounds them on an H100: a gather-GEMM over the neighbour pairs that
exist, bytes at the level-0 shapes (the 27 x V neighbour table and the
gathered rows), operations deeper.  Both kernels run on the tensor cores
(mma.sync m16n8k8, 3xTF32 split for fp32 accuracy) and gather rows with
cp.async into a ring of shared-memory buffers ahead of the math; the
sources' head notes give the tiles.  Every sum runs in a fixed order with
no atomics, so a repeat is bitwise equal.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor each
computes its plain version (`subm_conv_reference`,
`subm_conv_dgrad_reference`, `subm_conv_wgrad_reference`) and counts
nothing.  `subm_conv` is the autograd-aware entry: it saves only
(features, nbr, weights) for the backward, as the JAX VJP does.

With `compute_dtype=torch.bfloat16` (the JAX `subm_conv_apply(...,
compute_dtype=jnp.bfloat16)`, ops/sparse_conv.py:368-380) the conv runs on
operands rounded to bf16 with fp32 accumulation and an fp32 output, and its
backward rounds where the JAX VJP rounds (sparse_conv.py:286-318): the
output gradient to bf16, the dgrad's and the wgrad's fp32 results to bf16.
Three more wrappers launch the bf16 kernels, counted as "fwd_bf16",
"dgrad_bf16" and "wgrad_bf16":

  * `subm_conv_forward_bf16` -> csrc/subm_conv_bf16.cu;
  * `subm_conv_dgrad_bf16`   -> csrc/subm_conv_bf16.cu on the output
                                gradient, with a tap-reversed weight copy;
  * `subm_conv_wgrad_bf16`   -> csrc/subm_conv_wgrad_bf16.cu.

They take float32 or bfloat16 tensors and write the bf16 operand copies
the kernels read (rows padded with zeros to a multiple of 8 channels, so
every row is whole 16-byte copies; the weights in the layout of the mma's
B fragments), run mma.sync m16n8k16 in one pass, and launch no fp32
kernel.  Their plain versions (`subm_conv_bf16_reference`,
`subm_conv_dgrad_bf16_reference`, `subm_conv_wgrad_bf16_reference`) round
the operands, run the fp32 plain versions and round as the JAX VJP does.

The kernels are compiled at first use with nvcc for sm_90a into
`gapartnet_tpu_torch/_build/` (one library per source, keyed by a hash of
source, shared headers `csrc/*.cuh` and flags, the sources compiled
in parallel) and bound through ctypes to plain `extern "C"` launchers.
They launch on the current CUDA device and PyTorch's current stream.  The
tap splits and row chunks of a shape (which need the card's SM count) are
computed once per (device, shape) and cached, so a launch costs one ctypes
call and the output's allocation.
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
SOURCES = (CSRC_DIR / "subm_conv.cu", CSRC_DIR / "subm_conv_wgrad.cu",
           CSRC_DIR / "subm_conv_bf16.cu", CSRC_DIR / "subm_conv_wgrad_bf16.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
K_TAPS = 27
LAUNCHES: Dict[str, int] = {"fwd": 0, "dgrad": 0, "wgrad": 0,
                            "fwd_bf16": 0, "dgrad_bf16": 0, "wgrad_bf16": 0}


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
    """The library built from `source`, keyed by a hash of it, of the shared
    headers it includes and of the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_wgrad_chunks.argtypes = [ctypes.c_int] * 5
    lib.gapartnet_subm_conv_wgrad_chunks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bf16_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["subm_conv_bf16"]))
    fn = lib.gapartnet_subm_conv_bf16_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_bf16_splits.argtypes = [ctypes.c_int] * 4
    lib.gapartnet_subm_conv_bf16_splits.restype = ctypes.c_int
    lib.gapartnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gapartnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_bf16_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["subm_conv_wgrad_bf16"]))
    fn = lib.gapartnet_subm_conv_wgrad_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gapartnet_subm_conv_wgrad_bf16_chunks.argtypes = [ctypes.c_int] * 5
    lib.gapartnet_subm_conv_wgrad_bf16_chunks.restype = ctypes.c_int
    return lib


def _check(features: torch.Tensor, nbr: torch.Tensor, weights=None, grad=None,
           transposed=False, dtypes=(torch.float32,)) -> None:
    """features (B, V, Cin) and nbr (B, 27, V) int32, with weights
    (27, Cin, Cout) ((27, Cout, Cin) if `transposed`, the dgrad's) or an
    output gradient (B, V, Cout), each float of one of `dtypes` (float32;
    the bf16 wrappers also take bfloat16): types, shapes, one device,
    contiguous."""
    others = [t for t in (weights, grad) if t is not None]
    if any(t.dtype not in dtypes for t in [features, *others]):
        raise TypeError(
            f"subm_conv takes {' or '.join(str(d) for d in dtypes)} features, weights and "
            f"gradients, got {[t.dtype for t in [features, *others]]}"
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
            or (weights is not None and (weights.shape[0], weights.shape[2 if transposed else 1])
                != (K_TAPS, cin))
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _splits(device: int, b: int, v: int, cout: int) -> int:
    """Tap splits of the forward kernel for this shape (1 = no scratch)."""
    return _library().gapartnet_subm_conv_splits(b, v, cout, _sm_count(device))


@functools.lru_cache(maxsize=None)
def _chunks(device: int, b: int, v: int, cin: int, cout: int) -> int:
    """Row chunks of the wgrad kernel for this shape (1 = no scratch)."""
    return _wgrad_library().gapartnet_subm_conv_wgrad_chunks(b, v, cin, cout, _sm_count(device))


def _device(t: torch.Tensor, name: str) -> int:
    """The tensor's CUDA device, which must be the current one: the
    kernels launch there."""
    current = torch.cuda.current_device()
    device = current if t.device.index is None else t.device.index
    if device != current:
        raise ValueError(f"{name}: inputs on cuda:{device}, but the current device is "
                         f"cuda:{current}")
    return device


def _launch_forward(features, nbr, weights, counter: str, flip: bool) -> torch.Tensor:
    """The forward kernel; with `flip` the dgrad, `weights` being the
    forward's (27, Cout, Cin), read tap-reversed and transposed."""
    lib = _library()
    b, v, cin = features.shape
    cout = weights.shape[1] if flip else weights.shape[2]
    device = _device(features, f"subm_conv {counter}")
    out = torch.empty((b, v, cout), dtype=torch.float32, device=features.device)
    # small grids split their taps over blocks; the partial sums need scratch
    splits = _splits(device, b, v, cout)
    partial = (
        torch.empty((splits, b, v, cout), dtype=torch.float32, device=features.device)
        if splits > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_forward(
        features.data_ptr(), nbr.data_ptr(), weights.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, splits, int(flip), stream,
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
    return _launch_forward(features, nbr, weights, "fwd", flip=False)


def subm_conv_dgrad(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """d_features (B, V, Cin) from the output gradient (B, V, Cout) and the
    forward's weights (27, Cin, Cout): the forward kernel on flip(W, 0)^T
    (read in place), counted as "dgrad"."""
    _check(grad, nbr, weights=weights, transposed=True)
    if not _on_card(grad, "subm_conv_dgrad"):
        return subm_conv_dgrad_reference(grad, nbr, weights)
    return _launch_forward(grad, nbr, weights, "dgrad", flip=True)


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
    device = _device(features, "subm_conv wgrad")
    dw = torch.empty((K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
    chunks = _chunks(device, b, v, cin, cout)
    partial = (
        torch.empty((chunks, K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
        if chunks > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_wgrad(
        features.data_ptr(), nbr.data_ptr(), grad.data_ptr(), dw.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, chunks, stream,
    )
    if rc != 0:
        msg = _library().gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv wgrad launch failed: {msg} (CUDA error {rc})")
    LAUNCHES["wgrad"] += 1
    return dw


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even) and widened back to
    float32: JAX's `.astype(bfloat16)` followed by the VJP's upcast."""
    return t.to(torch.bfloat16).to(torch.float32)


def subm_conv_bf16_reference(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain bf16 forward: the fp32 plain forward on operands rounded to
    bf16 (sparse_conv.py:375-377; bf16 products are exact in fp32)."""
    return subm_conv_reference(round_bf16(features), nbr, round_bf16(weights))


def subm_conv_dgrad_bf16_reference(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain bf16 dgrad: the fp32 plain dgrad on operands rounded to bf16,
    its result rounded to bf16 (sparse_conv.py:289-295)."""
    return round_bf16(subm_conv_dgrad_reference(round_bf16(grad), nbr, round_bf16(weights)))


def subm_conv_wgrad_bf16_reference(
    features: torch.Tensor, nbr: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """Plain bf16 wgrad: the fp32 plain wgrad on operands rounded to bf16,
    its result rounded to bf16 (sparse_conv.py:297-316)."""
    return round_bf16(subm_conv_wgrad_reference(round_bf16(features), nbr, round_bf16(grad)))


def bf16_rows(t: torch.Tensor) -> torch.Tensor:
    """(..., C) float -> (..., C rounded up to 8) bfloat16, contiguous,
    16-byte aligned, zeros past C: the operand copy the bf16 kernels read
    (every row a whole number of 16-byte copies).  A tensor that already
    is one is returned as it is."""
    c = t.shape[-1]
    cp = -(-c // 8) * 8
    if (t.dtype == torch.bfloat16 and cp == c and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    out = torch.empty(t.shape[:-1] + (cp,), dtype=torch.bfloat16, device=t.device)
    out[..., :c] = t
    out[..., c:] = 0
    return out


@functools.lru_cache(maxsize=None)
def _splits_bf16(device: int, b: int, v: int, n: int) -> int:
    """Tap splits of the bf16 forward kernel for this shape."""
    return _bf16_library().gapartnet_subm_conv_bf16_splits(b, v, n, _sm_count(device))


@functools.lru_cache(maxsize=None)
def _chunks_bf16(device: int, b: int, v: int, cin: int, cout: int) -> int:
    """Row chunks of the bf16 wgrad kernel for this shape."""
    return _wgrad_bf16_library().gapartnet_subm_conv_wgrad_bf16_chunks(
        b, v, cin, cout, _sm_count(device))


def _launch_forward_bf16(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, k: int,
                         counter: str, round_out: bool) -> torch.Tensor:
    """The bf16 forward kernel on operand copies x (B, V, ld) and
    w (27, N, ld), ld = k rounded up to 8 -> (B, V, N) f32; with
    `round_out` the result rounded to bf16 (the dgrad)."""
    lib = _bf16_library()
    b, v, _ = x.shape
    n = w.shape[1]
    device = _device(x, f"subm_conv {counter}")
    out = torch.empty((b, v, n), dtype=torch.float32, device=x.device)
    splits = _splits_bf16(device, b, v, n)
    partial = (
        torch.empty((splits, b, v, n), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gapartnet_subm_conv_bf16_forward(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, k, n, splits, int(round_out), stream,
    )
    if rc != 0:
        msg = lib.gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv {counter} launch failed: {msg} (CUDA error {rc})")
    LAUNCHES[counter] += 1
    return out


_BF16 = (torch.float32, torch.bfloat16)


def subm_conv_forward_bf16(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The bf16 forward alone, with no autograd: features (B, V, Cin) and
    weights (27, Cin, Cout), float32 or bfloat16, rounded to bf16; nbr
    (B, 27, V) int32 -> (B, V, Cout) f32 (fp32 accumulation)."""
    _check(features, nbr, weights, dtypes=_BF16)
    if not _on_card(features, "subm_conv"):
        return subm_conv_bf16_reference(features, nbr, weights)
    # w[k][co][ci] = W[k][ci][co]: the k-pairs of a B fragment adjacent
    wt = bf16_rows(weights.transpose(1, 2))
    return _launch_forward_bf16(bf16_rows(features), nbr, wt, features.shape[-1],
                                "fwd_bf16", round_out=False)


def subm_conv_dgrad_bf16(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The bf16 dgrad: d_features (B, V, Cin) f32, rounded to bf16, from the
    output gradient (B, V, Cout) rounded to bf16 and the forward's weights
    (27, Cin, Cout): the bf16 forward kernel on flip(W, 0)^T."""
    _check(grad, nbr, weights=weights, transposed=True, dtypes=_BF16)
    if not _on_card(grad, "subm_conv_dgrad"):
        return subm_conv_dgrad_bf16_reference(grad, nbr, weights)
    # the conv's B operand is flip(W, 0)^T; stored row by row of its N
    # (= Cin) with its K (= Cout) contiguous, that is flip(W, 0) itself
    wf = bf16_rows(weights.flip(0))
    return _launch_forward_bf16(bf16_rows(grad), nbr, wf, grad.shape[-1],
                                "dgrad_bf16", round_out=True)


def subm_conv_wgrad_bf16(
    features: torch.Tensor, nbr: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """The bf16 wgrad: d_weights (27, Cin, Cout) f32, rounded to bf16, from
    the inputs (B, V, Cin) and the output gradient (B, V, Cout), both
    rounded to bf16, through csrc/subm_conv_wgrad_bf16.cu."""
    _check(features, nbr, grad=grad, dtypes=_BF16)
    b, v, cin = features.shape
    cout = grad.shape[-1]
    if not _on_card(features, "subm_conv_wgrad"):
        return subm_conv_wgrad_bf16_reference(features, nbr, grad)
    lib = _wgrad_bf16_library()
    x, g = bf16_rows(features), bf16_rows(grad)
    device = _device(features, "subm_conv wgrad_bf16")
    dw = torch.empty((K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
    chunks = _chunks_bf16(device, b, v, cin, cout)
    partial = (
        torch.empty((chunks, K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
        if chunks > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_wgrad_bf16(
        x.data_ptr(), nbr.data_ptr(), g.data_ptr(), dw.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, chunks, stream,
    )
    if rc != 0:
        msg = _bf16_library().gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv wgrad_bf16 launch failed: {msg} (CUDA error {rc})")
    LAUNCHES["wgrad_bf16"] += 1
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


class _SubmConvBf16(torch.autograd.Function):
    """The JAX bf16 conv and its VJP (sparse_conv.py:286-318, 375-377):
    the inputs are rounded to bf16 (and saved so), the output gradient is
    rounded to bf16, and the dgrad and wgrad round their fp32 results to
    bf16; the gradients come back as float32, the upcast of the VJP of
    `astype`."""

    @staticmethod
    def forward(ctx, features, nbr, weights):
        x = features.to(torch.bfloat16)
        ctx.save_for_backward(x, nbr, weights)
        return subm_conv_forward_bf16(x, nbr, weights)

    @staticmethod
    def backward(ctx, grad):
        x, nbr, weights = ctx.saved_tensors
        g = grad.to(torch.bfloat16).contiguous()
        d_features = subm_conv_dgrad_bf16(g, nbr, weights) if ctx.needs_input_grad[0] else None
        d_weights = subm_conv_wgrad_bf16(x, nbr, g) if ctx.needs_input_grad[2] else None
        return d_features, None, d_weights


def subm_conv(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """features (B, V, Cin) f32, nbr (B, 27, V) int32, weights (27, Cin, Cout)
    f32 -> (B, V, Cout) f32, differentiable in features and weights.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels (counted
    in `subm_conv.launches`) or raise.  `compute_dtype` None (or float32)
    computes in fp32; torch.bfloat16 rounds the operands to bf16 and runs
    the bf16 kernels, as the JAX `compute_dtype=jnp.bfloat16`."""
    _check(features, nbr, weights)
    grad = torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad)
    if compute_dtype in (None, torch.float32):
        return _SubmConv.apply(features, nbr, weights) if grad else subm_conv_forward(
            features, nbr, weights)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"subm_conv computes in float32 or bfloat16, not {compute_dtype}")
    if grad:
        return _SubmConvBf16.apply(features, nbr, weights)
    return subm_conv_forward_bf16(features, nbr, weights)


subm_conv.launches = LAUNCHES
