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

Three wrappers launch the kernels, each launch counted by
`utils/profiling.count` under its kind's name in `LAUNCH_COUNTERS`
(`subm_conv_fwd_launches`, ...; counted only while a recording is on):

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
Three more wrappers launch the bf16 kernels, counted as kinds "fwd_bf16",
"dgrad_bf16" and "wgrad_bf16":

  * `subm_conv_forward_bf16` -> csrc/subm_conv_bf16.cu;
  * `subm_conv_dgrad_bf16`   -> csrc/subm_conv_bf16.cu on the output
                                gradient, reading W tap-reversed and
                                transposed in place;
  * `subm_conv_wgrad_bf16`   -> csrc/subm_conv_wgrad_bf16.cu.

They take float32 or bfloat16 tensors as they are (rows of any width and
alignment) and write no operand copy: the kernels gather fp32 rows and
weights by cp.async, round them to bf16 in shared memory, run
wgmma.mma_async (bf16 in, fp32 accumulation), and launch no fp32 kernel.
Their launch plans (`bf16_forward_plan`, `bf16_wgrad_plan`: wgmma N tile,
tap splits, row chunks, shared bytes) are computed here and checked by the
kernels; a call is one launch, or two where it splits taps or row chunks.
Their
plain versions (`subm_conv_bf16_reference`, `subm_conv_dgrad_bf16_reference`,
`subm_conv_wgrad_bf16_reference`) round the operands, run the fp32 plain
versions and round as the JAX VJP does.

The kernels are compiled at first use with nvcc for sm_90a into
`gapartnet_tpu_torch/_build/` (one library per source, keyed by a hash of
source, shared headers `csrc/*.cuh` and flags, the sources compiled
in parallel) and bound through ctypes to plain `extern "C"` launchers.
`build` takes the sources wanted, so ops/ccl.py builds its own kernel by
the same route only when exact clustering first runs.
They launch on the current CUDA device and PyTorch's current stream.  The
tap splits, row chunks and plans of a shape (which need the card's SM count)
are computed once per (device, shape) and cached, so a launch costs one ctypes
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
from typing import Dict, Sequence

import torch

from gapartnet_tpu_torch.utils.profiling import count

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
# the profiling counter of each wrapper's launches, by kind
LAUNCH_COUNTERS = {kind: f"subm_conv_{kind}_launches" for kind in (
    "fwd", "dgrad", "wgrad", "fwd_bf16", "dgrad_bf16", "wgrad_bf16")}


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


def build(sources: Sequence[Path] = SOURCES) -> Dict[str, Path]:
    """Compile the libraries of `sources` (the conv kernels' by default)
    that are not built yet, one nvcc per source, all started together;
    return {source stem: library path}.  The compiler's output (with the
    ptxas register and shared-memory report) is kept beside each library as
    `<library>.log`."""
    libs = {src.stem: library_path(src) for src in sources}
    jobs = []
    for src in sources:
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


def build_log(sources: Sequence[Path] = SOURCES) -> str:
    """The compiler's reports of the current builds of `sources` ('' if none)."""
    logs = [Path(str(library_path(src)) + ".log") for src in sources]
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
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.gapartnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gapartnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_bf16_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["subm_conv_wgrad_bf16"]))
    fn = lib.gapartnet_subm_conv_wgrad_bf16
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                                                  ctypes.c_void_p])
    fn.restype = ctypes.c_int
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
    count(LAUNCH_COUNTERS[counter], 1)
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
    count(LAUNCH_COUNTERS["wgrad"], 1)
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


# The bf16 kernels' launch plans (csrc/subm_conv_bf16.cu and
# csrc/subm_conv_wgrad_bf16.cu check what they are given against their own
# layout): the wgmma N tiles the kernels are built for, the staging ring's
# depth, the rows of a wgmma tile, the forward's channels per stage, the
# wgrad's compacted rows per stage and candidate rows per pass, the shared
# memory a block may use, and the blocks per SM the tap splits and row
# chunks aim for.
BF16_N_TILES = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256)
BF16_STAGES = 3
BF16_ROWS = 64
BF16_KC = 16
BF16_WGRAD_ROWS = 32
BF16_WGRAD_CANDIDATES = 2048
BF16_MAX_SMEM = 232448
BF16_THREADS = 128
BF16_FWD_BLOCKS_PER_SM = 4
BF16_WGRAD_BLOCKS_PER_SM = 16
BF16_WGRAD_MIN_CHUNK_ROWS = 512


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _n_tile(n: int) -> int:
    """The wgmma N of a tile of `n` output channels: n split into equal
    tiles of at most 256, each rounded up to a width the kernels are built
    for."""
    per = _cdiv(n, _cdiv(n, BF16_N_TILES[-1]))
    return next(t for t in BF16_N_TILES if t >= per)


def bf16_forward_plan(b: int, v: int, k: int, n: int, sms: int) -> Dict[str, int]:
    """Launch plan of the bf16 forward / dgrad kernel for x (b, v, k) ->
    (b, v, n) on a card with `sms` SMs: the N tile; the voxels per block
    (two 64-row wgmma tiles while their accumulators fit 128 registers a
    thread, else one); the tap splits (until the grid holds
    BF16_FWD_BLOCKS_PER_SM blocks per SM, no split empty); the dynamic
    shared memory of a block (two bf16 operand buffers of A (rows x 16) and
    B (n_tile x 16), BF16_STAGES fp32 staging buffers of the gathered rows
    and the weights, the tile's 27 x rows neighbour indices)."""
    n_tile = _n_tile(n)
    rows = BF16_ROWS * (2 if n_tile <= 128 else 1)
    kc = BF16_KC
    smem = (2 * (rows + n_tile) * kc * 2 + BF16_STAGES * (rows * (kc + 4) + n_tile * kc) * 4
            + K_TAPS * rows * 4)
    base = _cdiv(v, rows) * b * _cdiv(n, n_tile)
    splits = min(K_TAPS, max(1, _cdiv(BF16_FWD_BLOCKS_PER_SM * sms, base)))
    splits = _cdiv(K_TAPS, _cdiv(K_TAPS, splits))
    return dict(n_tile=n_tile, rows=rows, splits=splits, smem=smem)


def bf16_wgrad_plan(b: int, v: int, cin: int, cout: int, sms: int) -> Dict[str, int]:
    """Launch plan of the bf16 wgrad kernel (a block per row chunk, tap, 64
    input channels and N tile): the N tile; the row chunks (until the grid
    holds BF16_WGRAD_BLOCKS_PER_SM blocks per SM, each chunk at least
    BF16_WGRAD_MIN_CHUNK_ROWS rows, a multiple of the 128 threads' rows,
    none empty); the dynamic shared memory (two bf16 operand buffers and
    BF16_STAGES fp32 staging buffers of A (64 x 32 compacted rows) and B
    (32 x n_tile), and the pass's two lists of compacted rows)."""
    n_tile = _n_tile(cout)
    blocks = K_TAPS * _cdiv(cin, 64) * _cdiv(cout, n_tile)
    rows = b * v
    chunks = min(_cdiv(BF16_WGRAD_BLOCKS_PER_SM * sms, blocks),
                 _cdiv(rows, BF16_WGRAD_MIN_CHUNK_ROWS))
    chunk_rows = BF16_THREADS * _cdiv(_cdiv(rows, chunks), BF16_THREADS)
    ab = (64 + n_tile) * BF16_WGRAD_ROWS
    smem = 2 * ab * 2 + BF16_STAGES * ab * 4 + 2 * BF16_WGRAD_CANDIDATES * 4
    return dict(n_tile=n_tile, chunks=_cdiv(rows, chunk_rows), chunk_rows=chunk_rows, smem=smem)


@functools.lru_cache(maxsize=None)
def _forward_plan_bf16(device: int, b: int, v: int, k: int, n: int) -> Dict[str, int]:
    return bf16_forward_plan(b, v, k, n, _sm_count(device))


@functools.lru_cache(maxsize=None)
def _wgrad_plan_bf16(device: int, b: int, v: int, cin: int, cout: int) -> Dict[str, int]:
    return bf16_wgrad_plan(b, v, cin, cout, _sm_count(device))


def _launch_forward_bf16(x: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
                         counter: str, flip: bool) -> torch.Tensor:
    """The bf16 forward kernel on x (B, V, K) as it is (fp32 or bf16) and
    the weights in place -> (B, V, N) f32; with `flip` the dgrad: the
    forward's (27, N, K) weights read tap-reversed and transposed, the
    result rounded to bf16."""
    lib = _bf16_library()
    b, v, k = x.shape
    n = weights.shape[1] if flip else weights.shape[2]
    device = _device(x, f"subm_conv {counter}")
    plan = _forward_plan_bf16(device, b, v, k, n)
    out = torch.empty((b, v, n), dtype=torch.float32, device=x.device)
    splits = plan["splits"]
    partial = (
        torch.empty((splits, b, v, n), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gapartnet_subm_conv_bf16_forward(
        x.data_ptr(), int(x.dtype == torch.bfloat16), nbr.data_ptr(), weights.data_ptr(),
        int(weights.dtype == torch.bfloat16), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, k, n, plan["n_tile"], splits, plan["smem"], int(flip), int(flip),
        stream,
    )
    if rc != 0:
        msg = lib.gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv {counter} launch failed: {msg} (CUDA error {rc})")
    count(LAUNCH_COUNTERS[counter], 1)
    return out


_BF16 = (torch.float32, torch.bfloat16)


def subm_conv_forward_bf16(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The bf16 forward alone, with no autograd: features (B, V, Cin) and
    weights (27, Cin, Cout), float32 or bfloat16, rounded to bf16 inside the
    kernel; nbr (B, 27, V) int32 -> (B, V, Cout) f32 (fp32 accumulation)."""
    _check(features, nbr, weights, dtypes=_BF16)
    if not _on_card(features, "subm_conv"):
        return subm_conv_bf16_reference(features, nbr, weights)
    return _launch_forward_bf16(features, nbr, weights, "fwd_bf16", flip=False)


def subm_conv_dgrad_bf16(
    grad: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The bf16 dgrad: d_features (B, V, Cin) f32, rounded to bf16, from the
    output gradient (B, V, Cout) rounded to bf16 and the forward's weights
    (27, Cin, Cout): the bf16 forward kernel on flip(W, 0)^T, read in place."""
    _check(grad, nbr, weights=weights, transposed=True, dtypes=_BF16)
    if not _on_card(grad, "subm_conv_dgrad"):
        return subm_conv_dgrad_bf16_reference(grad, nbr, weights)
    return _launch_forward_bf16(grad, nbr, weights, "dgrad_bf16", flip=True)


def subm_conv_wgrad_bf16(
    features: torch.Tensor, nbr: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """The bf16 wgrad: d_weights (27, Cin, Cout) f32, rounded to bf16, from
    the inputs (B, V, Cin) and the output gradient (B, V, Cout), both
    rounded to bf16 inside the kernel, through csrc/subm_conv_wgrad_bf16.cu."""
    _check(features, nbr, grad=grad, dtypes=_BF16)
    b, v, cin = features.shape
    cout = grad.shape[-1]
    if not _on_card(features, "subm_conv_wgrad"):
        return subm_conv_wgrad_bf16_reference(features, nbr, grad)
    lib = _wgrad_bf16_library()
    device = _device(features, "subm_conv wgrad_bf16")
    plan = _wgrad_plan_bf16(device, b, v, cin, cout)
    dw = torch.empty((K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
    chunks = plan["chunks"]
    partial = (
        torch.empty((chunks, K_TAPS, cin, cout), dtype=torch.float32, device=features.device)
        if chunks > 1 else None
    )
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.gapartnet_subm_conv_wgrad_bf16(
        features.data_ptr(), int(features.dtype == torch.bfloat16), nbr.data_ptr(),
        grad.data_ptr(), int(grad.dtype == torch.bfloat16), dw.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, v, cin, cout, plan["n_tile"], chunks, plan["chunk_rows"],
        plan["smem"], stream,
    )
    if rc != 0:
        msg = _bf16_library().gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"subm_conv wgrad_bf16 launch failed: {msg} (CUDA error {rc})")
    count(LAUNCH_COUNTERS["wgrad_bf16"], 1)
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
    """The JAX bf16 conv and its VJP (sparse_conv.py:286-318, 375-377): the
    inputs are rounded to bf16, the output gradient is rounded to bf16, and
    the dgrad and wgrad round their fp32 results to bf16; the gradients come
    back as float32, the upcast of the VJP of `astype`.  The roundings of
    the operands happen inside the kernels (and the plain versions), so the
    features are saved as they came (the tensor the network holds anyway)
    and the gradient is passed on as it comes."""

    @staticmethod
    def forward(ctx, features, nbr, weights):
        ctx.save_for_backward(features, nbr, weights)
        return subm_conv_forward_bf16(features, nbr, weights)

    @staticmethod
    def backward(ctx, grad):
        features, nbr, weights = ctx.saved_tensors
        grad = grad.contiguous()
        d_features = subm_conv_dgrad_bf16(grad, nbr, weights) if ctx.needs_input_grad[0] else None
        d_weights = subm_conv_wgrad_bf16(features, nbr, grad) if ctx.needs_input_grad[2] else None
        return d_features, None, d_weights


def subm_conv(
    features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """features (B, V, Cin) f32, nbr (B, 27, V) int32, weights (27, Cin, Cout)
    f32 -> (B, V, Cout) f32, differentiable in features and weights.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels (counted
    as `LAUNCH_COUNTERS` says) or raise.  `compute_dtype` None (or float32)
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
