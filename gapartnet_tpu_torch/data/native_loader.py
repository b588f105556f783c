"""ctypes bindings of the native data-pipeline library (the port's copy of
data/native_loader.py, built from its own copy of data/native/gapdata.cpp).

The library is compiled with g++ at first use (plain C interface, no
pybind11) into `gapartnet_tpu_torch/_build/`, keyed by a hash of the source,
the compiler, its flags and the host CPU (`-march=native`), and written
through a temporary file and a rename, so concurrent processes never load a
half-written library.  It replaces the reference's host hot loops:
pointnet_lib CUDA FPS for preprocessing and the per-instance Python loop in
dataloader workers (gapartnet.py:145-176).

There is no silent fallback: a failed build raises with the compiler's
output.  The JAX package falls back to NumPy, and the two differ past
`max_instances`: the native `instance_info` (gapdata.cpp:65-113) leaves the
regions of instances past the cap at 0, the NumPy one computes them.  The
NumPy versions stay as the plain versions, reached with `native=False`.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from gapartnet_tpu_torch.data.instances import generate_instance_info

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "native" / "gapdata.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
BUILD_TIMEOUT_S = 120


def _host_cpu() -> bytes:
    """The CPU model and feature flags that -march=native compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def library_path(cxx: str = CXX, build_dir: Path = BUILD_DIR) -> Path:
    """The library built from SOURCE by `cxx` with CXX_FLAGS on this CPU."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()
                            + _host_cpu())
    return Path(build_dir) / f"libgapdata-{digest.hexdigest()[:16]}.so"


def build(cxx: str = CXX, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless it is built; return its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path(cxx, build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so")
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native data library: cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native data library: {' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library with its ctypes signatures (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    lib.fps_cpu.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fps_cpu.restype = None
    lib.instance_info.restype = ctypes.c_int32
    lib.instance_info.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.augment_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.augment_points.restype = None
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def fps_cpu(xyz: np.ndarray, num_samples: int, native: bool = True) -> np.ndarray:
    """Greedy FPS on the host, seeded at index 0: (n, 3) -> (num_samples,)
    int32.  `native=False`: the NumPy version (same semantics)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"fps_cpu: xyz must be (n, 3), got {xyz.shape}")
    out = np.zeros(num_samples, np.int32)
    if native:
        get_lib().fps_cpu(_fptr(xyz), xyz.shape[0], num_samples, _iptr(out))
        return out
    dists = np.full(xyz.shape[0], np.inf, np.float32)
    last = 0
    for s in range(1, num_samples):
        d = ((xyz - xyz[last]) ** 2).sum(1)
        np.minimum(dists, d, out=dists)
        last = int(np.argmax(dists))
        out[s] = last
    return out


def instance_info(
    points: np.ndarray, sem_labels: np.ndarray, instance_labels: np.ndarray,
    max_instances: int, native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(instance_regions (N, 9), num_points_per_instance (I,),
    instance_sem_labels (I,), K): per-point instance mean / min / max and
    per-instance sizes and labels, padded to I = `max_instances`, K clamped
    to it.  Natively, points of instances past the cap get regions 0;
    `native=False` (data/instances.py) computes theirs."""
    if not native:
        regions, nppi, isl, num = generate_instance_info(points, sem_labels, instance_labels)
        k = min(num, max_instances)
        nppi_p = np.zeros(max_instances, np.int32)
        isl_p = np.full(max_instances, -1, np.int32)
        nppi_p[:k] = nppi[:k]
        isl_p[:k] = isl[:k]
        return regions, nppi_p, isl_p, k
    points = np.ascontiguousarray(points, np.float32)
    sem = np.ascontiguousarray(sem_labels, np.int32)
    ins = np.ascontiguousarray(instance_labels, np.int32)
    n, c = points.shape
    if c < 3 or sem.shape != (n,) or ins.shape != (n,):
        raise ValueError(f"instance_info: points {points.shape}, sem {sem.shape}, ins {ins.shape}")
    regions = np.zeros((n, 9), np.float32)
    nppi = np.zeros(max_instances, np.int32)
    isl = np.full(max_instances, -1, np.int32)
    num = get_lib().instance_info(
        _fptr(points), n, c, _iptr(sem), _iptr(ins), max_instances,
        _fptr(regions), _iptr(nppi), _iptr(isl),
    )
    return regions, nppi, isl, int(num)


def augment_points(points: np.ndarray, m: np.ndarray, color_delta: np.ndarray,
                   native: bool = True) -> np.ndarray:
    """points[:, :3] @ m and points[:, 3:] + color_delta, in place when
    `points` is contiguous float32 (else on a copy); returns the result.
    Natively the products may be contracted into FMAs (-march=native), so
    they can differ from NumPy's by an ulp."""
    points = np.ascontiguousarray(points, np.float32)
    mm = np.ascontiguousarray(m, np.float32)
    cd = np.ascontiguousarray(color_delta, np.float32)
    if points.ndim != 2 or points.shape[1] < 3 or mm.shape != (3, 3) or \
            cd.shape != (points.shape[1] - 3,):
        raise ValueError(f"augment_points: points {points.shape}, m {mm.shape}, "
                         f"color_delta {cd.shape}")
    if native:
        get_lib().augment_points(_fptr(points), points.shape[0], points.shape[1],
                                 _fptr(mm), _fptr(cd))
        return points
    points[:, :3] = points[:, :3] @ m
    points[:, 3:] += color_delta[None, :]
    return points
