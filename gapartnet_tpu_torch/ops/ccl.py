"""Connected components of a fixed-shape neighbour graph (counterpart of
ops/ccl.py `connected_components_single`).

The graph is the (N, K) first-K neighbour list of ops/ball_query.py.  Min-
label propagation with pointer jumping: each iteration pulls the minimum
label over a node's neighbours, pushes each node's label onto its
neighbours (a scatter-min, which symmetrizes the capped directed graph),
then jumps pointers twice.  As the JAX `while_loop`, the loop tests for
convergence before each iteration (labels unchanged by the last one) and
stops after `max_iters`.  Labels converge to the minimum point index of
each component; invalid nodes label themselves.  When the cap ends the
loop, one more iteration tells whether it would still change a label: then
the loop ended before the fixpoint, and the labels are another grouping's
(the second value returned, a () int32 tensor, says so; the counters
`ccl_exact_iterations` and `ccl_exact_unconverged` count both).

`connected_components_single` is the entry, inside the span `cluster:ccl`.
On a CPU tensor it runs the plain loop, `connected_components_reference`
(the JAX body step for step: absent neighbours scatter to a dump slot,
JAX's `mode="drop"`), whose convergence test is one host synchronisation
an iteration (`sync:ccl_exact_converged`; a call makes as many tests as
iterations).  On a CUDA tensor it makes one launch of
csrc/ccl_exact.cu, which runs the whole loop on the device and gives
bitwise the plain loop's labels, iteration count and flag, with no host
sync: the count and the flag stay on the device, read by the recorder
only when a recording ends (each launch counted as
`ccl_exact_launches`).  The kernel replaces no Pallas kernel (the JAX CCL
is an XLA `while_loop`).  By bytes it is bound by the listed neighbours,
read once an iteration (3.1 MB on the bench cloud's shifted set), and the
labels; in practice one block's walk over the rows binds, a warp a row.
Its two label buffers live in the block's shared memory up to N = 28,928
(an H100's 227 KB); a larger graph keeps them in device scratch, the same
code.  The launcher alone makes that choice; the wrapper always hands it
3 N ints of scratch.  The kernel reads a row only where its first entry is
a node index (rows are ascending and -1 padded, as ball_query_single gives
them), and skips the entries that are not.  The source's head note gives
the design and why convergence needs no copy of the previous labels (every
phase only lowers labels).

The library is built at first use with nvcc by ops/subm_conv.py's route
(`build((SOURCE,))`), so configurations that never cluster exactly build
nothing more.  A recording counts the iterations of either route
(`ccl_exact_iterations`); a call is the `n` of its `cluster:ccl` span.
"""

import ctypes
import functools
from typing import Tuple

import torch

from gapartnet_tpu_torch.ops.subm_conv import CSRC_DIR, _device, _on_card, build
from gapartnet_tpu_torch.utils.profiling import count, span

SOURCE = CSRC_DIR / "ccl_exact.cu"


def connected_components_reference(
    neighbor_idx: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain loop on any device: (N, K) int32 neighbour lists (-1
    padded), (N,) bool -> ((N,) int32 labels, () int32 flag: 1 where
    `max_iters` ended the loop before the labels reached their fixpoint)."""
    n = neighbor_idx.shape[0]
    dev = neighbor_idx.device
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    nbr_ok = neighbor_idx >= 0
    nbr = torch.where(nbr_ok, neighbor_idx, self_idx[:, None]).long()
    targets = torch.where(nbr_ok, nbr, n).reshape(-1)
    big = torch.full_like(neighbor_idx, n)

    def propagate(labels):
        # pull
        labels = torch.minimum(labels, torch.where(nbr_ok, labels[nbr], big).amin(dim=1))
        # push: scatter-min of each node's label onto its neighbours
        pushed = torch.cat([labels, labels.new_full((1,), n)])
        pushed.scatter_reduce_(0, targets, labels[:, None].expand_as(nbr).reshape(-1),
                               reduce="amin", include_self=True)
        labels = pushed[:n]
        # pointer jumping: labels are point indices
        labels = labels[labels.long()]
        return labels[labels.long()]

    labels = self_idx
    iterations = unconverged = 0
    for it in range(max_iters):
        if it > 0:
            with span("sync:ccl_exact_converged"):
                done = torch.equal(labels, prev)
            if done:
                break
        iterations += 1
        prev = labels
        labels = propagate(labels)
    else:
        # the cap ended the loop: the labels are final if one more
        # iteration would leave them as they are
        with span("sync:ccl_exact_converged"):
            unconverged = int(not torch.equal(propagate(labels), labels))
    count("ccl_exact_iterations", iterations)
    count("ccl_exact_unconverged", unconverged)
    return (torch.where(valid, labels, self_idx),
            torch.full((), unconverged, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build((SOURCE,))[SOURCE.stem]))
    fn = lib.gapartnet_ccl_exact
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.gapartnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gapartnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def connected_components_kernel(
    neighbor_idx: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of csrc/ccl_exact.cu on CUDA tensors: (N, K) int32
    neighbour lists, (N,) bool -> ((N,) int32 labels, () int32 iteration
    count, () int32 flag), all on the device; no host sync."""
    if neighbor_idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"ccl_exact takes int32 neighbour lists and a bool mask, got "
                        f"{neighbor_idx.dtype} and {valid.dtype}")
    if neighbor_idx.dim() != 2 or tuple(valid.shape) != (neighbor_idx.shape[0],):
        raise ValueError(f"ccl_exact takes neighbour lists (N, K) and a mask (N,), got "
                         f"{tuple(neighbor_idx.shape)} and {tuple(valid.shape)}")
    if neighbor_idx.device != valid.device or neighbor_idx.device.type != "cuda":
        raise ValueError(f"ccl_exact runs on one CUDA device, got {neighbor_idx.device} and "
                         f"{valid.device}")
    if not (neighbor_idx.is_contiguous() and valid.is_contiguous()):
        raise ValueError("ccl_exact takes contiguous tensors")
    if max_iters < 0:
        raise ValueError(f"ccl_exact: max_iters {max_iters} < 0")
    lib = _library()
    n, k = neighbor_idx.shape
    _device(neighbor_idx, "ccl_exact")
    out = torch.empty((n + 2,), dtype=torch.int32, device=neighbor_idx.device)
    # the listed rows, and the two label buffers where shared memory is short
    scratch_ints = max(1, 3 * n)
    scratch = torch.empty((scratch_ints,), dtype=torch.int32, device=neighbor_idx.device)
    stream = torch.cuda.current_stream(neighbor_idx.device).cuda_stream
    ptr = out.data_ptr()
    rc = lib.gapartnet_ccl_exact(
        neighbor_idx.data_ptr(), valid.data_ptr(), n, k, max_iters,
        ptr, ptr + 4 * n, ptr + 4 * (n + 1), scratch.data_ptr(), scratch_ints, stream,
    )
    if rc != 0:
        msg = lib.gapartnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"ccl_exact launch failed: {msg} (CUDA error {rc})")
    count("ccl_exact_launches", 1)
    return out[:n], out[n], out[n + 1]


def connected_components_single(
    neighbor_idx: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) int32 neighbour lists (-1 padded), (N,) bool -> ((N,) int32
    labels: the minimum point index of each node's component; () int32 on
    the input's device: 1 where `max_iters` ended the loop before the labels
    reached their fixpoint, else 0).  The plain loop on the CPU, the kernel
    on a CUDA device.  Each row lists its neighbours first, then only -1
    (ball_query_single's rows): the kernel takes a row whose first entry is
    -1 as empty, where the plain loop would still link any node listed
    after it."""
    with span("cluster:ccl"):
        if not _on_card(neighbor_idx, "connected_components_single"):
            return connected_components_reference(neighbor_idx, valid, max_iters)
        labels, iterations, unconverged = connected_components_kernel(
            neighbor_idx, valid, max_iters)
        count("ccl_exact_iterations", iterations)
        count("ccl_exact_unconverged", unconverged)
        return labels, unconverged
