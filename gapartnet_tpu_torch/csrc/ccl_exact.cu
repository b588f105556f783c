// Connected components of a first-K neighbour graph (exact clustering), the
// whole min-label loop in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX CCL (gapartnet_tpu/ops/ccl.py
// `connected_components_single`) is an XLA `while_loop`.  It replaces the
// port's plain loop (ops/ccl.py `connected_components_reference`), which
// runs each iteration as some 15 small launches, pushes every (node,
// neighbour) pair through one scatter-min (absent neighbours to a dump
// slot) and tests convergence with one host sync an iteration.  This
// kernel gives bitwise the same labels, iteration count and unconverged
// flag, and makes no host sync.
//
// One iteration, on labels L (every label a point index with L[j] <= j):
//   pull:  A[i] = min(L[i], min over listed j of L[nbr(i, j)])
//   push:  B = A, then B[t] = min(B[t], A[i]) for each listed t of row i
//   jump:  C[i] = B[B[i]],  D[i] = C[C[i]];  D is the next L.
// As the JAX loop, a call iterates until an iteration leaves L as it is, or
// `max_iters` iterations; when the cap ends the loop, one more iteration
// tells whether the labels had reached their fixpoint (the flag), and the
// labels returned are those after `max_iters` iterations.  Invalid nodes
// label themselves at the end.
//
// Inputs: neighbour lists (N, K) int32, each row ascending and padded with
// -1 after its last neighbour (ops/ball_query.py's first K).  The kernel
// relies on the padding: a row whose first entry is not a node index in
// [0, N) is taken as empty, unread past that entry (a row [-1, 5, ...]
// links nothing here, while the plain loop links it); in the other rows
// every entry that is not a node index is skipped.  Reading each row whole
// to lift this would cost one block a pass over all N K entries a call.
//
// Convergence needs no copy of the previous labels: every phase is
// elementwise non-increasing (L[j] <= j makes B[B[i]] <= B[i]), so D == L
// exactly when no phase lowered an element, and the last barrier of an
// iteration (__syncthreads_or) ORs each thread's "lowered" bit.
//
// What bounds it on this card: by bytes, the listed neighbours read once an
// iteration (3.1 MB at N = 20000, K = 300 on the bench cloud, where 2,639
// rows are not empty; 0.17 MB at K = 50) and the labels, about a
// microsecond an iteration at 3.35 TB/s.  One block does the whole loop,
// so the lists come from L2 (they stay there across iterations) at one
// SM's share of its bandwidth, and a launch costs one SM and no host round
// trip.  Measured on an H100 (SM clocks at the barriers), the row walk
// binds: about 800 cycles a row for each warp, the push's shared-memory
// atomics about half of it, the L2 load and the warp reduction the rest;
// the per-node phases and the barriers take a tenth of an iteration.
//
// Design:
//   * one block of 1024 threads a call; the two label buffers live in
//     shared memory (2 x 4 N bytes, up to N = 28,928 on an H100's 227 KB);
//     a larger graph takes the same code with the buffers in device memory
//     (the caller's scratch), where the atomics go to L2.  The launcher
//     alone chooses, from the device's opt-in limit; the caller always
//     hands it 3 N ints of scratch;
//   * pull and push are one phase: the pull reads L from buffer P while the
//     push lowers buffer Q, which holds C of the previous iteration (or L
//     itself at the start) and so is >= L >= A everywhere; each node's own
//     A and every push go into Q by atomicMin, which leaves Q = B.  The
//     jumps then run Q -> P (C) and P -> Q (D), and P and Q swap roles: the
//     iteration costs three barriers and one read of the neighbour lists;
//   * a prologue lists the rows that are not empty (a warp-aggregated
//     counter into the caller's scratch), so an iteration walks only those:
//     a warp a row, each lane loading up to kRegChunks entries of it at
//     once and keeping them and their labels in registers for the push; a
//     push is made only where the neighbour's label lies above the row's
//     minimum (else B there is already at most that minimum), with no read
//     of Q before it (the read cost more than the atomics it saved).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRegChunks = 10;            // up to a row's first 320 entries stay in registers
constexpr unsigned kFull = 0xffffffffu;
// shared bytes the block keeps besides the label buffers (the row count)
constexpr int kStaticShared = 1024;

__device__ __forceinline__ bool listed(int t, int n) {
  return static_cast<unsigned>(t) < static_cast<unsigned>(n);
}

// Pull and push over the rows that list neighbours, a warp a row: a row's
// first 32 C entries are loaded at once and kept in registers with their
// labels (C = the row's 32-entry chunks, a template parameter, so a short
// row issues no instruction for the chunks it has not); with LONG, entries
// past 32 kRegChunks are read again for the push.
template <int C, bool LONG>
__device__ __forceinline__ void pull_push(const int* __restrict__ nbr, int n, int k,
                                          const int* P, int* Q, const int* rows, int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int next = warp < nrows ? rows[warp] : 0;
  for (int r = warp; r < nrows; r += kWarps) {
    const int i = next;
    if (r + kWarps < nrows) next = rows[r + kWarps];
    const int* row = nbr + static_cast<size_t>(i) * k;
    int t[C], lt[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int e = 32 * u + lane;
      t[u] = e < k ? __ldg(row + e) : -1;
    }
    const int own = P[i];
    int a = own;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      lt[u] = listed(t[u], n) ? P[t[u]] : -1;
      if (lt[u] >= 0) a = min(a, lt[u]);
    }
    if (LONG) {
      for (int e = 32 * C + lane; e < k; e += 32) {
        const int tt = __ldg(row + e);
        if (listed(tt, n)) a = min(a, P[tt]);
      }
    }
    a = __reduce_min_sync(kFull, a);
    // the node's own A (where it equals L, the loop over all nodes put it
    // in Q), then the pushes: one matters only where the neighbour's label
    // lies above a, else B there is at most a already
    if (lane == 0 && a < own) atomicMin(&Q[i], a);
#pragma unroll
    for (int u = 0; u < C; ++u)
      if (lt[u] > a) atomicMin(&Q[t[u]], a);
    if (LONG) {
      for (int e = 32 * C + lane; e < k; e += 32) {
        const int tt = __ldg(row + e);
        if (listed(tt, n) && P[tt] > a) atomicMin(&Q[tt], a);
      }
    }
  }
}

// pull_push with C = the rows' chunk count, or kRegChunks and LONG beyond it
template <int C = 1>
__device__ __forceinline__ void pull_push_rows(const int* __restrict__ nbr, int n, int k,
                                               const int* P, int* Q, const int* rows,
                                               int nrows) {
  const int chunks = (k + 31) / 32;
  if constexpr (C < kRegChunks) {
    if (chunks <= C)
      pull_push<C, false>(nbr, n, k, P, Q, rows, nrows);
    else
      pull_push_rows<C + 1>(nbr, n, k, P, Q, rows, nrows);
  } else if (chunks <= C) {
    pull_push<C, false>(nbr, n, k, P, Q, rows, nrows);
  } else {
    pull_push<C, true>(nbr, n, k, P, Q, rows, nrows);
  }
}

// One iteration on labels in P (read) with Q >= L everywhere (written);
// returns (to every thread) whether it lowered any label.  Leaves the new
// labels in Q and the intermediate C in P.
__device__ __forceinline__ bool iterate(const int* __restrict__ nbr, int n, int k, int* P,
                                        int* Q, const int* rows, int nrows) {
  const int tid = threadIdx.x;
  // pull and push: each node's own A (= L for an empty row), and the rows
  for (int i = tid; i < n; i += kThreads) {
    const int l = P[i];
    if (Q[i] > l) atomicMin(&Q[i], l);
  }
  pull_push_rows(nbr, n, k, P, Q, rows, nrows);
  __syncthreads();
  // jump: C = B[B] into P (L is read here for the last time) ...
  bool lowered = false;
  for (int i = tid; i < n; i += kThreads) {
    const int l = P[i];
    const int c = Q[Q[i]];
    lowered |= c < l;
    P[i] = c;
  }
  __syncthreads();
  // ... and D = C[C] into Q
  for (int i = tid; i < n; i += kThreads) {
    const int c = P[i];
    const int d = P[c];
    lowered |= d < c;
    Q[i] = d;
  }
  return __syncthreads_or(lowered) != 0;
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads, 1)
ccl_exact_kernel(const int* __restrict__ nbr, const unsigned char* __restrict__ valid, int n,
                 int k, int max_iters, int* __restrict__ labels, int* __restrict__ iterations,
                 int* __restrict__ unconverged, int* __restrict__ rows, int* global_labels) {
  extern __shared__ int shared_labels[];
  __shared__ int nrows;
  int* P = SHARED ? shared_labels : global_labels;
  int* Q = P + n;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) nrows = 0;
  for (int i = tid; i < n; i += kThreads) P[i] = Q[i] = i;
  __syncthreads();
  // the rows that list a neighbour, in any order (min is order-free)
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool busy = i < n && k > 0 && listed(__ldg(nbr + static_cast<size_t>(i) * k), n);
    const unsigned ballot = __ballot_sync(kFull, busy);
    int slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&nrows, __popc(ballot));
    slot = __shfl_sync(kFull, slot, 0);
    if (busy) rows[slot + __popc(ballot & ((1u << lane) - 1))] = i;
  }
  __syncthreads();
  const int busy_rows = nrows;

  int done = 0;
  bool changed = true;
  for (;;) {
    if (done == max_iters) {
      for (int i = tid; i < n; i += kThreads) labels[i] = valid[i] ? P[i] : i;
      // would one more iteration still change a label?
      const bool more = changed && iterate(nbr, n, k, P, Q, rows, busy_rows);
      if (tid == 0) {
        *iterations = done;
        *unconverged = more ? 1 : 0;
      }
      return;
    }
    changed = iterate(nbr, n, k, P, Q, rows, busy_rows);
    int* swap = P;
    P = Q;
    Q = swap;
    ++done;
    if (!changed) {
      for (int i = tid; i < n; i += kThreads) labels[i] = valid[i] ? P[i] : i;
      if (tid == 0) {
        *iterations = done;
        *unconverged = 0;
      }
      return;
    }
  }
}

int max_shared_nodes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return (optin - kStaticShared) / static_cast<int>(2 * sizeof(int));
}

}  // namespace

extern "C" {

// Plain C launcher for ctypes, on the current device.  Launches one block
// on `stream` (PyTorch's current stream), does not synchronise and
// allocates nothing: `scratch` holds at least 3 N ints, N for the listed
// rows and, where the two label buffers do not fit the block's shared
// memory on this device, 2 N for them; `scratch_ints` says how many it
// holds.  `valid` is N bools (one byte
// each); `labels` receives N int32, `iterations` and `unconverged` one int32
// each.  Returns 0 (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_ccl_exact(const int* nbr, const unsigned char* valid, int n, int k,
                                int max_iters, int* labels, int* iterations, int* unconverged,
                                int* scratch, long long scratch_ints, void* stream) {
  if (n < 0 || k < 0 || max_iters < 0 || scratch == nullptr) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool shared = n <= max_shared_nodes(device);
  if (scratch_ints < 3LL * n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    // the largest buffer any N asks for, set once (the attribute stays with
    // the kernel)
    static const cudaError_t attr = cudaFuncSetAttribute(
        ccl_exact_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_shared_nodes(device) * static_cast<int>(2 * sizeof(int)));
    if (attr != cudaSuccess) return attr;
    ccl_exact_kernel<true><<<1, kThreads, 2 * sizeof(int) * static_cast<size_t>(n), s>>>(
        nbr, valid, n, k, max_iters, labels, iterations, unconverged, scratch, nullptr);
  } else {
    ccl_exact_kernel<false><<<1, kThreads, 0, s>>>(nbr, valid, n, k, max_iters, labels,
                                                   iterations, unconverged, scratch, scratch + n);
  }
  return cudaGetLastError();
}

const char* gapartnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
