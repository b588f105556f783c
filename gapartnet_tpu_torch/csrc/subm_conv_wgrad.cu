// Submanifold 3x3x3 sparse convolution, weight gradient, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the weight half of the TPU kernel's custom VJP:
// gapartnet_tpu/ops/pallas_conv.py:105-111 (`dw_one` in `_bwd`, an XLA
// gather + einsum beside the Pallas dgrad of :95-103).  The numerics it must
// reproduce are those of gapartnet_tpu/ops/sparse_conv.py:297-316:
//
//   dW[k, ci, co] = sum_b sum_v  x[b, nbr[b, k, v], ci] * g[b, v, co]
//                   (no term where nbr = -1)
//
// x (B, V, Cin) f32, nbr (B, 27, V) int32, g (B, V, Cout) f32,
// dW (27, Cin, Cout) f32, fp32 accumulation.
//
// What bounds it on this card: the same neighbour pairs as the forward,
// 2 * pairs * Cin * Cout FLOP, against x, g and nbr read once and dW
// written once.  At the level-0 16->16 shape (B = 8, V = 20000) that is
// about 0.3 GFLOP against 12 MB, so with fp32 FMA on CUDA cores it is
// compute-bound at 67 TFLOP/s.  chip_smoke.py recomputes the bound from the
// pairs that exist in the run's data.
//
// Design (simple, correct and deterministic first):
//   * blocks over (V-chunk, Cin tile x Cout tile, tap); tiles are 16, 32 or
//     64 channels wide; 256 threads, each owning a 4 x 4 register tile of
//     dW; when the tile has fewer than 256 / 16 * 16 outputs, the threads
//     split into row groups that each take every kRG-th row;
//   * a block walks its (b, v) rows 32 at a time: one warp reads the 32
//     neighbour indices of its tap, compacts the rows whose neighbour exists
//     (ballot + popc, in row order), and the block gathers those rows of x
//     and g into shared memory; rows with nbr = -1 cost nothing further;
//   * each thread accumulates its rows in a fixed order; the row groups are
//     summed through shared memory in group order, and each V-chunk writes
//     its partial dW to scratch, which a second kernel sums in chunk order.
//     No atomics anywhere, so two runs give bitwise equal results;
//   * the number of V-chunks is chosen so that the grid holds about four
//     blocks per SM, as the forward's tap split does.
// What a later change would do: tensor cores (TF32 or bf16 mma / wgmma) on
// the gathered tiles, cp.async double buffering, and one launch for all the
// convs of a level that share a rulebook.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 27;
constexpr int kThreads = 256;
constexpr int kRows = 32;         // candidate rows per stage: one warp's ballot
constexpr int kBlocksPerSM = 4;   // V-chunks until the grid holds this many

int tile_width(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : 64); }

long long rows_per_chunk(long long total, int chunks) {
  const long long per = (total + chunks - 1) / chunks;
  return ((per + kRows - 1) / kRows) * kRows;
}

template <int TI, int TO>
__global__ void __launch_bounds__(kThreads)
subm_conv_wgrad_kernel(const float* __restrict__ x,
                       const int* __restrict__ nbr,
                       const float* __restrict__ g,
                       float* __restrict__ dst,
                       int B, int V, int Cin, int Cout, long long chunk_rows) {
  constexpr int kTXI = TI / 4;                 // threads along Cin
  constexpr int kTXO = TO / 4;                 // threads along Cout
  constexpr int kGroup = kTXI * kTXO;          // threads per row group
  constexpr int kRG = kThreads / kGroup;       // row groups
  static_assert(kRG >= 1 && kRG * kGroup == kThreads, "tile does not fit the block");
  __shared__ int s_src[kRows];                 // row of x: b * V + nbr
  __shared__ int s_dst[kRows];                 // row of g: b * V + v
  __shared__ int s_n;
  __shared__ float s_x[kRows][TI];
  __shared__ float s_g[kRows][TO];
  __shared__ float s_red[kRG][TI * TO];

  const int k = blockIdx.z;
  const int co_tiles = (Cout + TO - 1) / TO;
  const int ci0 = (blockIdx.y / co_tiles) * TI;
  const int co0 = (blockIdx.y % co_tiles) * TO;
  const long long total = static_cast<long long>(B) * V;
  const long long r_begin = static_cast<long long>(blockIdx.x) * chunk_rows;
  const long long r_end = min(total, r_begin + chunk_rows);
  const int tid = threadIdx.x;
  const int rg = tid / kGroup;
  const int ti = (tid % kGroup) / kTXO;
  const int to = (tid % kGroup) % kTXO;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (tid < 32) {
      const long long r = r0 + tid;
      int src = -1;
      if (r < r_end) {
        const int b = static_cast<int>(r / V);
        const int v = static_cast<int>(r - static_cast<long long>(b) * V);
        const int s = nbr[(static_cast<size_t>(b) * kTaps + k) * V + v];
        src = s >= 0 ? b * V + s : -1;
      }
      const unsigned ok = __ballot_sync(0xffffffffu, src >= 0);
      if (src >= 0) {
        const int pos = __popc(ok & ((1u << tid) - 1u));
        s_src[pos] = src;
        s_dst[pos] = static_cast<int>(r);
      }
      if (tid == 0) s_n = __popc(ok);
    }
    __syncthreads();
    const int n = s_n;   // the same for every thread: the branch is uniform
    if (n > 0) {
      for (int e = tid; e < n * TI; e += kThreads) {
        const int i = e / TI;
        const int ci = ci0 + e % TI;
        s_x[i][e % TI] = ci < Cin ? x[static_cast<size_t>(s_src[i]) * Cin + ci] : 0.f;
      }
      for (int e = tid; e < n * TO; e += kThreads) {
        const int i = e / TO;
        const int co = co0 + e % TO;
        s_g[i][e % TO] = co < Cout ? g[static_cast<size_t>(s_dst[i]) * Cout + co] : 0.f;
      }
      __syncthreads();
      for (int i = rg; i < n; i += kRG) {
        float xv[4];
        float gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = s_x[i][ti + kTXI * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) gv[c] = s_g[i][to + kTXO * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xv[a], gv[c], acc[a][c]);
      }
    }
    // the next stage overwrites s_n, the row lists and the tiles
    __syncthreads();
  }

  // sum the row groups in group order, then write this chunk's tile
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s_red[rg][(ti + kTXI * a) * TO + to + kTXO * c] = acc[a][c];
  __syncthreads();
  float* out = dst + (static_cast<size_t>(blockIdx.x) * kTaps + k) * Cin * Cout;
  for (int e = tid; e < TI * TO; e += kThreads) {
    const int ci = ci0 + e / TO;
    const int co = co0 + e % TO;
    if (ci >= Cin || co >= Cout) continue;
    float s = s_red[0][e];
    for (int q = 1; q < kRG; ++q) s += s_red[q][e];
    out[static_cast<size_t>(ci) * Cout + co] = s;
  }
}

// out[i] = sum over chunks c of partial[c][i], in chunk order
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t n, int chunks) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int c = 1; c < chunks; ++c) acc += partial[static_cast<size_t>(c) * n + i];
    out[i] = acc;
  }
}

template <int TI, int TO>
cudaError_t launch(const float* x, const int* nbr, const float* g, float* dst,
                   int B, int V, int Cin, int Cout, int chunks, cudaStream_t stream) {
  const long long rows = rows_per_chunk(static_cast<long long>(B) * V, chunks);
  dim3 grid(chunks, ((Cin + TI - 1) / TI) * ((Cout + TO - 1) / TO), kTaps);
  subm_conv_wgrad_kernel<TI, TO><<<grid, kThreads, 0, stream>>>(
      x, nbr, g, dst, B, V, Cin, Cout, rows);
  return cudaGetLastError();
}

template <int TI>
cudaError_t launch_ti(const float* x, const int* nbr, const float* g, float* dst,
                      int B, int V, int Cin, int Cout, int chunks, cudaStream_t s) {
  switch (tile_width(Cout)) {
    case 16: return launch<TI, 16>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 32: return launch<TI, 32>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    default: return launch<TI, 64>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
  }
}

}  // namespace

extern "C" {

// Number of V-chunks the launcher uses for this shape (1 = no scratch).
// The caller allocates a scratch buffer of chunks * 27 * Cin * Cout floats
// when it is above 1.
int gapartnet_subm_conv_wgrad_chunks(int B, int V, int Cin, int Cout, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (B <= 0 || V <= 0 || Cin <= 0 || Cout <= 0) return 1;
  const int ti = tile_width(Cin);
  const int to = tile_width(Cout);
  const long long base =
      static_cast<long long>(kTaps) * ((Cin + ti - 1) / ti) * ((Cout + to - 1) / to);
  const long long target = static_cast<long long>(kBlocksPerSM) * sms;
  const long long total = static_cast<long long>(B) * V;
  long long want = (target + base - 1) / base;
  const long long most = (total + kRows - 1) / kRows;   // at least one stage each
  if (want > most) want = most;
  if (want < 1) want = 1;
  // no empty chunk
  return static_cast<int>((total + rows_per_chunk(total, static_cast<int>(want)) - 1) /
                          rows_per_chunk(total, static_cast<int>(want)));
}

// Plain C launcher for ctypes.  Launches on `stream` (PyTorch's current
// stream), does not synchronise and allocates nothing: `partial` is the
// caller's scratch for `chunks` > 1 (see gapartnet_subm_conv_wgrad_chunks).
// Returns the launch status: 0 (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_subm_conv_wgrad(const float* x, const int* nbr, const float* g,
                                      float* dw, float* partial, int B, int V, int Cin,
                                      int Cout, int chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Cin <= 0 || Cout <= 0) return cudaSuccess;
  if (B <= 0 || V <= 0 || chunks < 1 || (chunks > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = chunks > 1 ? partial : dw;
  switch (tile_width(Cin)) {
    case 16: err = launch_ti<16>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s); break;
    case 32: err = launch_ti<32>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s); break;
    default: err = launch_ti<64>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s); break;
  }
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = static_cast<size_t>(kTaps) * Cin * Cout;
  const int threads = 256;
  const size_t need = (n + threads - 1) / threads;
  const int blocks = need > 4096 ? 4096 : static_cast<int>(need);
  sum_chunks_kernel<<<blocks, threads, 0, s>>>(partial, dw, n, chunks);
  return cudaGetLastError();
}

}  // extern "C"
