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
// What bounds it on this card: the forward's neighbour pairs,
// 2 * pairs * Cin * Cout FLOP, against x, g and nbr read once and dW
// written once.  As 3xTF32 on the tensor cores (495 / 3 TFLOP/s) the
// level-0 shapes are bound by bytes, the deeper ones by operations.
// chip_smoke.py recomputes both from the pairs in the run's data.
//
// Design:
//   * blocks over (row chunk, Cin tile x Cout tile, tap); Cin tiles are 16,
//     32 or 64 channels, Cout tiles 16, 32, 48 or 64; 4 warps.  The GEMM
//     per block is M = Cin tile, N = Cout tile, K = the chunk's rows whose
//     neighbour exists at the tap;
//   * a pass takes kCand candidate rows: every warp ballots its rows, a
//     block prefix sum over (row group, warp) in row order gives each
//     present row its place, and the pass's (x row, g row) pairs land in
//     shared memory.  Rows with nbr = -1 cost one 4-byte index read;
//   * the compacted rows are then gathered kKR at a time through a cp.async
//     ring of kStages buffers, kStages - 1 stages ahead of the math, one
//     wait_group and one barrier per stage; rows past the count are
//     zero-filled (src-size 0).  Copies are 16 bytes where rows allow it,
//     else 4 bytes (Cin 5, 6), chosen per operand by template parameters.
//     A stage's kKR / 8 k-steps are unrolled (zero rows past the count
//     add nothing);
//   * the math is mma.sync m16n8k8 on TF32 with fp32 accumulation, split
//     three ways as in csrc/subm_conv.cu (lo*hi, hi*lo, hi*hi per k-step).
//     A = the gathered x transposed, read from rows padded to a stride of
//     8 or 24 mod 32 floats (no bank conflicts); when the Cin tile has
//     fewer than 4 m16 tiles the warps also split the k-steps, and their
//     partial tiles are added through shared memory in warp order;
//   * the number of row chunks is chosen so that the grid holds about
//     kBlocksPerSM blocks per SM; each chunk writes its partial dW to
//     scratch and a second kernel adds them in chunk order.  No atomics
//     anywhere: two runs give bitwise equal results.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace gapartnet;

constexpr int kTaps = 27;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 16;                    // candidate rows per thread and pass
constexpr int kCand = kPer * kThreads;      // candidate rows per pass
constexpr int kKR = 32;                     // compacted rows per stage
constexpr int kStages = 3;                  // cp.async ring depth
constexpr int kBlocksPerSM = 16;            // row chunks until the grid holds this many

// channel tiles: Cin (the mma M, one m16 tile per warp) 16, 32 or 64;
// Cout (the mma N) 16, 32, 48 or 64
int tile_in(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : 64); }
int tile_out(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : (c <= 48 ? 48 : 64)); }

long long rows_per_chunk(long long total, int chunks) {
  const long long per = (total + chunks - 1) / chunks;
  return ((per + kThreads - 1) / kThreads) * kThreads;
}

// kKR compacted rows (from `first`) of one operand, channels c0 onwards,
// into shared memory; rows past n and channels past C are zero-filled
template <int T, int VEC>
__device__ __forceinline__ void gather_rows(float* s, const float* base, const int* rows, int first,
                                            int n, int c0, int C, int tid) {
  constexpr int S = frag_stride(T);
  constexpr int NV = T / VEC;
  for (int e = tid; e < kKR * NV; e += kThreads) {
    const int r = e / NV;
    const int c = (e % NV) * VEC;
    const bool ok = first + r < n && c0 + c < C;
    cp_async<VEC>(s + r * S + c, ok ? base + static_cast<size_t>(rows[first + r]) * C + c0 + c : base, ok);
  }
}

template <int TI, int TO, int VX, int VG>
__global__ void __launch_bounds__(kThreads)
subm_conv_wgrad_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                       const float* __restrict__ g, float* __restrict__ dst,
                       int B, int V, int Cin, int Cout, long long chunk_rows) {
  constexpr int WM = TI / 16;           // warps along Cin, one m16 tile each
  constexpr int WK = kWarps / WM;       // warps along the rows (k-steps)
  constexpr int NT = TO / 8;
  constexpr int SX = frag_stride(TI);
  constexpr int SG = frag_stride(TO);
  static_assert(WM * WK == kWarps, "the Cin tile must be 16, 32 or 64");
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                                                   // [kStages][kKR][SX]
  float* s_g = s_x + kStages * kKR * SX;                               // [kStages][kKR][SG]
  int* s_src = reinterpret_cast<int*>(s_g + kStages * kKR * SG);       // [kCand] rows of x
  int* s_dst = s_src + kCand;                                          // [kCand] rows of g
  __shared__ int s_cnt[kPer * kWarps];
  __shared__ int s_total;

  const int k = blockIdx.z;
  const int co_tiles = (Cout + TO - 1) / TO;
  const int ci0 = (blockIdx.y / co_tiles) * TI;
  const int co0 = (blockIdx.y % co_tiles) * TO;
  const long long total = static_cast<long long>(B) * V;
  const long long r_begin = static_cast<long long>(blockIdx.x) * chunk_rows;
  const long long r_end = min(total, r_begin + chunk_rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int wk = warp / WM;
  const int gr = lane >> 2;
  const int tg = lane & 3;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  auto load_stage = [&](int st, int n) {
    const int buf = st % kStages;
    gather_rows<TI, VX>(s_x + buf * kKR * SX, x, s_src, st * kKR, n, ci0, Cin, tid);
    gather_rows<TO, VG>(s_g + buf * kKR * SG, g, s_dst, st * kKR, n, co0, Cout, tid);
  };

  for (long long p0 = r_begin; p0 < r_end; p0 += kCand) {
    // compact the pass's rows whose neighbour exists at tap k, in row order:
    // candidate p0 + i * kThreads + tid is number i * kWarps + warp of the
    // 32-row groups
    // (rows are ints: B * V < 2^31; all kPer loads are in flight together)
    int src[kPer];
    int pos[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long r = p0 + i * kThreads + tid;
      src[i] = -1;
      if (r < r_end) {
        const int b = static_cast<int>(r) / V;
        const int v = static_cast<int>(r) - b * V;
        src[i] = __ldg(nbr + (static_cast<size_t>(b) * kTaps + k) * V + v);
        if (src[i] >= 0) src[i] += b * V;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const unsigned ok = __ballot_sync(0xffffffffu, src[i] >= 0);
      pos[i] = __popc(ok & ((1u << lane) - 1u));
      if (lane == 0) s_cnt[i * kWarps + warp] = __popc(ok);
    }
    __syncthreads();
    if (warp == 0) {   // exclusive scan of the 64 group counts, two per lane
      const int c0 = s_cnt[2 * lane], c1 = s_cnt[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const int excl = incl - c0 - c1;
      s_cnt[2 * lane] = excl;
      s_cnt[2 * lane + 1] = excl + c0;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (src[i] >= 0) {
        const int at = s_cnt[i * kWarps + warp] + pos[i];
        s_src[at] = src[i];
        s_dst[at] = static_cast<int>(p0 + i * kThreads + tid);
      }
    }
    __syncthreads();
    const int n = s_total;
    const int stages = (n + kKR - 1) / kKR;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < stages) load_stage(st, n);
      cp_async_commit();
    }
    for (int st = 0; st < stages; ++st) {
      // stage st has landed for every thread, and every thread is done with
      // the buffer that stage st + kStages - 1 now refills
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (st + kStages - 1 < stages) load_stage(st + kStages - 1, n);
      cp_async_commit();

      const float* xs = s_x + (st % kStages) * kKR * SX + wm * 16 + gr;
      const float* gs = s_g + (st % kStages) * kKR * SG + gr;
      // all kKR / 8 k-steps, unrolled: rows past n are zeros
#pragma unroll
      for (int i = 0; i < kKR / 8 / WK; ++i) {
        const int ks = wk + i * WK;
        // A[m][kk] = x row kk, channel m: fragments (m = gr (+8), kk = tg (+4))
        const float* pa = xs + (ks * 8 + tg) * SX;
        uint32_t ah[4], al[4];
        split_tf32(pa[0], ah[0], al[0]);
        split_tf32(pa[8], ah[1], al[1]);
        split_tf32(pa[4 * SX], ah[2], al[2]);
        split_tf32(pa[4 * SX + 8], ah[3], al[3]);
        const float* pb = gs + (ks * 8 + tg) * SG;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh[2], bl[2];
          split_tf32(pb[nt * 8], bh[0], bl[0]);
          split_tf32(pb[4 * SG + nt * 8], bh[1], bl[1]);
          mma_3xtf32(acc[nt], ah, al, bh, bl);
        }
      }
    }
    // the next pass overwrites s_cnt, s_total and the row lists
    cp_async_wait<0>();
    __syncthreads();
  }

  // add the k-step warps' tiles in warp order, then write this chunk's tile
  float* s_red = smem;   // [WK][TI][TO], over the drained ring
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = s_red + (wk * TI + wm * 16 + gr) * TO + nt * 8 + 2 * tg;
    p[0] = acc[nt][0];
    p[1] = acc[nt][1];
    p[8 * TO] = acc[nt][2];
    p[8 * TO + 1] = acc[nt][3];
  }
  __syncthreads();
  float* out = dst + (static_cast<size_t>(blockIdx.x) * kTaps + k) * Cin * Cout;
  for (int e = tid; e < TI * TO; e += kThreads) {
    const int ci = ci0 + e / TO;
    const int co = co0 + e % TO;
    if (ci >= Cin || co >= Cout) continue;
    float s = s_red[e];
#pragma unroll
    for (int q = 1; q < WK; ++q) s += s_red[q * TI * TO + e];
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

template <int TI, int TO, int VX, int VG>
cudaError_t launch(const float* x, const int* nbr, const float* g, float* dst,
                   int B, int V, int Cin, int Cout, int chunks, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kStages * kKR * (frag_stride(TI) + frag_stride(TO)) +
                          sizeof(int) * 2 * kCand;
  static_assert(smem >= sizeof(float) * kThreads / 32 * 16 * TO, "the warp sums fit the ring");
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_wgrad_kernel<TI, TO, VX, VG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long rows = rows_per_chunk(static_cast<long long>(B) * V, chunks);
  dim3 grid(chunks, ((Cin + TI - 1) / TI) * ((Cout + TO - 1) / TO), kTaps);
  subm_conv_wgrad_kernel<TI, TO, VX, VG><<<grid, kThreads, smem, stream>>>(
      x, nbr, g, dst, B, V, Cin, Cout, rows);
  return cudaGetLastError();
}

template <int TI, int VX, int VG>
cudaError_t launch_ti(const float* x, const int* nbr, const float* g, float* dst,
                      int B, int V, int Cin, int Cout, int chunks, cudaStream_t s) {
  switch (tile_out(Cout)) {
    case 16: return launch<TI, 16, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 32: return launch<TI, 32, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 48: return launch<TI, 48, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    default: return launch<TI, 64, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
  }
}

template <int VX, int VG>
cudaError_t launch_vec(const float* x, const int* nbr, const float* g, float* dst,
                       int B, int V, int Cin, int Cout, int chunks, cudaStream_t s) {
  switch (tile_in(Cin)) {
    case 16: return launch_ti<16, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 32: return launch_ti<32, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    default: return launch_ti<64, VX, VG>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
  }
}

}  // namespace

extern "C" {

// Number of row chunks the launcher uses for this shape on a card with
// `sms` SMs (1 = no scratch).  The caller allocates a scratch buffer of
// chunks * 27 * Cin * Cout floats when it is above 1.  Pure: no CUDA call.
int gapartnet_subm_conv_wgrad_chunks(int B, int V, int Cin, int Cout, int sms) {
  if (B <= 0 || V <= 0 || Cin <= 0 || Cout <= 0 || sms <= 0) return 1;
  const int ti = tile_in(Cin);
  const int to = tile_out(Cout);
  const long long base =
      static_cast<long long>(kTaps) * ((Cin + ti - 1) / ti) * ((Cout + to - 1) / to);
  const long long target = static_cast<long long>(kBlocksPerSM) * sms;
  const long long total = static_cast<long long>(B) * V;
  long long want = (target + base - 1) / base;
  const long long most = (total + kThreads - 1) / kThreads;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const long long per = rows_per_chunk(total, static_cast<int>(want));
  return static_cast<int>((total + per - 1) / per);   // no empty chunk
}

// Plain C launcher for ctypes, on the current device.  Launches on
// `stream` (PyTorch's current stream), does not synchronise and allocates
// nothing: `partial` is the caller's scratch for `chunks` > 1.
// Returns 0 (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_subm_conv_wgrad(const float* x, const int* nbr, const float* g,
                                      float* dw, float* partial, int B, int V, int Cin,
                                      int Cout, int chunks, void* stream) {
  if (Cin <= 0 || Cout <= 0) return cudaSuccess;
  if (B <= 0 || V <= 0 || chunks < 1 || (chunks > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = chunks > 1 ? partial : dw;
  // 16-byte copies need 16-byte rows and a 16-byte aligned base; g's rows
  // take them whenever they can (x's too, if g's can)
  const bool wide_g = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool wide_x = wide_g && Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err = wide_x   ? launch_vec<4, 4>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s)
                    : wide_g ? launch_vec<1, 4>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s)
                             : launch_vec<1, 1>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = static_cast<size_t>(kTaps) * Cin * Cout;
  const int threads = 256;
  const size_t need = (n + threads - 1) / threads;
  const int blocks = need > 4096 ? 4096 : static_cast<int>(need);
  sum_chunks_kernel<<<blocks, threads, 0, s>>>(partial, dw, n, chunks);
  return cudaGetLastError();
}

}  // extern "C"
