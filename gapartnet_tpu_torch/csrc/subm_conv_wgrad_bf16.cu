// Submanifold 3x3x3 sparse convolution on bf16 operands, weight gradient,
// for NVIDIA Hopper (sm_90a).
//
// The bf16 twin of csrc/subm_conv_wgrad.cu (which replaces the weight half
// of the TPU kernel's custom VJP, gapartnet_tpu/ops/pallas_conv.py:105-111).
// The numerics it must reproduce are those of the JAX package's bf16 VJP,
// gapartnet_tpu/ops/sparse_conv.py:289 and :297-316:
//
//   dW[k, ci, co] = bf16( sum_b sum_v  x[b, nbr[b, k, v], ci] * g[b, v, co] )
//                   (no term where nbr = -1)
//
// x (B, V, ldx) bf16 (the features rounded to bf16) and g (B, V, ldg) bf16
// (the output gradient rounded to bf16) are copies the wrapper writes, rows
// padded with zeros to ldx = Cin and ldg = Cout rounded up to 8; dW
// (27, Cin, Cout) f32 holds the fp32 sums rounded to bf16, as the JAX VJP's
// `.astype(bfloat16)`.
//
// What bounds it on this card: the forward's neighbour pairs,
// 2 * pairs * Cin * Cout FLOP at the bf16 dense tensor-core rate (989
// TFLOP/s), against x, g and nbr read once and dW written once: bytes at
// every level of the flagship.  chip_smoke.py recomputes both from the
// pairs in the run's data.
//
// Design: that of csrc/subm_conv_wgrad.cu with bf16 operands:
//   * blocks over (row chunk, Cin tile x Cout tile, tap); Cin tiles 16, 32
//     or 64, Cout tiles 16, 32, 48 or 64; 4 warps.  The GEMM per block is
//     M = Cin tile, N = Cout tile, K = the chunk's rows whose neighbour
//     exists at the tap;
//   * a pass takes kCand candidate rows: every warp ballots its rows, a
//     block prefix sum in row order gives each present row its place, and
//     the pass's (x row, g row) pairs land in shared memory;
//   * the compacted rows are gathered kKR at a time (16-byte cp.async,
//     zero-fill past the count and past ld) through a ring of kStages
//     buffers, kStages - 1 stages ahead of the math;
//   * the math is mma.sync m16n8k16 (bf16 in, fp32 accumulation).  Both
//     operands are stored row by row (rows = the GEMM's K), so their
//     fragments are read by ldmatrix .trans from shared rows of T + 8 bf16
//     (no bank conflicts).  When the Cin tile has fewer than 4 m16 tiles
//     the warps also split the k-steps, and their partial tiles are added
//     through shared memory in warp order;
//   * the number of row chunks is chosen so that the grid holds about
//     kBlocksPerSM blocks per SM; each chunk writes its fp32 partial dW to
//     scratch and a second kernel adds them in chunk order and rounds (one
//     chunk rounds in place).  No atomics: two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace gapartnet;
typedef __nv_bfloat16 bf16;

constexpr int kTaps = 27;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 16;                    // candidate rows per thread and pass
constexpr int kCand = kPer * kThreads;      // candidate rows per pass
constexpr int kKR = 64;                     // compacted rows per stage (4 k-steps)
constexpr int kStages = 3;                  // cp.async ring depth
constexpr int kBlocksPerSM = 16;            // row chunks until the grid holds this many

// channel tiles: Cin (the mma M, one m16 tile per warp) 16, 32 or 64;
// Cout (the mma N) 16, 32, 48 or 64
int tile_in(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : 64); }
int tile_out(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : (c <= 48 ? 48 : 64)); }

__host__ __device__ constexpr int padded(int c) { return (c + 7) / 8 * 8; }

long long rows_per_chunk(long long total, int chunks) {
  const long long per = (total + chunks - 1) / chunks;
  return ((per + kThreads - 1) / kThreads) * kThreads;
}

// kKR compacted rows (from `first`) of one operand, channels c0 onwards,
// into shared rows of T + 8; rows past n and pieces past ld are zero-filled
template <int T>
__device__ __forceinline__ void gather_rows(bf16* s, const bf16* base, const int* rows, int first,
                                            int n, int c0, int ld, int tid) {
  constexpr int S = T + 8;
  constexpr int NV = T / 8;
  for (int e = tid; e < kKR * NV; e += kThreads) {
    const int r = e / NV;
    const int c = (e % NV) * 8;
    const bool ok = first + r < n && c0 + c < ld;
    cp_async16(s + r * S + c, ok ? base + static_cast<size_t>(rows[first + r]) * ld + c0 + c : base,
               ok);
  }
}

template <int TI, int TO>
__global__ void __launch_bounds__(kThreads)
subm_conv_wgrad_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                            const bf16* __restrict__ g, float* __restrict__ dst,
                            int B, int V, int Cin, int Cout, long long chunk_rows, int round_out) {
  constexpr int WM = TI / 16;           // warps along Cin, one m16 tile each
  constexpr int WK = kWarps / WM;       // warps along the rows (k-steps)
  constexpr int NT = TO / 8;
  constexpr int SX = TI + 8;
  constexpr int SG = TO + 8;
  constexpr int KSTEPS = kKR / 16;
  static_assert(WM * WK == kWarps && KSTEPS % WK == 0, "the Cin tile must be 16, 32 or 64");
  static_assert(NT % 2 == 0, "B fragments are loaded two n-tiles at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);                              // [kStages][kKR][SX]
  bf16* s_g = s_x + kStages * kKR * SX;                                   // [kStages][kKR][SG]
  int* s_src = reinterpret_cast<int*>(s_g + kStages * kKR * SG);          // [kCand] rows of x
  int* s_dst = s_src + kCand;                                             // [kCand] rows of g
  __shared__ int s_cnt[kPer * kWarps];
  __shared__ int s_total;

  const int ldx = padded(Cin);
  const int ldg = padded(Cout);
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
    gather_rows<TI>(s_x + buf * kKR * SX, x, s_src, st * kKR, n, ci0, ldx, tid);
    gather_rows<TO>(s_g + buf * kKR * SG, g, s_dst, st * kKR, n, co0, ldg, tid);
  };

  for (long long p0 = r_begin; p0 < r_end; p0 += kCand) {
    // compact the pass's rows whose neighbour exists at tap k, in row order:
    // candidate p0 + i * kThreads + tid is number i * kWarps + warp of the
    // 32-row groups (rows are ints: B * V < 2^31; all kPer loads in flight)
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

      const bf16* xs = s_x + (st % kStages) * kKR * SX;
      const bf16* gs = s_g + (st % kStages) * kKR * SG;
      // this warp's k-steps of the stage, unrolled: rows past n are zeros
#pragma unroll
      for (int i = 0; i < KSTEPS / WK; ++i) {
        const int ks = wk + i * WK;
        // A[m = ci][kk = row] from rows kk: lanes 0-7 give rows 0-7 at
        // channel 0, 8-15 rows 0-7 at channel 8, 16-23 rows 8-15 at 0,
        // 24-31 rows 8-15 at 8, each block transposed
        uint32_t af[4];
        ldmatrix_x4_trans(af, xs + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * SX + wm * 16 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          // B[kk = row][n = co] for n-tiles nt (lanes 0-15: rows 0-15) and
          // nt + 1 (lanes 16-31), transposed
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, gs + (ks * 16 + (lane & 15)) * SG + (nt + (lane >> 4)) * 8);
          const uint32_t b0[2] = {bq[0], bq[1]};
          const uint32_t b1[2] = {bq[2], bq[3]};
          mma_bf16(acc[nt], af, b0);
          mma_bf16(acc[nt + 1], af, b1);
        }
      }
    }
    // the next pass overwrites s_cnt, s_total and the row lists
    cp_async_wait<0>();
    __syncthreads();
  }

  // add the k-step warps' tiles in warp order, then write this chunk's tile
  float* s_red = reinterpret_cast<float*>(smem);   // [WK][TI][TO], over the drained ring
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = s_red + (wk * TI + wm * 16 + gr) * TO + nt * 8 + 2 * tg;
    p[0] = acc[nt][0];
    p[1] = acc[nt][1];
    p[8 * TO] = acc[nt][2];
    p[8 * TO + 1] = acc[nt][3];
  }
  __syncthreads();
  const bool rnd = round_out != 0;
  float* out = dst + (static_cast<size_t>(blockIdx.x) * kTaps + k) * Cin * Cout;
  for (int e = tid; e < TI * TO; e += kThreads) {
    const int ci = ci0 + e / TO;
    const int co = co0 + e % TO;
    if (ci >= Cin || co >= Cout) continue;
    float s = s_red[e];
#pragma unroll
    for (int q = 1; q < WK; ++q) s += s_red[q * TI * TO + e];
    out[static_cast<size_t>(ci) * Cout + co] = round_bf16(s, rnd);
  }
}

// out[i] = bf16(sum over chunks c of partial[c][i]), in chunk order
__global__ void sum_chunks_bf16_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, size_t n, int chunks) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int c = 1; c < chunks; ++c) acc += partial[static_cast<size_t>(c) * n + i];
    out[i] = round_bf16(acc, true);
  }
}

template <int TI, int TO>
cudaError_t launch(const bf16* x, const int* nbr, const bf16* g, float* dst,
                   int B, int V, int Cin, int Cout, int chunks, cudaStream_t stream) {
  constexpr size_t ring = sizeof(bf16) * kStages * kKR * ((TI + 8) + (TO + 8));
  constexpr size_t smem = ring + sizeof(int) * 2 * kCand;
  static_assert(ring >= sizeof(float) * kWarps * 16 * TO, "the warp sums fit the ring");
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_wgrad_bf16_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long rows = rows_per_chunk(static_cast<long long>(B) * V, chunks);
  dim3 grid(chunks, ((Cin + TI - 1) / TI) * ((Cout + TO - 1) / TO), kTaps);
  subm_conv_wgrad_bf16_kernel<TI, TO><<<grid, kThreads, smem, stream>>>(
      x, nbr, g, dst, B, V, Cin, Cout, rows, chunks == 1);
  return cudaGetLastError();
}

template <int TI>
cudaError_t launch_ti(const bf16* x, const int* nbr, const bf16* g, float* dst,
                      int B, int V, int Cin, int Cout, int chunks, cudaStream_t s) {
  switch (tile_out(Cout)) {
    case 16: return launch<TI, 16>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 32: return launch<TI, 32>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    case 48: return launch<TI, 48>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
    default: return launch<TI, 64>(x, nbr, g, dst, B, V, Cin, Cout, chunks, s);
  }
}

}  // namespace

extern "C" {

// Number of row chunks the launcher uses for this shape on a card with
// `sms` SMs (1 = no scratch).  The caller allocates a scratch buffer of
// chunks * 27 * Cin * Cout floats when it is above 1.  Pure: no CUDA call.
int gapartnet_subm_conv_wgrad_bf16_chunks(int B, int V, int Cin, int Cout, int sms) {
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

// Plain C launcher for ctypes, on the current device.  `x` (B, V, ldx) and
// `g` (B, V, ldg) are bf16 with rows padded with zeros to Cin and Cout
// rounded up to 8, both 16-byte aligned; `dw` (27, Cin, Cout) f32 receives
// the sums rounded to bf16.  Launches on `stream` (PyTorch's current
// stream), does not synchronise and allocates nothing: `partial` is the
// caller's scratch for `chunks` > 1.  Returns 0 (cudaSuccess) or the CUDA
// error code.
cudaError_t gapartnet_subm_conv_wgrad_bf16(const void* x, const int* nbr, const void* g,
                                           float* dw, float* partial, int B, int V, int Cin,
                                           int Cout, int chunks, void* stream) {
  if (Cin <= 0 || Cout <= 0) return cudaSuccess;
  if (B <= 0 || V <= 0 || chunks < 1 || (chunks > 1 && partial == nullptr) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  float* dst = chunks > 1 ? partial : dw;
  cudaError_t err;
  switch (tile_in(Cin)) {
    case 16: err = launch_ti<16>(xb, nbr, gb, dst, B, V, Cin, Cout, chunks, s); break;
    case 32: err = launch_ti<32>(xb, nbr, gb, dst, B, V, Cin, Cout, chunks, s); break;
    default: err = launch_ti<64>(xb, nbr, gb, dst, B, V, Cin, Cout, chunks, s); break;
  }
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = static_cast<size_t>(kTaps) * Cin * Cout;
  const int threads = 256;
  const size_t need = (n + threads - 1) / threads;
  const int blocks = need > 4096 ? 4096 : static_cast<int>(need);
  sum_chunks_bf16_kernel<<<blocks, threads, 0, s>>>(partial, dw, n, chunks);
  return cudaGetLastError();
}

}  // extern "C"
