// Submanifold 3x3x3 sparse convolution on bf16 operands, weight gradient,
// for NVIDIA Hopper (sm_90a): wgmma from shared memory, bf16 rounding
// inside the kernel, no operand copies.
//
// The bf16 twin of csrc/subm_conv_wgrad.cu, which replaces the weight half
// of the TPU kernel's custom VJP (gapartnet_tpu/ops/pallas_conv.py:105-111).
// The numerics it must reproduce are those of the JAX package's bf16 VJP
// (gapartnet_tpu/ops/sparse_conv.py:250-318, the weight gradient at :297-316):
//
//   dW[k, ci, co] = bf16( sum_b sum_v  bf16(x[b, nbr[b, k, v], ci]) * bf16(g[b, v, co]) )
//                   (no term where nbr = -1)
//
// x (B, V, Cin) and g (B, V, Cout) are fp32 (or bf16) as the network holds
// them, any width and alignment; they are rounded to bf16 (to nearest, ties
// to even) on their way into the operand buffers.  dW (27, Cin, Cout) f32
// holds the fp32 sums rounded to bf16, as the JAX VJP's `.astype(bfloat16)`.
//
// What bounds it on this card: the forward's neighbour pairs, 2 * pairs *
// Cin * Cout FLOP at the bf16 dense tensor-core rate (989 TFLOP/s), against
// x, g and nbr read once and dW written once: bytes at every level of the
// flagship (chip_smoke.py recomputes both from the run's pairs).  In
// practice each present pair gathers an x row and a g row as 16-byte
// asynchronous copies, and that request traffic binds, as in the forward
// (csrc/subm_conv_bf16.cu); the rows are read in fp32 as the network holds
// them, so that the wrapper writes no copy.
//
// Design:
//   * blocks over (row chunk, 64-channel Cin tile x N tile, tap): one
//     warpgroup (128 threads) computes M = 64 input channels (one wgmma M;
//     channels past Cin are zero rows, never copied), N = the N tile (at
//     most 256, one wgmma N, every flagship width in one), K = the chunk's
//     rows whose neighbour exists at the tap;
//   * a pass takes 2048 candidate rows: the neighbour indices are read all
//     at once (branch-free), every warp ballots its rows, a block prefix sum
//     in row order gives each present row its place, and the pass's (x row,
//     g row) pairs land in shared memory.  Absent pairs cost one index read
//     and no product: at level 0 about 84% of the (tap, row) slots are
//     empty;
//   * the compacted pairs are gathered 32 at a time (two k-steps) through a
//     3-stage fp32 staging ring by cp.async, two stages ahead; each thread
//     copies and then converts only its own 8-float segments (pair t % 32,
//     channels 8 (t / 32) + 32 i ..), after waiting for its own copies, into
//     bf16 MN-major core matrices (A: M = ci, K = pair; B: K = pair, N = co;
//     wgmma's transposed operands); one barrier per stage;
//   * wgmma.mma_async m64nNk16 (trans bits 1), accumulators in registers
//     over all passes; wgmma.wait_group 1 keeps one stage in flight;
//   * the row chunks are the wrapper's (about 16 blocks per SM, at least
//     512 rows each); each chunk writes its fp32 partial dW to scratch and a
//     second kernel adds them in chunk order and rounds (one chunk rounds in
//     place).  No atomics: two runs are bitwise equal.
// The launch plan (N tile, chunks, rows per chunk, shared bytes) is the
// wrapper's (ops/subm_conv.bf16_wgrad_plan) and checked here.  A flattened
// design that stacked taps in M and read g once per row lost on the card at
// the sparse levels (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using namespace gapartnet;

constexpr int kTaps = 27;
constexpr int kThreads = 128;               // one warpgroup
constexpr int kPer = 16;                    // candidate rows per thread and pass
constexpr int kCand = kPer * kThreads;      // candidate rows per pass
constexpr int kKR = 32;                     // compacted rows (the GEMM's K) per stage: 2 k-steps
constexpr int kStages = 3;                  // fp32 staging ring: 2 stages' gathers in flight
constexpr int kTI = 64;                     // input channels per block: one wgmma M
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int smem_bytes(int nt) {
  // bf16 operands (2 buffers of A 64 x kKR and B nt x kKR), fp32 staging
  // (kStages of both), the pass's compacted row lists
  return 2 * (kTI + nt) * kKR * 2 + kStages * (kTI + nt) * kKR * 4 + 2 * kCand * 4;
}

struct Args {
  const void* x;
  const int* nbr;
  const void* g;
  float* dst;
  int B, V, Cin, Cout;
  long long chunk_rows;
  int x_bf16, x_vec, g_bf16, g_vec, round_out;
};

template <int NT>
__global__ void __launch_bounds__(kThreads) subm_conv_wgrad_bf16_wgmma_kernel(const Args a) {
  constexpr int SBO = kKR * 16;           // bytes between 8-wide groups of ci (A) or co (B)
  constexpr int BSEG = kKR * NT / 8;      // B segments of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_cnt[kPer * 4];
  __shared__ int s_total;
  unsigned char* op_a = smem;                                          // [2][64 x kKR] bf16
  unsigned char* op_b = op_a + 2 * kTI * kKR * 2;                      // [2][NT x kKR] bf16
  float* stg = reinterpret_cast<float*>(op_b + 2 * NT * kKR * 2);      // [kStages][64 + NT][kKR][..]
  int* s_src = reinterpret_cast<int*>(stg + kStages * (kTI + NT) * kKR);   // [kCand] rows of x
  int* s_dst = s_src + kCand;                                          // [kCand] rows of g

  const int V = a.V, Cin = a.Cin, Cout = a.Cout;
  const int k = blockIdx.z;
  const int ntiles = (Cout + NT - 1) / NT;
  const int ci0 = (blockIdx.y / ntiles) * kTI;
  const int c0 = (blockIdx.y % ntiles) * NT;
  const long long total = static_cast<long long>(a.B) * V;
  const long long r_begin = static_cast<long long>(blockIdx.x) * a.chunk_rows;
  const long long r_end = min(total, r_begin + a.chunk_rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int pr = tid % kKR;               // the stage row (pair) of all this thread's segments
  const bool xb = a.x_bf16 != 0, gb = a.g_bf16 != 0;
  const float* xf = static_cast<const float*>(a.x);
  const float* gf = static_cast<const float*>(a.g);

  // A rows ci >= Cin stay zero: both operand buffers start zeroed
  for (int e = tid; e < 2 * kTI * kKR / 8; e += kThreads)
    reinterpret_cast<uint4*>(op_a)[e] = make_uint4(0u, 0u, 0u, 0u);

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  int done = 0;   // stages issued to the tensor cores so far (operand buffer parity)

  for (long long p0 = r_begin; p0 < r_end; p0 += kCand) {
    // compact the pass's rows whose neighbour exists at tap k, in row order:
    // candidate p0 + i * kThreads + tid is number i * 4 + warp of the
    // 32-row groups (rows are ints: B * V < 2^31; all kPer loads in flight)
    int src[kPer];
    int pos[kPer];
    {
      int r = static_cast<int>(p0) + tid;
      int b = r / V, v = r - b * V;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool in = r < r_end;
        src[i] = __ldg(a.nbr + (static_cast<size_t>(in ? b : 0) * kTaps + k) * V + (in ? v : 0));
        src[i] = in && src[i] >= 0 ? src[i] + b * V : -1;
        r += kThreads;
        v += kThreads;
        while (v >= V) { v -= V; ++b; }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const unsigned ok = __ballot_sync(0xffffffffu, src[i] >= 0);
      pos[i] = __popc(ok & ((1u << lane) - 1u));
      if (lane == 0) s_cnt[i * 4 + warp] = __popc(ok);
    }
    __syncthreads();
    if (warp == 0) {   // exclusive scan of the 64 group counts, two per lane
      const int q0 = s_cnt[2 * lane], q1 = s_cnt[2 * lane + 1];
      int incl = q0 + q1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const int excl = incl - q0 - q1;
      s_cnt[2 * lane] = excl;
      s_cnt[2 * lane + 1] = excl + q0;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (src[i] >= 0) {
        const int at = s_cnt[i * 4 + warp] + pos[i];
        s_src[at] = src[i];
        s_dst[at] = static_cast<int>(p0 + i * kThreads + tid);
      }
    }
    __syncthreads();
    const int n = s_total;
    const int stages = (n + kKR - 1) / kKR;

    // each thread copies, and later converts, only its own segments: A
    // segment e = tid + 128 i is pair e % 32, channels ci0 + 8 (e / 32) ..
    // of its x row; B segment e is pair e % 32, channels c0 + 8 (e / 32) ..
    // of its g row; absent pairs (past n) and channels are zero-filled
    auto issue = [&](int st) {
      const int buf = st % kStages;
      float* sa = stg + buf * (kTI + NT) * kKR;
      const int p = st * kKR + pr;
      const bool live = p < n;
      if (!xb) {
#pragma unroll
        for (int i = 0; i < kTI * kKR / 8 / kThreads; ++i) {
          const int cg = (tid + i * kThreads) / kKR;
          const int ci = ci0 + 8 * cg;
          if (ci >= Cin) continue;   // A rows past Cin stay zero
          float* dst = sa + (cg * kKR + pr) * 8;
          const int valid = live ? min(8, Cin - ci) : 0;
          const float* row = xf + static_cast<size_t>(live ? s_src[p] : 0) * Cin + ci;
          if (valid == 8 && a.x_vec) {
            cp_async_f32<4>(dst, row, true);
            cp_async_f32<4>(dst + 4, row + 4, true);
          } else {
            for (int q = 0; q < 8; ++q) cp_async_f32<1>(dst + q, q < valid ? row + q : xf, q < valid);
          }
        }
      }
      if (!gb) {
        for (int e = tid; e < BSEG; e += kThreads) {
          const int co = c0 + 8 * (e / kKR);
          float* dst = sa + kTI * kKR + e * 8;
          const int valid = live ? min(8, Cout - co) : 0;
          const float* row = gf + static_cast<size_t>(live ? s_dst[p] : 0) * Cout + co;
          if (valid == 8 && a.g_vec) {
            cp_async_f32<4>(dst, row, true);
            cp_async_f32<4>(dst + 4, row + 4, true);
          } else {
            for (int q = 0; q < 8; ++q) cp_async_f32<1>(dst + q, q < valid ? row + q : gf, q < valid);
          }
        }
      }
      cp_commit();
    };

    // one cp.async group per stage, empty past the last
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < stages) issue(st);
      else cp_commit();
    }
    for (int st = 0; st < stages; ++st) {
      if (st + kStages - 1 < stages) issue(st + kStages - 1);
      else cp_commit();
      cp_wait<kStages - 1>();   // this thread's copies of stage st have landed
      wgmma_wait<1>();          // the wgmma two stages back is done with its operands
      fence_regs(acc);

      // convert to bf16, MN-major core matrices: A (ci, pair) at
      // (ci / 8) * SBO + (pair / 8) * 128 + (pair % 8) * 16, B likewise
      const float* sa = stg + (st % kStages) * (kTI + NT) * kKR;
      unsigned char* oa = op_a + (done & 1) * kTI * kKR * 2;
      unsigned char* ob = op_b + (done & 1) * NT * kKR * 2;
      const int p = st * kKR + pr;
      const bool live = p < n;
      unsigned char* at = oa + (pr >> 3) * 128 + (pr & 7) * 16;
#pragma unroll
      for (int i = 0; i < kTI * kKR / 8 / kThreads; ++i) {
        const int cg = (tid + i * kThreads) / kKR;
        const int ci = ci0 + 8 * cg;
        if (ci >= Cin) continue;   // stays zero
        uint4 val;
        if (xb)
          val = live ? load8_bf16(static_cast<const __nv_bfloat16*>(a.x) +
                                      static_cast<size_t>(s_src[p]) * Cin + ci,
                                  Cin - ci, a.x_vec && ci + 8 <= Cin)
                     : make_uint4(0u, 0u, 0u, 0u);
        else
          val = cvt8_bf16(sa + (cg * kKR + pr) * 8);
        *reinterpret_cast<uint4*>(at + cg * SBO) = val;
      }
      for (int e = tid; e < BSEG; e += kThreads) {
        const int ng = e / kKR;
        const int co = c0 + 8 * ng;
        uint4 val;
        if (gb)
          val = live ? load8_bf16(static_cast<const __nv_bfloat16*>(a.g) +
                                      static_cast<size_t>(s_dst[p]) * Cout + co,
                                  Cout - co, a.g_vec && co + 8 <= Cout)
                     : make_uint4(0u, 0u, 0u, 0u);
        else
          val = cvt8_bf16(sa + kTI * kKR + e * 8);
        *reinterpret_cast<uint4*>(ob + ng * SBO + (pr >> 3) * 128 + (pr & 7) * 16) = val;
      }
      fence_proxy_async();
      __syncthreads();

      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKR / 16; ++ks)
        Wgmma<NT>::template mma<1, 1>(acc, smem_desc(oa + ks * 256, 128, SBO),
                                      smem_desc(ob + ks * 256, 128, SBO));
      wgmma_commit();
      ++done;
    }
    // the next pass overwrites the row lists (the last stages' copies have
    // landed: their groups were waited for in the loop)
    cp_wait<0>();
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const bool rnd = a.round_out != 0;
  float* out = a.dst + (static_cast<size_t>(blockIdx.x) * kTaps + k) * Cin * Cout;
  const int gl = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = ci0 + warp * 16 + gl + 8 * h;
    if (ci < Cin) {
      float* o = out + static_cast<size_t>(ci) * Cout;
#pragma unroll
      for (int j8 = 0; j8 < NT / 8; ++j8) {
        const int co = c0 + j8 * 8 + 2 * (lane & 3);
        if (co < Cout) o[co] = round_bf16(acc[4 * j8 + 2 * h], rnd);
        if (co + 1 < Cout) o[co + 1] = round_bf16(acc[4 * j8 + 2 * h + 1], rnd);
      }
    }
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

template <int NT>
cudaError_t launch(const Args& a, int chunks, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_wgrad_bf16_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(NT));
  if (attr != cudaSuccess) return attr;
  if (smem != smem_bytes(NT) || smem > kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid(chunks, ((a.Cin + kTI - 1) / kTI) * ((a.Cout + NT - 1) / NT), kTaps);
  subm_conv_wgrad_bf16_wgmma_kernel<NT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_nt(int n_tile, const Args& a, int chunks, int smem, cudaStream_t s) {
  switch (n_tile) {
    case 16: return launch<16>(a, chunks, smem, s);
    case 32: return launch<32>(a, chunks, smem, s);
    case 48: return launch<48>(a, chunks, smem, s);
    case 64: return launch<64>(a, chunks, smem, s);
    case 80: return launch<80>(a, chunks, smem, s);
    case 96: return launch<96>(a, chunks, smem, s);
    case 112: return launch<112>(a, chunks, smem, s);
    case 128: return launch<128>(a, chunks, smem, s);
    case 160: return launch<160>(a, chunks, smem, s);
    case 192: return launch<192>(a, chunks, smem, s);
    case 224: return launch<224>(a, chunks, smem, s);
    case 256: return launch<256>(a, chunks, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Plain C launcher for ctypes, on the current device.  x (B, V, Cin) and
// g (B, V, Cout) are fp32 (or bf16 where x_bf16 / g_bf16), contiguous; nbr
// (B, 27, V) int32; dw (27, Cin, Cout) f32 receives the sums rounded to
// bf16.  The plan (n_tile, chunks, chunk_rows, smem) is the
// wrapper's; it is refused (cudaErrorInvalidValue) if it does not fit this
// kernel.  Launches on `stream` (PyTorch's current stream), does not
// synchronise and allocates nothing: `partial` is the caller's scratch of
// chunks * 27 * Cin * Cout floats for `chunks` > 1.  Returns 0
// (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_subm_conv_wgrad_bf16(const void* x, int x_bf16, const int* nbr,
                                           const void* g, int g_bf16, float* dw, float* partial,
                                           int B, int V, int Cin, int Cout, int n_tile,
                                           int chunks, long long chunk_rows, int smem,
                                           void* stream) {
  if (Cin <= 0 || Cout <= 0) return cudaSuccess;
  const long long total = static_cast<long long>(B) * V;
  if (B <= 0 || V <= 0 || chunks < 1 || (chunks > 1 && partial == nullptr) ||
      n_tile <= 0 || n_tile > 256 || chunk_rows <= 0 || chunk_rows % kThreads != 0 ||
      (total + chunk_rows - 1) / chunk_rows != chunks)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.nbr = nbr;
  a.g = g;
  a.dst = chunks > 1 ? partial : dw;
  a.B = B;
  a.V = V;
  a.Cin = Cin;
  a.Cout = Cout;
  a.chunk_rows = chunk_rows;
  a.x_bf16 = x_bf16 != 0;
  a.g_bf16 = g_bf16 != 0;
  // 16-byte loads of 8 channels where every row and chunk is 16-byte aligned
  a.x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && Cin % (x_bf16 ? 8 : 4) == 0;
  a.g_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && Cout % (g_bf16 ? 8 : 4) == 0;
  a.round_out = chunks == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_nt(n_tile, a, chunks, smem, s);
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = static_cast<size_t>(kTaps) * Cin * Cout;
  const int threads = 256;
  const size_t need = (n + threads - 1) / threads;
  const int blocks = need > 4096 ? 4096 : static_cast<int>(need);
  sum_chunks_bf16_kernel<<<blocks, threads, 0, s>>>(partial, dw, n, chunks);
  return cudaGetLastError();
}

}  // extern "C"
