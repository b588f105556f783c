// Submanifold 3x3x3 sparse convolution on bf16 operands, forward and dgrad,
// for NVIDIA Hopper (sm_90a): wgmma from shared memory, bf16 rounding
// inside the kernel, no operand copies.
//
// The bf16 twin of csrc/subm_conv.cu, which replaces the TPU kernel
// `_kernel` of gapartnet_tpu/ops/pallas_conv.py:32 (pallas_call at :68) and,
// as the dgrad, the same kernel in its custom VJP (`_bwd`, :95-103).  The
// Pallas kernel casts its operands to f32 (pallas_conv.py:79); the JAX
// package's bf16 conv is the XLA gather-GEMM with `compute_dtype=bfloat16`
// (gapartnet_tpu/ops/sparse_conv.py:250-318, :368-380), the same function on
// operands rounded to bf16:
//
//   out[b, v, n] = sum_k sum_c  bf16(x[b, nbr[b, k, v], c]) * bf16(B_k[c][n])
//                  (no term where nbr = -1), fp32 accumulation
//
//   * forward (sparse_conv.py:375-377): x = the features (B, V, Cin),
//     B_k = W[k] (K = Cin, N = Cout), read in place from the (27, Cin, Cout)
//     weights;
//   * dgrad (sparse_conv.py:289-295): x = the output gradient (B, V, Cout),
//     B_k = W[26 - k]^T (K = Cout, N = Cin), read in place from the same
//     weights (`flip`), and the fp32 result rounded to bf16 (`round_out`),
//     as the JAX VJP's `.astype(bfloat16)`.
//
// x and W are fp32 or bf16, rows of any width and alignment: they are
// rounded to bf16 (to nearest, ties to even, the values of
// tensor.to(torch.bfloat16)) on their way into the operand buffers, so the
// wrapper writes no operand copy.  A bf16 product is exact in fp32, so only
// the order of the fp32 sums differs from the JAX package.
//
// What bounds it on this card: a gather-GEMM over the neighbour pairs that
// exist.  At the dense bf16 tensor-core rate (989 TFLOP/s) every level of
// the flagship is bound by bytes: the 27 x V neighbour table, the rows and
// the output (chip_smoke.py recomputes the bound from the run's pairs).  In
// practice each row is gathered once per pair through L1/L2 (about 11.5
// times at backbone level 1), as 16-byte asynchronous copies: timed inside
// the kernel on the card, issuing a stage's copies takes most of a stage's
// cycles, so the gathers' request traffic binds, not the tensor cores.  The
// rows are read as the network holds them, fp32, twice the requests of a
// bf16 copy: the price of writing no operand copy (PERF.md, section 6).
//
// Design:
//   * a block is one warpgroup (128 threads) and owns 128 output voxels
//     (two 64-row wgmma tiles; 64 where N > 128) and an N tile of at most
//     256 channels (one wgmma N: every flagship width is one tile, so no
//     voxel tile is gathered twice); B rides blockIdx.y, N tiles and tap
//     splits blockIdx.z;
//   * it first reads the tile's 27 neighbour indices per row (all loads in
//     flight) and votes which taps have a neighbour in the tile; absent
//     taps cost nothing;
//   * the present (tap, 16-channel chunk) pairs form a sequence of stages.
//     A 3-stage fp32 staging ring is filled by cp.async two stages ahead:
//     warp w copies rows 32w .. 32w + 31, four lanes a row, so that each
//     copy instruction asks for whole 32-byte sectors (an absent
//     neighbour's row costs nothing), and thread t weight segments t,
//     t + 128, ... (8 contiguous floats each: the forward's W[k] rows along
//     N, the dgrad's W[26 - k] rows along K, both read in place).  Each
//     thread then waits for its own copies, its warp syncs, and it converts
//     its row and its segments to bf16 (to nearest, ties to even) into one
//     of two operand buffers of core matrices: A K-major, the forward's B
//     MN-major (wgmma's transposed B) and the dgrad's K-major, so neither
//     needs a transposed weight copy.  One block barrier per stage, after
//     the conversion (with the proxy fence wgmma needs);
//   * wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulation) per 64-row
//     tile and stage, the accumulators in registers across all taps;
//     wgmma.wait_group 1 keeps one stage in flight and frees the operand
//     buffer two stages back;
//   * Cin = 6 (the stem) and other rows that are not 16-byte aligned are
//     copied 4 bytes at a time and padded with zeros in shared memory;
//     bf16 inputs are read and converted at conversion time instead;
//   * small grids split their taps over blockIdx.z; each split writes an
//     fp32 partial sum and a second kernel adds them in split order (and
//     then rounds).  No atomics: a repeat is bitwise equal.
// The launch plan (N tile, splits, shared bytes) is computed by the wrapper
// (ops/subm_conv.bf16_forward_plan) and checked here.  Variants that lost
// on the card (a warp-specialized mbarrier ring with producer warps, bulk
// copies per row, per-warp stage buffers, 32-channel stages) are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using namespace gapartnet;

constexpr int kTaps = 27;
constexpr int kThreads = 128;     // one warpgroup
constexpr int kStages = 3;        // fp32 staging ring: 2 stages' gathers in flight
constexpr int KC = 16;            // channels per stage: one wgmma k-step
constexpr int SA = KC + 4;        // fp32 staging row stride (16-byte rows, no bank conflicts)
constexpr int SBO = KC * 16;      // bytes between core matrices along M or N
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// 64-row wgmma tiles per block: 2 (128 voxels) while the accumulators
// (MT * NT / 2 a thread) stay within 128 registers
__host__ __device__ constexpr int m_tiles(int nt) { return nt <= 128 ? 2 : 1; }

__host__ __device__ constexpr int smem_bytes(int nt) {
  // bf16 operands (2 buffers of A rows x KC and B nt x KC), fp32 staging
  // (kStages of A rows x SA and the nt x KC weights), neighbour indices
  return 2 * (64 * m_tiles(nt) + nt) * KC * 2 +
         kStages * (64 * m_tiles(nt) * SA + nt * KC) * 4 + kTaps * 64 * m_tiles(nt) * 4;
}

struct Args {
  const void* x;
  const int* nbr;
  const void* w;
  float* out;
  int V, K, N, taps_per_split;
  int x_bf16, x_vec, w_bf16, w_vec, flip, round_out;
};

template <int NT>
__global__ void __launch_bounds__(kThreads) subm_conv_bf16_wgmma_kernel(const Args a) {
  constexpr int MT = m_tiles(NT);
  constexpr int ROWS = 64 * MT;
  constexpr int SEGS = NT * KC / 8;   // 8-float weight segments of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned s_or[kThreads / 32];
  unsigned char* op_a = smem;                                   // [2][ROWS x KC] bf16
  unsigned char* op_b = op_a + 2 * ROWS * KC * 2;               // [2][NT x KC] bf16
  float* stg_a = reinterpret_cast<float*>(op_b + 2 * NT * KC * 2);   // [kStages][ROWS][SA]
  float* stg_w = stg_a + kStages * ROWS * SA;                   // [kStages][SEGS][8]
  int* s_nbr = reinterpret_cast<int*>(stg_w + kStages * NT * KC);    // [taps][ROWS]

  const int V = a.V, K = a.K, N = a.N;
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * ROWS;
  const int ntiles = (N + NT - 1) / NT;
  const int split = blockIdx.z / ntiles;
  const int c0 = (blockIdx.z % ntiles) * NT;
  const int k_begin = split * a.taps_per_split;
  const int nk = min(kTaps, k_begin + a.taps_per_split) - k_begin;
  const int tid = threadIdx.x;
  const bool xb = a.x_bf16 != 0, wb = a.w_bf16 != 0, flip = a.flip != 0;
  const char* xbase = static_cast<const char*>(a.x) + static_cast<size_t>(b) * V * K * (xb ? 2 : 4);
  const float* xf = reinterpret_cast<const float*>(xbase);
  const float* wf = static_cast<const float*>(a.w);

  // the tile's neighbour indices (thread t reads row t's, all loads in
  // flight together) and the taps that have a neighbour anywhere in it
  {
    unsigned mine = 0;
    if (tid < ROWS) {
      const int* nb = a.nbr + (static_cast<size_t>(b) * kTaps + k_begin) * V + v0 + tid;
      int src[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j)
        src[j] = j < nk && v0 + tid < V ? __ldg(nb + static_cast<size_t>(j) * V) : -1;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (j < nk) s_nbr[j * ROWS + tid] = src[j];
        mine |= static_cast<unsigned>(src[j] >= 0) << j;
      }
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    if ((tid & 31) == 0) s_or[tid >> 5] = mine;
  }
  __syncthreads();
  unsigned taps = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) taps |= s_or[i];
  const int nq = (K + KC - 1) / KC;
  const int total = __popc(taps) * nq;

  // Each warp copies, and later converts, only its own pieces: rows 32w ..
  // 32w + 31 of A (row t converted by thread t) and weight segments t,
  // t + 128, ... (8 contiguous floats each, copied and converted by thread
  // t), so a stage needs no block barrier between its copies landing and
  // its conversion.
  // Forward segment e: row e % KC, columns 8 (e / KC) .. of W[k], stored
  // MN-major (B's k-row of 8 n); dgrad segment e: row n = e % NT, columns
  // 8 (e / NT) .. of W[26 - k], stored K-major (B's n-row of 8 k)
  auto w_seg = [&](int k, int cb, int e, int& valid) -> const float* {
    if (flip) {
      const int n = c0 + e % NT, c = cb + 8 * (e / NT);
      valid = n < N ? min(8, K - c) : 0;
      return wf + (static_cast<size_t>(kTaps - 1 - k) * N + n) * K + c;
    }
    const int n = c0 + 8 * (e / KC), c = cb + e % KC;
    valid = c < K ? min(8, N - n) : 0;
    return wf + (static_cast<size_t>(k) * K + c) * N + n;
  };
  // stage s = (j-th present tap, channel chunk q): the copies' cursor runs
  // kStages - 1 stages ahead of the conversion's; one cp.async group per
  // stage, empty past the last
  unsigned imask = taps, cmask = taps;
  int iq = 0, cq = 0;
  auto issue = [&](int s) {
    if (s < total) {
      const int buf = s % kStages;
      const int j = __ffs(imask) - 1;
      const int cb = iq * KC;
      if (!xb && (tid & ~31) < ROWS) {
        if (a.x_vec && cb + KC <= K) {
          // a warp copies its 32 rows 8 at a time, 4 lanes a row: each
          // instruction asks for whole 32-byte sectors
#pragma unroll
          for (int i = 0; i < 32 * KC / 4 / 32; ++i) {
            const int r = (tid & ~31) + i * 32 * 4 / KC + (tid & 31) / (KC / 4);
            const int c = ((tid & 31) % (KC / 4)) * 4;
            const int src = s_nbr[j * ROWS + r];
            if (src >= 0)
              cp_async_f32<4>(stg_a + (buf * ROWS + r) * SA + c,
                              xf + static_cast<size_t>(src) * K + cb + c, true);
          }
        } else {
          const int src = s_nbr[j * ROWS + tid];
          if (src >= 0) {
            float* dst = stg_a + (buf * ROWS + tid) * SA;
            const float* row = xf + static_cast<size_t>(src) * K + cb;
#pragma unroll
            for (int c = 0; c < KC; ++c) cp_async_f32<1>(dst + c, cb + c < K ? row + c : xf, cb + c < K);
          }
        }
      }
      if (!wb) {
#pragma unroll
        for (int i = 0; i < (SEGS + kThreads - 1) / kThreads; ++i) {
          const int e = tid + i * kThreads;
          if (SEGS % kThreads == 0 || e < SEGS) {
            int valid;
            const float* src = w_seg(k_begin + j, cb, e, valid);
            float* dst = stg_w + (buf * SEGS + e) * 8;
            if (valid == 8 && a.w_vec) {
              cp_async_f32<4>(dst, src, true);
              cp_async_f32<4>(dst + 4, src + 4, true);
            } else {
#pragma unroll
              for (int q = 0; q < 8; ++q) cp_async_f32<1>(dst + q, q < valid ? src + q : wf, q < valid);
            }
          }
        }
      }
      if (++iq == nq) { iq = 0; imask &= imask - 1; }
    }
    cp_commit();
  };

  float acc[MT][NT / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[m][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    // this thread's staging of stage s - 1, which stage s + kStages - 1
    // refills, was converted by it in the last iteration
    issue(s + kStages - 1);
    cp_wait<kStages - 1>();   // this thread's copies of stage s have landed,
    __syncwarp();             // and its warp's (its rows' other pieces)
    wgmma_wait<1>();          // the wgmma of stage s - 2 is done with its operands
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

    // convert to bf16 core matrices: A K-major (row r at (r / 8) * SBO +
    // (c / 8) * 128 + (r % 8) * 16), B MN-major (forward) or K-major (dgrad)
    const int j = __ffs(cmask) - 1;
    const int cb = cq * KC;
    const int buf = s % kStages;
    unsigned char* oa = op_a + (s & 1) * ROWS * KC * 2;
    unsigned char* ob = op_b + (s & 1) * NT * KC * 2;
    if (tid < ROWS) {
      const int src = s_nbr[j * ROWS + tid];
      const float* sa = stg_a + (buf * ROWS + tid) * SA;
      unsigned char* dst = oa + (tid >> 3) * SBO + (tid & 7) * 16;
#pragma unroll
      for (int g = 0; g < KC / 8; ++g) {
        const int c = cb + 8 * g;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (src >= 0)
          val = xb ? load8_bf16(reinterpret_cast<const __nv_bfloat16*>(xbase) +
                                    static_cast<size_t>(src) * K + c,
                                K - c, a.x_vec && c + 8 <= K)
                   : cvt8_bf16(sa + 8 * g);
        *reinterpret_cast<uint4*>(dst + g * 128) = val;
      }
    }
#pragma unroll
    for (int i = 0; i < (SEGS + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (SEGS % kThreads == 0 || e < SEGS) {
        int valid;
        const float* src = w_seg(k_begin + j, cb, e, valid);
        uint4 val;
        if (wb)
          val = load8_bf16(static_cast<const __nv_bfloat16*>(a.w) + (src - wf), valid,
                           a.w_vec && valid == 8);
        else
          val = valid > 0 ? cvt8_bf16(stg_w + (buf * SEGS + e) * 8) : make_uint4(0u, 0u, 0u, 0u);
        const int off = flip ? ((e % NT) >> 3) * SBO + (e / NT) * 128 + ((e % NT) & 7) * 16
                             : (e / KC) * SBO + ((e % KC) >> 3) * 128 + ((e % KC) & 7) * 16;
        *reinterpret_cast<uint4*>(ob + off) = val;
      }
    }
    if (++cq == nq) { cq = 0; cmask &= cmask - 1; }
    fence_proxy_async();
    __syncthreads();

    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        const uint64_t da = smem_desc(oa + m * 8 * SBO + ks * 256, 128, SBO);
        const uint64_t db = smem_desc(ob + ks * 256, 128, SBO);
        if (flip) Wgmma<NT>::template mma<0, 0>(acc[m], da, db);
        else Wgmma<NT>::template mma<0, 1>(acc[m], da, db);
      }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

  // split s writes its partial sum to slice s of `out` (B, V, N each)
  float* out = a.out + static_cast<size_t>(split) * gridDim.y * V * N;
  const bool rnd = a.round_out != 0;
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vv = v0 + m * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (vv < V) {
        float* o = out + (static_cast<size_t>(b) * V + vv) * N;
#pragma unroll
        for (int j8 = 0; j8 < NT / 8; ++j8) {
          const int co = c0 + j8 * 8 + 2 * (lane & 3);
          if (co < N) o[co] = round_bf16(acc[m][4 * j8 + 2 * h], rnd);
          if (co + 1 < N) o[co + 1] = round_bf16(acc[m][4 * j8 + 2 * h + 1], rnd);
        }
      }
    }
  }
}

// out[i] = sum over splits s of partial[s][i], in split order, then rounded
// to bf16 when `round_out`
__global__ void sum_splits_bf16_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, size_t n, int splits,
                                       int round_out) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int s = 1; s < splits; ++s) acc += partial[static_cast<size_t>(s) * n + i];
    out[i] = round_bf16(acc, round_out != 0);
  }
}

template <int NT>
cudaError_t launch(const Args& a, int B, int splits, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_bf16_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(NT));
  if (attr != cudaSuccess) return attr;
  if (smem != smem_bytes(NT) || smem > kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid((a.V + 64 * m_tiles(NT) - 1) / (64 * m_tiles(NT)), B, ((a.N + NT - 1) / NT) * splits);
  subm_conv_bf16_wgmma_kernel<NT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_nt(int n_tile, const Args& a, int B, int splits, int smem, cudaStream_t s) {
  switch (n_tile) {
    case 16: return launch<16>(a, B, splits, smem, s);
    case 32: return launch<32>(a, B, splits, smem, s);
    case 48: return launch<48>(a, B, splits, smem, s);
    case 64: return launch<64>(a, B, splits, smem, s);
    case 80: return launch<80>(a, B, splits, smem, s);
    case 96: return launch<96>(a, B, splits, smem, s);
    case 112: return launch<112>(a, B, splits, smem, s);
    case 128: return launch<128>(a, B, splits, smem, s);
    case 160: return launch<160>(a, B, splits, smem, s);
    case 192: return launch<192>(a, B, splits, smem, s);
    case 224: return launch<224>(a, B, splits, smem, s);
    case 256: return launch<256>(a, B, splits, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

int grid_blocks(size_t n, int threads) {
  const size_t need = (n + threads - 1) / threads;
  return need > 4096 ? 4096 : static_cast<int>(need);
}

}  // namespace

extern "C" {

// Plain C launcher for ctypes, on the current device.  x (B, V, K) and the
// weights (27, K, N), or (27, N, K) read tap-reversed and transposed with
// `flip`, are fp32 (or bf16 where x_bf16 / w_bf16), contiguous; nbr
// (B, 27, V) int32; out (B, V, N) f32.  The plan (n_tile, splits, smem)
// is the wrapper's; it is refused (cudaErrorInvalidValue) if it does not fit
// this kernel.  Launches on `stream` (PyTorch's current stream), does not
// synchronise and allocates nothing: `partial` is the caller's scratch of
// splits * B * V * N floats for `splits` > 1.  With `round_out` the result
// is rounded to bf16 (the dgrad).  Returns 0 (cudaSuccess) or the CUDA
// error code.
cudaError_t gapartnet_subm_conv_bf16_forward(const void* x, int x_bf16, const int* nbr,
                                             const void* w, int w_bf16, float* out,
                                             float* partial, int B, int V, int K, int N,
                                             int n_tile, int splits, int smem, int flip,
                                             int round_out, void* stream) {
  if (B <= 0 || V <= 0 || N <= 0) return cudaSuccess;
  const int per = splits >= 1 ? (kTaps + splits - 1) / splits : 0;
  if (K <= 0 || splits < 1 || splits > kTaps || (kTaps + per - 1) / per != splits ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x), wp = reinterpret_cast<uintptr_t>(w);
  Args a;
  a.x = x;
  a.nbr = nbr;
  a.w = w;
  a.out = splits > 1 ? partial : out;
  a.V = V;
  a.K = K;
  a.N = N;
  a.taps_per_split = per;
  a.x_bf16 = x_bf16 != 0;
  a.w_bf16 = w_bf16 != 0;
  // 16-byte loads of 8 channels where every row and chunk is 16-byte aligned
  a.x_vec = xp % 16 == 0 && K % (x_bf16 ? 8 : 4) == 0;
  // the dgrad's weight rows run along K, the forward's along N
  a.w_vec = wp % 16 == 0 && (flip ? K : N) % (w_bf16 ? 8 : 4) == 0;
  a.flip = flip != 0;
  a.round_out = splits > 1 ? 0 : round_out != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_nt(n_tile, a, B, splits, smem, s);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * V * N;
  sum_splits_bf16_kernel<<<grid_blocks(n, 256), 256, 0, s>>>(partial, out, n, splits, round_out);
  return cudaGetLastError();
}

const char* gapartnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
