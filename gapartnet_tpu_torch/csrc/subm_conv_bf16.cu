// Submanifold 3x3x3 sparse convolution on bf16 operands, forward and dgrad,
// for NVIDIA Hopper (sm_90a).
//
// The bf16 twin of csrc/subm_conv.cu (which replaces the TPU kernel `_kernel`
// of gapartnet_tpu/ops/pallas_conv.py:32, pallas_call at :68).  The Pallas
// kernel casts its operands to f32 (pallas_conv.py:79); the JAX package's
// bf16 conv is the XLA gather-GEMM with `compute_dtype=bfloat16`
// (gapartnet_tpu/ops/sparse_conv.py:368-380, :250-268), the same function on
// operands rounded to bf16:
//
//   out[b, v, n] = sum_k sum_c  x[b, nbr[b, k, v], c] * w[k][n][c]   (0 where nbr = -1)
//
// x (B, V, ld) bf16 and w (27, N, ld) bf16 are copies the wrapper writes,
// each row padded with zeros to ld = K rounded up to 8 (16 bytes, so every
// row is a whole number of 16-byte copies); nbr (B, 27, V) int32; out
// (B, V, N) f32, fp32 accumulation.  A bf16 product is exact in fp32, so
// only the order of the fp32 sums differs from the JAX package.
//
//   * forward (sparse_conv.py:375-377): x = features, w[k][n][c] = W[k][c][n]
//     (the weights transposed, so the k-pairs of an mma B fragment are
//     adjacent), K = Cin, N = Cout;
//   * dgrad (sparse_conv.py:289-295): x = the output gradient rounded to
//     bf16, w[k][n][c] = W[26 - k][n][c] (the weights tap-reversed; as the
//     B operand of the conv with flip(W, 0)^T it needs no transpose),
//     K = Cout, N = Cin, and the fp32 result rounded to bf16
//     (`round_out`), as the JAX VJP's `.astype(bfloat16)`.
//
// What bounds it on this card: a gather-GEMM with K = 27 * Cin over the
// neighbour pairs that exist.  At bf16 dense tensor-core rate (989 TFLOP/s)
// every level of the flagship backbone is bound by bytes: the 27 x V
// neighbour table and the rows gathered (each half the fp32 kernel's).
// chip_smoke.py recomputes both bounds from the pairs in the run's data.
//
// Design: that of csrc/subm_conv.cu with bf16 operands:
//   * a block owns 128 output voxels (4 warps, 32 rows each) and a tile of
//     TN <= 64 output channels; B rides blockIdx.y, channel tiles and tap
//     splits blockIdx.z; a per-tap presence vote over the block's
//     neighbour indices skips taps with no neighbour in the tile;
//   * the present (tap, channel chunk) pairs form a sequence of stages
//     filled by cp.async (16 bytes, zero-fill past ld; an absent
//     neighbour's row zeroed by plain stores) into a ring of kStages
//     shared buffers, kStages - 1 stages ahead of the math.  A chunk is
//     KC = 32 channels (16 for ld <= 16);
//   * the math is one mma.sync m16n8k16 (bf16 in, fp32 accumulation) per
//     16 channels, fragments read by ldmatrix from shared rows of KC + 8
//     bf16 (16-byte aligned; 8 consecutive rows on 8 distinct 16-byte bank
//     groups, so no bank conflicts);
//   * small grids split their taps over blockIdx.z; each split writes an
//     fp32 partial sum and a second kernel adds them in split order (and
//     then rounds).  No atomics: a repeat is bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace gapartnet;
typedef __nv_bfloat16 bf16;

constexpr int kTaps = 27;
constexpr int kTV = 128;          // voxels per block
constexpr int kWarps = 4;         // each owns 32 voxels
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kBlocksPerSM = 8;   // split taps until the grid holds this many
static_assert(kThreads == kTV, "thread t gathers row t");

// N in equal tiles of at most 64, each rounded up to 8 (the mma N)
int tile_channels(int N) {
  const int tiles = (N + 63) / 64;
  return (((N + tiles - 1) / tiles) + 7) / 8 * 8;
}

// bf16 elements of a padded row of K channels
__host__ __device__ constexpr int padded(int K) { return (K + 7) / 8 * 8; }

// channels per stage: 16 (one mma k-step) for rows of at most 16, else 32
int chunk_channels(int K) { return padded(K) <= 16 ? 16 : 32; }

template <int TN, int KC>
__global__ void __launch_bounds__(kThreads)
subm_conv_bf16_fwd_kernel(const bf16* __restrict__ feats, const int* __restrict__ nbr,
                          const bf16* __restrict__ w, float* __restrict__ out,
                          int V, int K, int N, int taps_per_split, int round_out) {
  constexpr int NT = TN / 8;
  constexpr int S = KC + 8;                                   // shared row stride (bf16)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_or[kWarps];
  bf16* s_a = reinterpret_cast<bf16*>(smem);                  // [kStages][kTV][S]
  bf16* s_w = s_a + kStages * kTV * S;                        // [kStages][TN][S]
  int* s_nbr = reinterpret_cast<int*>(s_w + kStages * TN * S);  // [taps][kTV]

  const int ld = padded(K);
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTV;
  const int ctiles = (N + TN - 1) / TN;
  const int split = blockIdx.z / ctiles;
  const int c0 = (blockIdx.z % ctiles) * TN;
  const int k_begin = split * taps_per_split;
  const int nk = min(kTaps, k_begin + taps_per_split) - k_begin;
  // split s writes its partial sum to slice s of `out` (B, V, N each)
  out += static_cast<size_t>(split) * gridDim.y * V * N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bf16* fb = feats + static_cast<size_t>(b) * V * ld;
  const int* nb = nbr + (static_cast<size_t>(b) * kTaps + k_begin) * V;

  // the tile's neighbour indices (thread t reads row t's, all loads in
  // flight together) and the taps that have a neighbour anywhere in it
  const int v = v0 + tid;
  int srcs[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
    srcs[j] = j < nk && v < V ? __ldg(nb + static_cast<size_t>(j) * V + v) : -1;
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    if (j < nk) s_nbr[j * kTV + tid] = srcs[j];
    mine |= static_cast<unsigned>(srcs[j] >= 0) << j;
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0) s_or[warp] = mine;
  __syncthreads();
  unsigned taps = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) taps |= s_or[i];

  const int nq = (ld + KC - 1) / KC;
  const int total = __popc(taps) * nq;

  // stage s = (j-th present tap, chunk q): the copies' cursor (pmask, pq)
  // runs kStages - 1 stages ahead of the math
  unsigned pmask = taps;
  int pq = 0;
  auto load_stage = [&](int buf) {
    const int j = __ffs(pmask) - 1;
    const int cb = pq * KC;
    // thread t gathers row t, pieces past ld zero-filled; an absent
    // neighbour's row is zeroed by plain stores, so it costs no copy
    bf16* a = s_a + (buf * kTV + tid) * S;
    const int src = s_nbr[j * kTV + tid];
    if (src >= 0) {
      const bf16* row = fb + static_cast<size_t>(src) * ld + cb;
#pragma unroll
      for (int c = 0; c < KC; c += 8) cp_async16(a + c, cb + c < ld ? row + c : fb, cb + c < ld);
    } else {
#pragma unroll
      for (int c = 0; c < KC; c += 8) *reinterpret_cast<uint4*>(a + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    // the w chunk: rows c0 + n < N, pieces cb + c < ld
    constexpr int kPieces = KC / 8;
    const bf16* wk = w + (static_cast<size_t>(k_begin + j) * N + c0) * ld + cb;
    bf16* ws = s_w + buf * TN * S;
    for (int e = tid; e < TN * kPieces; e += kThreads) {
      const int n = e / kPieces;
      const int c = (e - n * kPieces) * 8;
      const bool ok = c0 + n < N && cb + c < ld;
      cp_async16(ws + n * S + c, ok ? wk + static_cast<size_t>(n) * ld + c : w, ok);
    }
    if (++pq == nq) { pq = 0; pmask &= pmask - 1; }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    // stage s has landed for every thread, and every thread is done with
    // the buffer that stage s + kStages - 1 now refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < total) load_stage((s + kStages - 1) % kStages);
    cp_async_commit();

    const int buf = s % kStages;
    const bf16* a = s_a + (buf * kTV + warp * 32) * S;
    const bf16* ws = s_w + buf * TN * S;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      // A (16 x 16, rows = voxels): lane l addresses row l % 16, column
      // kk + 8 (l / 16), giving the four 8x8 blocks in fragment order
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], a + (mt * 16 + (lane & 15)) * S + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B (16 x 8) from rows n: lanes 0-7 columns kk, lanes 8-15 kk + 8
        uint32_t bfr[2];
        ldmatrix_x2(bfr, ws + (nt * 8 + (lane & 7)) * S + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], bfr);
      }
    }
  }
  cp_async_wait<0>();

  const bool rnd = round_out != 0;
  const int gr = lane >> 2;   // fragment row
  const int tg = lane & 3;    // fragment column pair
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vv = v0 + warp * 32 + mt * 16 + gr + 8 * h;
      if (vv >= V) continue;
      float* ob = out + (static_cast<size_t>(b) * V + vv) * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = c0 + nt * 8 + 2 * tg;
        if (co < N) ob[co] = round_bf16(acc[mt][nt][2 * h], rnd);
        if (co + 1 < N) ob[co + 1] = round_bf16(acc[mt][nt][2 * h + 1], rnd);
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

constexpr size_t smem_bytes(int TN, int KC, int taps_per_split) {
  return sizeof(bf16) * kStages * (kTV + TN) * (KC + 8) + sizeof(int) * taps_per_split * kTV;
}

int grid_blocks(size_t n, int threads) {
  const size_t need = (n + threads - 1) / threads;
  return need > 4096 ? 4096 : static_cast<int>(need);
}

template <int TN, int KC>
cudaError_t launch(const bf16* feats, const int* nbr, const bf16* w, float* dst, int B, int V,
                   int K, int N, int splits, int round_out, cudaStream_t stream) {
  // the largest dynamic shared memory any shape asks of this kernel, set
  // once (the attribute stays with the kernel)
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_bf16_fwd_kernel<TN, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(TN, KC, kTaps)));
  if (attr != cudaSuccess) return attr;
  const int taps_per_split = (kTaps + splits - 1) / splits;
  dim3 grid((V + kTV - 1) / kTV, B, ((N + TN - 1) / TN) * splits);
  subm_conv_bf16_fwd_kernel<TN, KC><<<grid, kThreads, smem_bytes(TN, KC, taps_per_split), stream>>>(
      feats, nbr, w, dst, V, K, N, taps_per_split, round_out);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_kc(const bf16* feats, const int* nbr, const bf16* w, float* dst, int B, int V,
                      int K, int N, int splits, int round_out, cudaStream_t s) {
  return chunk_channels(K) == 16
             ? launch<TN, 16>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s)
             : launch<TN, 32>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
}

cudaError_t launch_tn(const bf16* feats, const int* nbr, const bf16* w, float* dst, int B, int V,
                      int K, int N, int splits, int round_out, cudaStream_t s) {
  switch (tile_channels(N)) {
    case 8: return launch_kc<8>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 16: return launch_kc<16>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 24: return launch_kc<24>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 32: return launch_kc<32>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 40: return launch_kc<40>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 48: return launch_kc<48>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 56: return launch_kc<56>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    case 64: return launch_kc<64>(feats, nbr, w, dst, B, V, K, N, splits, round_out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of tap splits the launcher uses for this shape on a card with
// `sms` SMs (1 = no partial sums).  Pure: no CUDA call.
int gapartnet_subm_conv_bf16_splits(int B, int V, int N, int sms) {
  if (B <= 0 || V <= 0 || N <= 0 || sms <= 0) return 1;
  const int tc = tile_channels(N);
  const long long base = static_cast<long long>((V + kTV - 1) / kTV) * B * ((N + tc - 1) / tc);
  const long long target = static_cast<long long>(kBlocksPerSM) * sms;
  const long long want = (target + base - 1) / base;
  const int splits = want < 1 ? 1 : (want > kTaps ? kTaps : static_cast<int>(want));
  const int per = (kTaps + splits - 1) / splits;
  return (kTaps + per - 1) / per;   // no empty split
}

// Plain C launcher for ctypes, on the current device.  `feats` (B, V, ld)
// and `w` (27, N, ld) are bf16 with ld = K rounded up to 8, zeros past K,
// both 16-byte aligned.  Launches on `stream` (PyTorch's current stream),
// does not synchronise and allocates nothing: `partial` is the caller's
// scratch of splits * B * V * N floats for `splits` > 1.  With `round_out`
// the result is rounded to bf16 (the dgrad).  Returns 0 (cudaSuccess) or
// the CUDA error code.
cudaError_t gapartnet_subm_conv_bf16_forward(const void* feats, const int* nbr, const void* w,
                                             float* out, float* partial, int B, int V, int K,
                                             int N, int splits, int round_out, void* stream) {
  if (B <= 0 || V <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || splits < 1 || splits > kTaps || (splits > 1 && partial == nullptr) ||
      ((reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(w)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(feats);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaError_t err = launch_tn(x, nbr, wb, splits > 1 ? partial : out, B, V, K, N, splits,
                              splits > 1 ? 0 : round_out, s);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * V * N;
  sum_splits_bf16_kernel<<<grid_blocks(n, 256), 256, 0, s>>>(partial, out, n, splits, round_out);
  return cudaGetLastError();
}

const char* gapartnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
