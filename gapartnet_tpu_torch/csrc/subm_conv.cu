// Submanifold 3x3x3 sparse convolution, forward and dgrad, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` of gapartnet_tpu/ops/pallas_conv.py:32,
// launched by `_subm_conv_pallas_single` (pallas_conv.py:57, pallas_call at
// :68).  The numerics it must reproduce are those of
// gapartnet_tpu/ops/sparse_conv.py:250 `_subm_conv_forward`:
//
//   out[b, v, :] = sum_k  W[k]^T . x[b, nbr[b, k, v], :]   (row 0 where nbr = -1)
//
// features (B, V, Cin) f32, nbr (B, 27, V) int32, W (27, Cin, Cout) f32,
// out (B, V, Cout) f32, fp32 accumulation.
//
// The same kernel is the dgrad of the custom VJP (pallas_conv.py:95-103,
// sparse_conv.py:294-295): instantiated with FLIP it runs on the output
// gradient and reads W tap-reversed and transposed in place, W'[k][ci][co]
// = W[26 - k][co][ci] (its shared tile then holds rows along Cout), so no
// flipped copy of W is made.
//
// What bounds it on this card: a gather-GEMM with K = 27 * Cin over the
// neighbour pairs that exist.  Computed as 3xTF32 on the tensor cores
// (495 / 3 TFLOP/s), the level-0 shapes (Cin 16, about 16% of the 27 taps
// present) are bound by bytes: the 27 x V neighbour table and the gathered
// rows; the deeper levels (Cin 32-224, 40-50% present) by operations.
// chip_smoke.py recomputes both bounds from the pairs in the run's data.
// In practice the math loop binds, not the gathers: its operand splits,
// shared loads and mma, at the four blocks per SM that 128 registers a
// thread and the shared ring allow.
//
// Design:
//   * a block owns 128 output voxels (4 warps, 32 rows each) and a tile of
//     TN <= 64 output channels (Cout split into equal tiles rounded up to
//     8); B rides blockIdx.y, Cout tiles and tap splits blockIdx.z;
//   * it first loads the tile's neighbour indices for all of its taps (all
//     loads in flight together) and ORs a per-tap presence mask over the
//     block, so taps with no neighbour in the tile cost nothing;
//   * the present (tap, Cin chunk) pairs form a sequence of stages; a ring
//     of kStages shared-memory buffers is filled by cp.async, kStages - 1
//     stages ahead of the math, with one wait_group and one barrier per
//     stage.  Thread t gathers row t through L1 (neighbouring voxels share
//     neighbour rows); absent neighbours' rows are zeroed by plain shared
//     stores and channels past Cin zero-filled (src-size 0), so neither
//     moves bytes.  A chunk is KC = 16 channels (8 for Cin <= 8), a
//     template parameter, so a stage's two k-steps unroll and their loads
//     overlap the other's mma; 16 keeps the ring small enough for four
//     blocks per SM.  Copies are 16 bytes where rows allow it, else 4
//     bytes (Cin 5, 6), chosen by a template parameter;
//   * the math is mma.sync m16n8k8 on TF32 operands with fp32 accumulation,
//     split three ways for fp32 accuracy: a = a_hi + a_lo with
//     a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), and per k-step
//     lo*hi, hi*lo, hi*hi, in that order (single-pass TF32 keeps about 3
//     decimal digits, which the 1e-4 checks against fp32 would not pass);
//   * shared-memory rows are padded (A: stride = 4 mod 8 floats, W:
//     stride = 8 or 24 mod 32) so every fragment load hits 32 banks;
//   * small grids split their taps over blockIdx.z until the grid holds
//     about kBlocksPerSM blocks per SM; each split writes a partial sum and
//     a second kernel adds them in split order.  Every sum runs in a fixed
//     order with no atomics, so a repeat is bitwise equal;
//   * ragged edges (V, Cin, Cout) are masked in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace gapartnet;

constexpr int kTaps = 27;
constexpr int kTV = 128;          // voxels per block
constexpr int kWarps = 4;         // each owns 32 voxels
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kBlocksPerSM = 8;   // split taps until the grid holds this many
static_assert(kThreads == kTV, "thread t gathers row t");

// Cout in equal tiles of at most 64, each rounded up to 8 (the mma N)
int tile_channels(int Cout) {
  const int tiles = (Cout + 63) / 64;
  return (((Cout + tiles - 1) / tiles) + 7) / 8 * 8;
}

// input channels per stage: 8 (one mma k-step) for Cin <= 8, else 16
int chunk_channels(int Cin) { return Cin <= 8 ? 8 : 16; }

// floats of one stage's W chunk in shared memory: [KC][frag_stride(TN)]
// (forward, rows along Cin) or [TN][KC + 4] (dgrad, rows along Cout)
__host__ __device__ constexpr int w_tile(int TN, int KC, bool flip) {
  return flip ? TN * (KC + 4) : KC * frag_stride(TN);
}

// rows x cols floats (cols a multiple of VEC) into shared rows of stride
// `sd`, row r from src_row(r): consecutive threads take consecutive
// VEC-float pieces of a row.  Pieces past `valid_cols`, and rows that
// `src_row` maps to nullptr, are zero-filled without a read.
template <int VEC, typename RowFn>
__device__ __forceinline__ void load_rows(float* dst, int sd, int rows, int cols, int valid_cols,
                                          const float* fallback, RowFn src_row, int tid) {
  const int per_row = cols / VEC;
  for (int e = tid; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * VEC;
    const float* row = src_row(r);
    const bool ok = row != nullptr && c < valid_cols;
    cp_async<VEC>(dst + r * sd + c, ok ? row + c : fallback, ok);
  }
}

template <int TN, int VEC, bool FLIP, int KC>
__global__ void __launch_bounds__(kThreads)
subm_conv_fwd_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                     const float* __restrict__ w, float* __restrict__ out,
                     int V, int Cin, int Cout, int taps_per_split) {
  constexpr int NT = TN / 8;
  constexpr int SW = frag_stride(TN);
  constexpr int SA = KC + 4;                                  // = 4 mod 8: no bank conflicts
  constexpr int WT = w_tile(TN, KC, FLIP);
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_or[kWarps];
  float* s_a = smem;                                          // [kStages][kTV][SA]
  float* s_w = s_a + kStages * kTV * SA;                      // [kStages][WT]
  int* s_nbr = reinterpret_cast<int*>(s_w + kStages * WT);    // [taps][kTV]

  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTV;
  const int ctiles = (Cout + TN - 1) / TN;
  const int split = blockIdx.z / ctiles;
  const int c0 = (blockIdx.z % ctiles) * TN;
  const int k_begin = split * taps_per_split;
  const int nk = min(kTaps, k_begin + taps_per_split) - k_begin;
  // split s writes its partial sum to slice s of `out` (B, V, Cout each)
  out += static_cast<size_t>(split) * gridDim.y * V * Cout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* fb = feats + static_cast<size_t>(b) * V * Cin;
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

  const int nq = (Cin + KC - 1) / KC;
  const int total = __popc(taps) * nq;

  // stage s = (j-th present tap, chunk q): the copies' cursor (pmask, pq)
  // runs kStages - 1 stages ahead of the math
  unsigned pmask = taps;
  int pq = 0;
  auto load_stage = [&](int buf) {
    const int j = __ffs(pmask) - 1;
    const int ci0 = pq * KC;
    const int kc = min(KC, Cin - ci0);
    // thread t gathers row t, channels past Cin zero-filled; an absent
    // neighbour's row is zeroed by plain stores, so it costs no copy
    float* a = s_a + (buf * kTV + tid) * SA;
    const int src = s_nbr[j * kTV + tid];
    if (src >= 0) {
      const float* row = fb + static_cast<size_t>(src) * Cin + ci0;
#pragma unroll
      for (int c = 0; c < KC; c += VEC) cp_async<VEC>(a + c, c < kc ? row + c : fb, c < kc);
    } else {
#pragma unroll
      for (int c = 0; c < KC; c += 4) *reinterpret_cast<float4*>(a + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the W chunk: rows ci0 + r < Cin, columns c0 + n < Cout
    const int k = k_begin + j;
    float* ws = s_w + buf * WT;
    if (FLIP) {   // W'[k][ci][co] = W[26 - k][co][ci]: shared rows along Cout
      const float* wk = w + (static_cast<size_t>(kTaps - 1 - k) * Cout + c0) * Cin + ci0;
      load_rows<VEC>(ws, SA, TN, KC, kc, w, [&](int n) {
        return c0 + n < Cout ? wk + static_cast<size_t>(n) * Cin : nullptr;
      }, tid);
    } else {      // W[k][ci][co]: shared rows along Cin
      const float* wk = w + (static_cast<size_t>(k) * Cin + ci0) * Cout + c0;
      load_rows<VEC>(ws, SW, KC, TN, Cout - c0, w, [&](int r) {
        return r < kc ? wk + static_cast<size_t>(r) * Cout : nullptr;
      }, tid);
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

  const int gr = lane >> 2;   // mma group: fragment row / column
  const int tg = lane & 3;    // thread in group
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

    // the chunk's k-steps, unrolled (channels past Cin are zeros)
    const int buf = s % kStages;
    const float* a = s_a + (buf * kTV + warp * 32) * SA;
    const float* ws = s_w + buf * WT;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = a + (mt * 16 + gr) * SA + kk + tg;
        split_tf32(p[0], ah[mt][0], al[mt][0]);
        split_tf32(p[8 * SA], ah[mt][1], al[mt][1]);
        split_tf32(p[4], ah[mt][2], al[mt][2]);
        split_tf32(p[8 * SA + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B[kk + tg (+4)][nt * 8 + gr]
        const float* q = FLIP ? ws + (nt * 8 + gr) * SA + kk + tg : ws + (kk + tg) * SW + nt * 8 + gr;
        uint32_t bh[2], bl[2];
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[FLIP ? 4 : 4 * SW], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vv = v0 + warp * 32 + mt * 16 + gr + 8 * h;
      if (vv >= V) continue;
      float* ob = out + (static_cast<size_t>(b) * V + vv) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = c0 + nt * 8 + 2 * tg;
        if (co < Cout) ob[co] = acc[mt][nt][2 * h];
        if (co + 1 < Cout) ob[co + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// out[i] = sum over splits s of partial[s][i], in split order
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t n, int splits) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int s = 1; s < splits; ++s) acc += partial[static_cast<size_t>(s) * n + i];
    out[i] = acc;
  }
}

constexpr size_t smem_bytes(int TN, bool flip, int KC, int taps_per_split) {
  return sizeof(float) * kStages * (kTV * (KC + 4) + w_tile(TN, KC, flip)) +
         sizeof(int) * taps_per_split * kTV;
}

int grid_blocks(size_t n, int threads) {
  const size_t need = (n + threads - 1) / threads;
  return need > 4096 ? 4096 : static_cast<int>(need);
}

template <int TN, int VEC, bool FLIP, int KC>
cudaError_t launch(const float* feats, const int* nbr, const float* w, float* dst,
                   int B, int V, int Cin, int Cout, int splits, cudaStream_t stream) {
  // the largest dynamic shared memory any shape asks of this kernel, set
  // once (the attribute stays with the kernel)
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_conv_fwd_kernel<TN, VEC, FLIP, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(TN, FLIP, KC, kTaps)));
  if (attr != cudaSuccess) return attr;
  const int taps_per_split = (kTaps + splits - 1) / splits;
  dim3 grid((V + kTV - 1) / kTV, B, ((Cout + TN - 1) / TN) * splits);
  subm_conv_fwd_kernel<TN, VEC, FLIP, KC>
      <<<grid, kThreads, smem_bytes(TN, FLIP, KC, taps_per_split), stream>>>(
          feats, nbr, w, dst, V, Cin, Cout, taps_per_split);
  return cudaGetLastError();
}

template <int TN, int VEC, bool FLIP>
cudaError_t launch_kc(const float* feats, const int* nbr, const float* w, float* dst,
                      int B, int V, int Cin, int Cout, int splits, cudaStream_t s) {
  return chunk_channels(Cin) == 8
             ? launch<TN, VEC, FLIP, 8>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s)
             : launch<TN, VEC, FLIP, 16>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
}

template <int VEC, bool FLIP>
cudaError_t launch_vec(const float* feats, const int* nbr, const float* w, float* dst,
                       int B, int V, int Cin, int Cout, int splits, cudaStream_t s) {
  switch (tile_channels(Cout)) {
    case 8: return launch_kc<8, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 16: return launch_kc<16, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 24: return launch_kc<24, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 32: return launch_kc<32, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 40: return launch_kc<40, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 48: return launch_kc<48, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 56: return launch_kc<56, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    case 64: return launch_kc<64, VEC, FLIP>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of tap splits the launcher uses for this shape on a card with
// `sms` SMs (1 = no partial sums).  Pure: no CUDA call.
int gapartnet_subm_conv_splits(int B, int V, int Cout, int sms) {
  if (B <= 0 || V <= 0 || Cout <= 0 || sms <= 0) return 1;
  const int tc = tile_channels(Cout);
  const long long base = static_cast<long long>((V + kTV - 1) / kTV) * B * ((Cout + tc - 1) / tc);
  const long long target = static_cast<long long>(kBlocksPerSM) * sms;
  const long long want = (target + base - 1) / base;
  const int splits = want < 1 ? 1 : (want > kTaps ? kTaps : static_cast<int>(want));
  const int per = (kTaps + splits - 1) / splits;
  return (kTaps + per - 1) / per;   // no empty split
}

// Plain C launcher for ctypes, on the current device.  Launches on
// `stream` (PyTorch's current stream), does not synchronise and allocates
// nothing: `partial` is the caller's scratch of splits * B * V * Cout
// floats for `splits` > 1.  With `flip` it is the dgrad: `w` is the
// forward's (27, Cout, Cin) weight, read tap-reversed and transposed.
// Returns 0 (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_subm_conv_forward(const float* feats, const int* nbr, const float* w,
                                        float* out, float* partial, int B, int V, int Cin,
                                        int Cout, int splits, int flip, void* stream) {
  if (B <= 0 || V <= 0 || Cout <= 0) return cudaSuccess;
  if (Cin <= 0 || splits < 1 || splits > kTaps || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? partial : out;
  // 16-byte copies need 16-byte rows (x: Cin; W: Cout, or Cin for the
  // dgrad) and 16-byte aligned bases
  const bool wide = Cin % 4 == 0 && (flip || Cout % 4 == 0) &&
                    ((reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  cudaError_t err =
      flip ? (wide ? launch_vec<4, true>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s)
                   : launch_vec<1, true>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s))
           : (wide ? launch_vec<4, false>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s)
                   : launch_vec<1, false>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s));
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * V * Cout;
  sum_splits_kernel<<<grid_blocks(n, 256), 256, 0, s>>>(partial, out, n, splits);
  return cudaGetLastError();
}

const char* gapartnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
