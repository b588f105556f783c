// Submanifold 3x3x3 sparse convolution, forward, for NVIDIA Hopper (sm_90a).
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
// sparse_conv.py:294-295): the wrapper launches it on the output gradient
// with flip(W, 0) transposed, so Cin and Cout swap (outputs up to 192 wide,
// the 64-wide channel tiles below).  Its bound is the forward's: the same
// neighbour pairs at 2 * Cin * Cout FLOP each.
//
// What bounds it on this card: for the backbone's shapes it is a
// gather-GEMM with K = 27 * Cin.  One level-0 16->16 conv at V = 20000 is
// 0.28 GFLOP (dense 27 taps) against about 4.7 MB of compulsory traffic, so
// with fp32 FMA on CUDA cores (TF32 off) it is compute-bound: 67 TFLOP/s
// fp32 on an H100 SXM puts the floor of all 53 backbone convs near 0.38 ms
// at the default capacities.  chip_smoke.py recomputes the bound from the
// neighbour pairs that exist in the run's data.
//
// Design (simple and correct first):
//   * one block owns a tile of TV = 64 output voxels and TC output channels
//     (TC = Cout rounded up to a multiple of 16, up to 112; wider Cout is
//     split over blockIdx.z in tiles of 64); B rides blockIdx.y;
//   * for each of its taps, the block loads the tile's neighbour indices
//     into shared memory and skips the tap when none exists (a block-wide
//     vote), then walks Cin in chunks of CK = 32: it gathers the tile's
//     neighbour rows into shared memory (zeros where nbr = -1 or past Cin)
//     and stages the matching W[k] chunk;
//   * each thread owns a 4 x 4 register tile of outputs and accumulates in
//     fp32 in a fixed order (tap, then input channel), with no atomics;
//   * small grids (the deep levels hold 128-4480 voxels, i.e. 2-70 tiles)
//     would leave most SMs idle while each block walks all 27 taps in
//     series, so the taps are split over blockIdx.z until the grid holds
//     about four blocks per SM: each split writes its partial sum to a
//     scratch buffer and a second kernel adds the partials in split order.
//     Both passes run in a fixed order, so results stay deterministic;
//   * ragged edges (V, Cin, Cout) are masked in the kernel.
// What a later change would do: tensor cores through TF32 or bf16
// mma.sync / wgmma, cp.async gathers double-buffered against the math, and
// one persistent launch for all taps of the small deep levels.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 27;
constexpr int kRV = 4;            // voxels per thread
constexpr int kRC = 4;            // output channels per thread
constexpr int kTY = 16;           // thread rows along voxels
constexpr int kTV = kTY * kRV;    // voxels per block
constexpr int kCK = 32;           // input channels per shared-memory stage
constexpr int kBlocksPerSM = 4;   // split taps until the grid holds this many

int tile_channels(int Cout) { return Cout > 112 ? 64 : ((Cout + 15) / 16) * 16; }

template <int TC>
__global__ void __launch_bounds__((TC / kRC) * kTY)
subm_conv_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ nbr,
                     const float* __restrict__ w,
                     float* __restrict__ out,
                     int V, int Cin, int Cout, int taps_per_split) {
  constexpr int kTX = TC / kRC;
  constexpr int kThreads = kTX * kTY;
  __shared__ int s_nbr[kTV];
  __shared__ float s_x[kTV][kCK];
  __shared__ float s_w[kCK][TC];

  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTV;
  const int ctiles = (Cout + TC - 1) / TC;
  const int split = blockIdx.z / ctiles;
  const int c0 = (blockIdx.z % ctiles) * TC;
  const int k_begin = split * taps_per_split;
  const int k_end = min(kTaps, k_begin + taps_per_split);
  // split s writes its partial sum to slice s of `out` (B, V, Cout each)
  out += static_cast<size_t>(split) * gridDim.y * V * Cout;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const float* fb = feats + static_cast<size_t>(b) * V * Cin;
  const int* nb = nbr + static_cast<size_t>(b) * kTaps * V;

  float acc[kRV][kRC];
#pragma unroll
  for (int i = 0; i < kRV; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    int present = 0;
    if (tid < kTV) {
      const int v = v0 + tid;
      const int src = v < V ? nb[static_cast<size_t>(k) * V + v] : -1;
      s_nbr[tid] = src;
      present = src >= 0;
    }
    // barrier + vote: s_nbr is visible to all, and a tap with no neighbour
    // in this tile adds nothing, so every thread skips it together
    if (!__syncthreads_or(present)) continue;

    for (int ci0 = 0; ci0 < Cin; ci0 += kCK) {
      for (int e = tid; e < kTV * kCK; e += kThreads) {
        const int r = e / kCK;
        const int c = e % kCK;
        const int src = s_nbr[r];
        const int ci = ci0 + c;
        s_x[r][c] = (src >= 0 && ci < Cin)
                        ? fb[static_cast<size_t>(src) * Cin + ci] : 0.f;
      }
      for (int e = tid; e < kCK * TC; e += kThreads) {
        const int r = e / TC;
        const int c = e % TC;
        const int ci = ci0 + r;
        const int co = c0 + c;
        s_w[r][c] = (ci < Cin && co < Cout)
                        ? w[(static_cast<size_t>(k) * Cin + ci) * Cout + co] : 0.f;
      }
      __syncthreads();
      const int cn = min(kCK, Cin - ci0);
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        float xv[kRV];
        float wv[kRC];
#pragma unroll
        for (int i = 0; i < kRV; ++i) xv[i] = s_x[ty + kTY * i][c];
#pragma unroll
        for (int j = 0; j < kRC; ++j) wv[j] = s_w[c][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kRV; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
      // the next chunk (or the next tap's s_nbr) overwrites shared memory
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kRV; ++i) {
    const int v = v0 + ty + kTY * i;
    if (v >= V) continue;
    float* ob = out + (static_cast<size_t>(b) * V + v) * Cout;
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      const int co = c0 + tx + kTX * j;
      if (co < Cout) ob[co] = acc[i][j];
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

template <int TC>
cudaError_t launch(const float* feats, const int* nbr, const float* w, float* dst,
                   int B, int V, int Cin, int Cout, int splits, cudaStream_t stream) {
  const int taps_per_split = (kTaps + splits - 1) / splits;
  dim3 grid((V + kTV - 1) / kTV, B, ((Cout + TC - 1) / TC) * splits);
  dim3 block((TC / kRC) * kTY);
  subm_conv_fwd_kernel<TC><<<grid, block, 0, stream>>>(
      feats, nbr, w, dst, V, Cin, Cout, taps_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of tap splits the launcher uses for this shape (1 = no scratch).
// The caller allocates a scratch buffer of splits * B * V * Cout floats
// when it is above 1.
int gapartnet_subm_conv_splits(int B, int V, int Cout, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (B <= 0 || V <= 0 || Cout <= 0) return 1;
  const int tc = tile_channels(Cout);
  const long long base = static_cast<long long>((V + kTV - 1) / kTV) * B * ((Cout + tc - 1) / tc);
  const long long target = static_cast<long long>(kBlocksPerSM) * sms;
  const long long want = (target + base - 1) / base;
  const int splits = want < 1 ? 1 : (want > kTaps ? kTaps : static_cast<int>(want));
  const int per = (kTaps + splits - 1) / splits;
  return (kTaps + per - 1) / per;   // no empty split
}

// Plain C launcher for ctypes.  Launches on `stream` (PyTorch's current
// stream), does not synchronise and allocates nothing: `partial` is the
// caller's scratch for `splits` > 1 (see gapartnet_subm_conv_splits).
// Returns the launch status: 0 (cudaSuccess) or the CUDA error code.
cudaError_t gapartnet_subm_conv_forward(const float* feats, const int* nbr,
                                        const float* w, float* out, float* partial,
                                        int B, int V, int Cin, int Cout, int splits,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || V <= 0 || Cout <= 0) return cudaSuccess;
  if (Cin <= 0 || splits < 1 || splits > kTaps || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? partial : out;
  switch (tile_channels(Cout)) {
    case 16: err = launch<16>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 32: err = launch<32>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 48: err = launch<48>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 64: err = launch<64>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 80: err = launch<80>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 96: err = launch<96>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    case 112: err = launch<112>(feats, nbr, w, dst, B, V, Cin, Cout, splits, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * V * Cout;
  const int threads = 256;
  const size_t need = (n + threads - 1) / threads;
  const int blocks = need > 4096 ? 4096 : static_cast<int>(need);
  sum_splits_kernel<<<blocks, threads, 0, s>>>(partial, out, n, splits);
  return cudaGetLastError();
}

const char* gapartnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
