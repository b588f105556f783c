// Native data-pipeline kernels for the GAPartNet host loader (the PyTorch
// port's copy of gapartnet_tpu/data/native/gapdata.cpp, identical below this
// note).
//
// The reference keeps its host-side hot loops in CUDA/C++ extensions
// (pointnet_lib FPS, sampling_gpu.cu:93-253) and a per-instance Python loop
// in the dataloader (dataset/gapartnet.py:145-176).  What remains host-side
// at training time is per-sample CPU work in dataloader workers.  This
// library implements those loops natively and is loaded via ctypes by
// gapartnet_tpu_torch/data/native_loader.py, which builds it at first use
// and raises if the build fails (no fallback).
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp -o libgapdata.so gapdata.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// Greedy furthest point sampling, seeded at index 0 (pointnet_lib
// furthest_point_sampling semantics).  xyz: (n, 3) row-major; out: (m,).
void fps_cpu(const float* xyz, int64_t n, int64_t m, int32_t* out) {
    if (n <= 0 || m <= 0) return;
    float* dists = new float[n];
    for (int64_t i = 0; i < n; ++i) dists[i] = std::numeric_limits<float>::max();
    int64_t last = 0;
    out[0] = 0;
    for (int64_t s = 1; s < m; ++s) {
        const float lx = xyz[3 * last], ly = xyz[3 * last + 1], lz = xyz[3 * last + 2];
        float best = -1.f;
        int64_t best_i = 0;
#pragma omp parallel
        {
            float tbest = -1.f;
            int64_t tbest_i = 0;
#pragma omp for nowait
            for (int64_t i = 0; i < n; ++i) {
                const float dx = xyz[3 * i] - lx;
                const float dy = xyz[3 * i + 1] - ly;
                const float dz = xyz[3 * i + 2] - lz;
                const float d = dx * dx + dy * dy + dz * dz;
                if (d < dists[i]) dists[i] = d;
                if (dists[i] > tbest) { tbest = dists[i]; tbest_i = i; }
            }
#pragma omp critical
            {
                // ties resolve to the lowest index to stay deterministic
                if (tbest > best || (tbest == best && tbest_i < best_i)) {
                    best = tbest;
                    best_i = tbest_i;
                }
            }
        }
        last = best_i;
        out[s] = static_cast<int32_t>(best_i);
    }
    delete[] dists;
}

// Per-point instance regions (mean/min/max of each point's instance) plus
// per-instance sizes and semantic labels (dataset/gapartnet.py:145-176).
// points: (n, >=3); instance_labels: (n,) with -100/-1 for none;
// regions: (n, 9) output; nppi: (max_inst,) output; isl: (max_inst,) output.
// Returns the number of instances found (label max + 1, clipped).
int32_t instance_info(
    const float* points, int64_t n, int64_t stride,
    const int32_t* sem_labels, const int32_t* instance_labels,
    int64_t max_inst,
    float* regions, int32_t* nppi, int32_t* isl) {
    int32_t num_inst = 0;
    for (int64_t i = 0; i < n; ++i)
        if (instance_labels[i] >= 0 && instance_labels[i] + 1 > num_inst)
            num_inst = instance_labels[i] + 1;
    if (num_inst > max_inst) num_inst = static_cast<int32_t>(max_inst);

    double* sums = new double[num_inst * 3]();
    float* mins = new float[num_inst * 3];
    float* maxs = new float[num_inst * 3];
    int64_t* first = new int64_t[num_inst];
    for (int32_t k = 0; k < num_inst; ++k) {
        first[k] = -1;
        for (int d = 0; d < 3; ++d) {
            mins[k * 3 + d] = std::numeric_limits<float>::max();
            maxs[k * 3 + d] = -std::numeric_limits<float>::max();
        }
        nppi[k] = 0;
        isl[k] = -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t lab = instance_labels[i];
        if (lab < 0 || lab >= num_inst) continue;
        nppi[lab]++;
        if (first[lab] < 0) { first[lab] = i; isl[lab] = sem_labels[i]; }
        for (int d = 0; d < 3; ++d) {
            const float v = points[i * stride + d];
            sums[lab * 3 + d] += v;
            if (v < mins[lab * 3 + d]) mins[lab * 3 + d] = v;
            if (v > maxs[lab * 3 + d]) maxs[lab * 3 + d] = v;
        }
    }
    std::memset(regions, 0, sizeof(float) * n * 9);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t lab = instance_labels[i];
        if (lab < 0 || lab >= num_inst) continue;
        for (int d = 0; d < 3; ++d) {
            regions[i * 9 + d] = static_cast<float>(sums[lab * 3 + d] / nppi[lab]);
            regions[i * 9 + 3 + d] = mins[lab * 3 + d];
            regions[i * 9 + 6 + d] = maxs[lab * 3 + d];
        }
    }
    delete[] sums; delete[] mins; delete[] maxs; delete[] first;
    return num_inst;
}

// In-place augmentation: points (n, c) row-major with xyz in cols 0..2 and
// colors in cols 3..c-1; m is the 3x3 position matrix (row-vector convention
// p' = p @ m, dataset/gapartnet.py:112-118); color_delta has c-3 entries.
void augment_points(float* points, int64_t n, int64_t c,
                    const float* m, const float* color_delta) {
#pragma omp parallel for
    for (int64_t i = 0; i < n; ++i) {
        float* p = points + i * c;
        const float x = p[0], y = p[1], z = p[2];
        p[0] = x * m[0] + y * m[3] + z * m[6];
        p[1] = x * m[1] + y * m[4] + z * m[7];
        p[2] = x * m[2] + y * m[5] + z * m[8];
        for (int64_t d = 3; d < c; ++d) p[d] += color_delta[d - 3];
    }
}

}  // extern "C"
