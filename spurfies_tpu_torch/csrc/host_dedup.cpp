// Greedy radius dedup of a point cloud, on the host: the DTU Chamfer
// protocol's 0.2 mm downsample of mesh samples (reference
// evals/eval_dtu.py:119-140).
//
// The port's own copy of spurfies_tpu's native greedy_radius
// (native/spurfies_io.cpp): point i is kept when no point kept before it
// lies within the radius (squared f32 distance < radius^2), the earlier
// points looked up in a hash of radius-sized cells. It runs in O(N) on
// millions of samples; the port's plain version (eval/chamfer.py) is a
// KD-tree loop. Built by the host compiler through ops/cuda_build.py at
// first use, with floating-point contraction off.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

inline int64_t cell_of(const float *p, const float *lo, float inv_cell,
                       int64_t dy, int64_t dz) {
    int64_t ix = (int64_t)std::floor((p[0] - lo[0]) * inv_cell);
    int64_t iy = (int64_t)std::floor((p[1] - lo[1]) * inv_cell);
    int64_t iz = (int64_t)std::floor((p[2] - lo[2]) * inv_cell);
    return (ix * dy + iy) * dz + iz;
}

}  // namespace

extern "C" {

// keep[i] = 1 if point i survives (first-come order). Returns 0.
int host_radius_dedup(const float *pts, int64_t n, float radius,
                      uint8_t *keep) {
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            float v = pts[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    }
    for (int d = 0; d < 3; ++d) lo[d] -= radius;
    float inv_cell = 1.0f / radius;
    int64_t dy = (int64_t)((hi[1] - lo[1]) * inv_cell) + 3;
    int64_t dz = (int64_t)((hi[2] - lo[2]) * inv_cell) + 3;
    float r2 = radius * radius;

    std::unordered_map<int64_t, std::vector<int64_t>> grid;
    grid.reserve((size_t)(n / 4 + 16));

    for (int64_t i = 0; i < n; ++i) {
        const float *p = pts + 3 * i;
        int64_t c = cell_of(p, lo, inv_cell, dy, dz);
        bool ok = true;
        for (int64_t ox = -1; ox <= 1 && ok; ++ox)
            for (int64_t oy = -1; oy <= 1 && ok; ++oy)
                for (int64_t oz = -1; oz <= 1 && ok; ++oz) {
                    auto it = grid.find(c + (ox * dy + oy) * dz + oz);
                    if (it == grid.end()) continue;
                    for (int64_t j : it->second) {
                        const float *q = pts + 3 * j;
                        float dx = p[0] - q[0], dyv = p[1] - q[1],
                              dzv = p[2] - q[2];
                        if (dx * dx + dyv * dyv + dzv * dzv < r2) {
                            ok = false;
                            break;
                        }
                    }
                }
        keep[i] = ok ? 1 : 0;
        if (ok) grid[c].push_back(i);
    }
    return 0;
}

}  // extern "C"
