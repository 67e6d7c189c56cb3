// vulkan-forge (JAX rebuild): native host runtime core.
//
// The reference keeps its host runtime in native code (Rust: grid meshing
// src/terrain/mesh.rs, DEM statistics src/lib.rs:905-932 /
// src/terrain_stats.rs). This C++ core is this rebuild's equivalent for
// those CPU-side hot paths; the compute path (rasterization/shading) lives
// on the device in JAX/Pallas, and PNGs are encoded by the standard
// library (vulkan_forge/_io.py).
//
// Exposed through ctypes (see vulkan_forge/_native/__init__.py); every entry
// point has a NumPy fallback, so this library is a fast path, not a hard
// dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// Centered grid mesh, parity with make_grid (src/terrain/mesh.rs:35-90):
// xy[i] = (x*dx - cx, y*dy - cy), uv in [0,1]^2, CCW cell indices
// [i0, i1, i2, i2, i1, i3]. Output buffers are caller-allocated:
// xy/uv: nx*nz*2 floats, idx: (nx-1)*(nz-1)*6 uint32.
void vf_grid_generate(int32_t nx, int32_t nz, float dx, float dy,
                      float* xy, float* uv, uint32_t* idx) {
    const float cx = (static_cast<float>(nx) - 1.0f) * 0.5f * dx;
    const float cy = (static_cast<float>(nz) - 1.0f) * 0.5f * dy;
    // True f32 division (not reciprocal-multiply): keeps UVs bit-identical
    // to the reference's `x as f32 / (w as f32 - 1.0)` and the NumPy path.
    const float den_w = static_cast<float>(nx - 1);
    const float den_h = static_cast<float>(nz - 1);
    for (int32_t y = 0; y < nz; ++y) {
        const float wy = static_cast<float>(y) * dy - cy;
        const float v = static_cast<float>(y) / den_h;
        float* xyrow = xy + static_cast<int64_t>(y) * nx * 2;
        float* uvrow = uv + static_cast<int64_t>(y) * nx * 2;
        for (int32_t x = 0; x < nx; ++x) {
            xyrow[2 * x + 0] = static_cast<float>(x) * dx - cx;
            xyrow[2 * x + 1] = wy;
            uvrow[2 * x + 0] = static_cast<float>(x) / den_w;
            uvrow[2 * x + 1] = v;
        }
    }
    uint32_t* p = idx;
    for (int32_t y = 0; y < nz - 1; ++y) {
        const uint32_t row = static_cast<uint32_t>(y) * nx;
        for (int32_t x = 0; x < nx - 1; ++x) {
            const uint32_t i0 = row + x;
            const uint32_t i1 = row + x + 1;
            const uint32_t i2 = row + x + nx;
            const uint32_t i3 = row + x + nx + 1;
            *p++ = i0; *p++ = i1; *p++ = i2;
            *p++ = i2; *p++ = i1; *p++ = i3;
        }
    }
}

// Single-pass f32 min/max/mean + two-pass population std, matching
// dem_stats_from_slice (src/lib.rs:905-932). out = {min, max, mean, std}.
void vf_dem_stats(const float* h, int64_t n, float* out) {
    if (n <= 0) { out[0] = out[1] = out[2] = out[3] = 0.0f; return; }
    float mn = h[0], mx = h[0];
    double sum = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const float v = h[i];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
        sum += v;
    }
    const float mean = static_cast<float>(sum / static_cast<double>(n));
    double var = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double d = static_cast<double>(h[i]) - mean;
        var += d * d;
    }
    out[0] = mn;
    out[1] = mx;
    out[2] = mean;
    out[3] = static_cast<float>(std::sqrt(var / static_cast<double>(n)));
}

}  // extern "C"
