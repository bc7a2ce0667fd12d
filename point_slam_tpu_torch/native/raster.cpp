// Native mesh depth rasterizer (z-buffer) for reconstruction evaluation.
//
// Replaces the Open3D offscreen visualizer the reference uses for its
// virtual-view depth-L1 metric (src/tools/eval_recon.py:110-161). Camera
// convention matches the framework: x right, y up, z backward; a pixel
// (i, j) views along [(i-cx)/fx, -(j-cy)/fy, -1]; output depth is the
// camera-space z-depth (-z), 0 where nothing projects.
//
// Build: g++ -O3 -march=native -shared -fPIC raster.cpp -o libpsraster.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// verts: (n_verts, 3) float32, faces: (n_faces, 3) int32,
// w2c: 4x4 row-major float32, out_depth: H*W float32 (overwritten).
void rasterize_depth(const float* verts, int64_t n_verts,
                     const int32_t* faces, int64_t n_faces,
                     const float* w2c, float fx, float fy, float cx, float cy,
                     int32_t H, int32_t W, float z_far, float* out_depth) {
    std::fill(out_depth, out_depth + (int64_t)H * W, 0.0f);

    // transform all vertices to camera space once
    float* cam = new float[n_verts * 3];
    for (int64_t i = 0; i < n_verts; ++i) {
        const float* v = verts + 3 * i;
        for (int r = 0; r < 3; ++r) {
            cam[3 * i + r] = w2c[4 * r + 0] * v[0] + w2c[4 * r + 1] * v[1] +
                             w2c[4 * r + 2] * v[2] + w2c[4 * r + 3];
        }
    }

    const float eps = 1e-6f;
    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t* tri = faces + 3 * f;
        float px[3], py[3], pz[3];
        bool ok = true;
        for (int k = 0; k < 3; ++k) {
            const float* c = cam + 3 * tri[k];
            float z = -c[2];  // depth along the viewing direction
            if (z <= eps || z > z_far) { ok = false; break; }
            px[k] = fx * c[0] / z + cx;
            py[k] = -fy * c[1] / z + cy;
            pz[k] = z;
        }
        if (!ok) continue;  // near/far-plane triangles skipped (no clipping)

        int x0 = std::max(0, (int)std::floor(std::min({px[0], px[1], px[2]})));
        int x1 = std::min(W - 1, (int)std::ceil(std::max({px[0], px[1], px[2]})));
        int y0 = std::max(0, (int)std::floor(std::min({py[0], py[1], py[2]})));
        int y1 = std::min(H - 1, (int)std::ceil(std::max({py[0], py[1], py[2]})));
        if (x0 > x1 || y0 > y1) continue;

        float d01x = px[1] - px[0], d01y = py[1] - py[0];
        float d02x = px[2] - px[0], d02y = py[2] - py[0];
        float det = d01x * d02y - d01y * d02x;
        if (std::fabs(det) < 1e-12f) continue;
        float inv_det = 1.0f / det;
        // interpolate 1/z for perspective-correct depth
        float iz0 = 1.0f / pz[0], iz1 = 1.0f / pz[1], iz2 = 1.0f / pz[2];

        for (int y = y0; y <= y1; ++y) {
            for (int x = x0; x <= x1; ++x) {
                float ex = (float)x - px[0];
                float ey = (float)y - py[0];
                float b1 = (ex * d02y - ey * d02x) * inv_det;
                float b2 = (d01x * ey - d01y * ex) * inv_det;
                float b0 = 1.0f - b1 - b2;
                if (b0 < -1e-6f || b1 < -1e-6f || b2 < -1e-6f) continue;
                float iz = b0 * iz0 + b1 * iz1 + b2 * iz2;
                float z = 1.0f / iz;
                float* dst = out_depth + (int64_t)y * W + x;
                if (*dst == 0.0f || z < *dst) *dst = z;
            }
        }
    }
    delete[] cam;
}

// Frustum visibility counts for mesh culling (src/tools/cull_mesh.py):
// marks points that fall inside any of the provided camera frustums.
void points_in_any_frustum(const float* pts, int64_t n_pts,
                           const float* w2c_list, int64_t n_cams,
                           float fx, float fy, float cx, float cy,
                           int32_t H, int32_t W,
                           uint8_t* out_mask) {
    std::memset(out_mask, 0, n_pts);
    for (int64_t c = 0; c < n_cams; ++c) {
        const float* m = w2c_list + 16 * c;
        for (int64_t i = 0; i < n_pts; ++i) {
            if (out_mask[i]) continue;
            const float* p = pts + 3 * i;
            float xc = m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3];
            float yc = m[4] * p[0] + m[5] * p[1] + m[6] * p[2] + m[7];
            float zc = m[8] * p[0] + m[9] * p[1] + m[10] * p[2] + m[11];
            float z = -zc;
            if (z <= 0.0f) continue;
            float u = fx * xc / z + cx;
            float v = -fy * yc / z + cy;
            if (u >= 0 && u < W && v >= 0 && v < H) out_mask[i] = 1;
        }
    }
}

}  // extern "C"
