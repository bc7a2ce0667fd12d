// Marching-tetrahedra isosurface extraction with vertex welding.
//
// Native (C++) fast path for point_slam_tpu.tools.marching — the analog of
// Open3D's C++ extract_triangle_mesh the reference relies on
// (src/tools/get_mesh_tsdf_fusion.py:345). Semantics mirror the numpy
// implementation exactly (same six tetrahedra sharing the 0-6 cell
// diagonal, same crossing-case tables, same interpolation / orientation /
// quantized welding rules) so the Python version doubles as the test
// oracle.
//
// Build: g++ -O3 -shared -fPIC marching.cpp -o libpsmarch.so
// ABI: plain C; caller frees returned buffers with ps_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

// Corner offsets of a cell (same order as tools/marching.py _CORNERS).
const int CORNERS[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                           {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

// Six tetrahedra sharing the 0-6 diagonal (_TETS).
const int TETS[6][4] = {{0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
                        {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};

// Per-case triangle tables: up to 2 triangles, each 3 edges (a, b) of
// tet-local vertex ids. Built identically to _build_case_tables().
struct CaseTable {
  int n_tris;
  int edges[2][3][2];  // [tri][edge][endpoint]
};

CaseTable CASES[16];

void build_cases() {
  for (int c = 0; c < 16; ++c) {
    bool inside[4];
    int ins[4], outs[4], ni = 0, no = 0;
    for (int i = 0; i < 4; ++i) {
      inside[i] = (c >> i) & 1;
      if (inside[i]) ins[ni++] = i; else outs[no++] = i;
    }
    CaseTable &t = CASES[c];
    t.n_tris = 0;
    if (ni == 1) {
      t.n_tris = 1;
      for (int e = 0; e < 3; ++e) {
        t.edges[0][e][0] = ins[0];
        t.edges[0][e][1] = outs[e];
      }
    } else if (ni == 3) {
      t.n_tris = 1;
      for (int e = 0; e < 3; ++e) {
        t.edges[0][e][0] = ins[e];
        t.edges[0][e][1] = outs[0];
      }
    } else if (ni == 2) {
      // quad = [(i1,o1),(i1,o2),(i2,o2),(i2,o1)]; tris (0,1,2),(0,2,3)
      int quad[4][2] = {{ins[0], outs[0]}, {ins[0], outs[1]},
                        {ins[1], outs[1]}, {ins[1], outs[0]}};
      t.n_tris = 2;
      const int tri_ids[2][3] = {{0, 1, 2}, {0, 2, 3}};
      for (int k = 0; k < 2; ++k)
        for (int e = 0; e < 3; ++e) {
          t.edges[k][e][0] = quad[tri_ids[k][e]][0];
          t.edges[k][e][1] = quad[tri_ids[k][e]][1];
        }
    }
  }
}

// Exact quantized triple as the weld key: a 64-bit hash alone would weld
// unrelated vertices on a (vanishingly rare but silent) collision; keeping
// the triple makes dedup exact like the numpy oracle, with the mix used
// only as the unordered_map hasher.
struct WeldKey {
  std::int64_t x, y, z;
  bool operator==(const WeldKey &o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct KeyHash {
  size_t operator()(const WeldKey &k) const {
    std::uint64_t h = (std::uint64_t)k.x;
    h = h * 0x9E3779B97F4A7C15ULL ^ (std::uint64_t)k.y;
    h = h * 0x9E3779B97F4A7C15ULL ^ (std::uint64_t)k.z;
    h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    return (size_t)h;
  }
};

inline WeldKey quant_key(const float p[3]) {
  // quantize to 1e-5 voxel (same as the numpy weld)
  return {(std::int64_t)llroundf(p[0] * 1e5f),
          (std::int64_t)llroundf(p[1] * 1e5f),
          (std::int64_t)llroundf(p[2] * 1e5f)};
}

}  // namespace

extern "C" {

void ps_free(void *p) { free(p); }

// Returns the number of faces; fills out buffers (malloc'd):
//   *out_verts: n_verts * 3 floats (world coords: *voxel + origin)
//   *out_faces: n_faces * 3 int32
//   *out_vcols: n_verts * 3 floats (only if color != nullptr)
// weight / color may be nullptr. sdf is C-order (nx, ny, nz).
long ps_marching_tetra(const float *sdf, const float *weight,
                       const float *color, long nx, long ny, long nz,
                       float iso, float ox, float oy, float oz, float voxel,
                       float **out_verts, int **out_faces, float **out_vcols,
                       long *n_verts_out) {
  static bool built = false;
  if (!built) { build_cases(); built = true; }
  *out_verts = nullptr; *out_faces = nullptr;
  if (out_vcols) *out_vcols = nullptr;
  *n_verts_out = 0;
  if (nx < 2 || ny < 2 || nz < 2) return 0;

  std::vector<float> verts;     // welded, voxel units
  std::vector<float> vcols;
  std::vector<int> faces;
  std::unordered_map<WeldKey, int, KeyHash> weld;
  weld.reserve(1 << 16);

  const long syx = ny * nz, sy = nz;
  auto sdf_at = [&](long x, long y, long z) {
    return sdf[x * syx + y * sy + z];
  };

  float cv[8];          // corner values
  float cpos[8][3];     // corner positions (voxel units)
  float ccol[8][3];

  for (long x = 0; x + 1 < nx; ++x)
    for (long y = 0; y + 1 < ny; ++y)
      for (long z = 0; z + 1 < nz; ++z) {
        float vmin = 1e30f, vmax = -1e30f;
        bool ok = true;
        for (int ci = 0; ci < 8; ++ci) {
          long cx = x + CORNERS[ci][0], cy = y + CORNERS[ci][1],
               cz = z + CORNERS[ci][2];
          float v = sdf_at(cx, cy, cz);
          cv[ci] = v;
          vmin = v < vmin ? v : vmin;
          vmax = v > vmax ? v : vmax;
          if (weight && !(weight[cx * syx + cy * sy + cz] > 0.f)) ok = false;
        }
        if (!ok || !(vmin < iso && vmax >= iso)) continue;
        for (int ci = 0; ci < 8; ++ci) {
          cpos[ci][0] = (float)(x + CORNERS[ci][0]);
          cpos[ci][1] = (float)(y + CORNERS[ci][1]);
          cpos[ci][2] = (float)(z + CORNERS[ci][2]);
          if (color) {
            long cx = x + CORNERS[ci][0], cy = y + CORNERS[ci][1],
                 cz = z + CORNERS[ci][2];
            const float *c = color + ((cx * syx + cy * sy + cz) * 3);
            ccol[ci][0] = c[0]; ccol[ci][1] = c[1]; ccol[ci][2] = c[2];
          }
        }
        for (int ti = 0; ti < 6; ++ti) {
          const int *tet = TETS[ti];
          int cse = 0;
          for (int i = 0; i < 4; ++i)
            if (cv[tet[i]] < iso) cse |= 1 << i;
          const CaseTable &tab = CASES[cse];
          if (!tab.n_tris) continue;

          // tet inside/outside centroids for outward orientation
          float mean_in[3] = {0, 0, 0}, mean_out[3] = {0, 0, 0};
          int n_in = 0, n_out = 0;
          for (int i = 0; i < 4; ++i) {
            const float *p = cpos[tet[i]];
            if (cv[tet[i]] < iso) {
              mean_in[0] += p[0]; mean_in[1] += p[1]; mean_in[2] += p[2];
              ++n_in;
            } else {
              mean_out[0] += p[0]; mean_out[1] += p[1]; mean_out[2] += p[2];
              ++n_out;
            }
          }
          float outward[3];
          for (int i = 0; i < 3; ++i)
            outward[i] = mean_out[i] / (n_out ? n_out : 1)
                       - mean_in[i] / (n_in ? n_in : 1);

          for (int k = 0; k < tab.n_tris; ++k) {
            float p[3][3], pc[3][3];
            for (int e = 0; e < 3; ++e) {
              int a = tab.edges[k][e][0], b = tab.edges[k][e][1];
              float va = cv[tet[a]], vb = cv[tet[b]];
              float den = vb - va;
              if (fabsf(den) < 1e-12f) den = 1e-12f;
              float t = (iso - va) / den;
              t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
              const float *pa = cpos[tet[a]], *pb = cpos[tet[b]];
              for (int i = 0; i < 3; ++i)
                p[e][i] = pa[i] + t * (pb[i] - pa[i]);
              if (color) {
                const float *ca = ccol[tet[a]], *cb = ccol[tet[b]];
                for (int i = 0; i < 3; ++i)
                  pc[e][i] = ca[i] + t * (cb[i] - ca[i]);
              }
            }
            // orient the triangle normal along `outward`
            float u[3], w[3], nrm[3];
            for (int i = 0; i < 3; ++i) {
              u[i] = p[1][i] - p[0][i];
              w[i] = p[2][i] - p[0][i];
            }
            nrm[0] = u[1] * w[2] - u[2] * w[1];
            nrm[1] = u[2] * w[0] - u[0] * w[2];
            nrm[2] = u[0] * w[1] - u[1] * w[0];
            bool flip = nrm[0] * outward[0] + nrm[1] * outward[1]
                      + nrm[2] * outward[2] < 0.f;
            int order[3] = {0, flip ? 2 : 1, flip ? 1 : 2};

            int fidx[3];
            for (int e = 0; e < 3; ++e) {
              const float *pt = p[order[e]];
              WeldKey key = quant_key(pt);
              auto it = weld.find(key);
              if (it == weld.end()) {
                int id = (int)(verts.size() / 3);
                weld.emplace(key, id);
                verts.push_back(pt[0]);
                verts.push_back(pt[1]);
                verts.push_back(pt[2]);
                if (color) {
                  const float *cc = pc[order[e]];
                  vcols.push_back(cc[0]);
                  vcols.push_back(cc[1]);
                  vcols.push_back(cc[2]);
                }
                fidx[e] = id;
              } else {
                fidx[e] = it->second;
              }
            }
            if (fidx[0] != fidx[1] && fidx[1] != fidx[2]
                && fidx[0] != fidx[2]) {
              faces.push_back(fidx[0]);
              faces.push_back(fidx[1]);
              faces.push_back(fidx[2]);
            }
          }
        }
      }

  long n_verts = (long)(verts.size() / 3);
  long n_faces = (long)(faces.size() / 3);
  *n_verts_out = n_verts;
  *out_verts = (float *)malloc(sizeof(float) * verts.size());
  for (size_t i = 0; i < verts.size(); i += 3) {
    (*out_verts)[i + 0] = verts[i + 0] * voxel + ox;
    (*out_verts)[i + 1] = verts[i + 1] * voxel + oy;
    (*out_verts)[i + 2] = verts[i + 2] * voxel + oz;
  }
  *out_faces = (int *)malloc(sizeof(int) * faces.size());
  memcpy(*out_faces, faces.data(), sizeof(int) * faces.size());
  if (color && out_vcols) {
    *out_vcols = (float *)malloc(sizeof(float) * vcols.size());
    memcpy(*out_vcols, vcols.data(), sizeof(float) * vcols.size());
  }
  return n_faces;
}

}  // extern "C"
