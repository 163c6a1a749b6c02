// Implicit surface reconstruction for arbitrary point clouds.
//
// Hoppe-style signed-distance reconstruction: oriented PCA normals,
// Gaussian-weighted projection onto nearest tangent planes on a uniform
// grid, marching-tetrahedra extraction (shared primitives in geom.h).
// One of three native reconstruction back ends (with poisson.cpp and
// bpa.cpp) covering the capability the reference gets from Open3D's
// create_from_point_cloud_poisson / ball-pivoting (reference
// backend/app.py:283-305). The depth-grid pipeline keeps its exact grid
// triangulation (pipeline/meshing.py); these handle clouds with no known
// topology — the v2 asset path and externally loaded clouds.
//
// C ABI for the ctypes binding in native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>

#include "geom.h"

using ipc::V3;

extern "C" {

// Reconstruct a triangle mesh from an arbitrary point cloud.
//   pts: (n, 3) float32; cols: (n, 3) uint8 (may be null)
//   depth: octree-style resolution exponent; grid res = 1<<depth,
//          clamped to [16, 192] (reference default Poisson depth=8)
//   orient_mode: 0 = normals outward from centroid (closed objects),
//                1 = normals toward the origin (camera-facing depth clouds)
// Outputs are allocated here; free with ipc_surface_release. Returns 0 on
// success, <0 on failure (too few points / degenerate bbox / no surface).
int32_t ipc_surface_reconstruct(const float* pts_in, const uint8_t* cols_in,
                                int64_t n, int32_t depth, int32_t orient_mode,
                                float** out_verts, uint8_t** out_cols,
                                int64_t* out_nv, int32_t** out_faces,
                                int64_t* out_nf) {
  *out_verts = nullptr;
  *out_cols = nullptr;
  *out_faces = nullptr;
  *out_nv = 0;
  *out_nf = 0;
  if (n < 16) return -1;
  const V3* pts = (const V3*)pts_in;

  // Bounding box, padded so the surface never clips the grid boundary.
  V3 lo = pts[0], hi = pts[0];
  for (int64_t i = 1; i < n; i++) {
    lo.x = std::min(lo.x, pts[i].x); hi.x = std::max(hi.x, pts[i].x);
    lo.y = std::min(lo.y, pts[i].y); hi.y = std::max(hi.y, pts[i].y);
    lo.z = std::min(lo.z, pts[i].z); hi.z = std::max(hi.z, pts[i].z);
  }
  V3 size = ipc::sub(hi, lo);
  float maxdim = std::max(size.x, std::max(size.y, size.z));
  if (maxdim <= 0) return -2;
  float pad = 0.06f * maxdim;
  lo = {lo.x - pad, lo.y - pad, lo.z - pad};
  hi = {hi.x + pad, hi.y + pad, hi.z + pad};
  size = ipc::sub(hi, lo);

  int res = 1 << std::min(std::max(depth, 4), 8);
  res = std::min(res, 192);
  float cell = std::max(size.x, std::max(size.y, size.z)) / (float)res;
  int nx = (int)std::ceil(size.x / cell) + 1;
  int ny = (int)std::ceil(size.y / cell) + 1;
  int nz = (int)std::ceil(size.z / cell) + 1;
  auto nidx = [&](int ix, int iy, int iz) -> int64_t {
    return ((int64_t)iz * ny + iy) * nx + ix;
  };

  // Hash the points at a cell size tied to sampling density so radius
  // queries stay O(1): target ~8 points per bucket.
  float hcell = std::max(cell, maxdim / std::cbrt((float)n) * 2.0f);
  ipc::HashGrid grid{hcell, lo, {}};
  grid.insert(pts, n);

  // Normals: PCA over neighbors within 1.5 hash cells (KDTree-hybrid
  // analog of reference estimate_normals, backend/app.py:283).
  std::vector<V3> normals(n);
  ipc::estimate_normals(pts, n, grid, hcell * 1.5f, orient_mode,
                        normals.data());

  // Signed distance on grid nodes near the cloud (sparse: only nodes
  // within the support radius of some point are "known").
  float R = 2.2f * std::max(cell, hcell * 0.5f);
  float sigma2 = (R * 0.5f) * (R * 0.5f);
  int64_t nn = (int64_t)nx * ny * nz;
  std::vector<float> fval(nn, 0.0f);
  std::vector<float> wsum(nn, 0.0f);
  int span = (int)std::ceil(R / cell);
  for (int64_t i = 0; i < n; i++) {
    int ix0 = (int)std::floor((pts[i].x - lo.x) / cell);
    int iy0 = (int)std::floor((pts[i].y - lo.y) / cell);
    int iz0 = (int)std::floor((pts[i].z - lo.z) / cell);
    for (int dz = -span; dz <= span + 1; dz++) {
      int iz = iz0 + dz;
      if (iz < 0 || iz >= nz) continue;
      for (int dy = -span; dy <= span + 1; dy++) {
        int iy = iy0 + dy;
        if (iy < 0 || iy >= ny) continue;
        for (int dx = -span; dx <= span + 1; dx++) {
          int ix = ix0 + dx;
          if (ix < 0 || ix >= nx) continue;
          V3 node = {lo.x + ix * cell, lo.y + iy * cell, lo.z + iz * cell};
          V3 d = ipc::sub(node, pts[i]);
          float d2 = ipc::dot(d, d);
          if (d2 > R * R) continue;
          float w = std::exp(-d2 / sigma2);
          int64_t id = nidx(ix, iy, iz);
          fval[id] += w * ipc::dot(d, normals[i]);
          wsum[id] += w;
        }
      }
    }
  }
  const float WMIN = 1e-4f;
  std::vector<uint8_t> known(nn, 0);
  for (int64_t i = 0; i < nn; i++) {
    if (wsum[i] > WMIN) {
      fval[i] /= wsum[i];
      known[i] = 1;
    }
  }

  ipc::TetMesher mesher;
  mesher.run(fval.data(), known.data(), nx, ny, nz, lo, cell, 0.0f);
  int64_t nv = (int64_t)(mesher.verts.size() / 3);
  int64_t nf = (int64_t)(mesher.faces.size() / 3);
  if (nf == 0) return -3;
  mesher.fix_winding();

  uint8_t* vcols = new uint8_t[nv * 3];
  ipc::nearest_colors(mesher.verts, pts, cols_in, grid, vcols);

  float* v_out = new float[mesher.verts.size()];
  std::memcpy(v_out, mesher.verts.data(), mesher.verts.size() * sizeof(float));
  int32_t* f_out = new int32_t[mesher.faces.size()];
  std::memcpy(f_out, mesher.faces.data(),
              mesher.faces.size() * sizeof(int32_t));
  *out_verts = v_out;
  *out_cols = vcols;
  *out_faces = f_out;
  *out_nv = nv;
  *out_nf = nf;
  return 0;
}

void ipc_surface_release(float* verts, uint8_t* cols, int32_t* faces) {
  delete[] verts;
  delete[] cols;
  delete[] faces;
}

}  // extern "C"
