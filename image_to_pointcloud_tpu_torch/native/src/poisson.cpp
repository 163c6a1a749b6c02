// Poisson surface reconstruction on a uniform grid.
//
// A genuine Poisson-equation reconstruction in the Kazhdan formulation
// (the algorithm behind Open3D's create_from_point_cloud_poisson used by
// the reference at backend/app.py:297-301): estimate oriented normals,
// splat the (inward) normal field V onto a cubic grid, solve the Poisson
// equation lap(chi) = div V with geometric multigrid (V-cycles, red-black
// Gauss-Seidel), pick the isovalue as the density-weighted mean of chi at
// the samples, then run a *screened* second solve that adds a data term
// pulling chi toward that isovalue at the samples (screened Poisson,
// Kazhdan & Hoppe 2013), and extract the isosurface with marching
// tetrahedra. The reference crops the Poisson mesh to the sample bounding
// box (backend/app.py:299-301); `crop=1` reproduces that by restricting
// extraction to nodes inside the sample bbox (+1 cell).
//
// depth follows the reference's octree-depth parameter: grid resolution
// = 1<<depth (default 8 -> 256^3), clamped to [16, 256].
//
// C ABI for the ctypes binding in native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>

#include "geom.h"

using ipc::V3;

namespace {

// Cubic node-centered multigrid level: (res+1)^3 nodes, spacing h.
struct Level {
  int res;       // cells per axis (power of two)
  float h;       // cell size
  std::vector<float> x, b, rho;  // solution, rhs, screening density
};

inline int64_t lidx(const Level& L, int i, int j, int k) {
  int64_t n = L.res + 1;
  return ((int64_t)k * n + j) * n + i;
}

// One red-black Gauss-Seidel sweep of (lap - alpha*rho) x = b with
// Dirichlet x=0 on the boundary.
void smooth(Level& L, float alpha) {
  int n = L.res + 1;
  float h2 = L.h * L.h;
  for (int color = 0; color < 2; color++) {
    for (int k = 1; k < n - 1; k++) {
      for (int j = 1; j < n - 1; j++) {
        int i0 = 1 + ((k + j + 1 + color) & 1);
        for (int i = i0; i < n - 1; i += 2) {
          int64_t id = lidx(L, i, j, k);
          float nb = L.x[id - 1] + L.x[id + 1] + L.x[id - n] + L.x[id + n] +
                     L.x[id - (int64_t)n * n] + L.x[id + (int64_t)n * n];
          float diag = 6.0f + h2 * alpha * L.rho[id];
          L.x[id] = (nb - h2 * L.b[id]) / diag;
        }
      }
    }
  }
}

// Residual r = b - A x (A = (lap - alpha*rho), lap with spacing h).
void residual(const Level& L, float alpha, std::vector<float>& r) {
  int n = L.res + 1;
  float inv_h2 = 1.0f / (L.h * L.h);
  std::fill(r.begin(), r.end(), 0.0f);
  for (int k = 1; k < n - 1; k++) {
    for (int j = 1; j < n - 1; j++) {
      for (int i = 1; i < n - 1; i++) {
        int64_t id = lidx(L, i, j, k);
        float lap = (L.x[id - 1] + L.x[id + 1] + L.x[id - n] + L.x[id + n] +
                     L.x[id - (int64_t)n * n] + L.x[id + (int64_t)n * n] -
                     6.0f * L.x[id]) * inv_h2;
        r[id] = L.b[id] - (lap - alpha * L.rho[id] * L.x[id]);
      }
    }
  }
}

// Restrict fine-grid values to the coarse grid (injection + 6-neighbor
// averaging; coarse node 2i aligns with fine node i).
void restrict_to(const std::vector<float>& fine, int fres,
                 std::vector<float>& coarse, int cres) {
  int fn = fres + 1;
  auto F = [&](int i, int j, int k) -> float {
    return fine[((int64_t)k * fn + j) * fn + i];
  };
  int cn = cres + 1;
  for (int k = 0; k < cn; k++) {
    for (int j = 0; j < cn; j++) {
      for (int i = 0; i < cn; i++) {
        int fi = 2 * i, fj = 2 * j, fk = 2 * k;
        float v = 2.0f * F(fi, fj, fk);
        float w = 2.0f;
        if (fi > 0) { v += F(fi - 1, fj, fk); w += 1; }
        if (fi < fn - 1) { v += F(fi + 1, fj, fk); w += 1; }
        if (fj > 0) { v += F(fi, fj - 1, fk); w += 1; }
        if (fj < fn - 1) { v += F(fi, fj + 1, fk); w += 1; }
        if (fk > 0) { v += F(fi, fj, fk - 1); w += 1; }
        if (fk < fn - 1) { v += F(fi, fj, fk + 1); w += 1; }
        coarse[((int64_t)k * cn + j) * cn + i] = v / w;
      }
    }
  }
}

// Add the trilinear prolongation of the coarse correction to the fine x.
void prolong_add(std::vector<float>& fine, int fres,
                 const std::vector<float>& coarse, int cres) {
  int fn = fres + 1, cn = cres + 1;
  auto C = [&](int i, int j, int k) -> float {
    return coarse[((int64_t)k * cn + j) * cn + i];
  };
  for (int k = 0; k < fn; k++) {
    int ck = k / 2; float tk = (k & 1) ? 0.5f : 0.0f;
    int ck1 = std::min(ck + 1, cn - 1);
    for (int j = 0; j < fn; j++) {
      int cj = j / 2; float tj = (j & 1) ? 0.5f : 0.0f;
      int cj1 = std::min(cj + 1, cn - 1);
      for (int i = 0; i < fn; i++) {
        int ci = i / 2; float ti = (i & 1) ? 0.5f : 0.0f;
        int ci1 = std::min(ci + 1, cn - 1);
        float c00 = C(ci, cj, ck) * (1 - ti) + C(ci1, cj, ck) * ti;
        float c10 = C(ci, cj1, ck) * (1 - ti) + C(ci1, cj1, ck) * ti;
        float c01 = C(ci, cj, ck1) * (1 - ti) + C(ci1, cj, ck1) * ti;
        float c11 = C(ci, cj1, ck1) * (1 - ti) + C(ci1, cj1, ck1) * ti;
        float v = (c00 * (1 - tj) + c10 * tj) * (1 - tk) +
                  (c01 * (1 - tj) + c11 * tj) * tk;
        fine[((int64_t)k * fn + j) * fn + i] += v;
      }
    }
  }
}

void vcycle(std::vector<Level>& levels, size_t l, float alpha) {
  Level& L = levels[l];
  if (l + 1 == levels.size() || L.res <= 4) {
    for (int s = 0; s < 40; s++) smooth(L, alpha);
    return;
  }
  for (int s = 0; s < 3; s++) smooth(L, alpha);
  std::vector<float> r(L.x.size());
  residual(L, alpha, r);
  Level& C = levels[l + 1];
  restrict_to(r, L.res, C.b, C.res);
  std::fill(C.x.begin(), C.x.end(), 0.0f);
  vcycle(levels, l + 1, alpha);
  prolong_add(L.x, L.res, C.x, C.res);
  for (int s = 0; s < 3; s++) smooth(L, alpha);
}

void solve_mg(std::vector<Level>& levels, float alpha, int cycles) {
  for (int c = 0; c < cycles; c++) vcycle(levels, 0, alpha);
}

}  // namespace

extern "C" {

// Poisson-reconstruct a triangle mesh from an arbitrary point cloud.
//   pts: (n, 3) float32; cols: (n, 3) uint8 (may be null)
//   depth: grid resolution exponent, res = 1<<depth in [16, 256]
//          (reference default depth=8, backend/app.py:297)
//   orient_mode: 0 = normals outward from centroid, 1 = toward origin
//   crop: 1 = restrict extraction to the sample bbox + 1 cell
//         (reference mesh.crop(bbox), backend/app.py:299-301)
//   screen_alpha: screening weight for the second (screened) solve;
//                 0 disables screening. Units: 1/length^2 scale applied
//                 relative to the grid; 4.0 is a good default.
// Outputs allocated here; free with ipc_surface_release. Returns 0 on
// success, <0 on failure.
int32_t ipc_poisson_reconstruct(const float* pts_in, const uint8_t* cols_in,
                                int64_t n, int32_t depth, int32_t orient_mode,
                                int32_t crop, float screen_alpha,
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

  V3 blo = pts[0], bhi = pts[0];
  for (int64_t i = 1; i < n; i++) {
    blo.x = std::min(blo.x, pts[i].x); bhi.x = std::max(bhi.x, pts[i].x);
    blo.y = std::min(blo.y, pts[i].y); bhi.y = std::max(bhi.y, pts[i].y);
    blo.z = std::min(blo.z, pts[i].z); bhi.z = std::max(bhi.z, pts[i].z);
  }
  V3 bsize = ipc::sub(bhi, blo);
  float maxdim = std::max(bsize.x, std::max(bsize.y, bsize.z));
  if (maxdim <= 0) return -2;

  // Cubic domain with 10% padding per side, centered on the cloud.
  float side = maxdim * 1.2f;
  V3 center = ipc::scale(ipc::add(blo, bhi), 0.5f);
  V3 lo = {center.x - side / 2, center.y - side / 2, center.z - side / 2};

  int res = 1;
  int d = std::min(std::max((int)depth, 4), 8);
  res = 1 << d;                      // 16 .. 256
  float cell = side / (float)res;
  int nnode = res + 1;
  int64_t nn = (int64_t)nnode * nnode * nnode;

  // Hash grid for normals and color lookup.
  float hcell = std::max(cell, maxdim / std::cbrt((float)n) * 2.0f);
  ipc::HashGrid grid{hcell, lo, {}};
  grid.insert(pts, n);
  std::vector<V3> normals(n);
  ipc::estimate_normals(pts, n, grid, hcell * 1.5f, orient_mode,
                        normals.data());

  // Splat the *inward* normal field V = -n and the sample density rho
  // onto grid nodes with trilinear weights; rhs b = div V. (grad of the
  // indicator points inward across the surface, so lap(chi) = div(-n)
  // makes chi ~ the indicator: ~1 inside, ~0 outside.)
  std::vector<float> Vx(nn, 0), Vy(nn, 0), Vz(nn, 0);
  std::vector<float> rho(nn, 0);
  auto node_id = [&](int i, int j, int k) -> int64_t {
    return ((int64_t)k * nnode + j) * nnode + i;
  };
  for (int64_t p = 0; p < n; p++) {
    float fx = (pts[p].x - lo.x) / cell;
    float fy = (pts[p].y - lo.y) / cell;
    float fz = (pts[p].z - lo.z) / cell;
    int i = (int)fx, j = (int)fy, k = (int)fz;
    if (i < 0 || j < 0 || k < 0 || i >= res || j >= res || k >= res) continue;
    float tx = fx - i, ty = fy - j, tz = fz - k;
    for (int dk = 0; dk < 2; dk++) {
      for (int dj = 0; dj < 2; dj++) {
        for (int di = 0; di < 2; di++) {
          float w = (di ? tx : 1 - tx) * (dj ? ty : 1 - ty) *
                    (dk ? tz : 1 - tz);
          int64_t id = node_id(i + di, j + dj, k + dk);
          Vx[id] -= w * normals[p].x;
          Vy[id] -= w * normals[p].y;
          Vz[id] -= w * normals[p].z;
          rho[id] += w;
        }
      }
    }
  }

  // Multigrid hierarchy down to 4^3.
  std::vector<Level> levels;
  for (int r = res; r >= 4; r /= 2) {
    Level L;
    L.res = r;
    L.h = side / (float)r;
    int64_t cnt = (int64_t)(r + 1) * (r + 1) * (r + 1);
    L.x.assign(cnt, 0.0f);
    L.b.assign(cnt, 0.0f);
    L.rho.assign(cnt, 0.0f);
    levels.push_back(std::move(L));
  }
  // b = div V (central differences; one-sided at the boundary is not
  // needed — splats never reach the boundary thanks to the padding).
  {
    Level& L0 = levels[0];
    float inv2h = 1.0f / (2.0f * cell);
    for (int k = 1; k < nnode - 1; k++) {
      for (int j = 1; j < nnode - 1; j++) {
        for (int i = 1; i < nnode - 1; i++) {
          int64_t id = node_id(i, j, k);
          float div = (Vx[node_id(i + 1, j, k)] - Vx[node_id(i - 1, j, k)] +
                       Vy[node_id(i, j + 1, k)] - Vy[node_id(i, j - 1, k)] +
                       Vz[node_id(i, j, k + 1)] - Vz[node_id(i, j, k - 1)]) *
                      inv2h;
          L0.b[id] = div;
        }
      }
    }
    Vx.clear(); Vx.shrink_to_fit();
    Vy.clear(); Vy.shrink_to_fit();
    Vz.clear(); Vz.shrink_to_fit();
  }

  // Pass 1: unscreened Poisson solve.
  solve_mg(levels, 0.0f, 6);

  // Isovalue: density-weighted mean of chi at the samples (Kazhdan).
  auto sample_chi = [&](const std::vector<float>& chi, V3 p) -> float {
    float fx = (p.x - lo.x) / cell, fy = (p.y - lo.y) / cell,
          fz = (p.z - lo.z) / cell;
    int i = (int)fx, j = (int)fy, k = (int)fz;
    i = std::min(std::max(i, 0), res - 1);
    j = std::min(std::max(j, 0), res - 1);
    k = std::min(std::max(k, 0), res - 1);
    float tx = fx - i, ty = fy - j, tz = fz - k;
    float acc = 0;
    for (int dk = 0; dk < 2; dk++)
      for (int dj = 0; dj < 2; dj++)
        for (int di = 0; di < 2; di++)
          acc += chi[node_id(i + di, j + dj, k + dk)] *
                 (di ? tx : 1 - tx) * (dj ? ty : 1 - ty) * (dk ? tz : 1 - tz);
    return acc;
  };
  double iso_acc = 0;
  for (int64_t p = 0; p < n; p++) iso_acc += sample_chi(levels[0].x, pts[p]);
  float isoval = (float)(iso_acc / (double)n);

  // Pass 2: screened solve — (lap - alpha*rho) chi = b - alpha*rho*iso
  // pulls chi toward the isovalue exactly at the samples, sharpening the
  // surface (screened Poisson, Kazhdan & Hoppe 2013). rho needs to live
  // on every level; scale alpha by 1/h^2-like factor via cell^-2 so the
  // data term competes with the Laplacian at the finest scale.
  if (screen_alpha > 0) {
    Level& L0 = levels[0];
    float a = screen_alpha / (cell * cell);
    for (int64_t i = 0; i < nn; i++) {
      L0.rho[i] = rho[i];
      L0.b[i] -= a * rho[i] * isoval;
    }
    for (size_t l = 1; l < levels.size(); l++) {
      restrict_to(levels[l - 1].rho, levels[l - 1].res, levels[l].rho,
                  levels[l].res);
    }
    // Warm-start from the unscreened solution.
    solve_mg(levels, a, 4);
    double iso2 = 0;
    for (int64_t p = 0; p < n; p++) iso2 += sample_chi(levels[0].x, pts[p]);
    isoval = (float)(iso2 / (double)n);
  }

  // Extraction field: g = -chi so "inside" (chi > iso) is negative, the
  // convention TetMesher's winding logic expects.
  std::vector<float> g(nn);
  for (int64_t i = 0; i < nn; i++) g[i] = -levels[0].x[i];

  std::vector<uint8_t> known;
  const uint8_t* known_ptr = nullptr;
  if (crop) {
    // Reference behavior: crop the Poisson mesh to the sample bounding
    // box (backend/app.py:299-301). Extraction only uses cubes whose 8
    // corners are known, so mark nodes inside bbox + 1 cell.
    known.assign(nn, 0);
    int i0 = std::max(0, (int)std::floor((blo.x - lo.x) / cell) - 1);
    int j0 = std::max(0, (int)std::floor((blo.y - lo.y) / cell) - 1);
    int k0 = std::max(0, (int)std::floor((blo.z - lo.z) / cell) - 1);
    int i1 = std::min(res, (int)std::ceil((bhi.x - lo.x) / cell) + 1);
    int j1 = std::min(res, (int)std::ceil((bhi.y - lo.y) / cell) + 1);
    int k1 = std::min(res, (int)std::ceil((bhi.z - lo.z) / cell) + 1);
    for (int k = k0; k <= k1; k++)
      for (int j = j0; j <= j1; j++)
        for (int i = i0; i <= i1; i++) known[node_id(i, j, k)] = 1;
    known_ptr = known.data();
  }

  ipc::TetMesher mesher;
  mesher.run(g.data(), known_ptr, nnode, nnode, nnode, lo, cell, -isoval);
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

}  // extern "C"
