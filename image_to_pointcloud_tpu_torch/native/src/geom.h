// Shared host-side geometry primitives for the native reconstruction
// modules (surface.cpp / bpa.cpp / poisson.cpp): small-vector math, a
// spatial hash grid, PCA normal estimation (the analog of Open3D's
// estimate_normals with KDTreeSearchParamHybrid, reference
// backend/app.py:283), and marching-tetrahedra isosurface extraction.
//
// Header-only; internal linkage so each TU stays self-contained.

#ifndef IPC_NATIVE_GEOM_H_
#define IPC_NATIVE_GEOM_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace ipc {

struct V3 {
  float x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float len(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalized(V3 a) {
  float l = len(a);
  return l > 1e-20f ? scale(a, 1.0f / l) : V3{0, 0, 1};
}

// Smallest-eigenvalue eigenvector of a symmetric 3x3 covariance via
// Jacobi rotation sweeps (robust for these tiny matrices).
// c = [xx, xy, xz, yy, yz, zz].
inline V3 smallest_eigvec(const double c[6]) {
  double a[3][3] = {{c[0], c[1], c[2]}, {c[1], c[3], c[4]}, {c[2], c[4], c[5]}};
  double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 12; sweep++) {
    double off = std::abs(a[0][1]) + std::abs(a[0][2]) + std::abs(a[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; p++) {
      for (int q = p + 1; q < 3; q++) {
        if (std::abs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::abs(theta) + std::sqrt(theta * theta + 1));
        double cs = 1 / std::sqrt(t * t + 1), sn = t * cs;
        for (int k = 0; k < 3; k++) {
          double akp = a[k][p], akq = a[k][q];
          a[k][p] = cs * akp - sn * akq;
          a[k][q] = sn * akp + cs * akq;
        }
        for (int k = 0; k < 3; k++) {
          double apk = a[p][k], aqk = a[q][k];
          a[p][k] = cs * apk - sn * aqk;
          a[q][k] = sn * apk + cs * aqk;
          double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = cs * vkp - sn * vkq;
          v[k][q] = sn * vkp + cs * vkq;
        }
      }
    }
  }
  int mi = 0;
  for (int i = 1; i < 3; i++) {
    if (a[i][i] < a[mi][mi]) mi = i;
  }
  return {(float)v[0][mi], (float)v[1][mi], (float)v[2][mi]};
}

// Spatial hash over cubic cells of size `cell`.
struct HashGrid {
  float cell;
  V3 origin;
  std::unordered_map<int64_t, std::vector<int32_t>> buckets;

  int64_t key(int ix, int iy, int iz) const {
    return ((int64_t)(ix & 0x1fffff) << 42) | ((int64_t)(iy & 0x1fffff) << 21) |
           (int64_t)(iz & 0x1fffff);
  }
  void insert(const V3* pts, int64_t n) {
    buckets.reserve(n / 2);
    for (int64_t i = 0; i < n; i++) {
      int ix = (int)std::floor((pts[i].x - origin.x) / cell);
      int iy = (int)std::floor((pts[i].y - origin.y) / cell);
      int iz = (int)std::floor((pts[i].z - origin.z) / cell);
      buckets[key(ix, iy, iz)].push_back((int32_t)i);
    }
  }
  // Visit every point index in the (2r+1)^3 cell neighborhood of p.
  template <typename F>
  void visit(V3 p, int r, F&& f) const {
    int ix = (int)std::floor((p.x - origin.x) / cell);
    int iy = (int)std::floor((p.y - origin.y) / cell);
    int iz = (int)std::floor((p.z - origin.z) / cell);
    for (int dz = -r; dz <= r; dz++) {
      for (int dy = -r; dy <= r; dy++) {
        for (int dx = -r; dx <= r; dx++) {
          auto it = buckets.find(key(ix + dx, iy + dy, iz + dz));
          if (it == buckets.end()) continue;
          for (int32_t idx : it->second) f(idx);
        }
      }
    }
  }
};

// Oriented PCA normals with hybrid (radius + neighbor-count floor)
// gathering, mirroring the role of Open3D estimate_normals
// (KDTreeSearchParamHybrid) in the reference pipeline.
//   orient_mode 0: outward from the cloud centroid (closed objects)
//   orient_mode 1: toward the origin (camera-facing depth clouds)
inline void estimate_normals(const V3* pts, int64_t n, const HashGrid& grid,
                             float radius, int orient_mode, V3* normals) {
  V3 centroid = {0, 0, 0};
  for (int64_t i = 0; i < n; i++) centroid = add(centroid, pts[i]);
  centroid = scale(centroid, 1.0f / (float)n);
  for (int64_t i = 0; i < n; i++) {
    double c[6] = {0, 0, 0, 0, 0, 0};
    double mean[3] = {0, 0, 0};
    int cnt = 0;
    float r = radius;
    for (int attempt = 0; attempt < 2 && cnt < 6; attempt++) {
      c[0] = c[1] = c[2] = c[3] = c[4] = c[5] = 0;
      mean[0] = mean[1] = mean[2] = 0;
      cnt = 0;
      int rr = (int)std::ceil(r / grid.cell);
      grid.visit(pts[i], rr, [&](int32_t j) {
        V3 d = sub(pts[j], pts[i]);
        if (dot(d, d) > r * r) return;
        mean[0] += pts[j].x;
        mean[1] += pts[j].y;
        mean[2] += pts[j].z;
        cnt++;
      });
      if (cnt >= 6) {
        mean[0] /= cnt;
        mean[1] /= cnt;
        mean[2] /= cnt;
        grid.visit(pts[i], rr, [&](int32_t j) {
          V3 d = sub(pts[j], pts[i]);
          if (dot(d, d) > r * r) return;
          double dx = pts[j].x - mean[0], dy = pts[j].y - mean[1],
                 dz = pts[j].z - mean[2];
          c[0] += dx * dx;
          c[1] += dx * dy;
          c[2] += dx * dz;
          c[3] += dy * dy;
          c[4] += dy * dz;
          c[5] += dz * dz;
        });
      }
      r *= 2.0f;
    }
    V3 nrm = cnt >= 6 ? smallest_eigvec(c) : V3{0, 0, 1};
    nrm = normalized(nrm);
    V3 ref = orient_mode == 1 ? V3{-pts[i].x, -pts[i].y, -pts[i].z}
                              : sub(pts[i], centroid);
    if (dot(nrm, ref) < 0) nrm = scale(nrm, -1.0f);
    normals[i] = nrm;
  }
}

// Marching tetrahedra over a dense scalar grid. Cubes whose 8 corners
// are all `known` are split into 6 tets around the main diagonal; shared
// tet faces make the extraction crack-free without case tables. Emits
// vertices on sign-crossing edges (cached per edge), a per-vertex
// inside-to-outside direction (for robust winding), and triangle
// indices. `fval` is indexed [iz*ny+iy]*nx+ix; isosurface at f==iso with
// f<iso counted as inside.
struct TetMesher {
  std::vector<float> verts;
  std::vector<float> outward;
  std::vector<int32_t> faces;
  std::unordered_map<int64_t, int32_t> edge_cache;

  void run(const float* fval, const uint8_t* known, int nx, int ny, int nz,
           V3 lo, float cell, float iso) {
    auto nidx = [&](int ix, int iy, int iz) -> int64_t {
      return ((int64_t)iz * ny + iy) * nx + ix;
    };
    auto edge_vertex = [&](int64_t na, int64_t nb, V3 pa, V3 pb, float fa,
                           float fb) -> int32_t {
      int64_t k = na < nb ? (na << 32) | nb : (nb << 32) | na;
      auto it = edge_cache.find(k);
      if (it != edge_cache.end()) return it->second;
      float t = (iso - fa) / (fb - fa);
      t = std::min(1.0f, std::max(0.0f, t));
      int32_t id = (int32_t)(verts.size() / 3);
      verts.push_back(pa.x + t * (pb.x - pa.x));
      verts.push_back(pa.y + t * (pb.y - pa.y));
      verts.push_back(pa.z + t * (pb.z - pa.z));
      V3 o = fa < fb ? sub(pb, pa) : sub(pa, pb);
      outward.push_back(o.x);
      outward.push_back(o.y);
      outward.push_back(o.z);
      edge_cache.emplace(k, id);
      return id;
    };
    static const int TETS[6][4] = {{0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
                                   {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7}};
    for (int iz = 0; iz < nz - 1; iz++) {
      for (int iy = 0; iy < ny - 1; iy++) {
        for (int ix = 0; ix < nx - 1; ix++) {
          int64_t corner[8];
          V3 cpos[8];
          float cf[8];
          bool ok = true;
          for (int k = 0; k < 8; k++) {
            int cx = ix + (k & 1), cy = iy + ((k >> 1) & 1), cz = iz + (k >> 2);
            corner[k] = nidx(cx, cy, cz);
            if (known && !known[corner[k]]) {
              ok = false;
              break;
            }
            cpos[k] = {lo.x + cx * cell, lo.y + cy * cell, lo.z + cz * cell};
            cf[k] = fval[corner[k]] - iso;
          }
          if (!ok) continue;
          for (const auto& tet : TETS) {
            int a = tet[0], b = tet[1], cc = tet[2], d = tet[3];
            int code = (cf[a] < 0) | ((cf[b] < 0) << 1) | ((cf[cc] < 0) << 2) |
                       ((cf[d] < 0) << 3);
            if (code == 0 || code == 15) continue;
            auto ev = [&](int u, int v) {
              // Pass raw (un-shifted) field values so the cached edge
              // vertex interpolates identically from either side.
              return edge_vertex(corner[u], corner[v], cpos[u], cpos[v],
                                 cf[u] + iso, cf[v] + iso);
            };
            int32_t t0, t1, t2, t3;
            switch (code) {
              case 1:  faces.insert(faces.end(), {ev(a,b), ev(a,cc), ev(a,d)}); break;
              case 2:  faces.insert(faces.end(), {ev(b,a), ev(b,d), ev(b,cc)}); break;
              case 4:  faces.insert(faces.end(), {ev(cc,a), ev(cc,b), ev(cc,d)}); break;
              case 8:  faces.insert(faces.end(), {ev(d,a), ev(d,cc), ev(d,b)}); break;
              case 14: faces.insert(faces.end(), {ev(a,b), ev(a,d), ev(a,cc)}); break;
              case 13: faces.insert(faces.end(), {ev(b,a), ev(b,cc), ev(b,d)}); break;
              case 11: faces.insert(faces.end(), {ev(cc,a), ev(cc,d), ev(cc,b)}); break;
              case 7:  faces.insert(faces.end(), {ev(d,a), ev(d,b), ev(d,cc)}); break;
              case 3:
                t0 = ev(a,cc); t1 = ev(a,d); t2 = ev(b,d); t3 = ev(b,cc);
                faces.insert(faces.end(), {t0, t1, t2, t0, t2, t3});
                break;
              case 12:
                t0 = ev(a,cc); t1 = ev(a,d); t2 = ev(b,d); t3 = ev(b,cc);
                faces.insert(faces.end(), {t0, t2, t1, t0, t3, t2});
                break;
              case 5:
                t0 = ev(a,b); t1 = ev(a,d); t2 = ev(cc,d); t3 = ev(cc,b);
                faces.insert(faces.end(), {t0, t2, t1, t0, t3, t2});
                break;
              case 10:
                t0 = ev(a,b); t1 = ev(a,d); t2 = ev(cc,d); t3 = ev(cc,b);
                faces.insert(faces.end(), {t0, t1, t2, t0, t2, t3});
                break;
              case 6:
                t0 = ev(b,a); t1 = ev(b,d); t2 = ev(cc,d); t3 = ev(cc,a);
                faces.insert(faces.end(), {t0, t1, t2, t0, t2, t3});
                break;
              case 9:
                t0 = ev(b,a); t1 = ev(b,d); t2 = ev(cc,d); t3 = ev(cc,a);
                faces.insert(faces.end(), {t0, t2, t1, t0, t3, t2});
                break;
            }
          }
        }
      }
    }
  }

  // Flip any triangle whose geometric normal points against the field's
  // outward direction at its vertices.
  void fix_winding() {
    int64_t nf = (int64_t)(faces.size() / 3);
    for (int64_t f = 0; f < nf; f++) {
      int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
      V3 pa = {verts[3 * a], verts[3 * a + 1], verts[3 * a + 2]};
      V3 pb = {verts[3 * b], verts[3 * b + 1], verts[3 * b + 2]};
      V3 pc = {verts[3 * c], verts[3 * c + 1], verts[3 * c + 2]};
      V3 nrm = cross(sub(pb, pa), sub(pc, pa));
      V3 o = {outward[3 * a] + outward[3 * b] + outward[3 * c],
              outward[3 * a + 1] + outward[3 * b + 1] + outward[3 * c + 1],
              outward[3 * a + 2] + outward[3 * b + 2] + outward[3 * c + 2]};
      if (dot(nrm, o) < 0) std::swap(faces[3 * f + 1], faces[3 * f + 2]);
    }
  }
};

// Per-vertex colors from the nearest input point (colors travel with
// geometry, as with Open3D's per-vertex colors after reconstruction).
inline void nearest_colors(const std::vector<float>& verts,
                           const V3* pts, const uint8_t* cols_in,
                           const HashGrid& grid, uint8_t* vcols) {
  int64_t nv = (int64_t)(verts.size() / 3);
  for (int64_t i = 0; i < nv; i++) {
    V3 p = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    float best = 1e30f;
    int32_t bi = -1;
    for (int r = 1; r <= 4 && bi < 0; r *= 2) {
      grid.visit(p, r, [&](int32_t j) {
        V3 d = sub(pts[j], p);
        float d2 = dot(d, d);
        if (d2 < best) {
          best = d2;
          bi = j;
        }
      });
    }
    if (bi >= 0 && cols_in) {
      vcols[3 * i] = cols_in[3 * bi];
      vcols[3 * i + 1] = cols_in[3 * bi + 1];
      vcols[3 * i + 2] = cols_in[3 * bi + 2];
    } else {
      vcols[3 * i] = vcols[3 * i + 1] = vcols[3 * i + 2] = 180;
    }
  }
}

}  // namespace ipc

#endif  // IPC_NATIVE_GEOM_H_
