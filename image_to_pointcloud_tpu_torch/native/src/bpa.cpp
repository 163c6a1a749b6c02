// Ball-pivoting surface reconstruction (Bernardini et al. 1999).
//
// The real BPA behind Open3D's create_from_point_cloud_ball_pivoting,
// which the reference offers as the "bpa" meshing method with radii
// derived from the mean nearest-neighbor distance x {1.5, 2.0, 2.5}
// (reference backend/app.py:285-294). Mesh vertices are the input points
// themselves (BPA interpolates the samples); faces index into the input
// cloud, so colors travel with the points untouched.
//
// Multi-radius: the pivot front runs to exhaustion at each radius in
// ascending order; edges that fail to pivot at radius r_i are revived as
// candidates at r_{i+1} (Open3D semantics for a DoubleVector of radii).
//
// C ABI for the ctypes binding in native/__init__.py.

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

#include "geom.h"

using ipc::V3;

namespace {

constexpr float kPi = 3.14159265358979323846f;

// Undirected edge key.
inline uint64_t ekey(int32_t a, int32_t b) {
  uint32_t lo = (uint32_t)std::min(a, b), hi = (uint32_t)std::max(a, b);
  return ((uint64_t)hi << 32) | lo;
}

struct FrontEdge {
  int32_t i, j;   // directed: the existing triangle is (j, i, opposite)
  int32_t opp;    // opposite vertex of the existing triangle
  V3 center;      // ball center resting on (i, j, opp)
};

// Center of the radius-r ball through p0,p1,p2 on the side of `side`
// (unit vector; the center goes to the halfspace it points into).
// Returns false if the circumradius exceeds r or the triangle is
// degenerate.
bool ball_center(V3 p0, V3 p1, V3 p2, float r, V3 side, V3* out) {
  V3 e1 = ipc::sub(p1, p0), e2 = ipc::sub(p2, p0);
  V3 nrm = ipc::cross(e1, e2);
  float nn2 = ipc::dot(nrm, nrm);
  if (nn2 < 1e-20f) return false;
  // Circumcenter via the standard perpendicular-bisector formula.
  float e1l2 = ipc::dot(e1, e1), e2l2 = ipc::dot(e2, e2);
  V3 a = ipc::cross(ipc::sub(ipc::scale(e2, e1l2), ipc::scale(e1, e2l2)), nrm);
  V3 cc = ipc::add(p0, ipc::scale(a, 0.5f / nn2));
  float rc2 = ipc::dot(ipc::sub(cc, p0), ipc::sub(cc, p0));
  float h2 = r * r - rc2;
  if (h2 <= 0) return false;
  V3 un = ipc::normalized(nrm);
  if (ipc::dot(un, side) < 0) un = ipc::scale(un, -1.0f);
  *out = ipc::add(cc, ipc::scale(un, std::sqrt(h2)));
  return true;
}

struct BPA {
  const V3* pts;
  int64_t n;
  const V3* normals;
  ipc::HashGrid grid;
  float r;                                      // current radius
  std::deque<FrontEdge> front;
  std::vector<FrontEdge> boundary;              // failed pivots (revive at next r)
  std::unordered_map<uint64_t, uint8_t> edge_tris;  // triangles per edge
  std::vector<uint8_t> used;                    // vertex is in the mesh
  std::vector<int32_t> faces;

  // Points strictly inside the ball at c other than the three touching.
  bool ball_empty(V3 c, int32_t a, int32_t b, int32_t v) const {
    float lim = r * r * (1.0f - 1e-5f);
    bool empty = true;
    int rr = (int)std::ceil(r / grid.cell);
    grid.visit(c, rr, [&](int32_t k) {
      if (!empty || k == a || k == b || k == v) return;
      V3 d = ipc::sub(pts[k], c);
      if (ipc::dot(d, d) < lim) empty = false;
    });
    return empty;
  }

  void add_triangle(int32_t t0, int32_t t1, int32_t t2, V3 center) {
    faces.insert(faces.end(), {t0, t1, t2});
    used[t0] = used[t1] = used[t2] = 1;
    const int32_t vs[3][2] = {{t0, t1}, {t1, t2}, {t2, t0}};
    for (auto& e : vs) {
      uint8_t& cnt = edge_tris[ekey(e[0], e[1])];
      cnt++;
      if (cnt == 1) {
        // New front edge; opposite = the third vertex of this triangle.
        int32_t opp = t0 + t1 + t2 - e[0] - e[1];
        front.push_back({e[0], e[1], opp, center});
      }
      // cnt==2: the edge just became interior — its lazy front entries
      // will be skipped on pop.
    }
  }

  // Pivot the ball around front edge (i, j): find the candidate vertex
  // hit first when rotating the center away from the current triangle.
  // Returns the winning vertex (or -1) and its ball center.
  int32_t pivot(const FrontEdge& e, V3* out_center) const {
    V3 pi = pts[e.i], pj = pts[e.j];
    V3 m = ipc::scale(ipc::add(pi, pj), 0.5f);
    V3 axis = ipc::normalized(ipc::sub(pj, pi));
    V3 u0 = ipc::sub(e.center, m);
    u0 = ipc::sub(u0, ipc::scale(axis, ipc::dot(u0, axis)));
    float best_theta = 2.0f * kPi + 1.0f;
    int32_t best = -1;
    V3 best_c{0, 0, 0};
    int rr = (int)std::ceil(2.0f * r / grid.cell);
    // The triangle's outward side: average of the edge endpoints' normals
    // (the new ball must rest on the oriented surface side).
    V3 side = ipc::normalized(ipc::add(normals[e.i], normals[e.j]));
    grid.visit(m, rr, [&](int32_t v) {
      if (v == e.i || v == e.j || v == e.opp) return;
      V3 d = ipc::sub(pts[v], m);
      if (ipc::dot(d, d) > 4.0f * r * r) return;
      // Surface-orientation compatibility: the new triangle (j, i, v)
      // must face the same way as the vertex normal at v.
      V3 tn = ipc::cross(ipc::sub(pi, pj), ipc::sub(pts[v], pj));
      if (ipc::dot(tn, normals[v]) <= 0) return;
      // An edge already shared by two triangles cannot take a third.
      auto it1 = edge_tris.find(ekey(e.i, v));
      if (it1 != edge_tris.end() && it1->second >= 2) return;
      auto it2 = edge_tris.find(ekey(e.j, v));
      if (it2 != edge_tris.end() && it2->second >= 2) return;
      V3 c;
      if (!ball_center(pi, pj, pts[v], r, side, &c)) return;
      if (!ball_empty(c, e.i, e.j, v)) return;
      // Rotation angle of the center around the edge axis, measured from
      // the current position in the direction away from the triangle.
      V3 u1 = ipc::sub(c, m);
      u1 = ipc::sub(u1, ipc::scale(axis, ipc::dot(u1, axis)));
      float theta = std::atan2(ipc::dot(ipc::cross(u0, u1), axis),
                               ipc::dot(u0, u1));
      if (theta < 1e-6f) theta += 2.0f * kPi;
      if (theta < best_theta) {
        best_theta = theta;
        best = v;
        best_c = c;
      }
    });
    *out_center = best_c;
    return best;
  }

  // Run the front to exhaustion at the current radius.
  void run_front() {
    while (!front.empty()) {
      FrontEdge e = front.front();
      front.pop_front();
      auto it = edge_tris.find(ekey(e.i, e.j));
      if (it == edge_tris.end() || it->second != 1) continue;  // stale
      V3 c;
      int32_t v = pivot(e, &c);
      if (v < 0) {
        boundary.push_back(e);
        continue;
      }
      add_triangle(e.j, e.i, v, c);
    }
  }

  // Find a seed triangle among unused points; push its edges. Returns
  // false when no seed exists at this radius.
  bool seed(int64_t* cursor) {
    for (int64_t s = *cursor; s < n; s++) {
      if (used[s]) continue;
      V3 p = pts[s];
      // Candidates near p, closest first.
      std::vector<std::pair<float, int32_t>> cand;
      int rr = (int)std::ceil(2.0f * r / grid.cell);
      grid.visit(p, rr, [&](int32_t k) {
        if (k == (int32_t)s) return;
        V3 d = ipc::sub(pts[k], p);
        float d2 = ipc::dot(d, d);
        if (d2 <= 4.0f * r * r) cand.emplace_back(d2, k);
      });
      if (cand.size() < 2) continue;
      std::sort(cand.begin(), cand.end());
      size_t lim = std::min(cand.size(), (size_t)24);
      for (size_t a = 0; a < lim; a++) {
        for (size_t b = a + 1; b < lim; b++) {
          int32_t q = cand[a].second, t = cand[b].second;
          // A seed may touch used points (revive after a radius bump),
          // but never an edge that's already interior: attaching a
          // third triangle to (q,t) breaks the manifold invariant
          // pivot() enforces (edges carry at most 2 triangles).
          auto qt = edge_tris.find(ekey(q, t));
          if (qt != edge_tris.end() && qt->second >= 2) continue;
          auto sq = edge_tris.find(ekey((int32_t)s, q));
          if (sq != edge_tris.end() && sq->second >= 2) continue;
          auto st = edge_tris.find(ekey((int32_t)s, t));
          if (st != edge_tris.end() && st->second >= 2) continue;
          V3 side = ipc::normalized(ipc::add(
              ipc::add(normals[s], normals[q]), normals[t]));
          V3 c;
          if (!ball_center(p, pts[q], pts[t], r, side, &c)) continue;
          if (!ball_empty(c, (int32_t)s, q, t)) continue;
          // Wind the seed so its face normal agrees with the vertex
          // normals.
          V3 tn = ipc::cross(ipc::sub(pts[q], p), ipc::sub(pts[t], p));
          if (ipc::dot(tn, side) >= 0) {
            add_triangle((int32_t)s, q, t, c);
          } else {
            add_triangle((int32_t)s, t, q, c);
          }
          *cursor = s + 1;
          return true;
        }
      }
    }
    *cursor = n;
    return false;
  }
};

}  // namespace

extern "C" {

// Mean nearest-neighbor distance of a point cloud — the radius basis the
// reference derives BPA radii from (backend/app.py:288-291, Open3D
// compute_nearest_neighbor_distance). Returns <=0 on degenerate input.
float ipc_mean_nn_distance(const float* pts_in, int64_t n) {
  if (n < 2) return -1.0f;
  const V3* pts = (const V3*)pts_in;
  V3 lo = pts[0], hi = pts[0];
  for (int64_t i = 1; i < n; i++) {
    lo.x = std::min(lo.x, pts[i].x); hi.x = std::max(hi.x, pts[i].x);
    lo.y = std::min(lo.y, pts[i].y); hi.y = std::max(hi.y, pts[i].y);
    lo.z = std::min(lo.z, pts[i].z); hi.z = std::max(hi.z, pts[i].z);
  }
  float maxdim = std::max(hi.x - lo.x, std::max(hi.y - lo.y, hi.z - lo.z));
  if (maxdim <= 0) return -1.0f;
  float cell = maxdim / std::cbrt((float)n) * 2.0f;
  ipc::HashGrid grid{cell, lo, {}};
  grid.insert(pts, n);
  double acc = 0;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; i++) {
    float best = 1e30f;
    for (int rr = 1; rr <= 64; rr *= 2) {
      grid.visit(pts[i], rr, [&](int32_t j) {
        if (j == (int32_t)i) return;
        V3 d = ipc::sub(pts[j], pts[i]);
        float d2 = ipc::dot(d, d);
        if (d2 < best) best = d2;
      });
      // Only trust the hit once the search ring covers its distance.
      if (best < 1e29f && std::sqrt(best) <= rr * cell) break;
    }
    if (best < 1e29f) {
      acc += std::sqrt(best);
      cnt++;
    }
  }
  return cnt ? (float)(acc / cnt) : -1.0f;
}

// Ball-pivoting reconstruction.
//   pts: (n, 3) float32; radii: ascending ball radii (nr >= 1)
//   orient_mode: 0 = normals outward from centroid, 1 = toward origin
// Faces index the INPUT points (BPA keeps sample positions). The face
// buffer is allocated here; free with ipc_bpa_release. Returns the
// number of faces (>= 0) or <0 on failure.
int64_t ipc_bpa_reconstruct(const float* pts_in, int64_t n,
                            const float* radii, int32_t nr,
                            int32_t orient_mode, int32_t** out_faces) {
  *out_faces = nullptr;
  if (n < 3 || nr < 1) return -1;
  const V3* pts = (const V3*)pts_in;
  float rmax = radii[nr - 1];
  if (rmax <= 0) return -1;

  V3 lo = pts[0], hi = pts[0];
  for (int64_t i = 1; i < n; i++) {
    lo.x = std::min(lo.x, pts[i].x); hi.x = std::max(hi.x, pts[i].x);
    lo.y = std::min(lo.y, pts[i].y); hi.y = std::max(hi.y, pts[i].y);
    lo.z = std::min(lo.z, pts[i].z); hi.z = std::max(hi.z, pts[i].z);
  }
  float maxdim = std::max(hi.x - lo.x, std::max(hi.y - lo.y, hi.z - lo.z));
  if (maxdim <= 0) return -2;

  // Hash cell sized for 2r queries at the largest radius, floored by
  // sampling density so buckets stay small.
  float cell = std::max(rmax, maxdim / std::cbrt((float)n) * 2.0f);
  BPA bpa{pts, n, nullptr, ipc::HashGrid{cell, lo, {}}, radii[0],
          {}, {}, {}, {}, {}};
  bpa.grid.insert(pts, n);
  std::vector<V3> normals(n);
  ipc::estimate_normals(pts, n, bpa.grid, cell * 1.5f, orient_mode,
                        normals.data());
  bpa.normals = normals.data();
  bpa.used.assign(n, 0);

  for (int32_t ri = 0; ri < nr; ri++) {
    bpa.r = radii[ri];
    // Revive edges that failed to pivot at the previous radius: their
    // resting ball must be recomputed for the new r (same side).
    std::vector<FrontEdge> retry;
    retry.swap(bpa.boundary);
    for (auto& e : retry) {
      auto it = bpa.edge_tris.find(ekey(e.i, e.j));
      if (it == bpa.edge_tris.end() || it->second != 1) continue;
      V3 side = ipc::normalized(ipc::add(normals[e.i], normals[e.j]));
      V3 c;
      if (ball_center(pts[e.j], pts[e.i], pts[e.opp], bpa.r, side, &c)) {
        e.center = c;
      }
      bpa.front.push_back(e);
    }
    bpa.run_front();
    int64_t cursor = 0;
    while (bpa.seed(&cursor)) bpa.run_front();
  }

  int64_t nf = (int64_t)(bpa.faces.size() / 3);
  if (nf == 0) return 0;
  int32_t* f_out = new int32_t[bpa.faces.size()];
  std::memcpy(f_out, bpa.faces.data(), bpa.faces.size() * sizeof(int32_t));
  *out_faces = f_out;
  return nf;
}

void ipc_bpa_release(int32_t* faces) { delete[] faces; }

}  // extern "C"
