// Quadric error metric mesh decimation (Garland-Heckbert style).
//
// Native replacement for the capability the reference gets from Open3D's
// simplify_quadric_decimation (reference backend/app.py:516): collapse
// minimum-error edges until the face budget is met. Exposed through a C
// ABI for the ctypes binding in image_to_pointcloud_tpu/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>

namespace {

struct Quadric {
  // Symmetric 4x4 stored as 10 coefficients.
  double m[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d;
    m[9] += d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; i++) m[i] += o.m[i];
  }
  double eval(const double* v) const {
    double x = v[0], y = v[1], z = v[2];
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
};

struct Edge {
  double cost;
  int32_t u, v;
  uint32_t stamp_u, stamp_v;
  bool operator<(const Edge& o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

extern "C" {

// Decimate in place: returns new face count; vertices/colors are compacted
// and new_nv receives the new vertex count. faces/verts/cols are rewritten.
int32_t ipc_decimate(double* verts, double* cols, int32_t nv, int32_t* faces,
                     int32_t nf, int32_t target_faces, int32_t* new_nv) {
  std::vector<Quadric> q(nv);
  std::vector<std::vector<int32_t>> vfaces(nv);
  std::vector<uint8_t> face_alive(nf, 1);
  std::vector<uint32_t> stamp(nv, 0);
  std::vector<int32_t> parent(nv);
  for (int i = 0; i < nv; i++) parent[i] = i;

  auto find = [&](int32_t x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  // Build quadrics from face planes.
  for (int f = 0; f < nf; f++) {
    int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    double *pa = verts + 3 * a, *pb = verts + 3 * b, *pc = verts + 3 * c;
    double e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    double e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-20) { face_alive[f] = 0; continue; }
    n[0] /= len; n[1] /= len; n[2] /= len;
    double d = -(n[0] * pa[0] + n[1] * pa[1] + n[2] * pa[2]);
    q[a].add_plane(n[0], n[1], n[2], d);
    q[b].add_plane(n[0], n[1], n[2], d);
    q[c].add_plane(n[0], n[1], n[2], d);
    vfaces[a].push_back(f);
    vfaces[b].push_back(f);
    vfaces[c].push_back(f);
  }

  std::priority_queue<Edge> heap;
  auto push_edge = [&](int32_t u, int32_t v) {
    if (u == v) return;
    // Candidate position: midpoint (robust, no 4x4 solve needed).
    double mid[3] = {(verts[3 * u] + verts[3 * v]) * 0.5,
                     (verts[3 * u + 1] + verts[3 * v + 1]) * 0.5,
                     (verts[3 * u + 2] + verts[3 * v + 2]) * 0.5};
    Quadric sum = q[u];
    sum.add(q[v]);
    heap.push({sum.eval(mid), u, v, stamp[u], stamp[v]});
  };

  {
    std::unordered_set<int64_t> seen;
    seen.reserve(static_cast<size_t>(nf) * 3);
    for (int f = 0; f < nf; f++) {
      if (!face_alive[f]) continue;
      for (int k = 0; k < 3; k++) {
        int32_t u = faces[3 * f + k], v = faces[3 * f + (k + 1) % 3];
        int64_t key = u < v ? (static_cast<int64_t>(u) << 32) | v
                            : (static_cast<int64_t>(v) << 32) | u;
        if (seen.insert(key).second) push_edge(u, v);
      }
    }
  }

  int32_t alive_faces = 0;
  for (int f = 0; f < nf; f++) alive_faces += face_alive[f];

  while (alive_faces > target_faces && !heap.empty()) {
    Edge e = heap.top();
    heap.pop();
    int32_t u = find(e.u), v = find(e.v);
    if (u == v) continue;
    if (stamp[e.u] != e.stamp_u || stamp[e.v] != e.stamp_v) continue;

    // Collapse v into u at the midpoint.
    for (int k = 0; k < 3; k++) {
      verts[3 * u + k] = (verts[3 * u + k] + verts[3 * v + k]) * 0.5;
      cols[3 * u + k] = (cols[3 * u + k] + cols[3 * v + k]) * 0.5;
    }
    q[u].add(q[v]);
    parent[v] = u;
    stamp[u]++;
    stamp[v]++;

    // Merge incidence lists; kill degenerate faces.
    for (int32_t f : vfaces[v]) {
      if (!face_alive[f]) continue;
      int32_t* tri = faces + 3 * f;
      int cnt_u = 0;
      for (int k = 0; k < 3; k++) {
        if (find(tri[k]) == u) cnt_u++;
      }
      if (cnt_u >= 2) {
        face_alive[f] = 0;
        alive_faces--;
      } else {
        vfaces[u].push_back(f);
      }
    }
    vfaces[v].clear();

    // Refresh edges around u.
    std::unordered_set<int32_t> nbrs;
    for (int32_t f : vfaces[u]) {
      if (!face_alive[f]) continue;
      for (int k = 0; k < 3; k++) {
        int32_t w = find(faces[3 * f + k]);
        if (w != u) nbrs.insert(w);
      }
    }
    for (int32_t w : nbrs) push_edge(u, w);
  }

  // Compact vertices and faces (via temp buffers: in-place forward
  // compaction could read a slot already overwritten when root indices
  // are discovered out of order).
  std::vector<int32_t> remap(nv, -1);
  std::vector<double> vtmp, ctmp;
  vtmp.reserve(3 * static_cast<size_t>(nv));
  ctmp.reserve(3 * static_cast<size_t>(nv));
  int32_t out_nv = 0;
  int32_t out_nf = 0;
  for (int f = 0; f < nf; f++) {
    if (!face_alive[f]) continue;
    int32_t tri[3];
    for (int k = 0; k < 3; k++) tri[k] = find(faces[3 * f + k]);
    if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2]) continue;
    for (int k = 0; k < 3; k++) {
      if (remap[tri[k]] < 0) {
        remap[tri[k]] = out_nv;
        for (int d = 0; d < 3; d++) {
          vtmp.push_back(verts[3 * tri[k] + d]);
          ctmp.push_back(cols[3 * tri[k] + d]);
        }
        out_nv++;
      }
      faces[3 * out_nf + k] = remap[tri[k]];
    }
    out_nf++;
  }
  std::memcpy(verts, vtmp.data(), vtmp.size() * sizeof(double));
  std::memcpy(cols, ctmp.data(), ctmp.size() * sizeof(double));
  *new_nv = out_nv;
  return out_nf;
}

// Fused point-cloud reconstruction from the pipeline's quantized depth
// transfer: dequantize u16 depth, pinhole-unproject (reference math,
// backend/app.py:218-244), gather colors from the strided source image,
// and compact by the keep mask — one pass, SIMD-friendly.
// rgb strides are in bytes (numpy .strides of a possibly non-contiguous
// strided view). Returns the number of kept points.
int64_t ipc_reconstruct(const uint16_t* d16, const uint8_t* keep,
                        const uint8_t* rgb, int64_t rgb_rs, int64_t rgb_cs,
                        int32_t hh, int32_t ww, int32_t step, float depth_scale,
                        float f, float cx, float cy, float inv_q,
                        float* out_xyz, float* out_rgb) {
  // Operation order matches pipeline/graph.py depth16_to_xyz EXACTLY —
  // (d * inv_q) * scale and (u*zs) / f, each rounded in float32 — so a
  // host with the native kernel and one on the numpy fallback produce
  // bit-identical PLY/JSON bytes (the documented contract of the ONE
  // host implementation). inv_q is the f32 reciprocal of the
  // quantization denominator (1/65535 for the u16 contract, 1/4095 for
  // the 12-bit packed transfer), computed by the Python caller so both
  // hosts multiply by the identical float.
  const float q = inv_q;
  int64_t m = 0;
  for (int32_t r = 0; r < hh; r++) {
    const float y0 = (float)(r * step) - cy;
    const uint16_t* drow = d16 + (int64_t)r * ww;
    const uint8_t* krow = keep + (int64_t)r * ww;
    const uint8_t* crow = rgb + (int64_t)r * rgb_rs;
    for (int32_t c = 0; c < ww; c++) {
      if (!krow[c]) continue;
      float z = ((float)drow[c] * q) * depth_scale;
      float zs = (z != 0.0f) ? z : 1e-6f;
      float x0 = (float)(c * step) - cx;
      out_xyz[3 * m] = (x0 * zs) / f;
      out_xyz[3 * m + 1] = (y0 * zs) / f;
      out_xyz[3 * m + 2] = z;
      const uint8_t* px = crow + (int64_t)c * rgb_cs;
      out_rgb[3 * m] = (float)px[0];
      out_rgb[3 * m + 1] = (float)px[1];
      out_rgb[3 * m + 2] = (float)px[2];
      m++;
    }
  }
  return m;
}

// 4:2:0 variant of ipc_reconstruct for the hybrid-JPEG transfer
// bundle: colors arrive as a full-res strided luma plane plus 2x2
// subsampled chroma (the JPEG source stored chroma at half resolution
// to begin with; see pipeline/graph.py depth16 contract notes). The
// BT.601 full-range inverse (ITU-T T.871, the constants in
// ops/jpeg.py _decode_planes) runs per KEPT point only; ties-to-even
// rounding (nearbyintf) matches np.rint in the numpy fallback so both
// hosts emit bit-identical PLY/JSON bytes.
int64_t ipc_reconstruct_ycc420(const uint16_t* d16, const uint8_t* keep,
                               const uint8_t* yp, const uint8_t* cbp,
                               const uint8_t* crp, int32_t hh, int32_t ww,
                               int32_t cw, int32_t step, float depth_scale,
                               float f, float cx, float cy, float inv_q,
                               float* out_xyz, float* out_rgb) {
  const float q = inv_q;  // see ipc_reconstruct

  int64_t m = 0;
  for (int32_t r = 0; r < hh; r++) {
    const float y0 = (float)(r * step) - cy;
    const uint16_t* drow = d16 + (int64_t)r * ww;
    const uint8_t* krow = keep + (int64_t)r * ww;
    const uint8_t* yrow = yp + (int64_t)r * ww;
    const uint8_t* cbrow = cbp + (int64_t)(r >> 1) * cw;
    const uint8_t* crrow = crp + (int64_t)(r >> 1) * cw;
    for (int32_t c = 0; c < ww; c++) {
      if (!krow[c]) continue;
      float z = ((float)drow[c] * q) * depth_scale;
      float zs = (z != 0.0f) ? z : 1e-6f;
      float x0 = (float)(c * step) - cx;
      out_xyz[3 * m] = (x0 * zs) / f;
      out_xyz[3 * m + 1] = (y0 * zs) / f;
      out_xyz[3 * m + 2] = z;
      float Y = (float)yrow[c];
      float Cb = (float)cbrow[c >> 1] - 128.0f;
      float Cr = (float)crrow[c >> 1] - 128.0f;
      float R = Y + 1.402f * Cr;
      float G = Y - 0.344136286f * Cb - 0.714136286f * Cr;
      float B = Y + 1.772f * Cb;
      R = nearbyintf(R); G = nearbyintf(G); B = nearbyintf(B);
      out_rgb[3 * m] = R < 0.0f ? 0.0f : (R > 255.0f ? 255.0f : R);
      out_rgb[3 * m + 1] = G < 0.0f ? 0.0f : (G > 255.0f ? 255.0f : G);
      out_rgb[3 * m + 2] = B < 0.0f ? 0.0f : (B > 255.0f ? 255.0f : B);
      m++;
    }
  }
  return m;
}

// Fast "%.6f %.6f %.6f %d %d %d\n" formatting (reference backend/app.py:387).
// Returns bytes written (caller sizes out generously: 80 bytes/point).
int64_t ipc_format_xyz(const double* pts, const int32_t* cols, int32_t n,
                       char* out, int64_t cap) {
  int64_t off = 0;
  for (int32_t i = 0; i < n; i++) {
    if (off + 128 > cap) return -1;
    // snprintf returns the WOULD-BE length; a line longer than the
    // remaining space (huge-magnitude coordinates via %.6f) would
    // advance `off` past the bytes actually written and silently hand
    // the caller a truncated buffer. Signal the overflow instead (the
    // Python caller falls back to its own formatter).
    int r = snprintf(out + off, cap - off, "%.6f %.6f %.6f %d %d %d\n",
                     pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], cols[3 * i],
                     cols[3 * i + 1], cols[3 * i + 2]);
    if (r < 0 || r >= cap - off) return -1;
    off += r;
  }
  return off;
}

}  // extern "C"
