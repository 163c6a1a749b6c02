// Host-side serialization hot loops for the serving result path.
//
// The reference's results contract inlines a <=20k-point float preview
// into every completed job's status JSON (backend/app.py:496-506,
// 545-559) and writes binary PLY per job (backend/app.py:340 via
// Open3D's C++ writer). On a one-core serving host the pure-Python
// equivalents (float repr via json.dumps, numpy structured-array fill)
// dominate the per-job cost and starve the TPU; these kernels do the
// same work at memory-bandwidth speed.
//
// Float text format: std::to_chars shortest-round-trip doubles — the
// same values Python's repr() produces (both are shortest decimal that
// round-trips the promoted double), differing only in cosmetic form
// ("1" vs "1.0"), which JSON parsers read back to identical values.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Append one double as JSON; returns chars written (0 on overflow).
inline int64_t put_double(double v, char* out, int64_t cap) {
  if (cap < 32) return 0;
  if (std::isnan(v)) {  // json.dumps emits NaN/Infinity (non-strict JSON)
    std::memcpy(out, "NaN", 3);
    return 3;
  }
  if (std::isinf(v)) {
    if (v < 0) { std::memcpy(out, "-Infinity", 9); return 9; }
    std::memcpy(out, "Infinity", 8);
    return 8;
  }
  auto res = std::to_chars(out, out + cap, v);
  if (res.ec != std::errc()) return 0;
  return res.ptr - out;
}

}  // namespace

extern "C" {

// JSON array of n f32 values (promoted to double): "[a,b,c]".
// Returns bytes written, or -1 if cap is insufficient.
int64_t ipc_json_f32_list(const float* v, int64_t n, char* out, int64_t cap) {
  int64_t w = 0;
  if (cap < 2) return -1;
  out[w++] = '[';
  for (int64_t i = 0; i < n; ++i) {
    if (i) {
      if (w + 1 > cap) return -1;
      out[w++] = ',';
    }
    int64_t k = put_double(static_cast<double>(v[i]), out + w, cap - w);
    if (k == 0) return -1;
    w += k;
  }
  if (w + 1 > cap) return -1;
  out[w++] = ']';
  return w;
}

// JSON array of n [x,y,z] triples from an (n,3) f32 buffer:
// "[[a,b,c],[d,e,f]]" — the reference's preview contract shape
// (backend/app.py:504-505: (N,3).tolist()). Returns bytes or -1.
int64_t ipc_json_f32_triplets(const float* v, int64_t n, char* out,
                              int64_t cap) {
  int64_t w = 0;
  if (cap < 2) return -1;
  out[w++] = '[';
  for (int64_t i = 0; i < n; ++i) {
    if (i) {
      if (w + 1 > cap) return -1;
      out[w++] = ',';
    }
    if (w + 1 > cap) return -1;
    out[w++] = '[';
    for (int c = 0; c < 3; ++c) {
      if (c) {
        if (w + 1 > cap) return -1;
        out[w++] = ',';
      }
      int64_t k = put_double(static_cast<double>(v[i * 3 + c]), out + w,
                             cap - w);
      if (k == 0) return -1;
      w += k;
    }
    if (w + 1 > cap) return -1;
    out[w++] = ']';
  }
  if (w + 1 > cap) return -1;
  out[w++] = ']';
  return w;
}

// JSON array of n [x,y,z] triples from an (n,3) f64 buffer (exact
// doubles — used where the Python path emitted float64 values).
int64_t ipc_json_f64_triplets(const double* v, int64_t n, char* out,
                              int64_t cap) {
  int64_t w = 0;
  if (cap < 2) return -1;
  out[w++] = '[';
  for (int64_t i = 0; i < n; ++i) {
    if (i) {
      if (w + 1 > cap) return -1;
      out[w++] = ',';
    }
    if (w + 1 > cap) return -1;
    out[w++] = '[';
    for (int c = 0; c < 3; ++c) {
      if (c) {
        if (w + 1 > cap) return -1;
        out[w++] = ',';
      }
      int64_t k = put_double(v[i * 3 + c], out + w, cap - w);
      if (k == 0) return -1;
      w += k;
    }
    if (w + 1 > cap) return -1;
    out[w++] = ']';
  }
  if (w + 1 > cap) return -1;
  out[w++] = ']';
  return w;
}

// JSON array of n [a,b,c] int triples from an (n,3) i32 buffer.
int64_t ipc_json_i32_triplets(const int32_t* v, int64_t n, char* out,
                              int64_t cap) {
  int64_t w = 0;
  if (cap < 2) return -1;
  out[w++] = '[';
  for (int64_t i = 0; i < n; ++i) {
    if (i) {
      if (w + 1 > cap) return -1;
      out[w++] = ',';
    }
    if (w + 1 > cap) return -1;
    out[w++] = '[';
    for (int c = 0; c < 3; ++c) {
      if (c) {
        if (w + 1 > cap) return -1;
        out[w++] = ',';
      }
      if (cap - w < 16) return -1;
      auto res = std::to_chars(out + w, out + cap, v[i * 3 + c]);
      if (res.ec != std::errc()) return -1;
      w = res.ptr - out;
    }
    if (w + 1 > cap) return -1;
    out[w++] = ']';
  }
  if (w + 1 > cap) return -1;
  out[w++] = ']';
  return w;
}

// JSON array of n i32 values. Returns bytes written, or -1 on overflow.
int64_t ipc_json_i32_list(const int32_t* v, int64_t n, char* out, int64_t cap) {
  int64_t w = 0;
  if (cap < 2) return -1;
  out[w++] = '[';
  for (int64_t i = 0; i < n; ++i) {
    if (i) {
      if (w + 1 > cap) return -1;
      out[w++] = ',';
    }
    if (cap - w < 16) return -1;
    auto res = std::to_chars(out + w, out + cap, v[i]);
    if (res.ec != std::errc()) return -1;
    w = res.ptr - out;
  }
  if (w + 1 > cap) return -1;
  out[w++] = ']';
  return w;
}

// Binary-little-endian PLY vertex records: x,y,z as f64 (+ r,g,b u8).
// Matches io/ply.py's numpy layout: colors rounded half-to-even
// (np.round) then clamped to [0,255]. Little-endian host assumed (x86 /
// TPU hosts). Returns bytes written.
int64_t ipc_ply_pack(const float* pts, const float* cols, int64_t n,
                     uint8_t* out) {
  const int64_t rec = cols ? 27 : 24;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* r = out + i * rec;
    double xyz[3] = {static_cast<double>(pts[i * 3 + 0]),
                     static_cast<double>(pts[i * 3 + 1]),
                     static_cast<double>(pts[i * 3 + 2])};
    std::memcpy(r, xyz, 24);
    if (cols) {
      for (int c = 0; c < 3; ++c) {
        double v = std::nearbyint(static_cast<double>(cols[i * 3 + c]));
        r[24 + c] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
  return n * rec;
}

}  // extern "C"
