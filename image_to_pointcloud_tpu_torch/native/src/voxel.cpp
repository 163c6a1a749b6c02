// Voxel-grid downsampling (Open3D voxel_down_sample semantics).
//
// Host-side twin of ops/voxel.py's XLA kernel, used by the high-res
// pipeline's depth-grid transfer path (pipeline/advanced.py): the device
// ships a 12-bit depth grid instead of the budgeted cloud, the host
// reconstructs the full cloud and runs this voxel average locally —
// replacing the capability the reference gets from Open3D's
// voxel_down_sample (reference backend/app.py:255-258 via o3d).
//
// Semantics matched to ops/voxel.py (which is oracle-tested against the
// Open3D definition):
//   * grid origin sits half a voxel BELOW the min bound:
//     idx = floor((p - (minb - voxel/2)) / voxel), computed in float32
//     like the device kernel so boundary cells bucket identically;
//   * positions and colors are averaged per occupied voxel;
//   * output voxels are emitted in (z, y, x)-lexicographic index order —
//     the same order as ops/voxel.py's lexsort((x, y, z)) grouping.
//
// Exposed through a C ABI for the ctypes binding in
// image_to_pointcloud_tpu/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// pts/cols: (n, 3) float32. out_p/out_c: (n, 3) float32 capacity buffers.
// Returns the number of voxels written, or -1 when the index range
// exceeds the 21-bit-per-axis packed key (caller falls back to the
// device/XLA path).
int64_t ipc_voxel_downsample(const float* pts, const float* cols, int64_t n,
                             float voxel, float* out_p, float* out_c) {
  if (n <= 0 || !(voxel > 0.0f)) return 0;

  float minb[3] = {pts[0], pts[1], pts[2]};
  for (int64_t i = 1; i < n; i++) {
    for (int k = 0; k < 3; k++) {
      float v = pts[i * 3 + k];
      if (v < minb[k]) minb[k] = v;
    }
  }
  // Match the device kernel's float32 op order exactly:
  // (p - (minb - 0.5*voxel)) / voxel, then floor.
  float origin[3];
  for (int k = 0; k < 3; k++) origin[k] = minb[k] - 0.5f * voxel;

  constexpr int64_t kAxisBits = 21;
  constexpr int64_t kAxisMax = (int64_t(1) << kAxisBits) - 1;

  struct Acc {
    double p[3] = {0, 0, 0};
    double c[3] = {0, 0, 0};
    int64_t cnt = 0;
  };
  std::unordered_map<uint64_t, int32_t> slot_of;
  slot_of.reserve(static_cast<size_t>(n));
  std::vector<Acc> accs;
  accs.reserve(1024);
  std::vector<uint64_t> keys;
  keys.reserve(1024);

  for (int64_t i = 0; i < n; i++) {
    int64_t ix[3];
    for (int k = 0; k < 3; k++) {
      float q = (pts[i * 3 + k] - origin[k]) / voxel;
      int64_t idx = static_cast<int64_t>(std::floor(q));
      if (idx < 0) idx = 0;  // minb-derived, only float noise goes below
      if (idx > kAxisMax) return -1;
      ix[k] = idx;
    }
    // z-major key: ascending sort == (z, y, x) lexicographic order.
    uint64_t key = (static_cast<uint64_t>(ix[2]) << (2 * kAxisBits)) |
                   (static_cast<uint64_t>(ix[1]) << kAxisBits) |
                   static_cast<uint64_t>(ix[0]);
    auto it = slot_of.find(key);
    int32_t s;
    if (it == slot_of.end()) {
      s = static_cast<int32_t>(accs.size());
      slot_of.emplace(key, s);
      accs.emplace_back();
      keys.push_back(key);
    } else {
      s = it->second;
    }
    Acc& a = accs[s];
    for (int k = 0; k < 3; k++) {
      a.p[k] += pts[i * 3 + k];
      a.c[k] += cols[i * 3 + k];
    }
    a.cnt++;
  }

  std::vector<int32_t> order(keys.size());
  for (size_t i = 0; i < order.size(); i++) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return keys[a] < keys[b]; });

  int64_t m = static_cast<int64_t>(order.size());
  for (int64_t o = 0; o < m; o++) {
    const Acc& a = accs[order[o]];
    double inv = 1.0 / static_cast<double>(a.cnt);
    for (int k = 0; k < 3; k++) {
      out_p[o * 3 + k] = static_cast<float>(a.p[k] * inv);
      out_c[o * 3 + k] = static_cast<float>(a.c[k] * inv);
    }
  }
  return m;
}

}  // extern "C"
