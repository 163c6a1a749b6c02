// Host-side reconstruction of the hybrid-JPEG pipeline's strided-grid
// point colors, straight from the entropy-decoded DCT coefficients the
// host already holds (native/src/jpegdec.cpp output, truncated k=8).
//
// Why: in hybrid-JPEG mode the host never decodes pixels, so point
// colors ride the device→host bundle as 4:2:0 YCbCr (~100 KB/img at
// 518²/stride-2) — the single largest D2H item on this rig's
// serialized link (benchmarks/e2e_breakdown.py). But the colors are a
// pure function of the coefficients already sitting in host memory:
// an inverse DCT evaluated ONLY at the strided grid positions (step·g)
// costs ~1/step of the full IDCT for the luma plane, and the chroma
// planes are small. Reconstructing them here deletes the ride-along
// from the bundle entirely; the work hides under the link wait on the
// planner/executor thread (pipeline/graph.py submit_batch_jpeg).
//
// Fidelity: mirrors ops/jpeg.py _decode_planes exactly —
//   - 8-point inverse DCT per axis (idct_matrix(8), f32),
//   - +128 level shift, chroma re-centered by -128 the same way,
//   - libjpeg "fancy" 2× chroma upsampling ((3c[i]+c[i∓1])/4 with edge
//     replication), evaluated only at the grid positions the device
//     path would sample after upsampling,
//   - BT.601 full-range color transform, clip(round()) ties-to-even.
// Float summation order differs from the device einsum, so agreement
// is within ±1 gray level after rounding (tests/test_jpeg_hybrid.py);
// the reference-parity anchor stays the ±3-level libjpeg tolerance
// (replacing reference backend/app.py:433 cv2.imdecode colors at
// backend/app.py:244-246).
//
// Supported layouts (caller falls back to the device ride-along
// otherwise): k=8 full-scale decode, 1 or 3 components, per-axis
// chroma ratios 1 or 2 (4:4:4, 4:2:2, 4:4:0, 4:2:0, grayscale),
// strides step ∈ {1, 2, 4}.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// M[u][x]: 8-point inverse-DCT basis (ops/jpeg.py idct_matrix(8)).
struct Idct8 {
  float m[8][8];
  Idct8() {
    const double pi = 3.14159265358979323846;
    for (int u = 0; u < 8; u++) {
      const double a = (u == 0) ? std::sqrt(1.0 / 8.0) : std::sqrt(2.0 / 8.0);
      for (int x = 0; x < 8; x++)
        m[u][x] = static_cast<float>(a * std::cos((2 * x + 1) * u * pi / 16.0));
    }
  }
};
const Idct8 kIdct;

// Sampled inverse DCT of one coefficient plane: evaluate the decoded
// plane (level-shifted +128) at rows {0, sy, 2sy, ...} × cols
// {0, sx, 2sx, ...} of its valid region (vh × vw), writing a dense
// (ceil(vh/sy), ceil(vw/sx)) f32 plane. Block size is fixed 8 and
// 8 % s == 0 for s ∈ {1,2,4,8}, so the sampled in-block offsets are
// the same for every block.
void sampled_idct_plane(const int16_t* coeffs,  // (bh, bw, 64) natural
                        const float* qt,        // (64,) natural
                        int bh, int bw, int vh, int vw, int sy, int sx,
                        float* out, int out_w) {
  const int nsy = 8 / sy, nsx = 8 / sx;
  // Pre-sampled bases: col_basis[v][j] = M[v][j*sx].
  float bx[8][8], by[8][8];
  for (int u = 0; u < 8; u++) {
    for (int j = 0; j < nsy; j++) by[u][j] = kIdct.m[u][j * sy];
    for (int j = 0; j < nsx; j++) bx[u][j] = kIdct.m[u][j * sx];
  }
  const int gh = (vh + sy - 1) / sy, gw = (vw + sx - 1) / sx;
  for (int byi = 0; byi < bh; byi++) {
    const int row0 = byi * 8;
    if (row0 >= vh) break;
    for (int bxi = 0; bxi < bw; bxi++) {
      const int col0 = bxi * 8;
      if (col0 >= vw) break;
      const int16_t* c = coeffs + (static_cast<int64_t>(byi) * bw + bxi) * 64;
      // t[u][j] = sum_v deq[u][v] * bx[v][j]
      float t[8][8];
      for (int u = 0; u < 8; u++) {
        for (int j = 0; j < nsx; j++) {
          float acc = 0.0f;
          for (int v = 0; v < 8; v++)
            acc += static_cast<float>(c[u * 8 + v]) * qt[u * 8 + v] *
                   bx[v][j];
          t[u][j] = acc;
        }
      }
      // out[i][j] = sum_u by[u][i] * t[u][j] + 128
      // Grid rows/cols covered by this block: global sampled index
      // g = (row0 + i*sy)/sy = row0/sy + i (row0 % sy == 0 since 8%sy==0).
      const int g0y = row0 / sy, g0x = col0 / sx;
      const int ni = nsy < gh - g0y ? nsy : gh - g0y;
      const int nj = nsx < gw - g0x ? nsx : gw - g0x;
      for (int i = 0; i < ni; i++) {
        float* orow = out + static_cast<int64_t>(g0y + i) * out_w + g0x;
        for (int j = 0; j < nj; j++) {
          float acc = 0.0f;
          for (int u = 0; u < 8; u++) acc += by[u][i] * t[u][j];
          orow[j] = acc + 128.0f;
        }
      }
    }
  }
}

// Per-axis chroma taps at full-res position p for ratio r:
// r == 1: the plane was decoded at stride `step`, index p/step, one tap.
// r == 2: plane decoded at stride 1; libjpeg fancy-upsample evaluated
//   at p: even p → (3c[i] + c[i-1])/4, odd p → (3c[i] + c[i+1])/4,
//   i = p/2, edges replicated (ops/jpeg.py _fancy_upsample_axis).
struct Taps {
  int i0, i1;
  float w0, w1;
};
inline Taps chroma_taps(int p, int r, int step, int valid) {
  if (r == 1) {
    int i = p / step;
    if (i > valid - 1) i = valid - 1;
    return {i, i, 1.0f, 0.0f};
  }
  const int i = p >> 1;
  if ((p & 1) == 0) {
    const int im = i > 0 ? i - 1 : 0;
    return {i, im, 0.75f, 0.25f};
  }
  const int ip = i < valid - 1 ? i + 1 : valid - 1;
  return {i, ip, 0.75f, 0.25f};
}

}  // namespace

extern "C" {

// Reconstruct (gh, gw, 3) u8 RGB grid colors from truncated (k=8)
// natural-order coefficients. dims: per-component
// [bh, bw, ry, rx] × 3 (ry = vmax/v[c], rx = hmax/h[c]; component 0
// must be 1,1). qt: (3, 64) f32 natural-order dequant tables.
// out_h/out_w: decoded image size (spec.out_hw == working size; the
// caller gates the no-resize case). step: grid stride.
// Returns 0 on success, 1 for unsupported layouts (caller falls back).
int32_t ipc_jpeg_grid_colors(const int16_t* c0, const int16_t* c1,
                             const int16_t* c2, const float* qt,
                             int32_t ncomp, const int32_t* dims,
                             int32_t out_h, int32_t out_w, int32_t step,
                             uint8_t* out_rgb) {
  if (ncomp != 1 && ncomp != 3) return 1;
  if (step != 1 && step != 2 && step != 4) return 1;
  if (dims[2] != 1 || dims[3] != 1) return 1;  // luma must be full-res
  const int16_t* comps[3] = {c0, c1, c2};
  for (int c = 1; c < ncomp; c++) {
    const int ry = dims[4 * c + 2], rx = dims[4 * c + 3];
    if ((ry != 1 && ry != 2) || (rx != 1 && rx != 2)) return 1;
  }
  const int gh = (out_h + step - 1) / step, gw = (out_w + step - 1) / step;

  // Luma: decoded straight at the grid stride.
  std::vector<float> yp(static_cast<size_t>(gh) * gw);
  sampled_idct_plane(comps[0], qt, dims[0], dims[1], out_h, out_w, step,
                     step, yp.data(), gw);

  if (ncomp == 1) {
    for (int64_t i = 0; i < static_cast<int64_t>(gh) * gw; i++) {
      float v = std::nearbyintf(yp[i]);
      if (v < 0.0f) v = 0.0f;
      if (v > 255.0f) v = 255.0f;
      const uint8_t u = static_cast<uint8_t>(v);
      out_rgb[3 * i] = u;
      out_rgb[3 * i + 1] = u;
      out_rgb[3 * i + 2] = u;
    }
    return 0;
  }

  // Chroma planes: per-axis decode stride 1 where the device would
  // fancy-upsample (r == 2), the grid stride where it samples directly.
  std::vector<float> cp[2];
  int cvh[2], cvw[2], cdw[2];
  for (int c = 1; c < 3; c++) {
    const int bh = dims[4 * c], bw = dims[4 * c + 1];
    const int ry = dims[4 * c + 2], rx = dims[4 * c + 3];
    const int vh = (out_h + ry - 1) / ry, vw = (out_w + rx - 1) / rx;
    const int sy = ry == 2 ? 1 : step, sx = rx == 2 ? 1 : step;
    const int dh = (vh + sy - 1) / sy, dw = (vw + sx - 1) / sx;
    cp[c - 1].resize(static_cast<size_t>(dh) * dw);
    sampled_idct_plane(comps[c], qt + 64 * c, bh, bw, vh, vw, sy, sx,
                       cp[c - 1].data(), dw);
    cvh[c - 1] = dh;  // valid counts along each decoded axis
    cvw[c - 1] = dw;
    cdw[c - 1] = dw;
  }

  for (int gy = 0; gy < gh; gy++) {
    const int py = gy * step;
    uint8_t* orow = out_rgb + static_cast<int64_t>(gy) * gw * 3;
    for (int gx = 0; gx < gw; gx++) {
      const int px = gx * step;
      const float y = yp[static_cast<int64_t>(gy) * gw + gx];
      float cc[2];
      for (int c = 0; c < 2; c++) {
        const int ry = dims[4 * (c + 1) + 2], rx = dims[4 * (c + 1) + 3];
        const Taps ty = chroma_taps(py, ry, step, cvh[c]);
        const Taps tx = chroma_taps(px, rx, step, cvw[c]);
        const float* pl = cp[c].data();
        const int w = cdw[c];
        const float v =
            ty.w0 * (tx.w0 * pl[static_cast<int64_t>(ty.i0) * w + tx.i0] +
                     tx.w1 * pl[static_cast<int64_t>(ty.i0) * w + tx.i1]) +
            ty.w1 * (tx.w0 * pl[static_cast<int64_t>(ty.i1) * w + tx.i0] +
                     tx.w1 * pl[static_cast<int64_t>(ty.i1) * w + tx.i1]);
        cc[c] = v - 128.0f;
      }
      const float cb = cc[0], cr = cc[1];
      float rgb[3] = {y + 1.402f * cr,
                      y - 0.344136286f * cb - 0.714136286f * cr,
                      y + 1.772f * cb};
      for (int k = 0; k < 3; k++) {
        float v = std::nearbyintf(rgb[k]);
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        orow[3 * gx + k] = static_cast<uint8_t>(v);
      }
    }
  }
  return 0;
}

}  // extern "C"
