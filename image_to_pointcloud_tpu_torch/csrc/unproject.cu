// Pinhole depth→point-cloud unprojection for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `unproject_pallas` / `_unproject_kernel`
// (image_to_pointcloud_tpu/ops/unproject.py). For every point (i, j) of the
// strided grid of a (h, w) image, pixel (i·step, j·step):
//   u = j·step − cx,  v = i·step − cy,  z = d·scale,
//   zs = z != 0 ? z : 1e-6,  x = u·zs / f,  y = v·zs / f,
// written as the planar rows [x, y, z, r, g, b, 1, 0] of a (B, 8, N) f32
// buffer, N = ⌈h/step⌉·⌈w/step⌉.
//
// What bounds it on the H100: memory traffic, and at the serving shape
// (518², step 2: ~0.5 MB read, ~2.1 MB written per image) the launch
// itself. Design: one thread per output point over (B, N); the strided
// sampling is folded into the read index (no strided copy of the depth or
// the image), each of the 8 output rows is written by consecutive threads
// to consecutive addresses, and the per-image scale is read from a device
// array, so the caller never synchronises. The TPU kernel's row tiles (its
// VMEM slabs) have no counterpart: nothing is staged.
//
// Rounding: x and y divide by f (the TPU kernel multiplies by 1/f), as the
// port's plain version, numpy's host reconstruct and the reference do. The
// _rn intrinsics keep nvcc from contracting u·zs / f or approximating the
// division, so the result is bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename Pix>
__global__ void __launch_bounds__(256)
unproject_kernel(const float* __restrict__ depth, const Pix* __restrict__ rgb,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int B, int hh, int ww, int step, float cx, float cy, float f,
                 long long sdb, long long sdh, long long sdw, long long sib,
                 long long sih, long long siw, long long sic) {
  const long long n = static_cast<long long>(hh) * ww;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * B) return;
  const int b = static_cast<int>(idx / n);
  const long long p = idx - b * n;
  const int i = static_cast<int>(p / ww);
  const int j = static_cast<int>(p - static_cast<long long>(i) * ww);
  const long long row = static_cast<long long>(i) * step;
  const long long col = static_cast<long long>(j) * step;

  const float d = depth[b * sdb + row * sdh + col * sdw];
  const Pix* px = rgb + b * sib + row * sih + col * siw;
  const float u = __fsub_rn(static_cast<float>(j * step), cx);
  const float v = __fsub_rn(static_cast<float>(i * step), cy);
  const float z = __fmul_rn(d, scale[b]);
  const float zs = z != 0.f ? z : 1e-6f;

  float* o = out + static_cast<long long>(b) * 8 * n + p;
  o[0] = __fdiv_rn(__fmul_rn(u, zs), f);
  o[n] = __fdiv_rn(__fmul_rn(v, zs), f);
  o[2 * n] = z;
  o[3 * n] = static_cast<float>(px[0]);
  o[4 * n] = static_cast<float>(px[sic]);
  o[5 * n] = static_cast<float>(px[2 * sic]);
  o[6 * n] = 1.f;
  o[7 * n] = 0.f;
}

template <typename Pix>
int launch(const float* depth, const void* rgb, const float* scale, float* out,
           int B, int hh, int ww, int step, float cx, float cy, float f,
           long long sdb, long long sdh, long long sdw, long long sib,
           long long sih, long long siw, long long sic, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * hh * ww;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  unproject_kernel<Pix><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      depth, static_cast<const Pix*>(rgb), scale, out, B, hh, ww, step, cx, cy,
      f, sdb, sdh, sdw, sib, sih, siw, sic);
  return cudaGetLastError();
}

}  // namespace

// depth: f32 with element strides sdb (batch), sdh (row), sdw (column).
// rgb: u8 (rgb_is_u8 = 1) or f32 (0) with element strides sib, sih, siw and
// sic (channel). scale: (B,) f32. out: (B, 8, hh·ww) f32, contiguous, with
// hh = ⌈h/step⌉ and ww = ⌈w/step⌉. Returns the launch's cudaError_t.
extern "C" int ipc_unproject(const float* depth, const void* rgb, int rgb_is_u8,
                             const float* scale, float* out, int B, int hh,
                             int ww, int step, float cx, float cy, float f,
                             long long sdb, long long sdh, long long sdw,
                             long long sib, long long sih, long long siw,
                             long long sic, void* stream) {
  if (B <= 0 || hh <= 0 || ww <= 0 || step <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rgb_is_u8) {
    return launch<uint8_t>(depth, rgb, scale, out, B, hh, ww, step, cx, cy, f,
                           sdb, sdh, sdw, sib, sih, siw, sic, s);
  }
  return launch<float>(depth, rgb, scale, out, B, hh, ww, step, cx, cy, f, sdb,
                       sdh, sdw, sib, sih, siw, sic, s);
}
