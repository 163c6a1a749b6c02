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
// What bounds it on the H100: at the serving shape (518², step 2: ~0.5 MB
// read, ~2.1 MB written per image, warm in L2 when the layer before has
// just written its inputs) the launch itself and one load-to-store round
// trip, not the bytes: a one-element zero_() takes about half its time on
// the same harness (PERF.md).
//
// Design: one thread per output point, 256 to a block that owns 256
// consecutive points of one image (263 blocks at (1, 518, 518) step 2, two
// per SM), and 32-bit index arithmetic (the launcher refuses an N that
// does not fit), so each thread spends one 32-bit division on its (i, j). The strided
// sampling is folded into the read index (no strided copy of the depth or
// the image). Every read issues before the divisions, whose IEEE slow path
// is a call the reads cannot move across. Each of the 8 output rows is
// written by consecutive threads at consecutive addresses (a warp's store
// is one 128-byte request). The per-image scale is read from a device
// array, so the caller never synchronises. The TPU kernel's row tiles (its
// VMEM slabs) have no counterpart.
//
// 16-byte stores were measured and not kept: with N odd (67,081 at the
// serving shape) output row r of image b starts at word (8b + r)·N, at
// every residue mod 4, so a variant that staged rows 0-5 in shared memory
// and wrote each row's range as float4s from its first 16-byte boundary,
// with a scalar head and tail of up to 3 words, paid a barrier and a
// shared-memory round trip that cost as much as the store instructions
// they saved or more (PERF.md). Reads
// stay one word per point for the same reason in the other direction: a
// warp's read of 32 sampled values is one request over the sectors a wider
// word would touch, at step 2 half of each wider word would be an unused
// neighbour, 518-wide f32 rows (2072 B) are not 16-byte aligned, and the
// wrapper accepts any strides.
//
// Rounding: x and y divide by f (the TPU kernel multiplies by 1/f), as the
// port's plain version, numpy's host reconstruct and the reference do. The
// _rn intrinsics keep nvcc from contracting u·zs / f or approximating the
// division, so the result is bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one point each: a block owns 256 points

template <typename Pix>
__global__ void __launch_bounds__(kThreads)
unproject_kernel(const float* __restrict__ depth, const Pix* __restrict__ rgb,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int hh, int ww, int step, float cx, float cy, float f,
                 long long sdb, long long sdh, long long sdw, long long sib,
                 long long sih, long long siw, long long sic) {
  const int b = blockIdx.y;
  const int n = hh * ww;  // the launcher checks that it fits
  const int p0 = blockIdx.x * kThreads;
  const int cnt = min(kThreads, n - p0);
  const int t = threadIdx.x;
  if (t >= cnt) return;
  const int p = p0 + t;
  const int i = p / ww;
  const int j = p - i * ww;
  const long long row = static_cast<long long>(i) * step;
  const long long col = static_cast<long long>(j) * step;
  // Every read issues before the divisions (whose slow path is a call the
  // reads could not move across).
  float vals[8];
  const float d = depth[b * sdb + row * sdh + col * sdw];
  const Pix* px = rgb + b * sib + row * sih + col * siw;
  vals[3] = static_cast<float>(px[0]);
  vals[4] = static_cast<float>(px[sic]);
  vals[5] = static_cast<float>(px[2 * sic]);
  const float u = __fsub_rn(static_cast<float>(j * step), cx);
  const float v = __fsub_rn(static_cast<float>(i * step), cy);
  const float z = __fmul_rn(d, scale[b]);
  const float zs = z != 0.f ? z : 1e-6f;
  vals[0] = __fdiv_rn(__fmul_rn(u, zs), f);
  vals[1] = __fdiv_rn(__fmul_rn(v, zs), f);
  vals[2] = z;
  vals[6] = 1.f;
  vals[7] = 0.f;
  // Each row written by consecutive threads at consecutive addresses.
  float* o = out + static_cast<long long>(b) * 8 * n + p;
#pragma unroll
  for (int r = 0; r < 8; ++r) o[static_cast<long long>(r) * n] = vals[r];
}

template <typename Pix>
int launch(const float* depth, const void* rgb, const float* scale, float* out,
           int B, int hh, int ww, int step, float cx, float cy, float f,
           long long sdb, long long sdh, long long sdw, long long sib,
           long long sih, long long siw, long long sic, cudaStream_t stream) {
  const long long n = static_cast<long long>(hh) * ww;
  if (n > INT_MAX - kThreads || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), static_cast<unsigned>(B));
  unproject_kernel<Pix><<<grid, kThreads, 0, stream>>>(
      depth, static_cast<const Pix*>(rgb), scale, out, hh, ww, step, cx, cy, f,
      sdb, sdh, sdw, sib, sih, siw, sic);
  return cudaGetLastError();
}

}  // namespace

// depth: f32 with element strides sdb (batch), sdh (row), sdw (column).
// rgb: u8 (rgb_is_u8 = 1) or f32 (0) with element strides sib, sih, siw and
// sic (channel). scale: (B,) f32. out: (B, 8, hh·ww) f32, contiguous and
// 4-byte aligned, with hh = ⌈h/step⌉ and ww = ⌈w/step⌉. Returns the
// launch's cudaError_t.
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
