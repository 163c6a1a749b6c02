// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel_packed`
// (image_to_pointcloud_tpu/models/attention.py). Same math: bidirectional
// softmax(q·kᵀ·scale)·v per (batch, head); online softmax with the running
// max m, denominator l and accumulator acc held in f32; the scale is applied
// to the f32 dot; probabilities are rounded to the input dtype before the
// P·V product, as the Pallas body casts `pr.astype(v.dtype)`.
//
// What bounds it on the H100: the flagship shape (B·H = 6 per image,
// N = 1370, D = 64) is compute-bound (~0.5 GFLOP per image-layer against
// ~1 MB of q/k/v), and at one image per batch it has only 6·22 = 132 query
// tiles, one per SM. This first version runs the dots on the FP32 CUDA
// cores, not the tensor cores: one thread owns one query row (q and acc in
// registers), K/V tiles of 64 keys are staged in shared memory as f32 and
// read as warp-wide broadcasts, and keys are consumed in chunks of 16 so
// the online-softmax rescale runs once per chunk instead of once per key.
// Keys at n >= N are skipped directly, so no padding to a tile multiple is
// needed. wgmma/TMA tiles are later work.
//
// Layout: q/k/v/o are (B, H, N, 64) with the last dim contiguous and any
// element strides for b, h and n, so the (B, N, H·64) projections are read
// in place without a head transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;      // head dim
constexpr int kBQ = 64;     // queries (threads) per block
constexpr int kBK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The probability as the P·V dot sees it: rounded to the input dtype.
template <typename T> __device__ __forceinline__ float round_to_input(float p) {
  return to_f32(from_f32<T>(p));
}

template <typename T>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int N,
                 long long qsb, long long qsh, long long qsn,
                 long long ksb, long long ksh, long long ksn,
                 long long vsb, long long vsh, long long vsn,
                 long long osb, long long osh, long long osn, float scale) {
  __shared__ float4 ks[kBK][kD / 4];
  __shared__ float4 vs[kBK][kD / 4];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  float qr[kD];
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row < N ? to_f32(qb[row * qsn + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);
  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < kBK * kD; idx += kBQ) {
      const int kk = idx / kD;
      const int d = idx - kk * kD;
      const bool in = kk < nk;
      ksf[idx] = in ? to_f32(kb[(k0 + kk) * ksn + d]) : 0.f;
      vsf[idx] = in ? to_f32(vb[(k0 + kk) * vsn + d]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nk; c += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 kv = ks[c + j][d4];
          dot += qr[4 * d4] * kv.x;
          dot += qr[4 * d4 + 1] * kv.y;
          dot += qr[4 * d4 + 2] * kv.z;
          dot += qr[4 * d4 + 3] * kv.w;
        }
        s[j] = (c + j < nk) ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);  // finite: the chunk has a valid key
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);  // masked keys: exp(-inf) = 0
        l += p;
        const float pr = round_to_input<T>(p);
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vs[c + j][d4];
          acc[4 * d4] += pr * vv.x;
          acc[4 * d4 + 1] += pr * vv.y;
          acc[4 * d4 + 2] += pr * vv.z;
          acc[4 * d4 + 3] += pr * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row < N) {
    T* ob = o + b * osb + h * osh + row * osn;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; ++d) ob[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int N, const long long* st, float scale,
                   cudaStream_t stream) {
  dim3 grid((N + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, N, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, h, n)
// for q, k, v, o in that order. Returns the launch's cudaError_t.
extern "C" int ipc_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int N, int D,
                                   const long long* strides, float scale,
                                   int dtype, void* stream) {
  if (D != kD || N <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, H, N, strides, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, N, strides, scale, s);
  return cudaErrorInvalidValue;
}
