// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel_packed`
// (image_to_pointcloud_tpu/models/attention.py). Same math: bidirectional
// softmax(q·kᵀ·scale)·v per (batch, head); online softmax with the running
// max m, denominator l and accumulator acc held in f32, l summed from the
// unrounded probabilities; the scale is applied to the f32 dot;
// probabilities are rounded to the input dtype before the P·V product, as
// the Pallas body casts `pr.astype(v.dtype)`.
//
// Layout: q/k/v/o are (B, H, N, D) with the last dim contiguous and any
// element strides for b, h and n, so the (B, N, H·D) projections are read
// in place without a head transpose.
//
// Head dims: both kernels are templates on a padded head dim kD ∈ {32, 64,
// 128}; a call takes the smallest that holds D (D <= 128). Loads of columns
// >= D are predicated to zero (so they add nothing to q·k and p·v), the
// scale is the caller's 1/√D of the true D, and only the first D columns
// are stored. kD = 64 is the served instance (DA-V2, ViT-L/16, ViT-B/16).
// bf16 copies 16-byte chunks, so its D must be a multiple of 8 (the
// wrapper pads other D into a contiguous buffer).
//
// bf16: `flash_fwd_bf16_wgmma_kernel`, on the tensor cores.
//   What bounds it on the H100: at DA-V2's (1, 6, 1370, 64) a call is
//   4·6·1370²·64 = 2.9 GFLOP (2.9 µs at 989 TFLOP/s) and 11.3 M
//   exponentials, against 4.2 MB of q/k/v/o (1.3 µs at 3.35 TB/s): compute.
//   At batch 1 it has only 6·22 = 132 query tiles, one per SM.
//   Design: one CTA of two warpgroups per (b, h, 64-query tile). The Q tile
//   is loaded once into shared memory; each warpgroup streams its half of
//   the 64-key K/V tiles through its own double-buffered ring
//   (cp.async.cg 16-byte copies, rows past N zero-filled), written in the
//   128-byte swizzled layout the wgmma descriptors name. S = Q·Kᵀ is four
//   wgmma m64n64k16 steps (bf16 in, f32 accumulator in registers). The
//   online softmax runs on the accumulator fragment (row max and sum over
//   the quad with shuffles, log2(e)·scale folded into one multiply, exp2f,
//   keys >= N masked with -inf), P is rounded to bf16 in registers and fed
//   to O += P·V as wgmma's register A operand, V the shared-memory B
//   operand with the transpose bit. The two warpgroups double the warps on
//   each SM at batch 1; at the end they merge (m, l, O) through shared
//   memory (rescale by exp2(m_i - m) and add) and one stores O / l as bf16.
//   Two CTAs fit on an SM (<= 128 registers a thread, ~91 KB of shared
//   memory each), so `dpt-large`'s 16·10 = 160 tiles and batch 2's 264 run
//   in one wave.
//   Other head dims: the swizzled rows are panels of 64 columns (128
//   bytes, 128-byte swizzle); kD = 128 is two panels side by side (a k16
//   step of Q·Kᵀ reads panel kk / 4, and P·V is one m64n128k16 whose B
//   descriptor steps to the second panel by its leading byte offset), with
//   ~179 KB of shared memory and one CTA an SM; kD = 32 rows are 64 bytes
//   in the 64-byte swizzle (chunk c of row r at c ^ ((r / 2) % 4)), P·V an
//   m64n32k16.
//   Every pointer and b/h/n stride must be 16-byte aligned (the wrapper
//   checks; the entry point refuses anything else).
//
// f32: `flash_fwd_kernel`, SIMT on the FP32 cores (the tiny f32 configs;
//   TF32 tensor cores would not hold their 1e-5 tolerance). One thread owns
//   one query row (q and acc in registers), K/V tiles of 64 keys (32 at
//   kD = 128, to stay in 48 KB of static shared memory) are staged in
//   shared memory and read as warp-wide broadcasts, and keys are consumed
//   in chunks of 16 so the online-softmax rescale runs once per chunk. At
//   kD = 128 q and acc take 256 registers a thread and spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- f32 SIMT

constexpr int kBQ = 64;     // queries (threads) per block
constexpr int kChunk = 16;  // keys per online-softmax update

template <int kD>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int N, int D,
                 long long qsb, long long qsh, long long qsn,
                 long long ksb, long long ksh, long long ksn,
                 long long vsb, long long vsh, long long vsn,
                 long long osb, long long osh, long long osn, float scale) {
  constexpr int kBK = kD <= 64 ? 64 : 32;  // keys per shared-memory tile
  __shared__ float4 ks[kBK][kD / 4];
  __shared__ float4 vs[kBK][kD / 4];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  float qr[kD];
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row < N && d < D ? qb[row * qsn + d] : 0.f;
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
      const bool in = kk < nk && d < D;
      ksf[idx] = in ? kb[(k0 + kk) * ksn + d] : 0.f;
      vsf[idx] = in ? vb[(k0 + kk) * vsn + d] : 0.f;
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
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vs[c + j][d4];
          acc[4 * d4] += p * vv.x;
          acc[4 * d4 + 1] += p * vv.y;
          acc[4 * d4 + 2] += p * vv.z;
          acc[4 * d4 + 3] += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row < N) {
    float* ob = o + b * osb + h * osh + row * osn;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      if (d < D) ob[d] = acc[d] * inv;
    }
  }
}

// ------------------------------------------------------ bf16 tensor cores

constexpr int kTile = 64;                       // queries per CTA, keys per K/V tile
constexpr int kWgThreads = 128;                 // one warpgroup
constexpr int kThreads = 2 * kWgThreads;        // two warpgroups split the keys

// The shared-memory layout of one padded head dim. A tile of 64 rows is
// kPanels panels of kPW columns; a panel row is one swizzle row (128 bytes,
// or 64 at kD = 32). From a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows = 1024 bytes): Q, then per warpgroup two stages of
// (K, V), then the merge area (warpgroup 1's O fragment and m, l).
template <int kD>
struct Bf16Layout {
  static_assert(kD == 32 || kD == 64 || kD == 128, "padded head dims");
  static constexpr int kPW = kD < 64 ? kD : 64;        // panel width, elements
  static constexpr int kRowBytes = kPW * 2;             // 64 or 128
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte chunks a panel row
  static constexpr int kPanelBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kTile * kD * 2;     // 8 KB at kD = 64
  // wgmma descriptor fields: layout type (1 = 128-byte, 2 = 64-byte
  // swizzle) and the 8-row group stride in 16-byte units.
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSbo = 8 * kRowBytes / 16;
  // P·V's B operand (V, MN-major): the stride between 64-column panels.
  static constexpr uint32_t kLbo = kD == 128 ? kPanelBytes / 16 : 64;
  static constexpr int kAcc = kD / 2;                   // O fragment floats a thread
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemKV = kTileBytes;
  static constexpr int kSmemMerge = kSmemKV + 2 * 2 * 2 * kTileBytes;
  static constexpr int kMergeBytes = (kAcc + 4) * kWgThreads * 4;
  static constexpr int kSmemBytes = kSmemMerge + kMergeBytes + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "fits in an SM's shared memory");

  static __device__ __forceinline__ uint32_t kv_stage(int wg, int stage) {
    return kSmemKV + (wg * 2 + stage) * 2 * kTileBytes;  // K at +0, V at +kTileBytes
  }
  // Byte offset of row r's 16-byte chunk c (c < kD / 8) in a tile.
  static __device__ __forceinline__ uint32_t chunk(int r, int c) {
    const int p = c / kChunks;
    const int cc = c % kChunks;
    return p * kPanelBytes + r * kRowBytes + ((cc ^ ((r * kRowBytes >> 7) & (kChunks - 1))) << 4);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes (cp.async) become visible to wgmma's async-proxy
// reads of shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}

// One 64-row × kD-col bf16 tile (row stride `sn` elements) into shared
// memory at `dst` in the swizzled panel layout (Bf16Layout::chunk: at kD =
// 64, row r at r·128 bytes, its 16-byte chunk c at chunk c ^ (r % 8)).
// Rows at or past `n`, and (kMasked: D < kD) columns at or past `d`, are
// zeros.
template <int kD, bool kMasked>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base, long long sn,
                                          int n, int d, int tid, int nthreads) {
  constexpr int kRowChunks = kD / 8;
  for (int idx = tid; idx < kTile * kRowChunks; idx += nthreads) {
    const int r = idx / kRowChunks;
    const int c = idx % kRowChunks;
    const bool valid = r < n && (!kMasked || c * 8 < d);
    // An invalid chunk's address stays inside row 0's first D columns.
    const __nv_bfloat16* src = kMasked ? base + (valid ? r * sn + c * 8 : 0)
                                       : base + (valid ? r : 0) * sn + c * 8;
    cp_async16(dst + Bf16Layout<kD>::chunk(r, c), src, valid);
  }
}

// wgmma shared-memory descriptor: start address, the leading / stride byte
// offsets in 16-byte units, and the swizzle (layout type).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching a register wgmma still owns: reads of
// the accumulators stay after the wait, and P's registers stay live to it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define IPC_ACC16(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define IPC_ACC32(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31])
#define IPC_ACC64(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define IPC_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define IPC_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define IPC_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63}"

// d (+)= A·B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " IPC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : IPC_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, m64n{kD}k16, A (bf16 pairs) from registers, B from shared
// memory MN-major (the transpose bit).
template <int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " IPC_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : IPC_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " IPC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : IPC_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IPC_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : IPC_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragment of m64nN (per thread, N / 2 floats): warp w of the
// warpgroup owns rows 16w..16w+15; with g = lane / 4, t = lane % 4,
// element i sits at row 16w + g + 8·((i >> 1) & 1), column
// 8·(i >> 2) + 2t + (i & 1). The same pairs of S (m64n64), read four n8
// blocks at a time, are wgmma's register A fragment for k16 steps of P·V.
// Two CTAs an SM up to kD = 64; at kD = 128 the O fragment (64 floats) and
// ~179 KB of shared memory leave one. kMasked: D < kD, so loads of columns
// >= D are predicated off and only the first D columns are stored; D = kD
// (the served D = 64 among them) compiles without either test.
template <int kD, bool kMasked>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
flash_fwd_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int H, int N, int D,
                            long long qsb, long long qsh, long long qsn,
                            long long ksb, long long ksh, long long ksn,
                            long long vsb, long long vsh, long long vsn,
                            long long osb, long long osh, long long osn, float scale_log2) {
  using L = Bf16Layout<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* merge = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::kSmemMerge);

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  // Key tiles [first, last) of this warpgroup: the first half to 0, the
  // rest to 1 (the ragged last tile lands on 1 unless there is one tile).
  const int tiles = (N + kTile - 1) / kTile;
  const int half = (tiles + 1) / 2;
  const int first = wg == 0 ? 0 : half;
  const int count = (wg == 0 ? half : tiles) - first;

  load_tile<kD, kMasked>(sbase + L::kSmemQ, qb + static_cast<long long>(q0) * qsn, qsn,
                         N - q0, D, threadIdx.x, kThreads);
  if (count > 0) {
    const long long r0 = static_cast<long long>(first) * kTile;
    load_tile<kD, kMasked>(sbase + L::kv_stage(wg, 0), kb + r0 * ksn, ksn, N - first * kTile,
                           D, tid, kWgThreads);
    load_tile<kD, kMasked>(sbase + L::kv_stage(wg, 0) + L::kTileBytes, vb + r0 * vsn, vsn,
                           N - first * kTile, D, tid, kWgThreads);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float acc[L::kAcc];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums

  for (int it = 0; it < count; ++it) {
    const int tile = first + it;
    const int stage = it & 1;
    if (it + 1 < count) {
      const long long r0 = static_cast<long long>(tile + 1) * kTile;
      const uint32_t dst = sbase + L::kv_stage(wg, stage ^ 1);
      load_tile<kD, kMasked>(dst, kb + r0 * ksn, ksn, N - (tile + 1) * kTile, D, tid,
                             kWgThreads);
      load_tile<kD, kMasked>(dst + L::kTileBytes, vb + r0 * vsn, vsn, N - (tile + 1) * kTile, D,
                             tid, kWgThreads);
      cp_async_commit();
    }
    if (it > 0) {
      if (it + 1 < count) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();
      wg_barrier(wg);
    }
    const uint32_t ks = sbase + L::kv_stage(wg, stage);
    const uint32_t vs = ks + L::kTileBytes;

    // S = Q·Kᵀ: kD / 16 k16 steps; step kk reads panel 16kk / kPW, where
    // it advances the start address by 32 bytes a step within the swizzle
    // row.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (16 * kk / L::kPW) * L::kPanelBytes + (16 * kk % L::kPW) * 2;
      wgmma_ss(s, smem_desc(sbase + L::kSmemQ + off, 1, L::kSbo, L::kSwizzle),
               smem_desc(ks + off, 1, L::kSbo, L::kSwizzle), kk);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(s[i]);

    // Online softmax in the log2 domain; keys >= N get -inf.
    const int kvalid = N - tile * kTile;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      const float x = col < kvalid ? s[i] * scale_log2 : -INFINITY;
      s[i] = x;
      if ((i >> 1) & 1) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));  // finite: the tile has a valid key
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = exp2f(m0 - mn0);
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
    // O's rescale interleaved with the exponentials (at kD = 64 the
    // served kernel's schedule); the fragment's rows repeat every 4
    // elements, so acc[i] shares s[i]'s row.
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool r1 = (i >> 1) & 1;
      const float pa = exp2f(s[i] - (r1 ? mn1 : mn0));
      const float pb = exp2f(s[i + 1] - (r1 ? mn1 : mn0));
      if (r1) {
        l1 += pa + pb;
        if (i < L::kAcc) {
          acc[i] *= c1;
          acc[i + 1] *= c1;
        }
      } else {
        l0 += pa + pb;
        if (i < L::kAcc) {
          acc[i] *= c0;
          acc[i + 1] *= c0;
        }
      }
      p[i >> 1] = pack_bf16(pa, pb);  // P rounded to bf16, as the P·V dot sees it
    }
#pragma unroll
    for (int i = 32; i < L::kAcc; ++i) acc[i] *= ((i >> 1) & 1) ? c1 : c0;

    // O += P·V: k16 step kk takes P's columns 16kk..16kk+15 (registers
    // 4kk..4kk+3) and V's rows 16kk.. (16 swizzle rows further per step).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs<kD>(acc, a,
                   smem_desc(vs + kk * 16 * L::kRowBytes, L::kLbo, L::kSbo, L::kSwizzle));
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(p[i]);
    wg_barrier(wg);  // the stage is consumed before it is refilled
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Merge: warpgroup 1 hands its (m, l, O) to warpgroup 0, whose thread of
  // the same index holds the same rows and columns.
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i) merge[i * kWgThreads + tid] = acc[i];
    float* ml = merge + L::kAcc * kWgThreads + 4 * tid;
    ml[0] = m0;
    ml[1] = m1;
    ml[2] = l0;
    ml[3] = l1;
  }
  __syncthreads();
  if (wg == 1) return;
  const float* ml = merge + L::kAcc * kWgThreads + 4 * tid;
  const float mo0 = ml[0], mo1 = ml[1];
  const float mm0 = fmaxf(m0, mo0), mm1 = fmaxf(m1, mo1);
  const float a0 = exp2f(m0 - mm0), b0 = exp2f(mo0 - mm0);  // exp2(-inf) = 0: no keys
  const float a1 = exp2f(m1 - mm1), b1 = exp2f(mo1 - mm1);
  const float inv0 = 1.f / (l0 * a0 + ml[2] * b0);
  const float inv1 = 1.f / (l1 * a1 + ml[3] * b1);

  const int row0 = q0 + 16 * warp + g;
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (kMasked && col >= D) break;  // D is a multiple of 8: whole n8 blocks
    const float* mo = merge + 4 * j * kWgThreads + tid;
    if (row0 < N) {
      const float x = (acc[4 * j] * a0 + mo[0] * b0) * inv0;
      const float y = (acc[4 * j + 1] * a0 + mo[kWgThreads] * b0) * inv0;
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * osn + col) = __floats2bfloat162_rn(x, y);
    }
    if (row0 + 8 < N) {
      const float x = (acc[4 * j + 2] * a1 + mo[2 * kWgThreads] * b1) * inv1;
      const float y = (acc[4 * j + 3] * a1 + mo[3 * kWgThreads] * b1) * inv1;
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * osn + col) =
          __floats2bfloat162_rn(x, y);
    }
  }
}

bool aligned16(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i) {
    if (st[i] % 8 != 0) return false;  // 8 bf16 = 16 bytes
  }
  return true;
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
               const long long* st, float scale, cudaStream_t s) {
  dim3 grid((N + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<kD><<<grid, kBQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <int kD, bool kMasked>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s) {
  // Above 48 KB of shared memory only after opting in, once per device
  // and instance.
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_fwd_bf16_wgmma_kernel<kD, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Bf16Layout<kD>::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  dim3 grid((N + kTile - 1) / kTile, B * H);
  constexpr int kSmem = Bf16Layout<kD>::kSmemBytes;
  flash_fwd_bf16_wgmma_kernel<kD, kMasked><<<grid, kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: 1..128 (bf16: a multiple of 8).
// strides: 12 element strides, (b, h, n) for q, k, v, o in that order.
// Returns the launch's cudaError_t.
extern "C" int ipc_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int N, int D,
                                   const long long* st, float scale,
                                   int dtype, void* stream) {
  if (D < 1 || D > 128 || N <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 32) return launch_f32<32>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D <= 64) return launch_f32<64>(q, k, v, o, B, H, N, D, st, scale, s);
    return launch_f32<128>(q, k, v, o, B, H, N, D, st, scale, s);
  }
  if (dtype == 1) {
    if (D % 8 != 0) return cudaErrorInvalidValue;
    if (!(aligned16(q, st) && aligned16(k, st + 3) && aligned16(v, st + 6) &&
          aligned16(o, st + 9)))
      return cudaErrorMisalignedAddress;
    if (D == 32) return launch_bf16<32, false>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D < 32) return launch_bf16<32, true>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D == 64) return launch_bf16<64, false>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D < 64) return launch_bf16<64, true>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D == 128) return launch_bf16<128, false>(q, k, v, o, B, H, N, D, st, scale, s);
    return launch_bf16<128, true>(q, k, v, o, B, H, N, D, st, scale, s);
  }
  return cudaErrorInvalidValue;
}
