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
// Head dims: any. Up to 128 both kernels are templates on a padded head
// dim kD ∈ {32, 64, 128}, and a call takes the smallest that holds D;
// above it, O panels of 128 columns (below). Loads of columns >= D are
// predicated to zero (so they add nothing to q·k and p·v), the scale is
// the caller's 1/√D of the true D, and only the first D columns are
// stored. kD = 64 is the served instance (DA-V2, ViT-L/16, ViT-B/16).
// Rows are read in 16-byte chunks, so D must be a multiple of 8 in bf16
// and of 4 in f32, and every pointer and b/h/n stride 16-byte aligned (the
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
// f32: `flash_fwd_tf32x3_kernel`, on the tensor cores in 3xTF32.
//   What bounds it: at DA-V2's (1, 6, 1370, 64) a call is 2.9 GFLOP. On
//   the FP32 cores that is 0.043 ms at 67 TFLOP/s; 3xTF32 does three
//   TF32 products for each f32 one, 0.0175 ms at 495 TFLOP/s; the 8.4 MB
//   of q/k/v/o take 0.0025 ms at 3.35 TB/s: compute.
//   Precision: each f32 operand x is split into hi = cvt.rna.tf32(x) and
//   lo = cvt.rna.tf32(x - hi); a·b is taken as a_hi·b_hi + a_hi·b_lo +
//   a_lo·b_hi with an f32 accumulator, which drops only a_lo·b_lo and the
//   rounding of lo (about 2^-21 of |a·b|), against the 1e-5 tolerance.
//   S = Q·Kᵀ and O += P·V are both done so; P is split in registers. The
//   tensor cores' additions into an accumulator do not round to nearest,
//   so what accumulates is kept short: the correction products of S go to
//   an accumulator of their own (added to the hi·hi sum once, in f32), and
//   each key tile's P·V goes to a fresh accumulator that is added to O in
//   f32 (O = O·c + tile, one fmaf). Summed into one accumulator over all
//   of DA-V2's 43 key tiles, the error was ~3x an f32 FMA loop's, enough
//   to move an int8 encoder's activation codes (PERF.md §6).
//   Design: the bf16 kernel's CTA (two warpgroups over one 64-query tile,
//   each its half of the key tiles, merged at the end). tf32 wgmma has no
//   transpose bit, so both operands are K-major: Q and K as stored, and V
//   written transposed (Vᵀ: one row a head-dim column, keys contiguous).
//   No copy engine can split or transpose, so K/V go through registers: a
//   warpgroup loads its next key tile with float4 loads while the tensor
//   cores work on the current one, then writes hi and lo into its single
//   shared-memory stage (K in the 128-byte swizzle, Vᵀ with the keys of
//   each group of 8 permuted so that S's accumulator pairs are directly
//   P's A fragment). Key tiles are kBK = 32 keys (16 at kD = 128, where
//   the O fragment is 64 registers).
//   Shared memory (hi + lo of each tile): Q 64 × kD × 8 bytes, shared by
//   the warpgroups; each warpgroup K kBK × kD × 8 and Vᵀ kD × kBK × 8.
//     kD =  32: Q 16 KB + 2 × (8 + 8) KB = 48 KB (+ 1 KB alignment slack)
//     kD =  64: Q 32 KB + 2 × (16 + 16) KB = 96 KB
//     kD = 128: Q 64 KB + 2 × (16 + 16) KB = 128 KB
//   The merge of (m, l, O) reuses the warpgroups' K/V area. Registers (O,
//   a tile's O, S and its corrections, P's hi and lo, the prefetched
//   tile) make it one CTA an SM at every kD; DA-V2's batch-1 grid is 132
//   CTAs, one an SM anyway.
//
// D > 128: O in panels of 128 columns, each owned by one warpgroup, so S
//   is computed once a key tile for a whole group of panels: each
//   warpgroup computes its panel's partial S, the partials are summed in
//   f32 in one order (rank 0, 1, ...), and every warpgroup runs the same
//   softmax and multiplies the same P into its panel of V.
//   What bounds it: at (1, 4, 1370, 192) a call is 5.8 GFLOP (bf16 5.8 µs
//   at 989 TFLOP/s; f32 in 3xTF32 35 µs at 495) against 8.4 MB (2.5 µs):
//   compute. At batch 1 the grids are small ((1, 2, 300, 320): 10 query
//   tiles), so a CTA's time over all key tiles sets the call's.
//   bf16 (`flash_fwd_bf16_wide_kernel`): the panels of a group are the
//   two or three warpgroups of one CTA, the partials summed through its
//   shared memory. Up to D = 384 (one group) the Q panels stay resident
//   and the K and V panels are double-buffered by cp.async with the next
//   tile in flight; S and P·V run on the bf16 tensor cores (wgmma
//   m64n{32,64}k16 and m64n128k16), P rounded to bf16 as in the kernel
//   above. Past 384 columns every group of three panels computes all of S
//   (once per 384 columns), streaming the Q and K panels.
//   f32 (`flash_fwd_tf32x3_cluster_kernel`): Q hi / lo is 64 KB a panel,
//   so three panels' Q would leave no room for K and V in one CTA. The
//   panels of a group are the CTAs of a thread-block cluster instead (up
//   to 8, D <= 1024), one warpgroup each, the partials summed from the
//   peers' shared memory (DSMEM): Q hi / lo resident, K / Vᵀ through
//   registers with the next tile in flight, the kD = 128 kernel's 3xTF32
//   tiles and accumulation rule. Past 8 panels,
//   `flash_fwd_tf32x3_stream_kernel` (groups of two panels, S streamed).
//   Measured against the one-CTA groups in f32 and against clusters in
//   bf16, each won at every timed shape (PERF.md §6).
//   Limits left: B·H and the number of 128-column panels at most 65535
//   (the launch grid's y and z bound the groups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ------------------------------------------------------------ f32: 3xTF32

// The tf32 kernel's shared-memory layout at O width kD. Every operand is
// K-major in 32-bit words: rows of 32 words (128 bytes, the 128-byte
// swizzle), a wider row as 32-word panels side by side; a Vᵀ row is kBK
// words (128 bytes, or 64 in the 64-byte swizzle at kBK = 16). Each tile
// has a hi half and, kBytes further, a lo half. The whole Q tile sits at 0
// for both warpgroups, and each warpgroup has one stage of K and Vᵀ.
template <int kD>
struct Tf32Layout {
  static_assert(kD == 32 || kD == 64 || kD == 128, "O widths");
  static constexpr int kBK = kD == 128 ? 16 : 32;   // keys a tile
  static constexpr int kQBytes = kTile * kD * 4;    // one half
  static constexpr int kKBytes = kBK * kD * 4;
  static constexpr int kVBytes = kD * kBK * 4;
  static constexpr int kVRowBytes = kBK * 4;
  static constexpr uint64_t kVSwizzle = kVRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kVSbo = 8 * kVRowBytes / 16;
  static constexpr int kWgBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kSmemWg = 2 * kQBytes;
  static constexpr int kAcc = kD / 2;  // O fragment floats a thread
  static constexpr int kMergeBytes = (kAcc + 4) * kWgThreads * 4;
  static_assert(kMergeBytes <= 2 * kWgBytes, "the merge reuses the warpgroups' area");
  static constexpr int kSmemBytes = kSmemWg + 2 * kWgBytes + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "fits in an SM's shared memory");

  static __device__ __forceinline__ uint32_t q(int) { return 0; }
  static __device__ __forceinline__ uint32_t k(int wg) { return kSmemWg + wg * kWgBytes; }
  static __device__ __forceinline__ uint32_t v(int wg) { return k(wg) + 2 * kKBytes; }
};

// Byte offset of 16-byte chunk c of row r in a tile of kRows rows whose
// rows are kRowBytes (64 or 128) wide panels: the swizzle XORs the chunk
// with the row's bits above the 128-byte line (Bf16Layout::chunk's rule).
template <int kRows, int kRowBytes>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = kRowBytes / 16;
  const int p = c / kChunks;
  const int cc = c % kChunks;
  return p * kRows * kRowBytes + r * kRowBytes +
         ((cc ^ ((r * kRowBytes >> 7) & (kChunks - 1))) << 4);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A kRows × kCols-word tile of T in a warpgroup's registers, as float4
// chunks: chunk j of a thread is linear index i = tid + 128·j, eight
// consecutive rows first (row 8·(i / 8 / kC) + i % 8, column chunk i / 8 %
// kC), so a warp's loads fill whole 32-byte sectors and its K-major
// stores hit eight differently swizzled chunks.
template <typename T, int kRows, int kCols>
struct TileRegs {
  static constexpr int kC = kCols / 4;
  static constexpr int kN = kRows * kC / kWgThreads;
  static_assert(kRows % 8 == 0 && kRows * kC % kWgThreads == 0, "whole chunks a thread");
  float4 x[kN];

  static __device__ __forceinline__ void coords(int i, int& r, int& c) {
    c = i / 8 % kC;
    r = i / 8 / kC * 8 + i % 8;
  }
  // Rows at or past `rows` and columns at or past `cols` (a multiple of
  // 4) are zeros; their addresses are never formed into loads.
  __device__ __forceinline__ void load(const T* base, long long sn, int rows, int cols, int tid) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      int r, c;
      coords(tid + kWgThreads * j, r, c);
      x[j] = r < rows && 4 * c < cols ? load4(base + r * sn + 4 * c)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// The tile's hi and lo halves into a K-major tile of kDstRows rows at byte
// offsets `hi`, `lo` of `smem`, from row `row0` on.
template <int kDstRows, typename R>
__device__ __forceinline__ void store_kmajor(const R& t, uint8_t* smem, uint32_t hi, uint32_t lo,
                                             int row0, int tid) {
#pragma unroll
  for (int j = 0; j < R::kN; ++j) {
    int r, c;
    R::coords(tid + kWgThreads * j, r, c);
    const uint32_t off = swz<kDstRows, 128>(row0 + r, c);
    const float4 x = t.x[j];
    const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    *reinterpret_cast<float4*>(smem + hi + off) = h;
    *reinterpret_cast<float4*>(smem + lo + off) =
        make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                    tf32_rna(x.w - h.w));
  }
}

// A (keys × columns) V tile's hi and lo halves transposed into Vᵀ (a row
// per column, kVRowBytes of keys). Within each group of 8 keys, key e goes
// to position e / 2 + 4·(e % 2): the A fragment of a tf32 k8 step holds
// columns t and t + 4 of a thread's row, where S's accumulator holds keys
// 2t and 2t + 1, so P's registers feed P·V as they are.
template <int kVRows, int kVRowBytes, typename R>
__device__ __forceinline__ void store_vt(const R& t, uint8_t* smem, uint32_t hi, uint32_t lo,
                                         int tid) {
#pragma unroll
  for (int j = 0; j < R::kN; ++j) {
    int r, c;
    R::coords(tid + kWgThreads * j, r, c);
    const int kp = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
    const float xs[4] = {t.x[j].x, t.x[j].y, t.x[j].z, t.x[j].w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t off = swz<kVRows, kVRowBytes>(4 * c + m, kp / 4) + 4 * (kp % 4);
      const float h = tf32_rna(xs[m]);
      *reinterpret_cast<float*>(smem + hi + off) = h;
      *reinterpret_cast<float*>(smem + lo + off) = tf32_rna(xs[m] - h);
    }
  }
}

#define IPC_ACC8(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7])
#define IPC_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

// S (+)= A·B, m64n{N}k8 tf32, A and B from shared memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " IPC_D8 ", %8, %9, p, 1, 1;\n}\n"
      : IPC_ACC8(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " IPC_D16 ", %16, %17, p, 1, 1;\n}\n"
      : IPC_ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A·B, m64n{N}k8 tf32, A (tf32 words) from registers, B from shared
// memory, K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " IPC_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : IPC_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " IPC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : IPC_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " IPC_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : IPC_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S (+)= Q·Kᵀ over kSteps k8 steps of the resident Q and K columns (hi at
// q / k, lo kQBytes / kKBytes further); step kk reads panel kk / 4, 32
// bytes further along the swizzle row a step. The correction products
// lo·hi and hi·lo go to their own accumulator `c`, so the small terms are
// not added into (and truncated against) the large hi·hi sum.
template <typename L, int kSteps>
__device__ __forceinline__ void qk_steps(float (&s)[L::kBK / 2], float (&c)[L::kBK / 2],
                                         uint32_t q, uint32_t k, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t oq = (kk / 4) * kTile * 128 + (kk % 4) * 32;
    const uint32_t ok = (kk / 4) * L::kBK * 128 + (kk % 4) * 32;
    const uint64_t qh = smem_desc(q + oq, 1, 64, 1);
    const uint64_t kh = smem_desc(k + ok, 1, 64, 1);
    const int acc = accumulate || kk > 0;
    wgmma_tf32_ss<L::kBK>(c, smem_desc(q + L::kQBytes + oq, 1, 64, 1), kh, acc);
    wgmma_tf32_ss<L::kBK>(c, qh, smem_desc(k + L::kKBytes + ok, 1, 64, 1), 1);
    wgmma_tf32_ss<L::kBK>(s, qh, kh, acc);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One key tile of the tf32 kernels after S: the online softmax of s (the
// tile's logits, kBK / 2 a thread, keys >= nk masked) in the log2 domain,
// then this tile's P·V in 3xTF32 against the hi / lo Vᵀ tile at `vs`,
// into a fresh accumulator that is added to O (acc) in f32.
template <typename L, int kN>
__device__ __forceinline__ void tf32_softmax_pv(float (&s)[L::kBK / 2], int nk, int t,
                                                float scale_log2, uint32_t vs,
                                                float (&acc)[kN / 2], float& m0, float& m1,
                                                float& l0, float& l1) {
  constexpr int kBK = L::kBK;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    const float x = col < nk ? s[i] * scale_log2 : -INFINITY;
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
  // P's A fragments, one a k8 step of 8 keys: (row g, key 2t), (g + 8,
  // 2t), (g, 2t + 1), (g + 8, 2t + 1), at positions t, t, t + 4, t + 4.
  uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const float pa = exp2f(s[4 * j] - mn0);
    const float pb = exp2f(s[4 * j + 1] - mn0);
    const float pc = exp2f(s[4 * j + 2] - mn1);
    const float pd = exp2f(s[4 * j + 3] - mn1);
    l0 += pa + pb;
    l1 += pc + pd;
    const float a[4] = {pa, pc, pb, pd};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = tf32_rna(a[e]);
      ph[j][e] = __float_as_uint(hi);
      pl[j][e] = __float_as_uint(tf32_rna(a[e] - hi));
    }
  }

  // This tile's P·V into a fresh accumulator (k8 step j reads keys 8j..
  // of Vᵀ, 32 bytes further a step), then O = O·c + tile in f32, rounded
  // to nearest: the tensor cores' additions into an accumulator are not,
  // and over all of N's tiles in one accumulator their error would grow
  // with N.
  float ot[kN / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const uint64_t vh = smem_desc(vs + 32 * j, 1, L::kVSbo, L::kVSwizzle);
    wgmma_tf32_rs<kN>(ot, pl[j], vh, j > 0);
    wgmma_tf32_rs<kN>(ot, ph[j], smem_desc(vs + L::kVBytes + 32 * j, 1, L::kVSbo, L::kVSwizzle),
                      1);
    wgmma_tf32_rs<kN>(ot, ph[j], vh, 1);
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    fence_reg(ot[i]);
    acc[i] = fmaf(acc[i], ((i >> 1) & 1) ? c1 : c0, ot[i]);
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_reg(ph[j][e]);
      fence_reg(pl[j][e]);
    }
  }
}

// Accumulator fragments as in the bf16 kernel (element i of m64nN at row
// 16w + g + 8·((i >> 1) & 1), column 8·(i >> 2) + 2t + (i & 1)).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int H, int N, int D,
                        long long qsb, long long qsh, long long qsn,
                        long long ksb, long long ksh, long long ksn,
                        long long vsb, long long vsh, long long vsn,
                        long long osb, long long osh, long long osn, float scale_log2) {
  using T = float;
  using L = Tf32Layout<kD>;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);  // generic pointer at sbase
  float* merge = reinterpret_cast<float*>(sm + L::kSmemWg);

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
  const T* qb = q + b * qsb + h * qsh + static_cast<long long>(q0) * qsn;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  const int tiles = (N + kBK - 1) / kBK;
  const int half = (tiles + 1) / 2;
  const int first = wg == 0 ? 0 : half;
  const int count = (wg == 0 ? half : tiles) - first;
  const uint32_t qoff = L::q(wg), koff = L::k(wg), voff = L::v(wg);

  TileRegs<T, kBK, kD> kr;
  TileRegs<T, kBK, kD> vr;
  {  // Q once (each warpgroup its 32 rows), and the first K/V tile.
    TileRegs<T, kTile / 2, kD> qr;
    qr.load(qb + static_cast<long long>(32 * wg) * qsn, qsn, N - q0 - 32 * wg, D, tid);
    store_kmajor<kTile>(qr, sm, qoff, qoff + L::kQBytes, 32 * wg, tid);
    if (count > 0) {
      const long long r0 = static_cast<long long>(first) * kBK;
      kr.load(kb + r0 * ksn, ksn, N - first * kBK, D, tid);
      vr.load(vb + r0 * vsn, vsn, N - first * kBK, D, tid);
      store_kmajor<kBK>(kr, sm, koff, koff + L::kKBytes, 0, tid);
      store_vt<kD, L::kVRowBytes>(vr, sm, voff, voff + L::kVBytes, tid);
    }
    fence_proxy_async();
    __syncthreads();
  }

  float acc[L::kAcc];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums

  for (int it = 0; it < count; ++it) {
    const int tile = first + it;
    const long long r0 = static_cast<long long>(tile) * kBK;
    const int nk = N - tile * kBK;  // valid keys of the tile (may exceed kBK)
    float s[kBK / 2], sc[kBK / 2];  // hi·hi, and the corrections
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = sc[i] = 0.f;
    if (it + 1 < count) {  // the next tile, in flight during this one's products
      kr.load(kb + (r0 + kBK) * ksn, ksn, nk - kBK, D, tid);
      vr.load(vb + (r0 + kBK) * vsn, vsn, nk - kBK, D, tid);
    }
    wgmma_fence();
    qk_steps<L, kD / 8>(s, sc, sbase + qoff, sbase + koff, false);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      fence_reg(s[i]);
      fence_reg(sc[i]);
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] += sc[i];

    // Online softmax in the log2 domain; keys >= N get -inf. The same
    // steps as tf32_softmax_pv, kept inline here: through the helper the
    // served f32 instance ran ~4 % slower in an A/B (PERF.md §6).
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      const float x = col < nk ? s[i] * scale_log2 : -INFINITY;
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
    // P's A fragments, one a k8 step of 8 keys: (row g, key 2t), (g + 8,
    // 2t), (g, 2t + 1), (g + 8, 2t + 1), at positions t, t, t + 4, t + 4.
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float pa = exp2f(s[4 * j] - mn0);
      const float pb = exp2f(s[4 * j + 1] - mn0);
      const float pc = exp2f(s[4 * j + 2] - mn1);
      const float pd = exp2f(s[4 * j + 3] - mn1);
      l0 += pa + pb;
      l1 += pc + pd;
      const float a[4] = {pa, pc, pb, pd};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_rna(a[e]);
        ph[j][e] = __float_as_uint(hi);
        pl[j][e] = __float_as_uint(tf32_rna(a[e] - hi));
      }
    }

    // This tile's P·V into a fresh accumulator (k8 step j reads keys 8j..
    // of Vᵀ, 32 bytes further a step), then O = O·c + tile in f32, rounded
    // to nearest: the tensor cores' additions into an accumulator are not,
    // and over all of N's tiles in one accumulator their error would grow
    // with N.
    float ot[L::kAcc];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const uint64_t vh = smem_desc(sbase + voff + 32 * j, 1, L::kVSbo, L::kVSwizzle);
      wgmma_tf32_rs<kD>(ot, pl[j], vh, j > 0);
      wgmma_tf32_rs<kD>(
          ot, ph[j], smem_desc(sbase + voff + L::kVBytes + 32 * j, 1, L::kVSbo, L::kVSwizzle), 1);
      wgmma_tf32_rs<kD>(ot, ph[j], vh, 1);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i) {
      fence_reg(ot[i]);
      acc[i] = fmaf(acc[i], ((i >> 1) & 1) ? c1 : c0, ot[i]);
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_reg(ph[j][e]);
        fence_reg(pl[j][e]);
      }
    }
    wg_barrier(wg);  // the stage is consumed before it is refilled
    if (it + 1 < count) {
      store_kmajor<kBK>(kr, sm, koff, koff + L::kKBytes, 0, tid);
      store_vt<kD, L::kVRowBytes>(vr, sm, voff, voff + L::kVBytes, tid);
      fence_proxy_async();
      wg_barrier(wg);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Merge, as the bf16 kernel's, through the warpgroups' K/V area once
  // both are done with it.
  __syncthreads();
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
  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= D) break;  // D is a multiple of 4: whole pairs
    const float* mo = merge + 4 * j * kWgThreads + tid;
    if (row0 < N) {
      store_pair(ob + row0 * osn + col, (acc[4 * j] * a0 + mo[0] * b0) * inv0,
                 (acc[4 * j + 1] * a0 + mo[kWgThreads] * b0) * inv0);
    }
    if (row0 + 8 < N) {
      store_pair(ob + (row0 + 8) * osn + col, (acc[4 * j + 2] * a1 + mo[2 * kWgThreads] * b1) * inv1,
                 (acc[4 * j + 3] * a1 + mo[3 * kWgThreads] * b1) * inv1);
    }
  }
}

// ------------------------------------------------ D > 128: 128-column panels

// A group of kWG panels of 128 columns a CTA, warpgroup w owning O panel
// w: the columns [128·(kWG·z + w), +128) of O for grid z. Each warpgroup
// computes a partial S = Q_w·K_wᵀ of every key tile over its S panels;
// the partials are summed in f32 through shared memory, in one order
// (((S_0 + S_1) + S_2)), so every warpgroup holds the same S, runs the
// same online softmax, and multiplies the same P into its panel of V. No
// merge of (m, l) is needed at the end. A panel past D (a ragged last
// group) reads zeros and stores nothing.

// Byte offset of 16-byte chunk c of row r in a tile of kRows rows and 128
// bf16 columns: two 64-column panels of 128-byte swizzled rows.
template <int kRows>
__device__ __forceinline__ uint32_t panel_chunk(int r, int c) {
  return (c / 8) * kRows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// kRows rows × the 128 columns of a panel (row stride sn elements) into
// shared memory at dst; rows >= n and columns >= d are zeros, and their
// copies read nothing (their source is `safe`, a valid address).
template <int kRows>
__device__ __forceinline__ void load_panel(uint32_t dst, const __nv_bfloat16* base, long long sn,
                                           int n, int d, const __nv_bfloat16* safe, int tid) {
#pragma unroll 4
  for (int idx = tid; idx < kRows * 16; idx += kWgThreads) {
    const int r = idx / 16;
    const int c = idx % 16;
    const bool valid = r < n && c * 8 < d;
    cp_async16(dst + panel_chunk<kRows>(r, c), valid ? base + r * sn + c * 8 : safe, valid);
  }
}

// d (+)= A·B, m64n32k16 bf16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " IPC_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : IPC_ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <int kN>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (kN == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else {
    static_assert(kN == 64, "key tiles of 32 or 64");
    wgmma_ss(d, da, db, accumulate);
  }
}

// The partial S of this warpgroup (its fragment, kN floats a thread) into
// its slot of `buf`, a CTA barrier, then the sum of the kWG partials in
// one order: element i of thread tid sits at [i·128 + tid] in each slot.
template <int kWG, int kN>
__device__ __forceinline__ void sum_partials(float (&s)[kN], float* buf, int wg, int tid) {
#pragma unroll
  for (int i = 0; i < kN; ++i) buf[(wg * kN + i) * kWgThreads + tid] = s[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float x = buf[i * kWgThreads + tid];
#pragma unroll
    for (int w = 1; w < kWG; ++w) x += buf[(w * kN + i) * kWgThreads + tid];
    s[i] = x;
  }
}

// bf16, D > 128: `flash_fwd_bf16_wide_kernel`, kWG warpgroups of 128
// threads, key tiles of kBK keys. Per warpgroup: a Q panel buffer (64 ×
// 128, 16 KB), two stages of a K and a V panel (kBK × 128 each), and its
// partial S in one of two buffers (64 × kBK f32; two, so a warpgroup that
// runs ahead cannot overwrite the sum another still reads). S is wgmma
// m64n{kBK}k16 from shared memory, P·V m64n128k16 with P in registers and
// V MN-major (the transpose bit), as the kD = 128 kernel's. Shared memory:
//   kWG = 2 (D <= 256), kBK = 64: 2 × (16 + 2 × 32) KB + 2 × 2 × 16 KB = 224 KB
//   kWG = 3 (D > 256), kBK = 32: 3 × (16 + 2 × 16) KB + 2 × 3 × 8 KB = 192 KB
// Registers: O (64 floats), S (kBK / 2) and P (kBK / 4) a thread, one CTA
// an SM.
// Up to kWG panels (one group, kStream false) warpgroup w's S panel is its
// O panel: its Q panel is loaded once and stays, and its K and V panels
// are double-buffered by cp.async, the next tile in flight during the
// current one's products. Past kWG panels (kStream) every group computes
// all of S: warpgroup w takes the S panels w, w + kWG, ..., and for each
// streams its Q and K panels through the same buffers, then its O panel's
// V (loads not overlapped: no preset runs a head this wide).
template <int kWG, int kBK>
struct WideBf16Layout {
  static constexpr int kQBytes = kTile * 128 * 2;
  static constexpr int kKVBytes = kBK * 128 * 2;      // a K or V panel
  static constexpr int kWgBytes = kQBytes + 2 * 2 * kKVBytes;
  static constexpr int kSmemS = kWG * kWgBytes;
  static constexpr int kSBytes = kWG * kTile * kBK * 4;  // one buffer of the partials
  static constexpr int kSmemBytes = kSmemS + 2 * kSBytes + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "fits in an SM's shared memory");

  static __device__ __forceinline__ uint32_t q(int wg) { return wg * kWgBytes; }
  static __device__ __forceinline__ uint32_t kv(int wg, int stage) {  // K, then V
    return wg * kWgBytes + kQBytes + stage * 2 * kKVBytes;
  }
};

// S (+)= the Q panel at `qs` times the K panel at `ks` (kBK keys), over
// the eight k16 steps of its 128 columns (columns past D are zeros): step
// kk reads 64-column panel kk / 4, 32 bytes further along the swizzle row
// a step. No step is skipped at run time: a wgmma issued under a branch
// makes ptxas fence every one of them.
template <int kBK>
__device__ __forceinline__ void bf16_qk_panel(float (&s)[kBK / 2], uint32_t qs, uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_bf16_ss<kBK>(s, smem_desc(qs + (kk / 4) * kTile * 128 + (kk % 4) * 32, 1, 64, 1),
                       smem_desc(ks + (kk / 4) * kBK * 128 + (kk % 4) * 32, 1, 64, 1), 1);
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) fence_reg(s[i]);
}

// One key tile after S, as the bf16 kernel's: the online softmax of s
// (keys >= kvalid masked) in the log2 domain, P rounded to bf16 in
// registers, O rescaled, and (pv: the warpgroup has columns) O += P·V
// over the tile's kBK / 16 k16 steps against the V panel at `vs` (16
// swizzle rows a step; its two 64-column panels kBK rows apart).
template <int kBK>
__device__ __forceinline__ void bf16_softmax_pv(float (&s)[kBK / 2], int kvalid, int t,
                                                float scale_log2, uint32_t vs, bool pv,
                                                float (&acc)[64], float& m0, float& m1,
                                                float& l0, float& l1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
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
  uint32_t p[kBK / 4];
#pragma unroll
  for (int i = 0; i < kBK / 2; i += 2) {
    const bool r1 = (i >> 1) & 1;
    const float pa = exp2f(s[i] - (r1 ? mn1 : mn0));
    const float pb = exp2f(s[i + 1] - (r1 ? mn1 : mn0));
    if (r1) {
      l1 += pa + pb;
    } else {
      l0 += pa + pb;
    }
    p[i >> 1] = pack_bf16(pa, pb);  // P rounded to bf16, as the P·V dot sees it
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= ((i >> 1) & 1) ? c1 : c0;
  if (!pv) return;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs<128>(acc, a, smem_desc(vs + kk * 16 * 128, kBK * 128 / 16, 64, 1));
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int i = 0; i < kBK / 4; ++i) fence_reg(p[i]);
}

template <int kWG, int kBK, bool kStream>
__global__ void __launch_bounds__(kWG * kWgThreads, 1)
flash_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int H, int N, int D,
                           long long qsb, long long qsh, long long qsn,
                           long long ksb, long long ksh, long long ksn,
                           long long vsb, long long vsh, long long vsn,
                           long long osb, long long osh, long long osn, float scale_log2) {
  using L = WideBf16Layout<kWG, kBK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* sbuf = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::kSmemS);

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
  const int col0 = (blockIdx.z * kWG + wg) * 128;  // this warpgroup's O panel
  const int dcols = D - col0;                      // its columns (may be <= 0)
  const __nv_bfloat16* qh = q + b * qsb + h * qsh;
  const __nv_bfloat16* kh = k + b * ksb + h * ksh;
  const __nv_bfloat16* vh = v + b * vsb + h * vsh;
  const __nv_bfloat16* qb = qh + static_cast<long long>(q0) * qsn;
  const uint32_t qs = sbase + L::q(wg);
  const int tiles = (N + kBK - 1) / kBK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums

  if constexpr (!kStream) {
    load_panel<kTile>(qs, qb + col0, qsn, N - q0, dcols, qh, tid);
    load_panel<kBK>(sbase + L::kv(wg, 0), kh + col0, ksn, N, dcols, kh, tid);
    load_panel<kBK>(sbase + L::kv(wg, 0) + L::kKVBytes, vh + col0, vsn, N, dcols, vh, tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    wg_barrier(wg);
    for (int tile = 0; tile < tiles; ++tile) {
      const int stage = tile & 1;
      if (tile + 1 < tiles) {
        const long long r0 = static_cast<long long>(tile + 1) * kBK;
        const uint32_t dst = sbase + L::kv(wg, stage ^ 1);
        load_panel<kBK>(dst, kh + r0 * ksn + col0, ksn, N - (tile + 1) * kBK, dcols, kh, tid);
        load_panel<kBK>(dst + L::kKVBytes, vh + r0 * vsn + col0, vsn, N - (tile + 1) * kBK,
                        dcols, vh, tid);
        cp_async_commit();
      }
      if (tile > 0) {
        if (tile + 1 < tiles) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        fence_proxy_async();
        wg_barrier(wg);
      }
      const uint32_t ks = sbase + L::kv(wg, stage);
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
      bf16_qk_panel<kBK>(s, qs, ks);
      sum_partials<kWG, kBK / 2>(s, sbuf + stage * (L::kSBytes / 4), wg, tid);
      bf16_softmax_pv<kBK>(s, N - tile * kBK, t, scale_log2, ks + L::kKVBytes, true, acc, m0, m1,
                           l0, l1);
      wg_barrier(wg);  // the stage is consumed before it is refilled
    }
  } else {
    const int panels = (D + 127) / 128;
    const uint32_t ks = sbase + L::kv(wg, 0);
    const uint32_t vs = ks + L::kKVBytes;
    for (int tile = 0; tile < tiles; ++tile) {
      const long long r0 = static_cast<long long>(tile) * kBK;
      const int nk = N - tile * kBK;
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
      for (int sp = wg; sp < panels; sp += kWG) {  // this warpgroup's S panels
        load_panel<kTile>(qs, qb + sp * 128, qsn, N - q0, D - sp * 128, qh, tid);
        load_panel<kBK>(ks, kh + r0 * ksn + sp * 128, ksn, nk, D - sp * 128, kh, tid);
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        wg_barrier(wg);
        bf16_qk_panel<kBK>(s, qs, ks);
        wg_barrier(wg);  // consumed before the next panel refills them
      }
      load_panel<kBK>(vs, vh + r0 * vsn + col0, vsn, nk, dcols, vh, tid);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      wg_barrier(wg);
      sum_partials<kWG, kBK / 2>(s, sbuf + (tile & 1) * (L::kSBytes / 4), wg, tid);
      bf16_softmax_pv<kBK>(s, nk, t, scale_log2, vs, dcols > 0, acc, m0, m1, l0, l1);
      wg_barrier(wg);
    }
  }
  if (dcols <= 0) return;
  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
  const int row0 = q0 + 16 * warp + g;
  __nv_bfloat16* ob = o + b * osb + h * osh + col0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= dcols) break;  // D is a multiple of 8: whole n8 blocks
    if (row0 < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * osn + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (row0 + 8 < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * osn + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// f32 past 8 panels (D > 1024): `flash_fwd_tf32x3_stream_kernel`, two
// warpgroups (O panels of a 256-column group, grid z) and the kD = 128
// kernel's 3xTF32 tiles (kBK = 16 keys, each tile's P·V in a fresh
// accumulator). Every group computes all of S: warpgroup w takes the S
// panels w, w + 2, ..., and for each loads its Q and K panels into
// registers together (one round trip a panel), splits them and stores
// them into its buffers; V's tile is in flight during S. Per warpgroup: a
// Q panel buffer hi / lo (64 KB), K (16 KB) and Vᵀ (16 KB); the partials'
// two buffers 2 × 2 × 4 KB: 208 KB.
struct Tf32StreamLayout {
  using P = Tf32Layout<128>;  // a panel's tiles: kBK = 16, Vᵀ rows of 64 bytes
  static constexpr int kWgBytes = 2 * P::kQBytes + 2 * P::kKBytes + 2 * P::kVBytes;
  static constexpr int kSmemS = 2 * kWgBytes;
  static constexpr int kSBytes = 2 * kTile * P::kBK * 4;  // one buffer of the partials
  static constexpr int kSmemBytes = kSmemS + 2 * kSBytes + 1024;
  static_assert(kSmemBytes <= 232448, "fits in an SM's shared memory");

  static __device__ __forceinline__ uint32_t q(int wg) { return wg * kWgBytes; }
  static __device__ __forceinline__ uint32_t k(int wg) { return q(wg) + 2 * P::kQBytes; }
  static __device__ __forceinline__ uint32_t v(int wg) { return k(wg) + 2 * P::kKBytes; }
};

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, int H, int N,
                             int D, long long qsb, long long qsh, long long qsn,
                             long long ksb, long long ksh, long long ksn,
                             long long vsb, long long vsh, long long vsn,
                             long long osb, long long osh, long long osn, float scale_log2) {
  using W = Tf32StreamLayout;
  using L = W::P;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);  // generic pointer at sbase
  float* sbuf = reinterpret_cast<float*>(sm + W::kSmemS);

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
  const int col0 = (blockIdx.z * 2 + wg) * 128;  // this warpgroup's O panel
  const int dcols = D - col0;                    // its columns (may be <= 0)
  const float* qb = q + b * qsb + h * qsh + static_cast<long long>(q0) * qsn;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh + col0;
  const uint32_t qoff = W::q(wg), koff = W::k(wg), voff = W::v(wg);
  const int tiles = (N + kBK - 1) / kBK;

  TileRegs<float, kBK, 128> kr;
  TileRegs<float, kBK, 128> vr;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums
  const int panels = (D + 127) / 128;
  for (int tile = 0; tile < tiles; ++tile) {
    const long long r0 = static_cast<long long>(tile) * kBK;
    const int nk = N - tile * kBK;  // valid keys of the tile (may exceed kBK)
    float s[kBK / 2], sc[kBK / 2];  // hi·hi, and the corrections
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = sc[i] = 0.f;
    // V's tile in flight during S; each S panel's Q and K loaded together
    // (one round trip a panel), split and stored.
    vr.load(vb + r0 * vsn, vsn, nk, dcols, tid);
    for (int sp = wg; sp < panels; sp += 2) {  // this warpgroup's S panels
      TileRegs<float, kTile, 128> qr;
      qr.load(qb + sp * 128, qsn, N - q0, D - sp * 128, tid);
      kr.load(kb + r0 * ksn + sp * 128, ksn, nk, D - sp * 128, tid);
      store_kmajor<kTile>(qr, sm, qoff, qoff + L::kQBytes, 0, tid);
      store_kmajor<kBK>(kr, sm, koff, koff + L::kKBytes, 0, tid);
      fence_proxy_async();
      wg_barrier(wg);
      wgmma_fence();
      qk_steps<L, 16>(s, sc, sbase + qoff, sbase + koff, true);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        fence_reg(s[i]);
        fence_reg(sc[i]);
      }
      wg_barrier(wg);  // consumed before the next panel refills them
    }
    store_vt<128, L::kVRowBytes>(vr, sm, voff, voff + L::kVBytes, tid);
    fence_proxy_async();
    wg_barrier(wg);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] += sc[i];
    sum_partials<2, kBK / 2>(s, sbuf + (tile & 1) * (W::kSBytes / 4), wg, tid);
    tf32_softmax_pv<L, 128>(s, nk, t, scale_log2, sbase + voff, acc, m0, m1, l0, l1);
    wg_barrier(wg);  // the stage is consumed before it is refilled
  }
  if (dcols <= 0) return;
  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
  const int row0 = q0 + 16 * warp + g;
  float* ob = o + b * osb + h * osh + col0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= dcols) break;  // D is a multiple of 4: whole pairs
    if (row0 < N) store_pair(ob + row0 * osn + col, acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < N) {
      store_pair(ob + (row0 + 8) * osn + col, acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ------------------------------------- D > 128, up to 8 panels: clusters

// A cluster of one CTA a 128-column panel (grid z and the cluster's z:
// the panels), each CTA one warpgroup. CTA p holds panel p of Q (loaded
// once) and streams panel p of K and V; the partial S of every key tile
// goes into its shared memory, and after a cluster barrier each CTA sums
// the partials of ranks 0, 1, ... in that order from its peers' shared
// memory (DSMEM), so every CTA holds the same S, runs the same softmax,
// and multiplies the same P into its panel of V. S is computed once a
// key tile over the whole D, each panel has an SM's shared memory and
// tensor cores to itself, and the grid has one CTA a panel.
// Every thread of the cluster's CTAs arrives, then waits for all: their
// shared-memory writes before it are visible to the peers' reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The partial S of this CTA (its fragment, kN floats a thread) into
// `buf` (a shared-memory address), a cluster barrier, then the sum of
// every rank's partial in rank order, read from the peers' shared memory
// (mapa: the same offset in rank r's window): element i of thread tid
// sits at [i·128 + tid] in each CTA's buf.
template <int kN>
__device__ __forceinline__ void cluster_sum_partials(float (&s)[kN], uint32_t buf, int tid) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(buf + 4 * (i * kWgThreads + tid)), "f"(s[i])
                 : "memory");
  }
  cluster_sync();
  uint32_t ranks;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ranks));
  for (uint32_t r = 0; r < ranks; ++r) {
    uint32_t peer;
    asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(buf), "r"(r));
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float x;
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(x)
                   : "r"(peer + 4 * (i * kWgThreads + tid))
                   : "memory");
      s[i] = r == 0 ? x : s[i] + x;
    }
  }
}

// f32 (`flash_fwd_tf32x3_cluster_kernel`): the kD = 128 kernel's 3xTF32
// tiles (kBK = 16 keys; K and Vᵀ hi / lo through registers, the next tile
// in flight during the current one's products; each tile's P·V in a
// fresh accumulator). Q panel hi / lo 64 KB (split and stored once), K
// and Vᵀ 16 KB each, two buffers of the partial S 8 KB: 105 KB, two CTAs
// an SM.
struct ClusterTf32Layout {
  using P = Tf32Layout<128>;  // a panel's tiles: kBK = 16, Vᵀ rows of 64 bytes
  static constexpr int kK = 2 * P::kQBytes;
  static constexpr int kV = kK + 2 * P::kKBytes;
  static constexpr int kSmemS = kV + 2 * P::kVBytes;
  static constexpr int kSBytes = kTile * P::kBK * 4;  // one buffer of the partial
  static constexpr int kSmemBytes = kSmemS + 2 * kSBytes + 1024;
};

__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_tf32x3_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, int H,
                                int N, int D, long long qsb, long long qsh, long long qsn,
                                long long ksb, long long ksh, long long ksn,
                                long long vsb, long long vsh, long long vsn,
                                long long osb, long long osh, long long osn,
                                float scale_log2) {
  using W = ClusterTf32Layout;
  using L = W::P;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);  // generic pointer at sbase
  const uint32_t sbuf = sbase + W::kSmemS;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int col0 = blockIdx.z * 128;  // this CTA's panel
  const int dcols = D - col0;         // its columns
  const float* qb = q + b * qsb + h * qsh + static_cast<long long>(q0) * qsn + col0;
  const float* kb = k + b * ksb + h * ksh + col0;
  const float* vb = v + b * vsb + h * vsh + col0;
  const int tiles = (N + kBK - 1) / kBK;

  TileRegs<float, kBK, 128> kr;
  TileRegs<float, kBK, 128> vr;
  {  // The Q panel once, in two halves of 32 rows, and the first K/V tile.
    TileRegs<float, kTile / 2, 128> qr;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      qr.load(qb + static_cast<long long>(32 * half) * qsn, qsn, N - q0 - 32 * half, dcols, tid);
      store_kmajor<kTile>(qr, sm, 0, L::kQBytes, 32 * half, tid);
    }
    kr.load(kb, ksn, N, dcols, tid);
    vr.load(vb, vsn, N, dcols, tid);
    store_kmajor<kBK>(kr, sm, W::kK, W::kK + L::kKBytes, 0, tid);
    store_vt<128, L::kVRowBytes>(vr, sm, W::kV, W::kV + L::kVBytes, tid);
    fence_proxy_async();
    __syncthreads();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums
  for (int tile = 0; tile < tiles; ++tile) {
    const long long r0 = static_cast<long long>(tile) * kBK;
    const int nk = N - tile * kBK;  // valid keys of the tile (may exceed kBK)
    if (tile + 1 < tiles) {  // the next tile, in flight during this one's products
      kr.load(kb + (r0 + kBK) * ksn, ksn, nk - kBK, dcols, tid);
      vr.load(vb + (r0 + kBK) * vsn, vsn, nk - kBK, dcols, tid);
    }
    float s[kBK / 2], sc[kBK / 2];  // hi·hi, and the corrections
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = sc[i] = 0.f;
    wgmma_fence();
    qk_steps<L, 16>(s, sc, sbase, sbase + W::kK, false);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      fence_reg(s[i]);
      fence_reg(sc[i]);
      s[i] += sc[i];
    }
    cluster_sum_partials<kBK / 2>(s, sbuf + (tile & 1) * W::kSBytes, tid);
    tf32_softmax_pv<L, 128>(s, nk, t, scale_log2, sbase + W::kV, acc, m0, m1, l0, l1);
    __syncthreads();  // the stage is consumed before it is refilled
    if (tile + 1 < tiles) {
      store_kmajor<kBK>(kr, sm, W::kK, W::kK + L::kKBytes, 0, tid);
      store_vt<128, L::kVRowBytes>(vr, sm, W::kV, W::kV + L::kVBytes, tid);
      fence_proxy_async();
      __syncthreads();
    }
  }
  cluster_sync();  // no peer reads this CTA's partials any more
  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
  const int row0 = q0 + 16 * warp + g;
  float* ob = o + b * osb + h * osh + col0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= dcols) break;  // D is a multiple of 4: whole pairs
    if (row0 < N) store_pair(ob + row0 * osn + col, acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < N) {
      store_pair(ob + (row0 + 8) * osn + col, acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// 16-byte aligned: the pointer, and the b/h/n strides in elements (8 bf16
// or 4 f32 to 16 bytes).
bool aligned16(const void* p, const long long* st, int per16) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i) {
    if (st[i] % per16 != 0) return false;
  }
  return true;
}

// Above 48 KB of shared memory only after opting in, once per device and
// instance (a bit per device in `configured`).
template <class Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, unsigned& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  return cudaSuccess;
}

template <int kD>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s) {
  static unsigned configured = 0;
  constexpr int kSmem = Tf32Layout<kD>::kSmemBytes;
  const cudaError_t err = opt_in(flash_fwd_tf32x3_kernel<kD>, kSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, B * H);
  flash_fwd_tf32x3_kernel<kD><<<grid, kThreads, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int kD, bool kMasked>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s) {
  static unsigned configured = 0;
  constexpr int kSmem = Bf16Layout<kD>::kSmemBytes;
  const cudaError_t err = opt_in(flash_fwd_bf16_wgmma_kernel<kD, kMasked>, kSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, B * H);
  flash_fwd_bf16_wgmma_kernel<kD, kMasked><<<grid, kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// f32 up to kMaxCluster panels: a cluster of one CTA a panel (grid z).
constexpr int kMaxCluster = 8;  // the portable cluster size

int launch_tf32_cluster(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int N, int D, const long long* st, float scale, cudaStream_t s) {
  static unsigned configured = 0;
  constexpr int smem = ClusterTf32Layout::kSmemBytes;
  const cudaError_t err = opt_in(flash_fwd_tf32x3_cluster_kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const int panels = (D + 127) / 128;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, B * H, panels);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = panels;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_fwd_tf32x3_cluster_kernel, static_cast<const float*>(q),
                            static_cast<const float*>(k), static_cast<const float*>(v),
                            static_cast<float*>(o), H, N, D, st[0], st[1], st[2], st[3], st[4],
                            st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                            scale * 1.4426950408889634f);
}

// Grid z over groups of 128-column panels: two in f32 past 8 panels, kWG
// in bf16, which past one group streams all of S's panels (kStream).
int launch_tf32_stream(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int N, int D, const long long* st, float scale, cudaStream_t s) {
  static unsigned configured = 0;
  constexpr int kSmem = Tf32StreamLayout::kSmemBytes;
  const cudaError_t err = opt_in(flash_fwd_tf32x3_stream_kernel, kSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, B * H, (D + 255) / 256);
  flash_fwd_tf32x3_stream_kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int kWG, int kBK, bool kStream>
int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                     int D, const long long* st, float scale, cudaStream_t s) {
  static unsigned configured = 0;
  constexpr int kSmem = WideBf16Layout<kWG, kBK>::kSmemBytes;
  const cudaError_t err =
      opt_in(flash_fwd_bf16_wide_kernel<kWG, kBK, kStream>, kSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, B * H, (D + kWG * 128 - 1) / (kWG * 128));
  flash_fwd_bf16_wide_kernel<kWG, kBK, kStream><<<grid, kWG * kWgThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D >= 1, a multiple of 4 (f32) or 8
// (bf16); B·H and ceil(D / 128) at most 65535 (the launch grid's y and z).
// strides: 12 element strides, (b, h, n) for q, k, v, o in that order,
// 16-byte aligned as the pointers. Returns the launch's cudaError_t.
extern "C" int ipc_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int N, int D,
                                   const long long* st, float scale,
                                   int dtype, void* stream) {
  if (D < 1 || N <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * H > 65535 || (D + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int per16 = dtype == 0 ? 4 : 8;
  if (D % per16 != 0) return cudaErrorInvalidValue;
  if (!(aligned16(q, st, per16) && aligned16(k, st + 3, per16) && aligned16(v, st + 6, per16) &&
        aligned16(o, st + 9, per16)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 32) return launch_tf32<32>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D <= 64) return launch_tf32<64>(q, k, v, o, B, H, N, D, st, scale, s);
    if (D <= 128) return launch_tf32<128>(q, k, v, o, B, H, N, D, st, scale, s);
    if ((D + 127) / 128 <= kMaxCluster)
      return launch_tf32_cluster(q, k, v, o, B, H, N, D, st, scale, s);
    return launch_tf32_stream(q, k, v, o, B, H, N, D, st, scale, s);
  }
  if (D == 32) return launch_bf16<32, false>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D < 32) return launch_bf16<32, true>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D == 64) return launch_bf16<64, false>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D < 64) return launch_bf16<64, true>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D == 128) return launch_bf16<128, false>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D < 128) return launch_bf16<128, true>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D <= 256) return launch_bf16_wide<2, 64, false>(q, k, v, o, B, H, N, D, st, scale, s);
  if (D <= 384) return launch_bf16_wide<3, 32, false>(q, k, v, o, B, H, N, D, st, scale, s);
  return launch_bf16_wide<3, 32, true>(q, k, v, o, B, H, N, D, st, scale, s);
}
