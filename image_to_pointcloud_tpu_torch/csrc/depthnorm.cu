// Robust depth normalization of B planes at once, for Hopper (sm_90a),
// plain C interface.
//
// Replaces no Pallas kernel: the JAX package's normalize_depth
// (image_to_pointcloud_tpu/ops/depthnorm.py) is jnp, and finds its order
// statistics without a sort (order_statistics bisects the floats'
// IEEE-total-order keys, 32 counting passes). This kernel stands for that
// sort-free search on the card: an exact radix select over the same keys,
// in place of two full float sorts of every plane and some twenty
// one-element launches around them. For each plane of n f32 values:
//   1. the median of the finite values (non-finites count as +inf; ranks
//      (nfin-1)//2 and nfin//2 clamped at 0), which replaces the
//      non-finites,
//   2. numpy-'linear' percentiles p2, p98 from the ranks floor/ceil of
//      0.02·(n-1) and 0.98·(n-1), with (min, max) = ranks 0 and n-1 as the
//      fallback when p98 <= p2,
//   3. clip to [lo, hi] in the total order, (c - lo) / (hi - lo + 1e-6),
//      0 where hi > lo fails, 1 - out when inverting.
//
// What bounds it on the H100: bytes. The work is a handful of reads of the
// planes (DPT-Large's bulk batch: 16 × 518² f32, 17.2 MB, which the 50 MB
// L2 holds between passes) and one write; the arithmetic is a few integer
// operations an element.
//
// Design: four histogram passes of 8 key bits each (most significant
// first) and one elementwise pass, every pass one launch over all B
// planes (grid (⌈n/4096⌉, B), 256 threads a block, 16 values a thread).
// Each plane carries up to 14 target ranks: the two median ranks and the
// six percentile / extreme ranks of the masked plane (non-finites as
// +inf), and, when the plane has m > 0 non-finites, the six ranks r - m.
// The order statistics of the plane with the median written in follow
// from those without a second select: the m copies of the median sit
// between the finite values below it and those above, so rank r holds the
// masked plane's rank r if that is below the median, its rank r - m if
// that is above, and the median otherwise. A pass counts each value under
// the target prefix it extends (targets that share a prefix share one
// 256-bin histogram; distinct prefixes never overlap, so a value lands in
// at most one), in shared memory with one atomic a warp for lanes of one
// bin (a smooth depth map gives a warp of 32 neighbours one digit or a
// few: a warp-uniform test, else __match_any_sync), then flushes the
// nonzero bins to the plane's global histogram.
// The last block of each plane to flush (a ticket counter, after a fence)
// scans that plane's histograms, a warp a prefix, finds each target's
// digit and remaining rank, and dedups the new prefixes for the next
// pass; after the fourth it turns the keys into lo, hi, the median and
// the divisor. So no launch waits on the host, nothing is allocated here
// (the caller passes zeroed scratch), and the whole call is capturable in
// a CUDA graph.
//
// Rounding: bit for bit the port's plain version (and the JAX package's
// f32 arithmetic): every step is an _rn intrinsic, so nvcc contracts
// nothing into an FMA, and the division is IEEE. frac2, frac98 and 1e-6
// come from the host already rounded to f32.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;               // 8 key bits a pass
constexpr int kPasses = 4;
constexpr int kTargets = 14;             // 2 median + 6 percentile + 6 shifted ranks
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // values a block a pass
constexpr int kSelected = 6;             // floor/ceil p2, floor/ceil p98, min, max

// Per-plane state, in the caller's zeroed scratch.
struct Plane {
  unsigned done[kPasses];         // blocks of each pass that have flushed
  unsigned nonfinite;             // the plane's non-finite values (pass 0)
  int nslots;                     // distinct prefixes the next pass counts
  unsigned slot_prefix[kTargets];
  unsigned prefix[kTargets];      // each target's key bits found so far
  int rank[kTargets];             // its rank under that prefix; -1: unused
  int slot[kTargets];             // its prefix's index in slot_prefix
  float med, lo, hi, denom;
};

struct Params {
  int rank[kSelected];            // the six ranks of the replaced plane
  float frac2, frac98, eps;
};

constexpr long long kPlaneBytes = (sizeof(Plane) + 15) / 16 * 16;
constexpr long long kHistWords = static_cast<long long>(kTargets) * kBins;

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// IEEE-754 total order as unsigned keys: -0.0 just below +0.0.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The key of a value as the median's search sees it: non-finites as +inf.
__device__ __forceinline__ unsigned masked_key(float v) {
  return key_of(finite(v) ? v : __uint_as_float(0x7f800000u));
}

// The last block of a plane, after pass `pass`: each target's next digit
// and remaining rank from the plane's histograms (in `cnt`, shared), the
// new prefixes deduplicated, and after the last pass the plane's lo, hi,
// median and divisor.
__device__ void select_digits(Plane* pl, unsigned* cnt, int pass, int n, const Params& prm) {
  __shared__ unsigned t_prefix[kTargets], n_prefix[kTargets];
  __shared__ int t_rank[kTargets], t_slot[kTargets], n_rank[kTargets];
  __shared__ int nslots;
  const int tid = threadIdx.x;
  // A thread a target: the targets' state read in parallel.
  if (tid < kTargets) {
    const int t = tid;
    if (pass == 0) {
      const int m = static_cast<int>(__ldcg(&pl->nonfinite));
      const int nfin = n - m;
      if (t < 2) {
        t_rank[t] = t == 0 ? (nfin > 0 ? (nfin - 1) / 2 : 0) : nfin / 2;
      } else if (t < 2 + kSelected) {
        t_rank[t] = prm.rank[t - 2];
      } else {
        const int r = prm.rank[t - 2 - kSelected];
        t_rank[t] = (m > 0 && r >= m) ? r - m : -1;
      }
      t_prefix[t] = 0u;
      t_slot[t] = 0;
      if (t == 0) nslots = 1;
    } else {
      t_prefix[t] = pl->prefix[t];
      t_rank[t] = pl->rank[t];
      t_slot[t] = pl->slot[t];
      if (t == 0) nslots = pl->nslots;
    }
  }
  __syncthreads();
  // A warp a prefix: lane l holds bins 8l..8l+7, an exclusive scan over
  // the warp gives each bin's count of smaller digits.
  const int warp = tid >> 5, lane = tid & 31;
  for (int s = warp; s < nslots; s += kWarps) {
    unsigned c[8];
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      c[q] = cnt[s * kBins + lane * 8 + q];
      sum += c[q];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    for (int t = 0; t < kTargets; ++t) {
      if (t_slot[t] != s || t_rank[t] < 0) continue;
      const unsigned r = static_cast<unsigned>(t_rank[t]);
      unsigned below = incl - sum;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (below <= r && r < below + c[q]) {
          n_prefix[t] = (t_prefix[t] << 8) | static_cast<unsigned>(lane * 8 + q);
          n_rank[t] = static_cast<int>(r - below);
        }
        below += c[q];
      }
    }
  }
  __syncthreads();
  if (tid != 0) return;
  // The new prefixes, deduplicated: the next pass's slots.
  unsigned slot_prefix[kTargets];
  int slots = 0;
  for (int t = 0; t < kTargets; ++t) {
    if (t_rank[t] < 0) {
      pl->rank[t] = -1;
      continue;
    }
    const unsigned p = n_prefix[t];
    int s = 0;
    while (s < slots && slot_prefix[s] != p) ++s;
    if (s == slots) slot_prefix[slots++] = p;
    pl->prefix[t] = p;
    pl->rank[t] = n_rank[t];
    pl->slot[t] = s;
  }
  for (int s = 0; s < slots; ++s) pl->slot_prefix[s] = slot_prefix[s];
  pl->nslots = slots;
  if (pass != kPasses - 1) return;

  // The keys are found: the median, the replaced plane's six order
  // statistics, then lo, hi and the divisor, as the plain version rounds.
  const int m = static_cast<int>(pl->nonfinite);
  const float med = __fmul_rn(0.5f, __fadd_rn(value_of(n_prefix[0]), value_of(n_prefix[1])));
  const unsigned kmed = key_of(med);
  float os[kSelected];
  for (int j = 0; j < kSelected; ++j) {
    const unsigned a = n_prefix[2 + j], z = n_prefix[2 + kSelected + j];
    if (m == 0 || a < kmed) {
      os[j] = value_of(a);  // below the median's copies
    } else if (t_rank[2 + kSelected + j] >= 0 && z > kmed) {
      os[j] = value_of(z);  // above them
    } else {
      os[j] = med;
    }
  }
  const float p2 = __fadd_rn(__fmul_rn(os[0], __fsub_rn(1.f, prm.frac2)), __fmul_rn(os[1], prm.frac2));
  const float p98 = __fadd_rn(__fmul_rn(os[2], __fsub_rn(1.f, prm.frac98)), __fmul_rn(os[3], prm.frac98));
  const bool fallback = p98 <= p2;
  const float lo = fallback ? os[4] : p2;
  const float hi = fallback ? os[5] : p98;
  pl->med = med;
  pl->lo = lo;
  pl->hi = hi;
  pl->denom = __fadd_rn(__fsub_rn(hi, lo), prm.eps);
}

// One pass: the histogram of 8 key bits under each target prefix, for
// the block's 4096 values of plane blockIdx.y; the plane's last block
// then selects.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const float* __restrict__ x, int n, int pass, Plane* __restrict__ planes,
                 unsigned* __restrict__ hist, Params prm) {
  __shared__ unsigned sh[kHistWords];
  __shared__ unsigned prefixes[kTargets];
  __shared__ bool last;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  Plane* pl = planes + b;
  const int nslots = pass == 0 ? 1 : pl->nslots;
  if (tid < kTargets) prefixes[tid] = pass == 0 ? 0u : pl->slot_prefix[tid];
  for (int i = tid; i < nslots * kBins; i += kThreads) sh[i] = 0u;

  // Every read issues before the counting.
  const float* xp = x + static_cast<long long>(b) * n;
  const int base = blockIdx.x * kChunk + tid;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    v[j] = i < n ? xp[i] : 0.f;
  }
  __syncthreads();

  const int shift = 24 - 8 * pass;  // the digit's lowest bit
  unsigned nonfinite = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int bin = -1;
    if (base + j * kThreads < n) {
      nonfinite += !finite(v[j]);
      const unsigned k = masked_key(v[j]);
      const int d = static_cast<int>((k >> shift) & 0xffu);
      if (pass == 0) {
        bin = d;
      } else {
        const unsigned p = k >> (shift + 8);
        for (int s = 0; s < nslots; ++s) {
          if (p == prefixes[s]) {
            bin = s * kBins + d;
            break;
          }
        }
      }
    }
    // Lanes of one bin add once (all 32 lanes reach this every j). A warp
    // of one bin, or of none (the later passes' common case), skips the
    // match.
    const int first = __shfl_sync(0xffffffffu, bin, 0);
    if (__all_sync(0xffffffffu, bin == first)) {
      if (lane == 0 && first >= 0) atomicAdd(&sh[first], 32u);
    } else {
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&sh[bin], static_cast<unsigned>(__popc(peers)));
      }
    }
  }
  __syncthreads();

  unsigned* gh = hist + (static_cast<long long>(pass) * gridDim.y + b) * kHistWords;
  for (int i = tid; i < nslots * kBins; i += kThreads) {
    const unsigned c = sh[i];
    if (c) atomicAdd(&gh[i], c);
  }
  if (pass == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) nonfinite += __shfl_down_sync(0xffffffffu, nonfinite, off);
    if (lane == 0 && nonfinite) atomicAdd(&pl->nonfinite, nonfinite);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&pl->done[pass], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Every block's counts are in; the plane's histograms into shared memory.
  for (int i = tid; i < nslots * kBins; i += kThreads) sh[i] = __ldcg(&gh[i]);
  __syncthreads();
  select_digits(pl, sh, pass, n, prm);
}

// The elementwise pass: non-finites to the median, the total-order clip,
// the scale, the degenerate case and the inversion.
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
             const Plane* __restrict__ planes, int invert) {
  const Plane& pl = planes[blockIdx.y];
  const float med = pl.med, lo = pl.lo, hi = pl.hi, denom = pl.denom;
  const unsigned klo = key_of(lo), khi = key_of(hi);
  const bool spread = hi > lo;
  const long long off = static_cast<long long>(blockIdx.y) * n;
  const int base = blockIdx.x * kChunk + threadIdx.x;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    v[j] = i < n ? x[off + i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i >= n) continue;
    const float y = finite(v[j]) ? v[j] : med;
    float c = key_of(y) < klo ? lo : y;
    c = key_of(c) > khi ? hi : c;
    const float o = spread ? __fdiv_rn(__fsub_rn(c, lo), denom) : 0.f;
    out[off + i] = invert ? __fsub_rn(1.f, o) : o;
  }
}

}  // namespace

// Bytes of zeroed scratch ipc_depthnorm needs for B planes.
extern "C" long long ipc_depthnorm_scratch_bytes(int B) {
  return B * (kPlaneBytes + kPasses * kHistWords * 4);
}

// x, out: (B, n) f32, contiguous; scratch: ipc_depthnorm_scratch_bytes(B)
// bytes, zeroed, 16-byte aligned. ranks: floor/ceil of 0.02·(n-1) and of
// 0.98·(n-1), then 0 and n-1; frac2, frac98, eps: f32 as the plain
// version rounds them. Returns the first launch's cudaError_t, or 0.
extern "C" int ipc_depthnorm(const float* x, float* out, void* scratch, int B, int n,
                             int r0, int r1, int r2, int r3, int r4, int r5,
                             float frac2, float frac98, float eps, int invert, void* stream) {
  if (B <= 0 || B > 65535 || n <= 0 || n > INT_MAX - kChunk) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plane* planes = static_cast<Plane*>(scratch);
  unsigned* hist = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + B * kPlaneBytes);
  Params prm{{r0, r1, r2, r3, r4, r5}, frac2, frac98, eps};
  const dim3 grid(static_cast<unsigned>((n + kChunk - 1) / kChunk), static_cast<unsigned>(B));
  for (int pass = 0; pass < kPasses; ++pass) {
    histogram_kernel<<<grid, kThreads, 0, s>>>(x, n, pass, planes, hist, prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  apply_kernel<<<grid, kThreads, 0, s>>>(x, out, n, planes, invert);
  return cudaGetLastError();
}
