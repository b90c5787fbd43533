// The fused bucket aggregate over Fq and Fq2 in one launch: `bucket_reduce`,
// the port of the reference's `PallasEC._bucket_reduce_kernel`
// (crescent_tpu/ops/pallas_ec.py:575; op :790, `pl.pallas_call` :805),
// instantiated over Fe in ec.cu and over Fe2 in ec2.cu.
//
// What it computes.  Window w of a dense (W * B)-row Jacobian table (x, y,
// z), buckets S_0..S_{B-1} in rows w * B + b, becomes the one point
// sum_{b >= 1} b * S_b = sum_{d >= 1} running_d, running_d =
// sum_{b >= d} S_b: ceil(log2 B) suffix levels (row i += row i + j for
// j = 1, 2, 4, ..., the identity read past row B - 1), then a halving tree
// over rows 1..B - 1 (B - 1 a power of two; pairs (off + i, off + i + h),
// off = 1 at its first level, 0 after).  Every pair is the one the
// unfused aggregate adds (ops/cuda_ec.py `bucket_levels`, one `jadd`
// launch a level), in the same order, and each addition takes warp.cuh's
// rounds (`jadd_sum`) and cases (as `jadd_rounds`), which equal
// `jadd_plain` bit for bit, so the result is the unfused aggregate's, bit
// for bit.
//
// Where the time goes, and the design.  At c = 11 a window is B = 1025
// rows and 21 levels (11 of 1025 additions, then 512 down to 1), each
// addition 16 dependent Fq products (43 base products over Fq2).  One
// block a window leaves 107 of the card's 132 SMs idle, and one thread an
// addition runs its products in a row, so the work is bound by latency,
// not by the card's integer rate.  Here:
//   * a thread-block cluster of kBucketCluster<F> blocks runs one window
//     (grid W * K blocks, launched with cudaLaunchKernelEx and the cluster
//     attribute): 25 windows x 4 blocks take 100 SMs;
//   * the window's two level tables live in the cluster's distributed
//     shared memory: block r holds rows r S .. r S + S - 1 (S = ceil(B /
//     K)) of both, x, y and z planes, 98,400 B a table over Fq and 196,800
//     B over Fq2 at B = 1025 (S = 257 at K = 4: 50 KB and 99 KB a block).
//     A row in another block is reached through the generic pointer
//     `map_shared_rank` gives.  Each block copies its rows of the input
//     into table 0 first, so the input is read from device memory once and
//     the result written once; the tables ping-pong, with one cluster
//     barrier a level between a level's writes and the next level's reads.
//     Rows past the window read row S of the block's planes, kept zero
//     (Z = 0, the identity);
//   * one loop over the levels, whose layout thread 0 writes to shared
//     memory for every thread to read where it needs it: through an
//     addition's rounds the kernel keeps little beside the executor's own
//     registers.  A lane runs the formula's rounds (warp.cuh `jadd_sum`)
//     and stores the sum, then the cases the formula does not give (P == Q,
//     P == -Q, a side at the identity) from its rows again, so that no
//     value of the sum is live through them.  So the executors run without
//     spilling, as in their `jadd` kernels.  A lane is a call of its own
//     (`bucket_add`);
//   * each block adds its share of a level's pairs (its own rows at the
//     suffix levels, an even share of the tree's) on warp.cuh's product
//     threads (4 a lane over Fq, 8 over Fq2), or over Fq on a warp's
//     8-thread groups where the share is narrow (kBucketGroupLanesMax<F>).
//     One thread a lane (Fq) and the four-warp groups (Fq2) spill here.
// scripts/chain_designs.py times the alternatives (PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "field.cuh"
#include "point.cuh"
#include "warp.cuh"

namespace crescent {

namespace cg = cooperative_groups;

// Threads a block, one block an SM: 12 warps over Fq (at most 168
// registers a thread; a block's 257 suffix pairs in three passes of 96
// lanes of four product threads), 8 over Fq2 (255 registers a thread,
// which its eight product threads need; 32 lanes a pass).
template <class F>
constexpr int kBucketThreads = 384;
template <>
constexpr int kBucketThreads<Fe2> = 256;
// Blocks a window, the cluster size (8 is the portable maximum): 4 takes
// 100 SMs at 25 windows, and 30 such clusters fit the card at once; 2, 5
// and 8 measured slower (PERF.md).
template <class F>
constexpr int kBucketCluster = 4;
// A block's share of a level runs on a warp's groups up to
// kBucketGroupLanesMax<F> pairs (two passes of the block's warps), on
// product threads above (0: always, as over Fq2, where the four-warp
// groups would spill here).
template <class F>
constexpr int kBucketGroupLanesMax = 24;
template <>
constexpr int kBucketGroupLanesMax<Fe2> = 0;
// Dynamic shared memory a block may take (under the 227 KB a block can
// have, with the groups' buffers beside it).
constexpr int kBucketSmemMax = 200 * 1024;

// Dynamic shared memory of a block: two tables of 3 planes of S + 1 rows
// (row S of each plane zero: the identity past the window).
template <class F>
inline long long bucket_smem_bytes(long long B, int K) {
  const long long S = (B + K - 1) / K;
  return 6 * (S + 1) * FieldRow<F>::kVec * 16;
}

extern __shared__ uint4 bucket_smem[];

// One level, in shared memory: written by thread 0 between barriers and
// read (volatile) by every thread where it needs it, so that no thread
// keeps it in registers through an addition's rounds.  Lane i adds rows
// pofs + i and qofs + i of table src (the zero row where qofs + i >=
// qlimit) into row i of table src ^ 1; a block holds S rows of each table
// and adds lanes lo..hi - 1.
struct BucketLevel {
  int src, pofs, qofs, qlimit, S, lo, hi;
};

// Level l of a window of B rows (B - 1 a power of two) for block `rank` of
// K: the suffix levels j = 1, 2, 4, ... < B first (each block its own
// rows), then the weight tree's (an even share of each a block).
__device__ __forceinline__ BucketLevel bucket_level_at(int l, int B, int K, int rank) {
  const int S = (B + K - 1) / K, nsuf = 32 - __clz(B - 1);
  BucketLevel L;
  L.src = l & 1, L.S = S;
  if (l < nsuf) {
    L.pofs = 0, L.qofs = 1 << l, L.qlimit = B;
    L.lo = min(B, rank * S), L.hi = min(B, L.lo + S);
  } else {
    const int h = (B - 1) >> (l - nsuf + 1), q = (h + K - 1) / K;
    L.pofs = l == nsuf ? 1 : 0, L.qofs = L.pofs + h, L.qlimit = INT_MAX;
    L.lo = min(h, rank * q), L.hi = min(h, L.lo + q);
  }
  return L;
}

// Levels of a window of B rows: log2(B - 1) + 1 suffix levels, one fewer
// in the tree.
__device__ __forceinline__ int bucket_levels_of(int B) {
  return 2 * (32 - __clz(B - 1)) - 1;
}

// Row c of table t: in block c / S at c % S (a generic pointer, which
// reaches another block's shared memory), plane 0; planes (S + 1) V
// vectors apart.
template <int V>
__device__ __forceinline__ uint4* bucket_row(int t, int c, int S) {
  const int r = c / S;
  return cg::this_cluster().map_shared_rank(
      bucket_smem + ((long long)3 * t * (S + 1) + c - r * S) * V, r);
}

// Lane i's rows at level L: P, Q (the zero row past the window) and the
// result's, plane 0 of each.
struct BucketRows {
  const uint4 *p, *q;
  uint4* d;
  int plane;
};

template <int V>
__device__ __forceinline__ BucketRows bucket_rows(const volatile BucketLevel& L, int i) {
  const int S = L.S, src = L.src, q = L.qofs + i;
  return {bucket_row<V>(src, L.pofs + i, S),
          q < L.qlimit ? bucket_row<V>(src, q, S)
                       : bucket_smem + ((long long)3 * src * (S + 1) + S) * V,
          bucket_row<V>(src ^ 1, i, S), (S + 1) * V};
}

// Lane i of level L on executor ex (G threads a lane, this thread t of
// them): the formula's rounds, the sum stored (this thread's share of its
// coordinates), then the cases the formula does not give, each from the
// rows again, so that no value of the sum is kept through them.  A
// function of its own, called from the pass loop: inlined there, it ran
// 8% (Fq) and 1% (Fq2) slower (PERF.md, Slice 10), neither spilling.
template <class F, bool kAZero, int G, class X>
__device__ __noinline__ void bucket_add(const Curve& C, X& ex, int i, int t,
                                           const volatile BucketLevel& L) {
  constexpr int V = FieldRow<F>::kVec;
  JaddCase k;
  {
    const BucketRows w = bucket_rows<V>(L, i);
    const JaddRows in{w.p, w.p + w.plane, w.p + 2 * w.plane,
                      w.q, w.q + w.plane, w.q + 2 * w.plane};
    PtT<F> R;
    k = jadd_sum<kAZero>(C, ex, in, 0, R);
    store_coords<F, G>(w.d, w.d + w.plane, w.d + 2 * w.plane, 0, R, t);
  }
  if (ex.any(k.dbl)) {  // P == Q: the doubling of P
    const BucketRows w = bucket_rows<V>(L, i);
    const PtT<F> D = warp_double<kAZero>(
        C, pt_load<F>(w.p, w.p + w.plane, w.p + 2 * w.plane, 0), ex);
    if (k.dbl) store_coords<F, G>(w.d, w.d + w.plane, w.d + 2 * w.plane, 0, D, t);
  }
  if (k.p_inf || k.q_inf || k.negs) {  // the other side's row, or Z = 0 (P == -Q)
    const BucketRows w = bucket_rows<V>(L, i);
    const uint4* from = k.p_inf ? w.q : w.p;
    for (int c = t; c < 3; c += G) {
      if (k.negs && c != 2) continue;
      for (int v = 0; v < V; ++v) {
        w.d[c * w.plane + v] = k.negs ? make_uint4(0, 0, 0, 0) : from[c * w.plane + v];
      }
    }
  }
}

// Lanes lo..hi - 1 of level L, pass by pass, on a warp's groups (kGroups)
// or on kJaddProductThreads<F> threads a lane.
template <class F, bool kAZero, int T, bool kGroups>
__device__ __forceinline__ void bucket_lanes(const Curve& C, int lo, int hi,
                                             const volatile BucketLevel& L) {
  constexpr int G = kGroups ? 32 : kJaddProductThreads<F>, per = T / G;
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  if constexpr (kGroups) {
    // made for the level, kept across its passes (its buffers alternate)
    WarpGroups<> ex = GroupsOf<32>::make(C.M);
#pragma unroll 1
    for (int base = lo; base < hi; base += per) {
      const int i = base + slot;
      if (i < hi) bucket_add<F, kAZero, G>(C, ex, i, t, L);  // whole warps
    }
  } else {
#pragma unroll 1
    for (int base = lo; base < hi; base += per) {
      const int i = base + slot;
      const unsigned mask = __ballot_sync(kFullWarp, i < hi);
      if (i < hi) {
        ProductThreads<G> ex{C.M, t, mask};
        bucket_add<F, kAZero, G>(C, ex, i, t, L);
      }
    }
  }
}

// This block's share of level L (lanes L.lo..L.hi - 1), on the executor
// its size picks.
template <class F, bool kAZero, int T>
__device__ __forceinline__ void bucket_share(const Curve& C, const volatile BucketLevel& L) {
  const int lo = L.lo, hi = L.hi;
  if constexpr (kBucketGroupLanesMax<F> > 0) {
    if (hi - lo <= kBucketGroupLanesMax<F>) {
      bucket_lanes<F, kAZero, T, true>(C, lo, hi, L);
      return;
    }
  }
  bucket_lanes<F, kAZero, T, false>(C, lo, hi, L);
}

// One window a cluster (blocks blockIdx.x / K of K, K = kBucketCluster<F>);
// kAZero must be C.a_is_zero.
template <class F, bool kAZero, int T>
__global__ void __launch_bounds__(T, 1)
    bucket_reduce_kernel(Curve C, const uint4* x, const uint4* y, const uint4* z,
                         uint4* ox, uint4* oy, uint4* oz, int B) {
  constexpr int V = FieldRow<F>::kVec;
  __shared__ BucketLevel level;
  constexpr int K = kBucketCluster<F>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = (B + K - 1) / K;
  {  // this block's rows of the input into table 0; row S of every plane zero
    const long long first = (long long)(blockIdx.x / K) * B + rank * S;
    const int n = (min(B, rank * S + S) - min(B, rank * S)) * V;
    for (int k = threadIdx.x; k < 3 * n; k += T) {
      const int c = k / n, r = k - c * n;
      bucket_smem[(long long)c * (S + 1) * V + r] = (c == 0 ? x : c == 1 ? y : z)[first * V + r];
    }
    for (int k = threadIdx.x; k < 6 * V; k += T) {
      bucket_smem[((long long)(k / V) * (S + 1) + S) * V + k % V] = make_uint4(0, 0, 0, 0);
    }
  }
  cluster.sync();
  // one level a pass, its layout in shared memory (so that the loop keeps
  // nothing but l in registers through the additions), a cluster barrier
  // between a level's writes and the next level's reads
  const int levels = bucket_levels_of(B);
#pragma unroll 1
  for (int l = 0; l < levels; ++l) {
    if (threadIdx.x == 0) {
      const BucketLevel at = bucket_level_at(l, B, K, (int)cluster.block_rank());
      volatile BucketLevel& w = level;
      w.src = at.src, w.pofs = at.pofs, w.qofs = at.qofs;
      w.qlimit = at.qlimit, w.S = at.S, w.lo = at.lo, w.hi = at.hi;
    }
    __syncthreads();
    bucket_share<F, kAZero, T>(C, level);
    cluster.sync();
  }
  // row `off` of the last level's table holds the window's sum (row 1 where
  // B = 2 leaves no tree level)
  const int src = levels & 1, off = B == 2 ? 1 : 0;
  const int owner = off / S;
  if (rank == owner && threadIdx.x < 3 * V) {
    const int c = threadIdx.x / V, v = threadIdx.x % V;
    uint4* o = c == 0 ? ox : c == 1 ? oy : oz;
    o[(long long)(blockIdx.x / K) * V + v] =
        bucket_smem[((long long)(3 * src + c) * (S + 1) + off - owner * S) * V + v];
  }
}

// The launch of W windows of B rows over F (cfg, its cluster attribute in
// attr): W clusters of kBucketCluster<F> blocks of kBucketThreads<F>
// threads, the tables in dynamic shared memory.  An error where they do not
// fit a block's kBucketSmemMax bytes (B above 4,097 over Fq, 2,049 over
// Fq2, for B - 1 a power of two).
template <class F, bool kAZero>
cudaError_t bucket_launch(long long W, long long B, void* stream, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr) {
  constexpr int T = kBucketThreads<F>, K = kBucketCluster<F>;
  const long long smem = bucket_smem_bytes<F>(B, K);
  if (smem > kBucketSmemMax) return cudaErrorInvalidValue;
  // once an instance, before its first launch (outside any capture)
  static const cudaError_t attr_set =
      cudaFuncSetAttribute(bucket_reduce_kernel<F, kAZero, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBucketSmemMax);
  if (attr_set != cudaSuccess) return attr_set;
  cfg = {};
  cfg.gridDim = dim3((unsigned)(W * K));
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// bucket_launch's shape at W x B: (cluster size, threads a block, dynamic
// shared bytes a block, how many clusters the card holds at once).
template <class F, bool kAZero>
int bucket_reduce_fit(long long W, long long B, int* out4) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = bucket_launch<F, kAZero>(W, B, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  out4[0] = (int)attr.val.clusterDim.x, out4[1] = (int)cfg.blockDim.x;
  out4[2] = (int)cfg.dynamicSmemBytes, out4[3] = 0;
  return (int)cudaOccupancyMaxActiveClusters(
      &out4[3], bucket_reduce_kernel<F, kAZero, kBucketThreads<F>>, &cfg);
}

// W windows of B rows: one launch on the caller's stream (no
// synchronisation, nothing allocated, so it can be captured in a CUDA
// graph); returns the launch's error or cudaGetLastError().
template <class F, bool kAZero>
int launch_bucket_reduce(const Curve& C, const void* x, const void* y, const void* z,
                         void* ox, void* oy, void* oz, long long W, long long B,
                         void* stream) {
  if (W > 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = bucket_launch<F, kAZero>(W, B, stream, cfg, attr);
    if (e == cudaSuccess) {
      e = cudaLaunchKernelEx(&cfg, bucket_reduce_kernel<F, kAZero, kBucketThreads<F>>, C,
                             (const uint4*)x, (const uint4*)y, (const uint4*)z, (uint4*)ox,
                             (uint4*)oy, (uint4*)oz, (int)B);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
