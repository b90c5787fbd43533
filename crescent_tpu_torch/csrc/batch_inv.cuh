// Batched inversion over Fq and Fq2 in one launch: out[i] = 1/d[i], the
// whole of the reference's `batch_inv` (crescent_tpu/ops/msm_affine.py:75),
// which there is a product tree of `mul` launches (pallas_ec.py :680,
// `_mul_kernel` :513; over Fq2 `_F2.mont_mul` :362) with `inv` on its root
// level (:698, `_inv_core` :527; over Fq2 :858).
//
// The tree halves an (n, W) plane level by level while the level is above
// `inv_floor`, k times, inverts each of the R = n / 2^k root elements on
// its own and unwinds.  Root b is the product of the run of S = 2^k leaves
// [b S, (b + 1) S), and nothing in the tree mixes two runs, so one block a
// run does the same work with no other block involved: R blocks (at most
// inv_floor, 512 on the prove path) of kBatchInvThreads threads, of which
// T = min(kBatchInvThreads, S) hold leaves.  Thread t owns the leaves
// b S + t + j T, j < S / T (neighbouring threads on neighbouring rows, so
// a warp's loads coalesce), and
//   1. walks them with a running product, writing each leaf's exclusive
//      prefix to `out`;
//   2. puts its product into a binary tree in shared memory, which takes
//      the T products to the run's root, one level a step;
//   3. thread 0 inverts the root (field.cuh: `fe_inv_divsteps` over Fq,
//      `fe_inv` over Fq2, the `inv` kernels' bodies);
//   4. the tree unwinds (1/child = 1/parent * sibling), leaving each
//      thread the inverse of its product;
//   5. it walks its leaves back: out[i] = acc * prefix, acc = acc * d[i].
// About three products a leaf, as in the tree, but two passes over `d` and
// `out` in place of 3k launches of strided products.
//
// The result is the tree's bit for bit.  Every product is canonical
// (field.cuh), so the grouping of a run's products changes no value; a zero
// leaf makes its run's root 0, which the inversion maps to 0, and the
// unwind then zeroes exactly that run, as the tree does.
//
// What bounds it on this card.  By bytes, `d` read and `out` written once
// (64 B a leaf over Fq) take 2^21 leaves 0.04 ms; its three products a leaf
// take 0.05 ms of the card's integer rate.  But the root's inversion is a
// serial chain of about 31 us on one thread, and the narrow calls (64 to
// 256 leaves a root, 16 of a chunk's 22) are that chain and a few levels
// of products, so the R blocks' inversions must run side by side: every
// block has 128 threads, whatever S is, and the inversion's registers
// (98 a thread over Fq, 124 over Fq2) hold an SM to four of them,
// so R <= 512 roots take one wave of 132 SMs with at most four inversions
// an SM.  (Blocks of S < 128 threads let eight or nine share an SM, which
// made the narrow calls 1.5-1.7x longer.)  The same registers leave the
// wide calls (up to 32 leaves a thread at 2^21) 16 warps an SM for their
// dependent chains of products, against 32 to 64 for the `mul` launches
// of the tree: over Fq2 the widest calls take longer than the tree's.
//
// `out` must not alias `d`: step 1 writes prefixes where step 5 reads `d`.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "point.cuh"

namespace crescent {

constexpr int kBatchInvThreads = 128;

// 1/x (0 -> 0) by the field's divstep inversion; r3 = R^3 mod p.
__device__ __forceinline__ Fe root_inv(const Fe& x, const uint32_t* r3, const Mod& M) {
  return fe_inv_divsteps(x, r3, M);
}

__device__ __forceinline__ Fe2 root_inv(const Fe2& x, const uint32_t* r3, const Mod& M) {
  return fe_inv(x, r3, M);
}

// One block of kBatchInvThreads threads a run of 2^log_s leaves.
template <class F>
__global__ void __launch_bounds__(kBatchInvThreads, 4)
    batch_inv_kernel(Mod M, Words8 r3, const uint4* __restrict__ d, uint4* out,
                     int log_s) {
  typedef FieldRow<F> Row;
  constexpr int V = Row::kVec;
  // heap order: node 1 the root, node i's children 2i and 2i + 1, thread
  // t's product at T + t
  __shared__ F tree[2 * kBatchInvThreads];
  const long long S = 1LL << log_s;
  const int t = threadIdx.x;
  const int T = S < kBatchInvThreads ? (int)S : kBatchInvThreads;
  const long long steps = S / T;
  const long long first = ((long long)blockIdx.x << log_s) + t;

  if (t < T) {
    F acc = Row::load(d + V * first);
    for (long long j = 1; j < steps; ++j) {
      const long long i = first + j * T;
      Row::store(out + V * i, acc);
      acc = fe_mont_mul(acc, Row::load(d + V * i), M);
    }
    tree[T + t] = acc;
  }
  __syncthreads();
  for (int h = T >> 1; h >= 1; h >>= 1) {
    if (t < h) tree[h + t] = fe_mont_mul(tree[2 * (h + t)], tree[2 * (h + t) + 1], M);
    __syncthreads();
  }
  if (t == 0) tree[1] = root_inv(tree[1], r3.w, M);
  __syncthreads();
  for (int h = 1; h < T; h <<= 1) {
    // parents [h, 2h) hold their inverses: 1/left = 1/parent * right
    if (t < h) {
      const int p = h + t;
      const F l = tree[2 * p], r = tree[2 * p + 1];
      tree[2 * p] = fe_mont_mul(tree[p], r, M);
      tree[2 * p + 1] = fe_mont_mul(tree[p], l, M);
    }
    __syncthreads();
  }
  if (t < T) {
    F acc = tree[T + t];
    for (long long j = steps - 1; j >= 1; --j) {
      const long long i = first + j * T;
      Row::store(out + V * i, fe_mont_mul(acc, Row::load(out + V * i), M));
      acc = fe_mont_mul(acc, Row::load(d + V * i), M);
    }
    Row::store(out + V * first, acc);
  }
}

// n leaves in runs of 2^log_s (n a multiple of it); one launch.
template <class F>
int launch_batch_inv(const uint32_t* curve26, const uint32_t* r3, const void* d,
                     void* out, long long n, int log_s, void* stream) {
  if (log_s < 0 || log_s > 40 || n % (1LL << log_s)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    batch_inv_kernel<F><<<(unsigned)(n >> log_s), kBatchInvThreads, 0, (cudaStream_t)stream>>>(
        make_curve(curve26).M, words8(r3), (const uint4*)d, (uint4*)out, log_s);
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
