// The pair additions `affine_add` (affine L + R given inv = 1/denominator),
// over Fq on one thread a lane and over Fq2 on two threads a lane.  Each
// replaces the reference's `_aadd_kernel` (crescent_tpu/ops/pallas_ec.py:566,
// body `_affine_add_body` :421, op :771; over Fq2 at ROWS = 32), as
// point.cuh's one-thread template did for both before.
//
// Fq (`affine_add_lane_kernel`, one thread a lane; a = 0 and a != 0).  236
// bytes a lane against three Montgomery products on a chord, a chain of
// three dependent products (lam = num inv, lam^2, lam (Lx - x3)).  The
// template it replaces ran four (x^2 on every lane), with field.cuh's
// 64-bit accumulators in the products and the sums, at 54% of its byte
// bound at 2^21 lanes and 49.6% over a chunk's 22 pair-level calls:
// bound by the issue of its integer instructions, not by the bytes.  Here
// (each step's share measured on an H100, PERF.md, scripts/chain_designs.py):
//   * the tangent's 3 x^2 + a is computed only where a lane of the warp
//     has both sides valid and L == R: elsewhere the select never reads
//     it, or the lane passes a side through, so no result bit depends on
//     it (x^2 on every lane took 1.27x as long at 2^21 lanes);
//   * the sums and differences are warp.cuh's carry chains (fe_add_cc,
//     fe_sub_cc; field.cuh's fe_add / fe_sub took 1.08x);
//   * the same-x and same-y tests compare words (canonical inputs) in
//     place of a modular difference each.
// The products stay field.cuh's fe_mont_mul: a CIOS with PTX carry chains
// (mad.lo.cc / madc.hi.cc) measured the same.
// Splitting a lane over threads would not shorten the chain (its three
// products depend on each other), and the chunk's narrow calls (32,768 to
// 131,072 lanes) are a fifth of its lanes and a quarter of its time.
//
// Fq2 (`affine_add_halves_kernel`, two threads a lane, a = 0) holds one
// half of every element a thread: thread h of a pair holds c_h (c0 or c1;
// field.cuh Fe2) of each of Lx, Ly, Rx, Ry and inv, reads it as the
// 32-byte half h of the row (a pair reads a whole 64-byte row, a warp 16
// rows with each load), and writes half h of x3 and y3.
//
// What bounds the Fq2 kernel: 460 bytes a lane against 8 to 10 base
// products, so bytes (0.288 ms at 2^21 lanes on an H100) if the loads are
// in flight on enough warps.  One thread a lane held four whole Fq2 inputs and their sums in
// 182 registers, eight warps an SM, and ran its ten base products as one
// chain.  Here a thread holds half as much, and a lane's chain is four
// product latencies (five on a warp with a tangent lane) in place of ten.
//
// The product split (thread h computes half h of each Fq2 value; the
// partner's half of an operand crosses by one __shfl_xor_sync a word):
//   * a product u v (lam = num inv, and lam (Lx - x3)) is schoolbook, each
//     half one sum of two base products with one reduction
//     (field.cuh fe_mont_mul_sum):
//       c0 = u0 v0 + (p - u1) v1   on thread 0,
//       c1 = u0 v1 + u1 v0         on thread 1;
//   * a square u^2 (lam^2, and Lx^2 for the tangent) one base product a
//     thread: c0 = (u0 + u1)(u0 - u1) on thread 0, c1 = 2 u0 u1 on
//     thread 1.
// The sums and differences are warp.cuh's PTX carry chains (fe_add_cc,
// fe_sub_cc): with field.cuh's 64-bit accumulators the kernel took 1.2x
// as long (scripts/chain_designs.py `aadd_field_sums`).
// Crossing by shuffle: the same-x and same-y zero tests (one bit each),
// Lx (only where the tangent is computed), num and inv, lam, and Lx - x3.
// The flags lv and rv are read by both threads of a pair (one address, a
// broadcast); thread 0 writes the valid flag.
//
// The tangent's numerator 3 Lx^2 (a = 0: BN254 G2; the entry point checks
// it) is computed only where a lane of the warp is a tangent (L == R):
// elsewhere the select never reads it, so the result bits do not depend
// on it.
// Both kernels compute every value as the canonical field element of the
// reference's body, so their results are bit-equal to `affine_add_plain`
// (ops/cuda_ec.py) and to the reference (tests/test_torch_affine_add_halves.py
// models the Fq2 split in Python ints, tests/test_torch_affine_add_fq.py the
// Fq kernel's product and its tangent vote).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "field.cuh"
#include "point.cuh"
#include "warp.cuh"

namespace crescent {

// the other thread's copy of an element (the pair's threads are lanes 2k
// and 2k + 1 of the warp)
__device__ __forceinline__ Fe fe_partner(const Fe& a, unsigned mask) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = __shfl_xor_sync(mask, a.w[j], 1);
  return r;
}

// Half h of the Fq2 product u v, from this thread's halves (u, v) and the
// partner's (uo, vo): thread 0 u0 v0 + (p - u1) v1, thread 1 u1 v0 + u0 v1.
__device__ __forceinline__ Fe half_mul(const Fe& u, const Fe& uo, const Fe& v,
                                       const Fe& vo, int h, const Mod& M) {
  const Fe neg_uo = fe_sub_cc(fe_zero(), uo, M);  // p - u1 on thread 0
  return fe_mont_mul_sum(u, fe_select(h != 0, vo, v), fe_select(h != 0, uo, neg_uo),
                         fe_select(h != 0, v, vo), M);
}

// Half h of the Fq2 square u^2: thread 0 (u0 + u1)(u0 - u1), thread 1
// 2 u1 u0.
__device__ __forceinline__ Fe half_sqr(const Fe& u, const Fe& uo, int h, const Mod& M) {
  const Fe t = fe_mont_mul(fe_select(h != 0, u, fe_add_cc(u, uo, M)),
                           fe_select(h != 0, uo, fe_sub_cc(u, uo, M)), M);
  return fe_select(h != 0, fe_add_cc(t, t, M), t);
}

// Half h of lane L + R given inv = 1/denominator over Fq2 for a = 0, from
// this thread's halves of the lane's rows: x3, y3 and the valid flag.
// Every thread of `live` calls it (shuffles).
__device__ __forceinline__ void affine_add_half(const Mod& M, const Fe& Lx, const Fe& Ly,
                                                const Fe& Rx, const Fe& Ry, const Fe& iv,
                                                bool l, bool r, int h, unsigned live, Fe& x,
                                                Fe& y, bool& valid) {
  const bool both = l && r;
  const Fe dy = fe_sub_cc(Ry, Ly, M);
  const bool zx = fe_is_zero(fe_sub_cc(Rx, Lx, M)), zy = fe_is_zero(dy);
  // every live thread shuffles (no short circuit before the shuffle)
  const int zxo = __shfl_xor_sync(live, (int)zx, 1), zyo = __shfl_xor_sync(live, (int)zy, 1);
  const bool same_x = zx && zxo != 0, same_y = zy && zyo != 0;
  const bool dbl_case = same_x && same_y;
  const bool inf_case = same_x && !same_y;

  Fe num = dy;
  if (__any_sync(live, dbl_case)) {  // the same in every live thread of the warp
    const Fe xx = half_sqr(Lx, fe_partner(Lx, live), h, M);
    num = fe_select(dbl_case, fe_add_cc(fe_add_cc(xx, xx, M), xx, M), dy);
  }
  const Fe lam = half_mul(num, fe_partner(num, live), iv, fe_partner(iv, live), h, M);
  const Fe lo = fe_partner(lam, live);
  const Fe x3 = fe_sub_cc(fe_sub_cc(half_sqr(lam, lo, h, M), Lx, M), Rx, M);
  const Fe d = fe_sub_cc(Lx, x3, M);
  const Fe y3 = fe_sub_cc(half_mul(lam, lo, d, fe_partner(d, live), h, M), Ly, M);

  x = fe_select(both, x3, fe_select(l, Lx, Rx));
  y = fe_select(both, y3, fe_select(l, Ly, Ry));
  valid = (l || r) && !(both && inf_case);
}

// Threads 2i and 2i + 1 on lane i; blocks of kThreads threads (64 lanes).
// A template (a = 0 only), so that it is compiled only where it is
// launched (ec2.cu), as the Fq kernel below.
template <bool kAZero>
__global__ void __launch_bounds__(kThreads)
    affine_add_halves_kernel(Curve C, const uint4* lx, const uint4* ly, const int* lv,
                             const uint4* rx, const uint4* ry, const int* rv,
                             const uint4* inv, uint4* ox, uint4* oy, int* ov, long long n) {
  static_assert(kAZero, "the Fq2 pair additions serve a = 0 only");
  const long long i = lane() >> 1;
  const int h = threadIdx.x & 1;
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;  // whole pairs
  const long long v = 4 * i + 2 * h;  // half h of row i: 16-byte vectors
  Fe x, y;
  bool valid;
  affine_add_half(C.M, fe_load(lx + v), fe_load(ly + v), fe_load(rx + v), fe_load(ry + v),
                  fe_load(inv + v), lv[i] != 0, rv[i] != 0, h, live, x, y, valid);
  fe_store(ox + v, x);
  fe_store(oy + v, y);
  if (h == 0) ov[i] = valid ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Fq: one thread a lane.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool fe_equal(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j] ^ b.w[j];
  return acc == 0;
}

// Lane i over Fq, blocks of kThreads threads; kAZero must be C.a_is_zero
// (the launch picks the instance).
template <bool kAZero>
__global__ void __launch_bounds__(kThreads)
    affine_add_lane_kernel(Curve C, const uint4* lx, const uint4* ly, const int* lv,
                           const uint4* rx, const uint4* ry, const int* rv, const uint4* inv,
                           uint4* ox, uint4* oy, int* ov, long long n) {
  const long long i = lane();
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;
  const Mod& M = C.M;
  const Fe Lx = fe_load(lx + 2 * i), Ly = fe_load(ly + 2 * i);
  const Fe Rx = fe_load(rx + 2 * i), Ry = fe_load(ry + 2 * i);
  const bool l = lv[i] != 0, r = rv[i] != 0;
  const bool both = l && r;
  const bool same_x = fe_equal(Rx, Lx), same_y = fe_equal(Ry, Ly);
  const bool dbl_case = same_x && same_y;
  const bool inf_case = same_x && !same_y;

  Fe num = fe_sub_cc(Ry, Ly, M);
  if (__any_sync(live, both && dbl_case)) {  // the same in every live thread of the warp
    const Fe xx = fe_mont_mul(Lx, Lx, M);
    Fe t = fe_add_cc(fe_add_cc(xx, xx, M), xx, M);
    if (!kAZero) t = fe_add_cc(t, fe_from(C.a), M);
    num = fe_select(dbl_case, t, num);
  }
  const Fe lam = fe_mont_mul(num, fe_load(inv + 2 * i), M);
  const Fe x3 = fe_sub_cc(fe_sub_cc(fe_mont_mul(lam, lam, M), Lx, M), Rx, M);
  const Fe y3 = fe_sub_cc(fe_mont_mul(lam, fe_sub_cc(Lx, x3, M), M), Ly, M);

  fe_store(ox + 2 * i, fe_select(both, x3, fe_select(l, Lx, Rx)));
  fe_store(oy + 2 * i, fe_select(both, y3, fe_select(l, Ly, Ry)));
  ov[i] = ((l || r) && !(both && inf_case)) ? 1 : 0;
}

// Host side: n pair additions over F, one thread a lane over Fe (a == 0
// and a != 0), two over Fe2 (a = 0 only: cudaErrorInvalidValue else);
// returns cudaGetLastError().  A template, so that each library compiles
// only its own field's kernels.
template <class F>
int launch_affine_add(const uint32_t* curve26, const void* lx, const void* ly, const void* lv,
                      const void* rx, const void* ry, const void* rv, const void* inv,
                      void* ox, void* oy, void* ov, long long n, void* stream) {
  const Curve C = make_curve(curve26);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (std::is_same<F, Fe2>::value) {
    if (!C.a_is_zero) return (int)cudaErrorInvalidValue;
    if (n > 0) {
      affine_add_halves_kernel<true><<<grid_for(2 * n, kThreads), kThreads, 0, s>>>(
          C, (In)lx, (In)ly, (const int*)lv, (In)rx, (In)ry, (const int*)rv, (In)inv, (Out)ox,
          (Out)oy, (int*)ov, n);
    }
  } else if (n > 0) {
    auto kernel = C.a_is_zero ? affine_add_lane_kernel<true> : affine_add_lane_kernel<false>;
    kernel<<<grid_for(n, kThreads), kThreads, 0, s>>>(
        C, (In)lx, (In)ly, (const int*)lv, (In)rx, (In)ry, (const int*)rv, (In)inv, (Out)ox,
        (Out)oy, (int*)ov, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
