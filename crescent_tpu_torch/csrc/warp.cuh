// Fq `jdbl_n` as a warp per lane: the window combine's doubling chains
// (16, 8, 4, 2 and 1 lanes of 11 to 176 doublings in a G1 chunk) are too
// few lanes to fill the card and too long a dependent chain for one thread
// a lane, so they are bound by latency.  Here one warp runs one lane's
// chain, and each doubling runs its products side by side in three stages
// instead of eight in a row; each product is itself shared by a group of 8
// threads, one 32-bit word a thread (the threads-per-instance scheme of
// NVIDIA's CGBN library).  Fe only: Fq2's `jdbl_n` keeps point.cuh's
// `jdbl_n_kernel<Fe2>`.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "point.cuh"

namespace crescent {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// word k of an element every thread holds whole (k known only at run time:
// selects, so that the element stays in registers)
__device__ __forceinline__ uint32_t fe_word(const Fe& a, int k) {
  uint32_t r = a.w[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) r = k == j ? a.w[j] : r;
  return r;
}

// a + b and a - b mod p as PTX carry chains (add.cc / addc.cc, one
// instruction a word) for the sums between the stages, which lie on the
// doubling's critical path: field.cuh's fe_add and fe_sub, written with
// 64-bit accumulators, take longer there.  Canonical in and out.  The carry
// flag lives only within one asm statement, so each chain is one.
#define CRESCENT_IN8(v)                                                     \
  "r"(v.w[0]), "r"(v.w[1]), "r"(v.w[2]), "r"(v.w[3]), "r"(v.w[4]),         \
      "r"(v.w[5]), "r"(v.w[6]), "r"(v.w[7])
#define CRESCENT_OUT8(v)                                                    \
  "=r"(v.w[0]), "=r"(v.w[1]), "=r"(v.w[2]), "=r"(v.w[3]), "=r"(v.w[4]),    \
      "=r"(v.w[5]), "=r"(v.w[6]), "=r"(v.w[7])

// t = a - b; returns the borrow as a mask (0 or 0xFFFFFFFF)
__device__ __forceinline__ uint32_t sub_chain(Fe& t, const Fe& a, const Fe& b) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\tsubc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\tsubc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\tsubc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\tsubc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : CRESCENT_OUT8(t), "=r"(borrow)
      : CRESCENT_IN8(a), CRESCENT_IN8(b));
  return borrow;
}

// t = a + b, the carry out dropped
__device__ __forceinline__ void add_chain(Fe& t, const Fe& a, const Fe& b) {
  asm("add.cc.u32 %0, %8, %16;\n\taddc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\taddc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\taddc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\taddc.u32 %7, %15, %23;"
      : CRESCENT_OUT8(t)
      : CRESCENT_IN8(a), CRESCENT_IN8(b));
}

// a + b < 2p < 2^256 (p < 2^255): keep it if subtracting p borrows
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const Mod& M) {
  Fe t, d;
  add_chain(t, a, b);
  const uint32_t borrow = sub_chain(d, t, fe_from(M.p));
  return fe_select(borrow != 0, t, d);
}

// a - b, plus p where it borrowed (the carry out dropped)
__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b, const Mod& M) {
  Fe t, m, d;
  const uint32_t borrow = sub_chain(t, a, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) m.w[j] = M.p[j] & borrow;
  add_chain(d, t, m);
  return d;
}

// The group's 8-bit field of a warp ballot: bit j is thread j of group g.
__device__ __forceinline__ uint32_t group_bits(unsigned ballot, int base) {
  return (ballot >> base) & 0xFFu;
}

// Montgomery product a b 2^-256 mod p by the 8 threads of one group (lanes
// base .. base + 7 of the warp): thread k holds ak = word k of a, all of b
// and pk = word k of p, and gets word k of the canonical product.
//
// CIOS over the group: the accumulator T is one word a thread plus two
// carry words (c1 from the product a b_i, c2 from the reduction m p), both
// owed to the thread's own next position, so the shift down by a word moves
// only T's words (one __shfl_down_sync).  Each of the 8 steps broadcasts
// position 0's word to make the reduction factor m (one __shfl_sync).  At
// the end T < 2p < 2^256 with its carries pending: one __shfl_up_sync of
// the carries out of each word, then the single-bit carry chain and the
// borrow chain of T - p are each resolved at once from two warp votes
// (__ballot_sync of the generate and propagate bits: carry into word k is
// bit k of ((G << 1) + P) ^ P).  Every thread of the warp must call it.
__device__ __forceinline__ uint32_t group_mont_mul(uint32_t ak, const Fe& b,
                                                   uint32_t pk, const Mod& M,
                                                   int k, int base) {
  uint32_t t = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t v = (uint64_t)ak * b.w[i] + t + c1;  // < 2^64
    const uint32_t lo = (uint32_t)v;
    const uint32_t m = __shfl_sync(kFullWarp, lo + c2, base) * M.inv;
    const uint64_t w = (uint64_t)m * pk + lo + c2;  // word 0: low 32 bits 0
    c1 = (uint32_t)(v >> 32);
    c2 = (uint32_t)(w >> 32);
    const uint32_t up = __shfl_down_sync(kFullWarp, (uint32_t)w, 1, 8);
    t = k == 7 ? 0u : up;
  }
  // T = sum_k (t_k + c1_k + c2_k) 2^(32 k): carries of 0..2 out of each word
  const uint64_t s = (uint64_t)t + c1 + c2;
  const uint32_t e = __shfl_up_sync(kFullWarp, (uint32_t)(s >> 32), 1, 8);
  const uint64_t s2 = (uint64_t)(uint32_t)s + (k == 0 ? 0u : e);
  uint32_t r = (uint32_t)s2;
  uint32_t G = group_bits(__ballot_sync(kFullWarp, (uint32_t)(s2 >> 32)), base);
  uint32_t P = group_bits(__ballot_sync(kFullWarp, r == 0xFFFFFFFFu), base);
  r += (((G << 1) + P) ^ P) >> k & 1u;  // word 8 of T is 0: T < 2^256
  // T - p, kept unless it borrows out of word 7
  G = group_bits(__ballot_sync(kFullWarp, r < pk), base);
  P = group_bits(__ballot_sync(kFullWarp, r == pk), base);
  const uint32_t borrow = ((G << 1) + P) ^ P;
  const uint32_t d = r - pk - (borrow >> k & 1u);
  return borrow >> 8 & 1u ? r : d;
}

// N <= 4 products a[j] b[j], group j of the warp computing product j (the
// other groups repeat product 0 and are not read); every thread gets every
// product whole (8 shuffles a product).  g, k: this thread's group and word.
template <int N>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N],
                                              Fe (&out)[N], const Mod& M,
                                              int g, int k, uint32_t pk) {
  Fe x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = fe_select(g == j, a[j], x);
    y = fe_select(g == j, b[j], y);
  }
  const uint32_t w = group_mont_mul(fe_word(x, k), y, pk, M, k, 8 * g);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = __shfl_sync(kFullWarp, w, 8 * j + i);
  }
}

// One doubling by the whole warp, every thread holding P whole: pt_double's
// dbl-2007-bl with its products in stages of independent ones, (1) XX, YY,
// ZZ, (Y + Z)^2; (2) YYYY, (X + YY)^2, M^2 (M = 3 XX); (3) M (S - X3).  With
// a != 0 (kAZero false), stage 2 takes ZZ^2 in M^2's place, then a ZZ^2
// and M^2 (M = 3 XX + a ZZ^2) have a stage each.  The sums and differences
// are computed by every thread.  Each value is the one pt_double computes
// (canonical), so the result is bit-equal to it.
template <bool kAZero>
__device__ __forceinline__ PtT<Fe> warp_double(const Curve& C, const PtT<Fe>& P,
                                               int g, int k, uint32_t pk) {
  const Mod& M = C.M;
  Fe s1[4];
  {
    const Fe a[4] = {P.x, P.y, P.z, fe_add_cc(P.y, P.z, M)};
    warp_products<4>(a, a, s1, M, g, k, pk);
  }
  const Fe& XX = s1[0];
  const Fe& YY = s1[1];
  const Fe& ZZ = s1[2];
  PtT<Fe> R;
  R.z = fe_sub_cc(fe_sub_cc(s1[3], YY, M), ZZ, M);
  Fe Mm = fe_add_cc(fe_add_cc(XX, XX, M), XX, M);
  Fe s2[3];
  if (kAZero) {
    const Fe a[3] = {YY, fe_add_cc(P.x, YY, M), Mm};
    warp_products<3>(a, a, s2, M, g, k, pk);
  } else {
    const Fe a[3] = {YY, fe_add_cc(P.x, YY, M), ZZ};
    warp_products<3>(a, a, s2, M, g, k, pk);
    Fe t[1];
    const Fe ca[1] = {fe_from(C.a)}, z4[1] = {s2[2]};
    warp_products<1>(ca, z4, t, M, g, k, pk);
    Mm = fe_add_cc(Mm, t[0], M);
    const Fe mm[1] = {Mm};
    warp_products<1>(mm, mm, t, M, g, k, pk);
    s2[2] = t[0];
  }
  const Fe& YYYY = s2[0];
  Fe S = fe_sub_cc(fe_sub_cc(s2[1], XX, M), YYYY, M);
  S = fe_add_cc(S, S, M);
  R.x = fe_sub_cc(s2[2], fe_add_cc(S, S, M), M);
  Fe t[1];
  {
    const Fe mm[1] = {Mm}, sx[1] = {fe_sub_cc(S, R.x, M)};
    warp_products<1>(mm, sx, t, M, g, k, pk);
  }
  Fe e8 = fe_add_cc(YYYY, YYYY, M);
  e8 = fe_add_cc(e8, e8, M);
  R.y = fe_sub_cc(t[0], fe_add_cc(e8, e8, M), M);
  return R;
}

// `count` chained doublings of lane blockIdx.x, one warp a block and a lane;
// kAZero must be C.a_is_zero (the launch picks the instance).
template <bool kAZero>
__global__ void __launch_bounds__(32)
    warp_jdbl_n_kernel(Curve C, const uint4* x, const uint4* y, const uint4* z,
                       uint4* ox, uint4* oy, uint4* oz, long long n, int count) {
  const long long i = blockIdx.x;
  if (i >= n) return;  // the whole warp
  const int g = threadIdx.x >> 3, k = threadIdx.x & 7;
  const uint32_t pk = fe_word(fe_from(C.M.p), k);
  PtT<Fe> P = pt_load<Fe>(x, y, z, i);
#pragma unroll 1
  for (int c = 0; c < count; ++c) P = warp_double<kAZero>(C, P, g, k, pk);
  __syncwarp();  // every lane has read its rows: outputs may alias inputs
  if (threadIdx.x == 0) pt_store<Fe>(ox, oy, oz, i, P);
}

}  // namespace crescent
