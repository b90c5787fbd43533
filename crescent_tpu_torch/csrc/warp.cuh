// `jdbl_n` over Fq and over Fq2 with a warp or two per lane: the window
// combine's doubling chains (16, 8, 4, 2 and 1 lanes of 11 to 176
// doublings in a chunk) are too few lanes to fill the card and too long a
// dependent chain for one thread a lane, so they are bound by latency.
// Here one block runs one lane's chain, and each doubling runs its base
// products side by side in rounds instead of one after another; each
// product is itself shared by a group of 8 threads, one 32-bit word a
// thread (the threads-per-instance scheme of NVIDIA's CGBN library).  An Fq
// doubling is 8 products in three rounds on one warp (four groups, the
// products passed on by shuffles); an Fq2 one (a = 0 only, as BN254 G2) 16
// base products in three rounds on two warps (eight groups, the products
// passed on through shared memory).
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

// One Fq doubling by the whole warp, every thread holding P whole: pt_double's
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

// The Fq2 sums between the rounds: the carry chains above on each
// component.
__device__ __forceinline__ Fe2 fe2_add_cc(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_add_cc(a.c0, b.c0, M), fe_add_cc(a.c1, b.c1, M));
}

__device__ __forceinline__ Fe2 fe2_sub_cc(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_sub_cc(a.c0, b.c0, M), fe_sub_cc(a.c1, b.c1, M));
}

// N <= 8 products a[j] b[j] on the two warps of the block, group j (lanes
// 8 (j % 4) .. 8 (j % 4) + 7 of warp j / 4) computing product j (the other
// groups repeat product 0 and are not read), passed on through `buf` with
// one barrier; every thread gets every product whole.
template <int N>
__device__ __forceinline__ void block_products(const Fe (&a)[N], const Fe (&b)[N],
                                               Fe (&out)[N], uint32_t (*buf)[8],
                                               const Mod& M, int g, int k,
                                               uint32_t pk) {
  Fe x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = fe_select(g == j, a[j], x);
    y = fe_select(g == j, b[j], y);
  }
  const uint32_t w = group_mont_mul(fe_word(x, k), y, pk, M, k, 8 * (g & 3));
  if (g < N) buf[g][k] = w;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = buf[j][i];
  }
}

// One Fq2 doubling by two warps, every thread holding P whole, for a = 0
// (BN254 G2).  pt_double over Fe2 takes 17 base products: seven Fq2
// squares of two ((x0 + x1)(x0 - x1) and x0 x1) and one Karatsuba product
// of three.  With a = 0, ZZ enters only Z3 = (Y + Z)^2 - YY - ZZ, which is
// 2 Y Z: one Karatsuba product (3) in place of two squares (4), so 16
// products in three rounds, the doubling's dependent depth, on eight
// groups:
//   1. XX, YY and Y Z (y0 z0, y1 z1, (y0 + y1)(z0 + z1)): 7;
//   2. YYYY, (X + YY)^2 and M^2 (M = 3 XX): 6;
//   3. M (S - X3) as m0 d0, m1 d1 and (m0 + m1)(d0 + d1): 3.
// Each round has its own buffer, so one barrier a round also keeps a warp
// from overwriting products the other has still to read.  Every value is
// the field element pt_double computes, canonical, so the result is
// bit-equal to it (tests/test_torch_warp_fq2.py models the plan).
template <bool kAZero>
__device__ __forceinline__ PtT<Fe2> warp_double(const Curve& C, const PtT<Fe2>& P,
                                                int g, int k, uint32_t pk) {
  static_assert(kAZero, "the Fq2 doubling serves a = 0 only");
  __shared__ uint32_t buf[3][8][8];
  const Mod& M = C.M;
  const Fe ys = fe_add_cc(P.y.c0, P.y.c1, M);  // y0 + y1
  Fe r1[7];
  {
    const Fe a[7] = {fe_add_cc(P.x.c0, P.x.c1, M), P.x.c0, ys, P.y.c0,
                     P.y.c0, P.y.c1, ys};
    const Fe b[7] = {fe_sub_cc(P.x.c0, P.x.c1, M), P.x.c1, fe_sub_cc(P.y.c0, P.y.c1, M),
                     P.y.c1, P.z.c0, P.z.c1, fe_add_cc(P.z.c0, P.z.c1, M)};
    block_products<7>(a, b, r1, buf[0], M, g, k, pk);
  }
  const Fe2 XX = fe2_make(r1[0], fe_add_cc(r1[1], r1[1], M));
  const Fe2 YY = fe2_make(r1[2], fe_add_cc(r1[3], r1[3], M));
  // Karatsuba: u v = (u0 v0 - u1 v1) + ((u0 + u1)(v0 + v1) - u0 v0 - u1 v1) u
  const Fe2 YZ = fe2_make(fe_sub_cc(r1[4], r1[5], M),
                          fe_sub_cc(fe_sub_cc(r1[6], r1[4], M), r1[5], M));
  const Fe2 T = fe2_add_cc(P.x, YY, M);
  const Fe2 Mm = fe2_add_cc(fe2_add_cc(XX, XX, M), XX, M);
  Fe r2[6];
  {
    const Fe a[6] = {fe_add_cc(YY.c0, YY.c1, M), YY.c0, fe_add_cc(T.c0, T.c1, M), T.c0,
                     fe_add_cc(Mm.c0, Mm.c1, M), Mm.c0};
    const Fe b[6] = {fe_sub_cc(YY.c0, YY.c1, M), YY.c1, fe_sub_cc(T.c0, T.c1, M), T.c1,
                     fe_sub_cc(Mm.c0, Mm.c1, M), Mm.c1};
    block_products<6>(a, b, r2, buf[1], M, g, k, pk);
  }
  const Fe2 YYYY = fe2_make(r2[0], fe_add_cc(r2[1], r2[1], M));
  const Fe2 TT = fe2_make(r2[2], fe_add_cc(r2[3], r2[3], M));
  Fe2 S = fe2_sub_cc(fe2_sub_cc(TT, XX, M), YYYY, M);
  S = fe2_add_cc(S, S, M);
  PtT<Fe2> R;
  R.x = fe2_sub_cc(fe2_make(r2[4], fe_add_cc(r2[5], r2[5], M)), fe2_add_cc(S, S, M), M);
  const Fe2 D = fe2_sub_cc(S, R.x, M);
  Fe r3[3];
  {
    const Fe a[3] = {Mm.c0, Mm.c1, fe_add_cc(Mm.c0, Mm.c1, M)};
    const Fe b[3] = {D.c0, D.c1, fe_add_cc(D.c0, D.c1, M)};
    block_products<3>(a, b, r3, buf[2], M, g, k, pk);
  }
  const Fe2 MD = fe2_make(fe_sub_cc(r3[0], r3[1], M),
                          fe_sub_cc(fe_sub_cc(r3[2], r3[0], M), r3[1], M));
  Fe2 e8 = fe2_add_cc(YYYY, YYYY, M);
  e8 = fe2_add_cc(e8, e8, M);
  R.y = fe2_sub_cc(MD, fe2_add_cc(e8, e8, M), M);
  R.z = fe2_add_cc(YZ, YZ, M);
  return R;
}

// Threads that run one lane's chain: one warp over Fe, two over Fe2.
template <class F>
constexpr int kLaneThreads = 32;
template <>
constexpr int kLaneThreads<Fe2> = 64;

// `count` chained doublings of lane blockIdx.x over F (Fe or Fe2), a block
// of kLaneThreads<F> a lane; kAZero must be C.a_is_zero (the launch picks
// the instance; over Fe2 only a = 0 exists).
template <class F, bool kAZero>
__global__ void __launch_bounds__(kLaneThreads<F>)
    warp_jdbl_n_kernel(Curve C, const uint4* x, const uint4* y, const uint4* z,
                       uint4* ox, uint4* oy, uint4* oz, long long n, int count) {
  const long long i = blockIdx.x;
  if (i >= n) return;  // the whole block
  const int g = threadIdx.x >> 3, k = threadIdx.x & 7;
  const uint32_t pk = fe_word(fe_from(C.M.p), k);
  PtT<F> P = pt_load<F>(x, y, z, i);
#pragma unroll 1
  for (int c = 0; c < count; ++c) P = warp_double<kAZero>(C, P, g, k, pk);
  // every thread has read its rows: outputs may alias inputs
  if (kLaneThreads<F> > 32) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (threadIdx.x == 0) pt_store<F>(ox, oy, oz, i, P);
}

}  // namespace crescent
