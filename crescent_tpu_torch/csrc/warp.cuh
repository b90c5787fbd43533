// The latency-bound point kernels with several threads a lane, over Fq and
// over Fq2: `jdbl_n` and `jadd`; and the round plan of the mixed addition
// (`madd_sum`, `madd_rounds`) that madd.cuh's `madd` and `fixed_base` run
// on one thread a lane.  The window combine's doubling chains (16,
// 8, 4, 2 and 1 lanes of 11 to 176 doublings in a chunk) and the bucket
// aggregate's additions (one launch a level: 25,625 lanes for the suffix
// sums, then 12,800 down to 1 for the weights and the combine) are too few
// lanes to fill the card with one thread a lane, and each lane runs a long
// dependent chain of Montgomery products, so one thread a lane is bound by
// latency.  Here a lane's doubling or addition runs its base products side
// by side in rounds, each round reading only values of earlier rounds, on
// one of two kinds of executor:
//   * groups: each product shared by a group of 8 threads, one 32-bit word
//     a thread (the threads-per-instance scheme of NVIDIA's CGBN library);
//     one warp a lane (four groups, the products passed on by shuffles),
//     or the two or four warps of a block (eight or sixteen groups, through
//     shared memory);
//   * product threads: one whole product a thread (field.cuh's
//     fe_mont_mul), four or eight threads a lane, the products passed on by
//     shuffles, or one thread a lane running a round's products in turn.
//     They repeat less work than groups do (a group's threads each take a
//     share of every step of the product, and every thread computes every
//     sum), so they hold up where the lanes are many and the card's issue
//     rate, not the chain's latency, binds.
// An Fq doubling is 8 products in three rounds on one warp, an Fq2 one
// (a = 0 only, as BN254 G2) 16 base products in three rounds of at most
// eight on two warps; an Fq addition 16 products in five rounds of at most
// four, an Fq2 one 43 base products in five rounds of at most sixteen (on
// four warps) or six of at most eight (on eight product threads).
// `jdbl_n` runs on groups, `jadd` on the executor that the lane count
// picks (kJaddGroupLanesMax<F> and kJaddOneThreadLanesMin<F>, measured on
// the card: PERF.md), and the fused aggregate `bucket_reduce`
// (bucket.cuh) each level's additions on the executor that a block's share
// of the level picks.

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

// t = a + b; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add_chain_carry(Fe& t, const Fe& a, const Fe& b) {
  uint32_t carry;
  asm("add.cc.u32 %0, %9, %17;\n\taddc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\taddc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\taddc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\taddc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : CRESCENT_OUT8(t), "=r"(carry)
      : CRESCENT_IN8(a), CRESCENT_IN8(b));
  return carry;
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

// a + b < 2p: keep it if subtracting p borrows.  For p < 2^255 the sum
// fits 256 bits.  kWide (p >= 2^255, P-256's and T-256's base fields): a
// sum with a carry out of 256 bits is above p, and the chain's t - p
// (mod 2^256) is the result whatever it borrowed.
template <bool kWide = false>
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const Mod& M) {
  Fe t, d;
  if constexpr (kWide) {
    const uint32_t carry = add_chain_carry(t, a, b);
    const uint32_t borrow = sub_chain(d, t, fe_from(M.p));
    return fe_select(borrow != 0 && carry == 0, t, d);
  } else {
    add_chain(t, a, b);
    const uint32_t borrow = sub_chain(d, t, fe_from(M.p));
    return fe_select(borrow != 0, t, d);
  }
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
// bit k of ((G << 1) + P) ^ P).  kWide (p >= 2^255): T < 2p may reach
// 2^256, its word 8 the carries out of word 7 (thread 7's, then the
// chain's); T - p is then the product whatever it borrowed, as in
// field.cuh's fe_reduce_once.  Every thread of the warp must call it.
template <bool kWide = false>
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
  const uint32_t carry = ((G << 1) + P) ^ P;
  r += carry >> k & 1u;  // for p < 2^255 word 8 of T is 0: T < 2^256
  uint32_t top = 0;
  if constexpr (kWide) {
    top = __shfl_sync(kFullWarp, (uint32_t)(s >> 32), base + 7) + (carry >> 8 & 1u);
  }
  // T - p, kept unless it borrows out of word 7 (and word 8 is 0)
  G = group_bits(__ballot_sync(kFullWarp, r < pk), base);
  P = group_bits(__ballot_sync(kFullWarp, r == pk), base);
  const uint32_t borrow = ((G << 1) + P) ^ P;
  const uint32_t d = r - pk - (borrow >> k & 1u);
  if constexpr (kWide) {
    return (borrow >> 8 & 1u) > top ? r : d;
  } else {
    return borrow >> 8 & 1u ? r : d;
  }
}

// N <= 4 products a[j] b[j], group j of the warp computing product j (the
// other groups repeat product 0 and are not read); every thread gets every
// product whole (8 shuffles a product).  g, k: this thread's group and word.
template <int N, bool kWide>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N],
                                              Fe (&out)[N], const Mod& M,
                                              int g, int k, uint32_t pk) {
  Fe x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = fe_select(g == j, a[j], x);
    y = fe_select(g == j, b[j], y);
  }
  const uint32_t w = group_mont_mul<kWide>(fe_word(x, k), y, pk, M, k, 8 * g);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = __shfl_sync(kFullWarp, w, 8 * j + i);
  }
}

// N <= 8 products a[j] b[j] on the two warps of the block, group j (lanes
// 8 (j % 4) .. 8 (j % 4) + 7 of warp j / 4) computing product j (the other
// groups repeat product 0 and are not read), passed on through `buf` with
// one barrier; every thread gets every product whole.
template <int N, bool kWide>
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
  const uint32_t w = group_mont_mul<kWide>(fe_word(x, k), y, pk, M, k, 8 * (g & 3));
  if (g < N) buf[g][k] = w;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = buf[j][i];
  }
}


// The Fq2 sums between the rounds: the carry chains above on each
// component.
__device__ __forceinline__ Fe2 fe2_add_cc(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_add_cc(a.c0, b.c0, M), fe_add_cc(a.c1, b.c1, M));
}

__device__ __forceinline__ Fe2 fe2_sub_cc(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_sub_cc(a.c0, b.c0, M), fe_sub_cc(a.c1, b.c1, M));
}

// Karatsuba: u v = (u0 v0 - u1 v1) + ((u0 + u1)(v0 + v1) - u0 v0 - u1 v1) u
// from t0 = u0 v0, t1 = u1 v1, t2 = (u0 + u1)(v0 + v1).
__device__ __forceinline__ Fe2 fe2_karatsuba(const Fe& t0, const Fe& t1, const Fe& t2,
                                             const Mod& M) {
  return fe2_make(fe_sub_cc(t0, t1, M), fe_sub_cc(fe_sub_cc(t2, t0, M), t1, M));
}

// A square's c1 from t = u0 u1: 2 t.
__device__ __forceinline__ Fe2 fe2_square(const Fe& c0, const Fe& t, const Mod& M) {
  return fe2_make(c0, fe_add_cc(t, t, M));
}

// Executors: `run(a, b, out)` computes the N products a[j] b[j] of a round
// side by side and hands every thread of the lane all of them (kSlots: the
// most products a round of groups can have); `any(c)` is true where c holds
// for any lane that runs its rounds together with this one (c the same in
// all of a lane's threads; every thread calls it), so a branch on it runs
// its rounds on all of those lanes or on none.  kWide: the modulus is at
// or above 2^255 (the point bodies' sums then keep their carries too).

// One warp a lane: four 8-thread groups, the products passed on by shuffles.
template <bool W = false>
struct WarpGroups {
  static constexpr int kSlots = 4;
  static constexpr bool kWide = W;
  const Mod& M;
  int g, k;     // this thread's group and word
  uint32_t pk;  // word k of p
  template <int N>
  __device__ __forceinline__ void run(const Fe (&a)[N], const Fe (&b)[N], Fe (&out)[N]) {
    static_assert(N <= kSlots, "a round has more products than groups");
    warp_products<N, W>(a, b, out, M, g, k, pk);
  }
  __device__ __forceinline__ bool any(bool c) const { return c; }  // one lane
};

// The block's kWarps warps on one lane: 4 kWarps groups, the products
// passed on through two shared buffers in turn.  One barrier a round is
// enough: a buffer is written again two rounds later, by threads that have
// passed the barrier after which every thread read it.
template <int kWarps, bool W = false>
struct BlockGroups {
  static constexpr int kSlots = 4 * kWarps;
  static constexpr bool kWide = W;
  const Mod& M;
  int g, k;
  uint32_t pk;
  uint32_t (*buf)[kSlots][8];  // two buffers
  int turn;
  template <int N>
  __device__ __forceinline__ void run(const Fe (&a)[N], const Fe (&b)[N], Fe (&out)[N]) {
    static_assert(N <= kSlots, "a round has more products than groups");
    block_products<N, W>(a, b, out, buf[turn], M, g, k, pk);
    turn ^= 1;
  }
  __device__ __forceinline__ bool any(bool c) const { return c; }  // one lane
};

// The group executor of kThreads threads a lane: one warp (four lanes a
// block of 128 threads, or one), or the block's warps.
template <int kThreads, bool kWide = false>
struct GroupsOf {
  typedef BlockGroups<kThreads / 32, kWide> type;
  static __device__ __forceinline__ type make(const Mod& M) {
    __shared__ uint32_t buf[2][kThreads / 8][8];
    const int k = threadIdx.x & 7;
    return type{M, (int)(threadIdx.x >> 3), k, fe_word(fe_from(M.p), k), buf, 0};
  }
};

template <bool kWide>
struct GroupsOf<32, kWide> {
  typedef WarpGroups<kWide> type;
  static __device__ __forceinline__ type make(const Mod& M) {
    const int k = threadIdx.x & 7;
    return type{M, (int)((threadIdx.x >> 3) & 3), k, fe_word(fe_from(M.p), k)};
  }
};

// T threads a lane (T divides 32), thread t computing products t, t + T,
// t + 2 T, ... of a round whole (the others repeat the first of their
// turn, which is not read) and passing them on by shuffles; one thread a
// lane computes a round's products in turn.  `mask` holds the warp's live
// threads.  fe_mont_mul holds any p < 2^256, so kWide only tells the
// bodies.
template <int T, bool W = false>
struct ProductThreads {
  static constexpr bool kWide = W;
  const Mod& M;
  int t;
  unsigned mask;
  template <int N>
  __device__ __forceinline__ void run(const Fe (&a)[N], const Fe (&b)[N], Fe (&out)[N]) {
    constexpr int K = (N + T - 1) / T;  // products a thread
    Fe r[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      Fe x = a[q * T], y = b[q * T];
#pragma unroll
      for (int j = q * T + 1; j < N && j < (q + 1) * T; ++j) {
        x = fe_select(t == j - q * T, a[j], x);
        y = fe_select(t == j - q * T, b[j], y);
      }
      r[q] = fe_mont_mul(x, y, M);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out[j].w[i] = T == 1 ? r[j].w[i] : __shfl_sync(mask, r[j / T].w[i], j % T, T);
      }
    }
  }
  __device__ __forceinline__ bool any(bool c) const { return __any_sync(mask, c); }
};

// One Fq doubling on an executor of four slots or more, every thread
// holding P whole: pt_double's dbl-2007-bl with its products in rounds of
// independent ones, (1) XX, YY, ZZ, (Y + Z)^2; (2) YYYY, (X + YY)^2, M^2
// (M = 3 XX); (3) M (S - X3).  With a != 0 (kAZero false), round 2 takes
// ZZ^2 in M^2's place, then a ZZ^2 and M^2 (M = 3 XX + a ZZ^2) have a
// round each.  The sums and differences are computed by every thread.
// Each value is the one pt_double computes (canonical), so the result is
// bit-equal to it.
template <bool kAZero, class X>
__device__ __forceinline__ PtT<Fe> warp_double(const Curve& C, const PtT<Fe>& P, X& ex) {
  const Mod& M = C.M;
  Fe s1[4];
  {
    const Fe a[4] = {P.x, P.y, P.z, fe_add_cc<X::kWide>(P.y, P.z, M)};
    ex.run(a, a, s1);
  }
  const Fe& XX = s1[0];
  const Fe& YY = s1[1];
  const Fe& ZZ = s1[2];
  PtT<Fe> R;
  R.z = fe_sub_cc(fe_sub_cc(s1[3], YY, M), ZZ, M);
  Fe Mm = fe_add_cc<X::kWide>(fe_add_cc<X::kWide>(XX, XX, M), XX, M);
  Fe s2[3];
  if (kAZero) {
    const Fe a[3] = {YY, fe_add_cc<X::kWide>(P.x, YY, M), Mm};
    ex.run(a, a, s2);
  } else {
    const Fe a[3] = {YY, fe_add_cc<X::kWide>(P.x, YY, M), ZZ};
    ex.run(a, a, s2);
    Fe t[1];
    const Fe ca[1] = {fe_from(C.a)}, z4[1] = {s2[2]};
    ex.run(ca, z4, t);
    Mm = fe_add_cc<X::kWide>(Mm, t[0], M);
    const Fe mm[1] = {Mm};
    ex.run(mm, mm, t);
    s2[2] = t[0];
  }
  const Fe& YYYY = s2[0];
  Fe S = fe_sub_cc(fe_sub_cc(s2[1], XX, M), YYYY, M);
  S = fe_add_cc<X::kWide>(S, S, M);
  R.x = fe_sub_cc(s2[2], fe_add_cc<X::kWide>(S, S, M), M);
  Fe t[1];
  {
    const Fe mm[1] = {Mm}, sx[1] = {fe_sub_cc(S, R.x, M)};
    ex.run(mm, sx, t);
  }
  Fe e8 = fe_add_cc<X::kWide>(YYYY, YYYY, M);
  e8 = fe_add_cc<X::kWide>(e8, e8, M);
  R.y = fe_sub_cc(t[0], fe_add_cc<X::kWide>(e8, e8, M), M);
  return R;
}

// One Fq2 doubling on an executor of eight slots or more (the groups of
// two or four warps, or eight product threads), every thread holding P
// whole, for a = 0 (BN254 G2).  pt_double over Fe2 takes 17 base products: seven Fq2
// squares of two ((x0 + x1)(x0 - x1) and x0 x1) and one Karatsuba product
// of three.  With a = 0, ZZ enters only Z3 = (Y + Z)^2 - YY - ZZ, which is
// 2 Y Z: one Karatsuba product (3) in place of two squares (4), so 16
// products in three rounds, the doubling's dependent depth:
//   1. XX, YY and Y Z (y0 z0, y1 z1, (y0 + y1)(z0 + z1)): 7;
//   2. YYYY, (X + YY)^2 and M^2 (M = 3 XX): 6;
//   3. M (S - X3) as m0 d0, m1 d1 and (m0 + m1)(d0 + d1): 3.
// Every value is the field element pt_double computes, canonical, so the
// result is bit-equal to it (tests/test_torch_warp_fq2.py models the plan).
template <bool kAZero, class X>
__device__ __forceinline__ PtT<Fe2> warp_double(const Curve& C, const PtT<Fe2>& P, X& ex) {
  static_assert(kAZero, "the Fq2 doubling serves a = 0 only");
  const Mod& M = C.M;
  const Fe ys = fe_add_cc(P.y.c0, P.y.c1, M);  // y0 + y1
  Fe r1[7];
  {
    const Fe a[7] = {fe_add_cc(P.x.c0, P.x.c1, M), P.x.c0, ys, P.y.c0,
                     P.y.c0, P.y.c1, ys};
    const Fe b[7] = {fe_sub_cc(P.x.c0, P.x.c1, M), P.x.c1, fe_sub_cc(P.y.c0, P.y.c1, M),
                     P.y.c1, P.z.c0, P.z.c1, fe_add_cc(P.z.c0, P.z.c1, M)};
    ex.run(a, b, r1);
  }
  const Fe2 XX = fe2_square(r1[0], r1[1], M);
  const Fe2 YY = fe2_square(r1[2], r1[3], M);
  const Fe2 YZ = fe2_karatsuba(r1[4], r1[5], r1[6], M);
  const Fe2 T = fe2_add_cc(P.x, YY, M);
  const Fe2 Mm = fe2_add_cc(fe2_add_cc(XX, XX, M), XX, M);
  Fe r2[6];
  {
    const Fe a[6] = {fe_add_cc(YY.c0, YY.c1, M), YY.c0, fe_add_cc(T.c0, T.c1, M), T.c0,
                     fe_add_cc(Mm.c0, Mm.c1, M), Mm.c0};
    const Fe b[6] = {fe_sub_cc(YY.c0, YY.c1, M), YY.c1, fe_sub_cc(T.c0, T.c1, M), T.c1,
                     fe_sub_cc(Mm.c0, Mm.c1, M), Mm.c1};
    ex.run(a, b, r2);
  }
  const Fe2 YYYY = fe2_square(r2[0], r2[1], M);
  const Fe2 TT = fe2_square(r2[2], r2[3], M);
  Fe2 S = fe2_sub_cc(fe2_sub_cc(TT, XX, M), YYYY, M);
  S = fe2_add_cc(S, S, M);
  PtT<Fe2> R;
  R.x = fe2_sub_cc(fe2_square(r2[4], r2[5], M), fe2_add_cc(S, S, M), M);
  const Fe2 D = fe2_sub_cc(S, R.x, M);
  Fe r3[3];
  {
    const Fe a[3] = {Mm.c0, Mm.c1, fe_add_cc(Mm.c0, Mm.c1, M)};
    const Fe b[3] = {D.c0, D.c1, fe_add_cc(D.c0, D.c1, M)};
    ex.run(a, b, r3);
  }
  const Fe2 MD = fe2_karatsuba(r3[0], r3[1], r3[2], M);
  Fe2 e8 = fe2_add_cc(YYYY, YYYY, M);
  e8 = fe2_add_cc(e8, e8, M);
  R.y = fe2_sub_cc(MD, fe2_add_cc(e8, e8, M), M);
  R.z = fe2_add_cc(YZ, YZ, M);
  return R;
}

// The six input planes of `jadd`; a lane reads its rows where it needs them
// (the inputs, then again in the rare doubling and identity cases), so no
// thread keeps both points in registers through the rounds.
struct JaddRows {
  const uint4 *x1, *y1, *z1, *x2, *y2, *z2;
};

// The cases of a lane's addition that its formula does not give: P == Q
// (both finite) takes the doubling of P, P == -Q gives Z = 0 (x and y what
// the formula gave), a side at the identity gives the other side.
struct JaddCase {
  bool dbl, p_inf, q_inf, negs;
};

// R = P + Q, lane i's points (add-2007-bl with its edge cases,
// pallas_ec._jadd_body) on an executor of four slots or more: 16 products in five rounds,
// the formula's dependent depth,
//   1. Z1Z1, Z2Z2, Y1 Z2, Y2 Z1;
//   2. U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1;
//   3. I = (2 H)^2, rr^2, (Z1 + Z2)^2   (H = U2 - U1, rr = 2 (S2 - S1));
//   4. J = H I, V = U1 I, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H;
//   5. S1 J, rr (V - X3).
// R is the formula's sum; the cases it does not give are returned
// (jadd_rounds completes them).  Every value is the one `jadd_plain`
// (ops/cuda_ec.py) computes (canonical), so the result is bit-equal to it
// (tests/test_torch_jadd_rounds.py models the plan).
template <bool kAZero, class X>
__device__ __forceinline__ JaddCase jadd_sum(const Curve& C, X& ex, const JaddRows& in,
                                             long long i, PtT<Fe>& R) {
  const Mod& M = C.M;
  const Fe Z1 = fe_load(in.z1 + 2 * i), Z2 = fe_load(in.z2 + 2 * i);
  Fe r1[4];
  {
    const Fe a[4] = {Z1, Z2, fe_load(in.y1 + 2 * i), fe_load(in.y2 + 2 * i)};
    const Fe b[4] = {Z1, Z2, Z2, Z1};
    ex.run(a, b, r1);
  }
  const Fe& Z1Z1 = r1[0];
  const Fe& Z2Z2 = r1[1];
  Fe r2[4];
  {
    const Fe a[4] = {fe_load(in.x1 + 2 * i), fe_load(in.x2 + 2 * i), r1[2], r1[3]};
    const Fe b[4] = {Z2Z2, Z1Z1, Z2Z2, Z1Z1};
    ex.run(a, b, r2);
  }
  const Fe& U1 = r2[0];
  const Fe& S1 = r2[2];
  const Fe H = fe_sub_cc(r2[1], U1, M);
  const Fe r = fe_sub_cc(r2[3], S1, M);
  const bool h_zero = fe_is_zero(H), r_zero = fe_is_zero(r);
  const bool p_inf = fe_is_zero(Z1), q_inf = fe_is_zero(Z2);
  const bool finite = !p_inf && !q_inf;
  const bool dbl = finite && h_zero && r_zero;
  if (ex.any(!dbl)) {
    const Fe rr = fe_add_cc<X::kWide>(r, r, M);
    Fe r3[3];
    {
      const Fe a[3] = {fe_add_cc<X::kWide>(H, H, M), rr, fe_add_cc<X::kWide>(Z1, Z2, M)};
      ex.run(a, a, r3);
    }
    const Fe& I = r3[0];
    Fe r4[3];
    {
      const Fe a[3] = {H, U1, fe_sub_cc(fe_sub_cc(r3[2], Z1Z1, M), Z2Z2, M)};
      const Fe b[3] = {I, I, H};
      ex.run(a, b, r4);
    }
    const Fe& J = r4[0];
    const Fe& V = r4[1];
    R.x = fe_sub_cc(fe_sub_cc(r3[1], J, M), fe_add_cc<X::kWide>(V, V, M), M);
    R.z = r4[2];
    Fe r5[2];
    {
      const Fe a[2] = {S1, rr};
      const Fe b[2] = {J, fe_sub_cc(V, R.x, M)};
      ex.run(a, b, r5);
    }
    R.y = fe_sub_cc(r5[1], fe_add_cc<X::kWide>(r5[0], r5[0], M), M);
  }
  return {dbl, p_inf, q_inf, finite && h_zero && !r_zero};
}

// R = P + Q over Fq2, lane i's points (a = 0, BN254 G2), on the eight
// product threads of the wide launches: the addition over Fe2 is five Fq2
// squares of two base products and eleven Karatsuba products of three, 43
// base products.  At most eight a round, the formula's five dependent
// levels take six rounds:
//   1. Z1Z1, Z2Z2, Y1 Z2 and y20 z10 (Y2 Z1's first): 8;
//   2. the rest of Y2 Z1, U1 = X1 Z2Z2, U2 = X2 Z1Z1: 8;
//   3. S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, (Z1 + Z2)^2: 8;
//   4. I = (2 H)^2, rr^2, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H: 7;
//   5. J = H I, V = U1 I: 6;
//   6. S1 J, rr (V - X3): 6.
// The cases the formula does not give are returned, as over Fq.  Every
// value is the field element jadd_plain computes, canonical, so the result
// is bit-equal to it.
template <bool kAZero, class X>
__device__ __forceinline__ JaddCase jadd_sum(const Curve& C, X& ex, const JaddRows& in,
                                             long long i, PtT<Fe2>& R) {
  static_assert(kAZero, "the Fq2 addition serves a = 0 only");
  typedef FieldRow<Fe2> Row;
  const Mod& M = C.M;
  const Fe2 Z1 = Row::load(in.z1 + 4 * i), Z2 = Row::load(in.z2 + 4 * i);
  const Fe2 Y2 = Row::load(in.y2 + 4 * i);
  const Fe z1s = fe_add_cc(Z1.c0, Z1.c1, M);
  Fe r1[8];
  {
    const Fe2 Y1 = Row::load(in.y1 + 4 * i);
    const Fe z2s = fe_add_cc(Z2.c0, Z2.c1, M);
    const Fe a[8] = {z1s, Z1.c0, z2s, Z2.c0, Y1.c0, Y1.c1, fe_add_cc(Y1.c0, Y1.c1, M), Y2.c0};
    const Fe b[8] = {fe_sub_cc(Z1.c0, Z1.c1, M), Z1.c1, fe_sub_cc(Z2.c0, Z2.c1, M), Z2.c1,
                     Z2.c0, Z2.c1, z2s, Z1.c0};
    ex.run(a, b, r1);
  }
  const Fe2 Z1Z1 = fe2_square(r1[0], r1[1], M);
  const Fe2 Z2Z2 = fe2_square(r1[2], r1[3], M);
  const Fe2 Y1Z2 = fe2_karatsuba(r1[4], r1[5], r1[6], M);
  Fe r2[8];
  {
    const Fe2 X1 = Row::load(in.x1 + 4 * i), X2 = Row::load(in.x2 + 4 * i);
    const Fe a[8] = {Y2.c1, fe_add_cc(Y2.c0, Y2.c1, M), X1.c0, X1.c1,
                     fe_add_cc(X1.c0, X1.c1, M), X2.c0, X2.c1, fe_add_cc(X2.c0, X2.c1, M)};
    const Fe b[8] = {Z1.c1, z1s, Z2Z2.c0, Z2Z2.c1, fe_add_cc(Z2Z2.c0, Z2Z2.c1, M),
                     Z1Z1.c0, Z1Z1.c1, fe_add_cc(Z1Z1.c0, Z1Z1.c1, M)};
    ex.run(a, b, r2);
  }
  const Fe2 Y2Z1 = fe2_karatsuba(r1[7], r2[0], r2[1], M);
  const Fe2 U1 = fe2_karatsuba(r2[2], r2[3], r2[4], M);
  const Fe2 H = fe2_sub_cc(fe2_karatsuba(r2[5], r2[6], r2[7], M), U1, M);
  Fe r3[8];
  {
    const Fe2 ZS = fe2_add_cc(Z1, Z2, M);
    const Fe a[8] = {Y1Z2.c0, Y1Z2.c1, fe_add_cc(Y1Z2.c0, Y1Z2.c1, M), Y2Z1.c0, Y2Z1.c1,
                     fe_add_cc(Y2Z1.c0, Y2Z1.c1, M), fe_add_cc(ZS.c0, ZS.c1, M), ZS.c0};
    const Fe b[8] = {Z2Z2.c0, Z2Z2.c1, fe_add_cc(Z2Z2.c0, Z2Z2.c1, M), Z1Z1.c0, Z1Z1.c1,
                     fe_add_cc(Z1Z1.c0, Z1Z1.c1, M), fe_sub_cc(ZS.c0, ZS.c1, M), ZS.c1};
    ex.run(a, b, r3);
  }
  const Fe2 S1 = fe2_karatsuba(r3[0], r3[1], r3[2], M);
  const Fe2 r = fe2_sub_cc(fe2_karatsuba(r3[3], r3[4], r3[5], M), S1, M);
  const bool h_zero = fe_is_zero(H), r_zero = fe_is_zero(r);
  const bool p_inf = fe_is_zero(Z1), q_inf = fe_is_zero(Z2);
  const bool finite = !p_inf && !q_inf;
  const bool dbl = finite && h_zero && r_zero;
  if (ex.any(!dbl)) {
    const Fe2 rr = fe2_add_cc(r, r, M);
    Fe r4[7];
    {
      const Fe2 H2 = fe2_add_cc(H, H, M);
      const Fe2 Zt = fe2_sub_cc(fe2_sub_cc(fe2_square(r3[6], r3[7], M), Z1Z1, M), Z2Z2, M);
      const Fe a[7] = {fe_add_cc(H2.c0, H2.c1, M), H2.c0, fe_add_cc(rr.c0, rr.c1, M), rr.c0,
                       Zt.c0, Zt.c1, fe_add_cc(Zt.c0, Zt.c1, M)};
      const Fe b[7] = {fe_sub_cc(H2.c0, H2.c1, M), H2.c1, fe_sub_cc(rr.c0, rr.c1, M), rr.c1,
                       H.c0, H.c1, fe_add_cc(H.c0, H.c1, M)};
      ex.run(a, b, r4);
    }
    const Fe2 I = fe2_square(r4[0], r4[1], M);
    R.z = fe2_karatsuba(r4[4], r4[5], r4[6], M);
    Fe r5[6];
    {
      const Fe is = fe_add_cc(I.c0, I.c1, M);
      const Fe a[6] = {H.c0, H.c1, fe_add_cc(H.c0, H.c1, M), U1.c0, U1.c1,
                       fe_add_cc(U1.c0, U1.c1, M)};
      const Fe b[6] = {I.c0, I.c1, is, I.c0, I.c1, is};
      ex.run(a, b, r5);
    }
    const Fe2 J = fe2_karatsuba(r5[0], r5[1], r5[2], M);
    const Fe2 V = fe2_karatsuba(r5[3], r5[4], r5[5], M);
    R.x = fe2_sub_cc(fe2_sub_cc(fe2_square(r4[2], r4[3], M), J, M), fe2_add_cc(V, V, M), M);
    Fe r6[6];
    {
      const Fe2 D = fe2_sub_cc(V, R.x, M);
      const Fe a[6] = {S1.c0, S1.c1, fe_add_cc(S1.c0, S1.c1, M), rr.c0, rr.c1,
                       fe_add_cc(rr.c0, rr.c1, M)};
      const Fe b[6] = {J.c0, J.c1, fe_add_cc(J.c0, J.c1, M), D.c0, D.c1,
                       fe_add_cc(D.c0, D.c1, M)};
      ex.run(a, b, r6);
    }
    const Fe2 SJ = fe2_karatsuba(r6[0], r6[1], r6[2], M);
    R.y = fe2_sub_cc(fe2_karatsuba(r6[3], r6[4], r6[5], M), fe2_add_cc(SJ, SJ, M), M);
  }
  return {dbl, p_inf, q_inf, finite && h_zero && !r_zero};
}

// R = P + Q over Fq2 on sixteen groups (four warps a lane, a = 0), the
// narrow launches' executor: the 43 base products in the formula's five
// rounds,
//   1. Z1Z1, Z2Z2, Y1 Z2, Y2 Z1 and (Z1 + Z2)^2: 12;
//   2. U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1: 12;
//   3. I = (2 H)^2, rr^2, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H: 7;
//   4. J = H I, V = U1 I: 6;
//   5. S1 J, rr (V - X3): 6.
// The same values as the plan above, so bit-equal to jadd_plain too.
template <bool kAZero>
__device__ __forceinline__ JaddCase jadd_sum(const Curve& C, BlockGroups<4>& ex,
                                             const JaddRows& in, long long i, PtT<Fe2>& R) {
  static_assert(kAZero, "the Fq2 addition serves a = 0 only");
  typedef FieldRow<Fe2> Row;
  const Mod& M = C.M;
  const Fe2 Z1 = Row::load(in.z1 + 4 * i), Z2 = Row::load(in.z2 + 4 * i);
  Fe r1[12];
  {
    const Fe2 Y1 = Row::load(in.y1 + 4 * i), Y2 = Row::load(in.y2 + 4 * i);
    const Fe2 ZS = fe2_add_cc(Z1, Z2, M);
    const Fe z1s = fe_add_cc(Z1.c0, Z1.c1, M), z2s = fe_add_cc(Z2.c0, Z2.c1, M);
    const Fe a[12] = {z1s, Z1.c0, z2s, Z2.c0, Y1.c0, Y1.c1, fe_add_cc(Y1.c0, Y1.c1, M),
                      Y2.c0, Y2.c1, fe_add_cc(Y2.c0, Y2.c1, M), fe_add_cc(ZS.c0, ZS.c1, M),
                      ZS.c0};
    const Fe b[12] = {fe_sub_cc(Z1.c0, Z1.c1, M), Z1.c1, fe_sub_cc(Z2.c0, Z2.c1, M), Z2.c1,
                      Z2.c0, Z2.c1, z2s, Z1.c0, Z1.c1, z1s, fe_sub_cc(ZS.c0, ZS.c1, M), ZS.c1};
    ex.run(a, b, r1);
  }
  const Fe2 Z1Z1 = fe2_square(r1[0], r1[1], M);
  const Fe2 Z2Z2 = fe2_square(r1[2], r1[3], M);
  const Fe2 Y1Z2 = fe2_karatsuba(r1[4], r1[5], r1[6], M);
  const Fe2 Y2Z1 = fe2_karatsuba(r1[7], r1[8], r1[9], M);
  const Fe2 Zt = fe2_sub_cc(fe2_sub_cc(fe2_square(r1[10], r1[11], M), Z1Z1, M), Z2Z2, M);
  Fe r2[12];
  {
    const Fe2 X1 = Row::load(in.x1 + 4 * i), X2 = Row::load(in.x2 + 4 * i);
    const Fe z2z2s = fe_add_cc(Z2Z2.c0, Z2Z2.c1, M), z1z1s = fe_add_cc(Z1Z1.c0, Z1Z1.c1, M);
    const Fe a[12] = {X1.c0, X1.c1, fe_add_cc(X1.c0, X1.c1, M), X2.c0, X2.c1,
                      fe_add_cc(X2.c0, X2.c1, M), Y1Z2.c0, Y1Z2.c1,
                      fe_add_cc(Y1Z2.c0, Y1Z2.c1, M), Y2Z1.c0, Y2Z1.c1,
                      fe_add_cc(Y2Z1.c0, Y2Z1.c1, M)};
    const Fe b[12] = {Z2Z2.c0, Z2Z2.c1, z2z2s, Z1Z1.c0, Z1Z1.c1, z1z1s,
                      Z2Z2.c0, Z2Z2.c1, z2z2s, Z1Z1.c0, Z1Z1.c1, z1z1s};
    ex.run(a, b, r2);
  }
  const Fe2 U1 = fe2_karatsuba(r2[0], r2[1], r2[2], M);
  const Fe2 H = fe2_sub_cc(fe2_karatsuba(r2[3], r2[4], r2[5], M), U1, M);
  const Fe2 S1 = fe2_karatsuba(r2[6], r2[7], r2[8], M);
  const Fe2 r = fe2_sub_cc(fe2_karatsuba(r2[9], r2[10], r2[11], M), S1, M);
  const bool h_zero = fe_is_zero(H), r_zero = fe_is_zero(r);
  const bool p_inf = fe_is_zero(Z1), q_inf = fe_is_zero(Z2);
  const bool finite = !p_inf && !q_inf;
  const bool dbl = finite && h_zero && r_zero;
  if (ex.any(!dbl)) {
    const Fe2 rr = fe2_add_cc(r, r, M);
    Fe r3[7];
    {
      const Fe2 H2 = fe2_add_cc(H, H, M);
      const Fe a[7] = {fe_add_cc(H2.c0, H2.c1, M), H2.c0, fe_add_cc(rr.c0, rr.c1, M), rr.c0,
                       Zt.c0, Zt.c1, fe_add_cc(Zt.c0, Zt.c1, M)};
      const Fe b[7] = {fe_sub_cc(H2.c0, H2.c1, M), H2.c1, fe_sub_cc(rr.c0, rr.c1, M), rr.c1,
                       H.c0, H.c1, fe_add_cc(H.c0, H.c1, M)};
      ex.run(a, b, r3);
    }
    const Fe2 I = fe2_square(r3[0], r3[1], M);
    R.z = fe2_karatsuba(r3[4], r3[5], r3[6], M);
    Fe r4[6];
    {
      const Fe is = fe_add_cc(I.c0, I.c1, M);
      const Fe a[6] = {H.c0, H.c1, fe_add_cc(H.c0, H.c1, M), U1.c0, U1.c1,
                       fe_add_cc(U1.c0, U1.c1, M)};
      const Fe b[6] = {I.c0, I.c1, is, I.c0, I.c1, is};
      ex.run(a, b, r4);
    }
    const Fe2 J = fe2_karatsuba(r4[0], r4[1], r4[2], M);
    const Fe2 V = fe2_karatsuba(r4[3], r4[4], r4[5], M);
    R.x = fe2_sub_cc(fe2_sub_cc(fe2_square(r3[2], r3[3], M), J, M), fe2_add_cc(V, V, M), M);
    Fe r5[6];
    {
      const Fe2 D = fe2_sub_cc(V, R.x, M);
      const Fe a[6] = {S1.c0, S1.c1, fe_add_cc(S1.c0, S1.c1, M), rr.c0, rr.c1,
                       fe_add_cc(rr.c0, rr.c1, M)};
      const Fe b[6] = {J.c0, J.c1, fe_add_cc(J.c0, J.c1, M), D.c0, D.c1,
                       fe_add_cc(D.c0, D.c1, M)};
      ex.run(a, b, r5);
    }
    const Fe2 SJ = fe2_karatsuba(r5[0], r5[1], r5[2], M);
    R.y = fe2_sub_cc(fe2_karatsuba(r5[3], r5[4], r5[5], M), fe2_add_cc(SJ, SJ, M), M);
  }
  return {dbl, p_inf, q_inf, finite && h_zero && !r_zero};
}

// R = P + Q, lane i's points on executor ex: the formula's rounds
// (jadd_sum), then the cases it does not give, the doubling's rounds run
// wherever a lane run together with this one needs them.
template <bool kAZero, class F, class X>
__device__ __forceinline__ void jadd_rounds(const Curve& C, X& ex, const JaddRows& in,
                                            long long i, PtT<F>& R) {
  const JaddCase k = jadd_sum<kAZero>(C, ex, in, i, R);
  if (ex.any(k.dbl)) {
    const PtT<F> D = warp_double<kAZero>(C, pt_load<F>(in.x1, in.y1, in.z1, i), ex);
    if (k.dbl) R = D;
  }
  if (k.negs) R.z = FieldRow<F>::zero();
  if (k.p_inf) {
    R = pt_load<F>(in.x2, in.y2, in.z2, i);
  } else if (k.q_inf) {
    R = pt_load<F>(in.x1, in.y1, in.z1, i);
  }
}

// P = 2 P on executor ex (warp_double), in a function of its own: only
// lanes with P == Q take it, and its rounds' registers then do not add to
// the addition's.  The caller passes copies, so that its own P and
// executor stay in registers.
template <bool kAZero, class F, class X>
__device__ __noinline__ void madd_double(const Curve& C, X& ex, PtT<F>& P) {
  P = warp_double<kAZero>(C, P, ex);
}

// Whether madd's doubling over F is the call above (true) or inlined.
// Measured on the card (PERF.md, scripts/chain_designs.py): over Fq the
// call, inlined `fixed_base` is 1.26x slower; over Fq2 inlined, the call
// is 1.02x (`fixed_base`) and 1.11x (`madd`) slower, and neither spills.
template <class F>
constexpr bool kMaddDoubleCall = true;
template <>
constexpr bool kMaddDoubleCall<Fe2> = false;

// P = 2 P where `dbl` (P == Q), the doubling run wherever a lane run
// together with this one needs it.
template <bool kAZero, class F, class X>
__device__ __forceinline__ void madd_doubles(const Curve& C, X& ex, bool dbl, PtT<F>& P) {
  if (ex.any(dbl)) {
    PtT<F> D = P;
    X e = ex;
    if constexpr (kMaddDoubleCall<F>) {
      madd_double<kAZero>(C, e, D);
    } else {
      D = warp_double<kAZero>(C, D, e);
    }
    if (dbl) P = D;
  }
}

// P = P + Q where `add` (P finite), Q = (qx, qy) affine (madd-2007-bl,
// pallas_ec._madd_body), on an executor of two slots or more: 11 products
// in five rounds, the formula's dependent depth,
//   1. Z1Z1, qy Z1;
//   2. U2 = qx Z1Z1, S2 = qy Z1 Z1Z1;
//   3. HH = H^2, rr^2, (Z1 + H)^2   (H = U2 - X1, rr = 2 (S2 - Y1));
//   4. J = H I, V = X1 I   (I = 4 HH);
//   5. Y1 J, rr (V - X3).
// P == Q (H == 0 and r == 0) takes the doubling at the end, from P, which
// the rounds leave as it is there, so that only P (and over Fq the sum) is
// live across that call.  P == -Q needs nothing more: Z3 = (Z1 + 0)^2
// - Z1Z1 - 0 is 0, with x and y what the formula gives.  Every value is the
// one `madd_plain` (ops/cuda_ec.py) computes (canonical), so the result is
// bit-equal to it (tests/test_torch_madd_rounds.py models the plan).
template <bool kAZero, class X>
__device__ __forceinline__ void madd_sum(const Curve& C, X& ex, bool add, const Fe& qx,
                                         const Fe& qy, PtT<Fe>& P) {
  static_assert(!X::kWide, "madd serves p < 2^255 (ROADMAP Queue 2 item 1)");
  const Mod& M = C.M;
  Fe r1[2];
  {
    const Fe a[2] = {P.z, qy};
    const Fe b[2] = {P.z, P.z};
    ex.run(a, b, r1);
  }
  const Fe& Z1Z1 = r1[0];
  Fe r2[2];
  {
    const Fe a[2] = {qx, r1[1]};
    const Fe b[2] = {Z1Z1, Z1Z1};
    ex.run(a, b, r2);
  }
  const Fe H = fe_sub_cc(r2[0], P.x, M);
  const Fe r = fe_sub_cc(r2[1], P.y, M);
  const bool dbl = add && fe_is_zero(H) && fe_is_zero(r);
  const bool sum = add && !dbl;
  PtT<Fe> R;  // over Fq the registers have room for the sum beside P
  if (ex.any(sum)) {
    const Fe rr = fe_add_cc(r, r, M);
    Fe r3[3];
    {
      const Fe a[3] = {H, rr, fe_add_cc(P.z, H, M)};
      ex.run(a, a, r3);
    }
    const Fe& HH = r3[0];
    R.z = fe_sub_cc(fe_sub_cc(r3[2], Z1Z1, M), HH, M);
    Fe I = fe_add_cc(HH, HH, M);
    I = fe_add_cc(I, I, M);
    Fe r4[2];
    {
      const Fe a[2] = {H, P.x};
      const Fe b[2] = {I, I};
      ex.run(a, b, r4);
    }
    const Fe& J = r4[0];
    const Fe& V = r4[1];
    R.x = fe_sub_cc(fe_sub_cc(r3[1], J, M), fe_add_cc(V, V, M), M);
    Fe r5[2];
    {
      const Fe a[2] = {P.y, rr};
      const Fe b[2] = {J, fe_sub_cc(V, R.x, M)};
      ex.run(a, b, r5);
    }
    R.y = fe_sub_cc(r5[1], fe_add_cc(r5[0], r5[0], M), M);
  }
  madd_doubles<kAZero>(C, ex, dbl, P);
  if (sum) P = R;
}

// The same over Fq2 (a = 0, BN254 G2): Fq2 squares of two base products
// each and Karatsuba products of three, 30 base products in the same five
// rounds, with two changes that keep one thread a lane below the
// 255-register limit: the sum is written over P coordinate by coordinate
// once the rounds no longer read it (Z3 after round 3, X3 after 4, Y3
// after 5), so that no second point stays live beside P, and
// Z3 = (Z1 + H)^2 - Z1Z1 - HH is taken as 2 Z1 H (the same element; a
// Karatsuba product in place of a square, one base product more), so that
// Z1Z1 dies after round 2:
//   1. Z1Z1, qy Z1: 5;
//   2. U2 = qx Z1Z1, S2 = qy Z1 Z1Z1: 6;
//   3. HH, rr^2, Z1 H: 7;
//   4. J = H I, V = X1 I: 6;
//   5. Y1 J, rr (V - X3): 6.
template <bool kAZero, class X>
__device__ __forceinline__ void madd_sum(const Curve& C, X& ex, bool add, const Fe2& qx,
                                         const Fe2& qy, PtT<Fe2>& P) {
  static_assert(kAZero, "the Fq2 addition serves a = 0 only");
  const Mod& M = C.M;
  Fe r1[5];
  {
    const Fe zs = fe_add_cc(P.z.c0, P.z.c1, M);
    const Fe a[5] = {zs, P.z.c0, qy.c0, qy.c1, fe_add_cc(qy.c0, qy.c1, M)};
    const Fe b[5] = {fe_sub_cc(P.z.c0, P.z.c1, M), P.z.c1, P.z.c0, P.z.c1, zs};
    ex.run(a, b, r1);
  }
  const Fe2 Z1Z1 = fe2_square(r1[0], r1[1], M);
  Fe r2[6];
  {
    const Fe2 QZ = fe2_karatsuba(r1[2], r1[3], r1[4], M);
    const Fe zz = fe_add_cc(Z1Z1.c0, Z1Z1.c1, M);
    const Fe a[6] = {qx.c0, qx.c1, fe_add_cc(qx.c0, qx.c1, M), QZ.c0, QZ.c1,
                     fe_add_cc(QZ.c0, QZ.c1, M)};
    const Fe b[6] = {Z1Z1.c0, Z1Z1.c1, zz, Z1Z1.c0, Z1Z1.c1, zz};
    ex.run(a, b, r2);
  }
  const Fe2 H = fe2_sub_cc(fe2_karatsuba(r2[0], r2[1], r2[2], M), P.x, M);
  const Fe2 r = fe2_sub_cc(fe2_karatsuba(r2[3], r2[4], r2[5], M), P.y, M);
  const bool dbl = add && fe_is_zero(H) && fe_is_zero(r);
  const bool sum = add && !dbl;
  if (ex.any(sum)) {
    const Fe2 rr = fe2_add_cc(r, r, M);
    Fe r3[7];
    {
      const Fe hs = fe_add_cc(H.c0, H.c1, M);
      const Fe a[7] = {hs, H.c0, fe_add_cc(rr.c0, rr.c1, M), rr.c0, P.z.c0, P.z.c1,
                       fe_add_cc(P.z.c0, P.z.c1, M)};
      const Fe b[7] = {fe_sub_cc(H.c0, H.c1, M), H.c1, fe_sub_cc(rr.c0, rr.c1, M), rr.c1,
                       H.c0, H.c1, hs};
      ex.run(a, b, r3);
    }
    const Fe2 HH = fe2_square(r3[0], r3[1], M);
    if (sum) {
      const Fe2 ZH = fe2_karatsuba(r3[4], r3[5], r3[6], M);
      P.z = fe2_add_cc(ZH, ZH, M);
    }
    Fe2 I = fe2_add_cc(HH, HH, M);
    I = fe2_add_cc(I, I, M);
    Fe r4[6];
    {
      const Fe is = fe_add_cc(I.c0, I.c1, M);
      const Fe a[6] = {H.c0, H.c1, fe_add_cc(H.c0, H.c1, M), P.x.c0, P.x.c1,
                       fe_add_cc(P.x.c0, P.x.c1, M)};
      const Fe b[6] = {I.c0, I.c1, is, I.c0, I.c1, is};
      ex.run(a, b, r4);
    }
    const Fe2 J = fe2_karatsuba(r4[0], r4[1], r4[2], M);
    const Fe2 V = fe2_karatsuba(r4[3], r4[4], r4[5], M);
    const Fe2 X3 =
        fe2_sub_cc(fe2_sub_cc(fe2_square(r3[2], r3[3], M), J, M), fe2_add_cc(V, V, M), M);
    if (sum) P.x = X3;
    Fe r5[6];
    {
      const Fe2 D = fe2_sub_cc(V, X3, M);
      const Fe a[6] = {P.y.c0, P.y.c1, fe_add_cc(P.y.c0, P.y.c1, M), rr.c0, rr.c1,
                       fe_add_cc(rr.c0, rr.c1, M)};
      const Fe b[6] = {J.c0, J.c1, fe_add_cc(J.c0, J.c1, M), D.c0, D.c1,
                       fe_add_cc(D.c0, D.c1, M)};
      ex.run(a, b, r5);
    }
    const Fe2 YJ = fe2_karatsuba(r5[0], r5[1], r5[2], M);
    if (sum) P.y = fe2_sub_cc(fe2_karatsuba(r5[3], r5[4], r5[5], M), fe2_add_cc(YJ, YJ, M), M);
  }
  madd_doubles<kAZero>(C, ex, dbl, P);  // P is the input where dbl
}

// P = valid ? P + Q : P on executor ex, Q = (qx, qy) affine: Q itself
// (Z = 1) where P is the identity, taken first so that Q is dead after
// round 2; the formula's rounds (madd_sum) where P is finite, rounds run
// wherever a lane run together with this one needs them.  The result is
// madd_plain's (pallas_ec._madd_body's), bit for bit.
template <bool kAZero, class F, class X>
__device__ __forceinline__ void madd_rounds(const Curve& C, X& ex, bool valid, const F& qx,
                                            const F& qy, PtT<F>& P) {
  const bool p_inf = fe_is_zero(P.z);
  if (valid && p_inf) {
    P.x = qx;
    P.y = qy;
    P.z = FieldRow<F>::from_base(C.one);
  }
  const bool add = valid && !p_inf;
  if (ex.any(add)) madd_sum<kAZero>(C, ex, add, qx, qy, P);
}

// Threads that run one lane's `jdbl_n` chain on groups: one warp over Fe,
// two over Fe2.
template <class F>
constexpr int kLaneThreads = 32;
template <>
constexpr int kLaneThreads<Fe2> = 64;

// `jadd`'s executors over F by the lane count n: groups of
// kJaddGroupThreads<F> threads a lane for n <= kJaddGroupLanesMax<F>,
// kJaddProductThreads<F> product threads a lane above, and one thread a
// lane from kJaddOneThreadLanesMin<F> on (0: never).  The switch-overs lie
// between the chunk's shapes where the executors were measured to cross
// on the card (PERF.md, scripts/chain_designs.py): over Fq groups at 800
// lanes, product threads at 1,600 and 12,800, one thread at 25,625; over
// Fq2 groups at 200 and product threads from 400 on (one thread a lane
// would be faster at 25,625 but spills at the 255-register limit).
template <class F>
constexpr int kJaddGroupThreads = 32;
template <>
constexpr int kJaddGroupThreads<Fe2> = 128;
template <class F>
constexpr int kJaddProductThreads = 4;
template <>
constexpr int kJaddProductThreads<Fe2> = 8;
template <class F>
constexpr long long kJaddGroupLanesMax = 1024;
template <>
constexpr long long kJaddGroupLanesMax<Fe2> = 256;
template <class F>
constexpr long long kJaddOneThreadLanesMin = 16384;
template <>
constexpr long long kJaddOneThreadLanesMin<Fe2> = 0;

// Every thread of a lane of T threads has read its rows: outputs may alias
// inputs.
template <int T>
__device__ __forceinline__ void lane_sync(unsigned mask) {
  if (T > 32) {
    __syncthreads();
  } else {
    __syncwarp(mask);
  }
}

// Thread t of a lane of T stores coordinates t, t + T, ... of R (x, y, z).
template <class F, int T>
__device__ __forceinline__ void store_coords(uint4* ox, uint4* oy, uint4* oz, long long i,
                                             const PtT<F>& R, int t) {
#pragma unroll
  for (int c = t; c < 3; c += T) {
    uint4* o = c == 0 ? ox : c == 1 ? oy : oz;
    FieldRow<F>::store(o + FieldRow<F>::kVec * i,
                       fe_select(c == 0, R.x, fe_select(c == 1, R.y, R.z)));
  }
}

// `count` chained doublings of lane blockIdx.x over F (Fe or Fe2), a block
// of kLaneThreads<F> a lane; kAZero must be C.a_is_zero (the launch picks
// the instance; over Fe2 only a = 0 exists), kWide p >= 2^255.
template <class F, bool kAZero, bool kWide = false>
__global__ void __launch_bounds__(kLaneThreads<F>)
    warp_jdbl_n_kernel(Curve C, const uint4* x, const uint4* y, const uint4* z,
                       uint4* ox, uint4* oy, uint4* oz, long long n, int count) {
  const long long i = blockIdx.x;
  if (i >= n) return;  // the whole block
  typedef GroupsOf<kLaneThreads<F>, kWide> Groups;
  typename Groups::type ex = Groups::make(C.M);
  PtT<F> P = pt_load<F>(x, y, z, i);
#pragma unroll 1
  for (int c = 0; c < count; ++c) P = warp_double<kAZero>(C, P, ex);
  lane_sync<kLaneThreads<F>>(kFullWarp);
  if (threadIdx.x == 0) pt_store<F>(ox, oy, oz, i, P);
}

// One addition a lane on groups: kJaddGroupThreads<F> threads a lane, a
// block of 128 threads (four lanes) over Fe, one lane a block over Fe2.
template <class F, bool kAZero, bool kWide = false>
__global__ void __launch_bounds__((kJaddGroupThreads<F> > 32 ? kJaddGroupThreads<F> : 128))
    group_jadd_kernel(Curve C, JaddRows in, uint4* ox, uint4* oy, uint4* oz, long long n) {
  constexpr int T = kJaddGroupThreads<F>;
  const long long i = (long long)blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  if (i >= n) return;  // whole lanes: a warp, or the block
  typename GroupsOf<T, kWide>::type ex = GroupsOf<T, kWide>::make(C.M);
  PtT<F> R;
  jadd_rounds<kAZero>(C, ex, in, i, R);
  lane_sync<T>(kFullWarp);
  store_coords<F, T>(ox, oy, oz, i, R, threadIdx.x % T);
}

// One addition a lane on T product threads, blocks of 128 threads.
template <class F, bool kAZero, int T, bool kWide = false>
__global__ void __launch_bounds__(128)
    thread_jadd_kernel(Curve C, JaddRows in, uint4* ox, uint4* oy, uint4* oz, long long n) {
  const long long i = ((long long)blockIdx.x * 128 + threadIdx.x) / T;
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;  // whole lanes
  ProductThreads<T, kWide> ex{C.M, (int)(threadIdx.x % T), live};
  PtT<F> R;
  jadd_rounds<kAZero>(C, ex, in, i, R);
  lane_sync<T>(live);
  store_coords<F, T>(ox, oy, oz, i, R, threadIdx.x % T);
}

// Host side: n additions over F with kAZero == C.a_is_zero and kWide ==
// (p >= 2^255), on the design that n lanes take; returns
// cudaGetLastError().
template <class F, bool kAZero, bool kWide = false>
int launch_jadd_lanes(const Curve& C, const void* x1, const void* y1, const void* z1,
                      const void* x2, const void* y2, const void* z2, void* ox, void* oy,
                      void* oz, long long n, void* stream) {
  if (n > 0) {
    const JaddRows in{(const uint4*)x1, (const uint4*)y1, (const uint4*)z1,
                      (const uint4*)x2, (const uint4*)y2, (const uint4*)z2};
    if (n <= kJaddGroupLanesMax<F>) {
      constexpr int T = kJaddGroupThreads<F>, B = T > 32 ? T : 128;
      group_jadd_kernel<F, kAZero, kWide><<<grid_for(n * T, B), B, 0, (cudaStream_t)stream>>>(
          C, in, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
    } else if (kJaddOneThreadLanesMin<F> == 0 || n < kJaddOneThreadLanesMin<F>) {
      constexpr int T = kJaddProductThreads<F>;
      thread_jadd_kernel<F, kAZero, T, kWide>
          <<<grid_for(n * T, 128), 128, 0, (cudaStream_t)stream>>>(
          C, in, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
    } else if constexpr (kJaddOneThreadLanesMin<F> > 0) {
      thread_jadd_kernel<F, kAZero, 1, kWide><<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
          C, in, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
    }
  }
  return (int)cudaGetLastError();
}

// `jdbl` (one doubling a lane; `CurveCtx.double` in the small-N MSM's
// scalar_mul, 256 launches of 1 to 1,024 lanes an MSM) on the executor that
// the lane count n picks: the `jdbl_n` lane body with one doubling (a
// warp's groups a lane over Fe, two warps' over Fe2) for
// n <= kJdblGroupLanesMax<F>, kJdblProductThreads<F> product threads a
// lane above, and point.cuh's one thread a lane from
// kJdblOneThreadLanesMin<F> on (0: never), where the card is full.  One
// thread a lane runs the doubling's products in a row (8 over Fq, 17 base
// products over Fq2) on at most 8 of the card's 132 SMs at these lane
// counts: bound by that chain's latency, which the rounds cut to three
// products.  Both fields' `jdbl` launch here (ec.cu, a == 0 and a != 0;
// ec2.cu).  The switch-overs lie where the executors were measured to cross
// on the card (PERF.md, scripts/chain_designs.py `jdbl_groups`,
// `jdbl_threads`, `jdbl_one_thread`): over Fq groups up to 512 lanes
// (product threads from 768), one thread from 32,768 (product threads at
// 16,384); over Fq2 groups up to 256, product threads above (one thread
// 1.07x at 2^17).
template <class F>
constexpr long long kJdblGroupLanesMax = 512;
template <>
constexpr long long kJdblGroupLanesMax<Fe2> = 256;
template <class F>
constexpr int kJdblProductThreads = 4;
template <>
constexpr int kJdblProductThreads<Fe2> = 8;
template <class F>
constexpr long long kJdblOneThreadLanesMin = 32768;
template <>
constexpr long long kJdblOneThreadLanesMin<Fe2> = 0;

// One doubling a lane on T product threads, blocks of 128 threads.
template <class F, bool kAZero, int T, bool kWide = false>
__global__ void __launch_bounds__(128)
    thread_jdbl_kernel(Curve C, const uint4* x, const uint4* y, const uint4* z, uint4* ox,
                       uint4* oy, uint4* oz, long long n) {
  const long long i = ((long long)blockIdx.x * 128 + threadIdx.x) / T;
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;  // whole lanes
  ProductThreads<T, kWide> ex{C.M, (int)(threadIdx.x % T), live};
  const PtT<F> R = warp_double<kAZero>(C, pt_load<F>(x, y, z, i), ex);
  lane_sync<T>(live);
  store_coords<F, T>(ox, oy, oz, i, R, threadIdx.x % T);
}

// Host side: n doublings over F with kAZero == C.a_is_zero and kWide ==
// (p >= 2^255), on the design that n lanes take (point.cuh's one thread a
// lane runs field.cuh's ops, which hold any p < 2^256); returns
// cudaGetLastError().
template <class F, bool kAZero, bool kWide = false>
int launch_jdbl_lanes(const Curve& C, const void* x, const void* y, const void* z, void* ox,
                      void* oy, void* oz, long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (n <= kJdblGroupLanesMax<F>) {
      warp_jdbl_n_kernel<F, kAZero, kWide><<<(unsigned)n, kLaneThreads<F>, 0, s>>>(
          C, (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n, 1);
    } else if (kJdblOneThreadLanesMin<F> == 0 || n < kJdblOneThreadLanesMin<F>) {
      constexpr int T = kJdblProductThreads<F>;
      thread_jdbl_kernel<F, kAZero, T, kWide><<<grid_for(n * T, 128), 128, 0, s>>>(
          C, (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n);
    } else if constexpr (kJdblOneThreadLanesMin<F> > 0) {
      jdbl_kernel<F><<<grid_for(n, kThreads), kThreads, 0, s>>>(
          C, (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
