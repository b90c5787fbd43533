// 256-bit prime-field arithmetic for Hopper kernels, and its quadratic
// extension Fq2 (below `Fe2`).
//
// An element is eight little-endian 32-bit words (32 bytes, the same bytes
// as the JAX package's sixteen 16-bit limbs and the native backend's four
// u64 words), in Montgomery form with R = 2^256.  Every function takes
// canonical inputs in [0, p) and returns a canonical result, so a result is
// bit-equal to the reference's Pallas `_F` ops
// (crescent_tpu/ops/pallas_ec.py:174-236) on the same inputs.
//
// The modulus is a kernel argument (`Mod`, passed by value, so it sits in
// the constant bank and every thread reads the same words): one build
// serves BN254 Fr and Fq alike.  fe_add, fe_sub, fe_reduce_once and
// fe_mont_mul hold any odd p < 2^256: a sum a + b < 2p and the CIOS
// accumulator t < 2p keep their carry out of 256 bits (fe_add's `c`, the
// accumulator's ninth word t[8]; within a step t + a b_i < 2^289 reaches
// a tenth, t[9]), and fe_reduce_once subtracts p where that carry is set
// (tests/test_torch_t256.py replays them word by word over T-256's and
// P-256's p, both above 2^255).  fe_mont_mul_sum needs p < 2^254, the
// divstep inversion is checked on BN254's moduli only.
//
// The TPU kernels ran REDC's two by-constant products as byte-plane
// Toeplitz matmuls on the MXU (pallas_ec.py:147-206).  That trick exists
// for the TPU's matrix unit; here the product is word-serial CIOS with
// 64-bit accumulators, which the compiler lowers to IMAD.WIDE carry chains.
#pragma once

#include <cstdint>

namespace crescent {

struct Mod {
  uint32_t p[8];  // modulus, little-endian words
  uint32_t inv;   // -p^-1 mod 2^32
};

struct Fe {
  uint32_t w[8];
};

// One short-Weierstrass curve y^2 = x^3 + a*x + b over the field of M:
// what the point formulas need (b never enters them).  Passed by value like
// `Mod`.
struct Curve {
  Mod M;
  uint32_t one[8];     // Montgomery 1 (2^256 mod p)
  uint32_t a[8];       // a in Montgomery form
  uint32_t a_is_zero;  // 1: the a-terms are skipped
};

__device__ __forceinline__ Fe fe_from(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = w[j];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0;
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

// c ? a : b
__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// 32-byte element from a 16-byte-aligned row: two 128-bit loads.
__device__ __forceinline__ Fe fe_load(const uint4* src) {
  uint4 lo = src[0], hi = src[1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint4* dst, const Fe& a) {
  dst[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  dst[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// t (with carry word `top`, 0 or 1) < 2p  ->  t mod p.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& t, uint32_t top,
                                             const Mod& M) {
  Fe d;
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)t.w[j] - M.p[j] - br;
    d.w[j] = (uint32_t)s;
    br = s >> 63;
  }
  // keep t - p unless it borrowed past the carry word
  const bool keep_t = br > top;
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = keep_t ? t.w[j] : d.w[j];
  return r;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const Mod& M) {
  Fe t;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a.w[j] + b.w[j];
    t.w[j] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce_once(t, (uint32_t)c, M);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const Mod& M) {
  Fe t;
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - br;
    t.w[j] = (uint32_t)s;
    br = s >> 63;
  }
  // borrowed: add p back (branch-free; the final carry out is dropped)
  const uint32_t mask = 0u - (uint32_t)br;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)t.w[j] + (M.p[j] & mask);
    t.w[j] = (uint32_t)c;
    c >>= 32;
  }
  return t;
}

// Montgomery product a * b * 2^-256 mod p (CIOS, 8 x 32-bit words).
__device__ __forceinline__ Fe fe_mont_mul(const Fe& a, const Fe& b,
                                          const Mod& M) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    // t = (t + m * p) / 2^32 with m chosen so the low word cancels
    const uint32_t m = t[0] * M.inv;
    s = (uint64_t)t[0] + (uint64_t)m * M.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * M.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return fe_reduce_once(r, t[8], M);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Mod& M) {
  return fe_mont_mul(a, a, M);
}

// (a0 b0 + a1 b1) 2^-256 mod p: both products accumulated in one CIOS pass
// with one reduction a word (200 multiply-adds against two fe_mont_mul's
// 272).  Needs p < 2^254: the accumulator then stays below 4p before each
// step and below 2^288 within it (nine words; t[9] stays 0), and the end
// value (a0 b0 + a1 b1 + m p) / 2^256 is below 1.5 p, so one conditional
// subtraction makes it canonical (tests/test_torch_affine_add_halves.py
// replays it word by word).
__device__ __forceinline__ Fe fe_mont_mul_sum(const Fe& a0, const Fe& b0, const Fe& a1,
                                              const Fe& b1, const Mod& M) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a0 * b0[i] + a1 * b1[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a0.w[j] * b0.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)a1.w[j] * b1.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] += (uint32_t)(s >> 32);
    // t = (t + m * p) / 2^32 with m chosen so the low word cancels
    const uint32_t m = t[0] * M.inv;
    s = (uint64_t)t[0] + (uint64_t)m * M.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * M.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return fe_reduce_once(r, t[8], M);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Mod& M) {
  return fe_add(a, a, M);
}

// 0 - a (0 stays 0)
__device__ __forceinline__ Fe fe_neg(const Fe& a, const Mod& M) {
  return fe_sub(fe_zero(), a, M);
}

// ---------------------------------------------------------------------------
// Constant-time inversion by divsteps (Bernstein and Yang, "Fast
// constant-time gcd computation and modular inversion", 2019), in the 32-bit
// form of libsecp256k1's modinv32: values in nine signed 30-bit limbs (limbs
// 0..7 in [0, 2^30), limb 8 signed), 30 divsteps a batch applied to the low
// words of f and g, each batch's 2x2 matrix then applied to (f, g) and,
// modulo p, to (d, e).  This is the original divstep (delta starts at 1;
// eta = -delta here), not libsecp256k1's delta = 1/2 variant, so its count
// is Bernstein and Yang's proven bound for 256-bit inputs (Theorem 11.2):
// floor((49 * 256 + 57) / 17) = 741 divsteps, run as 25 batches of 30 =
// 750.  No branch and no loop bound depends on the data.
// ---------------------------------------------------------------------------

// The schedule (tests/test_torch_inv_divsteps.py reads these three lines):
// a batch's divsteps scale its matrix by 2^kS30Bits, which the limbs divide
// out exactly, so the batch length is the limb width.
constexpr int kS30Bits = 30;
constexpr int kDivstepBatch = kS30Bits;
constexpr int kDivstepBatches = 25;
constexpr int32_t kM30 = (int32_t)((1u << kS30Bits) - 1);

struct S30 {
  int32_t v[9];
};

// canonical element (8 words) -> 9 limbs of 30 bits
__device__ __forceinline__ S30 s30_from(const uint32_t* w) {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bit = kS30Bits * i, k = bit / 32, s = bit % 32;
    uint64_t x = w[k];
    if (k + 1 < 8) x |= (uint64_t)w[k + 1] << 32;
    r.v[i] = (int32_t)((x >> s) & (uint64_t)kM30);
  }
  return r;
}

// limbs in [0, 2^30) with a value below 2^256 -> 8 words
__device__ __forceinline__ Fe fe_from_s30(const S30& a) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bit = 32 * j, i = bit / kS30Bits, s = bit % kS30Bits;  // s <= 14
    const uint64_t x = (uint64_t)(uint32_t)a.v[i] | ((uint64_t)(uint32_t)a.v[i + 1] << kS30Bits);
    r.w[j] = (uint32_t)(x >> s);
  }
  return r;
}

// 30 divsteps on the low words f0, g0 of f and g.  Returns the new eta and
// the matrix t = (u, v, q, r) with u f0 + v g0 = f 2^30, q f0 + r g0 = g 2^30
// (f, g the new values); |u| + |v| and |q| + |r| stay <= 2^30.
__device__ __forceinline__ int32_t divsteps_30(int32_t eta, uint32_t f0,
                                               uint32_t g0, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < kDivstepBatch; ++i) {
    uint32_t c1 = (uint32_t)(eta >> 31);  // delta > 0
    const uint32_t c2 = 0u - (g & 1u);    // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;  // both: (delta, f, g) -> (1 - delta, g, (g - f) / 2)
    eta = (int32_t)((((uint32_t)eta ^ c1) - c1) - 1u);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (f, g) <- t (f, g) / 2^30 (exact).
__device__ __forceinline__ void update_fg_30(S30& f, S30& g, const int32_t t[4]) {
  const int64_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = u * f.v[0] + v * g.v[0];
  int64_t cg = q * f.v[0] + r * g.v[0];
  cf >>= kS30Bits;
  cg >>= kS30Bits;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += u * f.v[i] + v * g.v[i];
    cg += q * f.v[i] + r * g.v[i];
    f.v[i - 1] = (int32_t)cf & kM30;
    g.v[i - 1] = (int32_t)cg & kM30;
    cf >>= kS30Bits;
    cg >>= kS30Bits;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me chosen so the division
// is exact (pinv30 = p^-1 mod 2^30) and the values stay in (-2p, p).
__device__ __forceinline__ void update_de_30(S30& d, S30& e, const int32_t t[4],
                                             const S30& p30, uint32_t pinv30) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  const int64_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cd = u * d.v[0] + v * e.v[0];
  int64_t ce = q * d.v[0] + r * e.v[0];
  md -= (int32_t)((pinv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((pinv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)p30.v[0] * md;
  ce += (int64_t)p30.v[0] * me;
  cd >>= kS30Bits;
  ce >>= kS30Bits;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += u * d.v[i] + v * e.v[i] + (int64_t)p30.v[i] * md;
    ce += q * d.v[i] + r * e.v[i] + (int64_t)p30.v[i] * me;
    d.v[i - 1] = (int32_t)cd & kM30;
    e.v[i - 1] = (int32_t)ce & kM30;
    cd >>= kS30Bits;
    ce >>= kS30Bits;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// d in (-2p, p) -> sign(f) d in [0, p): add p if negative, negate if f < 0,
// carry; add p again if still negative, carry.
__device__ __forceinline__ void normalize_30(S30& d, int32_t fsign,
                                             const S30& p30) {
  int32_t add = d.v[8] >> 31;
  const int32_t neg = fsign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = ((d.v[i] + (p30.v[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> kS30Bits;
    d.v[i] &= kM30;
  }
  add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] += p30.v[i] & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> kS30Bits;
    d.v[i] &= kM30;
  }
}

// 1/x in Montgomery form (0 -> 0): the divsteps invert the row xR into
// x^-1 R^-1 in [0, p), and one Montgomery product by r3 = R^3 mod p makes
// it x^-1 R.  Canonical, so bit-equal to the reference's Fermat chain
// x^(p-2).
__device__ __forceinline__ Fe fe_inv_divsteps(const Fe& x, const uint32_t* r3,
                                              const Mod& M) {
  const uint32_t pinv30 = (0u - M.inv) & (uint32_t)kM30;  // p^-1 mod 2^30
  const S30 p30 = s30_from(M.p);
  S30 f = p30, g = s30_from(x.w), d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = e.v[i] = 0;
  e.v[0] = 1;
  int32_t eta = -1;  // delta = 1
#pragma unroll 1
  for (int b = 0; b < kDivstepBatches; ++b) {
    int32_t t[4];
    eta = divsteps_30(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30(d, e, t, p30, pinv30);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f.v[8], p30);  // f = +-1 (p where x = 0, and then d = 0)
  return fe_mont_mul(fe_from_s30(d), fe_from(r3), M);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1): two base elements (c0 + c1 u), both Montgomery
// form.  In memory a 64-byte row: c0's eight words, then c1's (the bytes of
// the reference's (n, 2, 16) limbs and of ArrayPointVec(g2=True) rows).
// The overloads below mirror the reference's `_F2`
// (crescent_tpu/ops/pallas_ec.py:337-401), so a point formula written as a
// template over the field type compiles for Fq and Fq2 alike, as `_F2`
// duck-types `_F` there.  Canonical in, canonical out.
// ---------------------------------------------------------------------------

struct Fe2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe2 fe2_make(const Fe& c0, const Fe& c1) {
  Fe2 r;
  r.c0 = c0;
  r.c1 = c1;
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe2& a) {
  return fe_is_zero(a.c0) && fe_is_zero(a.c1);
}

__device__ __forceinline__ Fe2 fe_select(bool c, const Fe2& a, const Fe2& b) {
  return fe2_make(fe_select(c, a.c0, b.c0), fe_select(c, a.c1, b.c1));
}

__device__ __forceinline__ Fe2 fe_add(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_add(a.c0, b.c0, M), fe_add(a.c1, b.c1, M));
}

__device__ __forceinline__ Fe2 fe_sub(const Fe2& a, const Fe2& b, const Mod& M) {
  return fe2_make(fe_sub(a.c0, b.c0, M), fe_sub(a.c1, b.c1, M));
}

__device__ __forceinline__ Fe2 fe_dbl(const Fe2& a, const Mod& M) {
  return fe_add(a, a, M);
}

__device__ __forceinline__ Fe2 fe_neg(const Fe2& a, const Mod& M) {
  return fe2_make(fe_neg(a.c0, M), fe_neg(a.c1, M));
}

// Karatsuba with the nonresidue -1: three base products.
// c0 = x0 y0 - x1 y1, c1 = (x0 + x1)(y0 + y1) - x0 y0 - x1 y1.
__device__ __forceinline__ Fe2 fe_mont_mul(const Fe2& x, const Fe2& y,
                                           const Mod& M) {
  const Fe t0 = fe_mont_mul(x.c0, y.c0, M);
  const Fe t1 = fe_mont_mul(x.c1, y.c1, M);
  const Fe t2 = fe_mont_mul(fe_add(x.c0, x.c1, M), fe_add(y.c0, y.c1, M), M);
  return fe2_make(fe_sub(t0, t1, M), fe_sub(fe_sub(t2, t0, M), t1, M));
}

// (x0 + x1 u)^2 = (x0 + x1)(x0 - x1) + 2 x0 x1 u: two base products.
__device__ __forceinline__ Fe2 fe_sqr(const Fe2& x, const Mod& M) {
  const Fe c0 = fe_mont_mul(fe_add(x.c0, x.c1, M), fe_sub(x.c0, x.c1, M), M);
  const Fe t = fe_mont_mul(x.c0, x.c1, M);
  return fe2_make(c0, fe_add(t, t, M));
}

// 1/(x0 + x1 u) = (x0 - x1 u) / (x0^2 + x1^2): the norm, its divstep
// inversion (r3 = R^3 mod p, as for fe_inv_divsteps) and two products
// (QuadPallasEC._inv_core, whose norm takes a Fermat chain).  0 -> 0: the
// norm is 0 only at x = 0, since p = 3 (mod 4) makes -1 a non-residue.
__device__ __forceinline__ Fe2 fe_inv(const Fe2& x, const uint32_t* r3,
                                      const Mod& M) {
  const Fe nrm = fe_add(fe_sqr(x.c0, M), fe_sqr(x.c1, M), M);
  const Fe ninv = fe_inv_divsteps(nrm, r3, M);
  return fe2_make(fe_mont_mul(x.c0, ninv, M),
                  fe_mont_mul(fe_neg(x.c1, M), ninv, M));
}

// Row access by field type: an element is kVec<F> 16-byte vectors, and
// packed row i starts at vector kVec<F> * i.
template <class F>
struct FieldRow;

template <>
struct FieldRow<Fe> {
  static constexpr int kVec = 2;
  static __device__ __forceinline__ Fe load(const uint4* p) { return fe_load(p); }
  static __device__ __forceinline__ void store(uint4* p, const Fe& a) {
    fe_store(p, a);
  }
  static __device__ __forceinline__ Fe from_base(const uint32_t* w) {
    return fe_from(w);
  }
  static __device__ __forceinline__ Fe zero() { return fe_zero(); }
};

template <>
struct FieldRow<Fe2> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ Fe2 load(const uint4* p) {
    return fe2_make(fe_load(p), fe_load(p + 2));
  }
  static __device__ __forceinline__ void store(uint4* p, const Fe2& a) {
    fe_store(p, a.c0);
    fe_store(p + 2, a.c1);
  }
  // a base-field constant w as w + 0u
  static __device__ __forceinline__ Fe2 from_base(const uint32_t* w) {
    return fe2_make(fe_from(w), fe_zero());
  }
  static __device__ __forceinline__ Fe2 zero() {
    return fe2_make(fe_zero(), fe_zero());
  }
};

}  // namespace crescent
