// 256-bit prime-field arithmetic for Hopper kernels.
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
// serves BN254 Fr and Fq alike.  Requires p < 2^255, so that the CIOS
// accumulator never needs a tenth word; both BN254 moduli are < 2^254.
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

// t (with carry word `top`) < 2p  ->  t mod p.
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

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Mod& M) {
  return fe_add(a, a, M);
}

// 0 - a (0 stays 0)
__device__ __forceinline__ Fe fe_neg(const Fe& a, const Mod& M) {
  return fe_sub(fe_zero(), a, M);
}

}  // namespace crescent
