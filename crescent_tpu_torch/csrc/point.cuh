// Jacobian point formulas over a field type F (Fe for Fq, Fe2 for Fq2),
// shared by ec.cu (Fq) and ec2.cu (Fq2).
//
// The reference writes each formula once and runs it over `_F` or `_F2`
// (crescent_tpu/ops/pallas_ec.py: `_double` :243, `_jadd_body` :300,
// `_affine_denom_body` :408);
// here each is a template over F, built on field.cuh's overloads and
// `FieldRow<F>` (row width, loads, stores, base constants), so one body
// compiles into the Fq kernels of ec.cu and the Fq2 kernels of ec2.cu.
// Every result is canonical and equals the reference's value, hence its
// bits.  The kernels below are one thread per lane; their launch shapes are
// the C entry points' (ec.cu, ec2.cu).  The Jacobian addition `_jadd_body`
// runs in rounds on several threads a lane (warp.cuh `jadd_sum` and
// `jadd_rounds`), for `jadd` and for `bucket_reduce` (bucket.cuh), and the
// mixed addition `_madd_body` :261 in rounds too (warp.cuh `madd_sum` and
// `madd_rounds`), for `madd` and `fixed_base` (madd.cuh).  The pair
// additions `_affine_add_body` :421 are affine_add.cuh's, and the one
// doubling `jdbl` runs on warp.cuh's `launch_jdbl_lanes` (`jdbl_kernel`
// below is its one-thread executor).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace crescent {

template <class F>
struct PtT {
  F x, y, z;
};

__device__ __forceinline__ long long lane() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

template <class F>
__device__ __forceinline__ PtT<F> pt_load(const uint4* x, const uint4* y,
                                          const uint4* z, long long i) {
  constexpr int V = FieldRow<F>::kVec;
  PtT<F> P;
  P.x = FieldRow<F>::load(x + V * i);
  P.y = FieldRow<F>::load(y + V * i);
  P.z = FieldRow<F>::load(z + V * i);
  return P;
}

template <class F>
__device__ __forceinline__ void pt_store(uint4* x, uint4* y, uint4* z,
                                         long long i, const PtT<F>& P) {
  constexpr int V = FieldRow<F>::kVec;
  FieldRow<F>::store(x + V * i, P.x);
  FieldRow<F>::store(y + V * i, P.y);
  FieldRow<F>::store(z + V * i, P.z);
}

// dbl-2007-bl, plus a*ZZ^2 in M when a != 0 (pallas_ec._double).  For Fq2
// the curve's a is a base-field constant (a + 0u); BN254 G2 has a = 0.
template <class F>
__device__ __forceinline__ PtT<F> pt_double(const Curve& C, const PtT<F>& P) {
  const Mod& M = C.M;
  const F XX = fe_sqr(P.x, M);
  const F YY = fe_sqr(P.y, M);
  const F YYYY = fe_sqr(YY, M);
  const F ZZ = fe_sqr(P.z, M);
  F S = fe_sqr(fe_add(P.x, YY, M), M);
  S = fe_sub(fe_sub(S, XX, M), YYYY, M);
  S = fe_add(S, S, M);
  F Mm = fe_add(fe_add(XX, XX, M), XX, M);
  if (!C.a_is_zero) {
    Mm = fe_add(Mm, fe_mont_mul(FieldRow<F>::from_base(C.a), fe_sqr(ZZ, M), M), M);
  }
  PtT<F> R;
  R.x = fe_sub(fe_sqr(Mm, M), fe_add(S, S, M), M);
  const F e8 = fe_dbl(fe_dbl(fe_dbl(YYYY, M), M), M);
  R.y = fe_sub(fe_mont_mul(Mm, fe_sub(S, R.x, M), M), e8, M);
  R.z = fe_sub(fe_sub(fe_sqr(fe_add(P.y, P.z, M), M), YY, M), ZZ, M);
  return R;
}

// Denominator of the affine sum L + R (pallas_ec._affine_denom_body): 2*ly
// if L == R; 1 if a side is invalid or L == -R; else rx - lx.
template <class F>
__global__ void affine_denom_kernel(Curve C, const uint4* lx, const uint4* ly,
                                    const int* lv, const uint4* rx,
                                    const uint4* ry, const int* rv, uint4* out,
                                    long long n) {
  const long long i = lane();
  if (i >= n) return;
  typedef FieldRow<F> Row;
  constexpr int V = Row::kVec;
  const Mod& M = C.M;
  const F Lx = Row::load(lx + V * i), Ly = Row::load(ly + V * i);
  const F Rx = Row::load(rx + V * i), Ry = Row::load(ry + V * i);
  const bool both = lv[i] != 0 && rv[i] != 0;
  const F dx = fe_sub(Rx, Lx, M);
  const bool same_x = fe_is_zero(dx);
  const bool same_y = fe_is_zero(fe_sub(Ry, Ly, M));
  F d = fe_select(same_x && same_y, fe_dbl(Ly, M), dx);
  d = fe_select(both && !(same_x && !same_y), d, Row::from_base(C.one));
  Row::store(out + V * i, d);
}

// One doubling a lane on one thread (launch_jdbl_lanes's executor of the
// widest launches, where it takes one: warp.cuh).
template <class F>
__global__ void jdbl_kernel(Curve C, const uint4* x, const uint4* y,
                            const uint4* z, uint4* ox, uint4* oy, uint4* oz,
                            long long n) {
  const long long i = lane();
  if (i >= n) return;
  pt_store<F>(ox, oy, oz, i, pt_double(C, pt_load<F>(x, y, z, i)));
}

// curve26: host array of 26 u32: modulus words, -p^-1 mod 2^32, Montgomery
// 1, Montgomery a, a_is_zero.
inline Curve make_curve(const uint32_t* c) {
  Curve C;
  for (int j = 0; j < 8; ++j) C.M.p[j] = c[j];
  C.M.inv = c[8];
  for (int j = 0; j < 8; ++j) C.one[j] = c[9 + j];
  for (int j = 0; j < 8; ++j) C.a[j] = c[17 + j];
  C.a_is_zero = c[25];
  return C;
}

inline unsigned grid_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

constexpr int kThreads = 128;      // wide kernels
constexpr int kChainThreads = 32;  // latency-bound chains: one warp a block

// A kernel argument of eight words (R^3 mod p for the inversions).
struct Words8 {
  uint32_t w[8];
};

inline Words8 words8(const uint32_t* w) {
  Words8 r;
  for (int j = 0; j < 8; ++j) r.w[j] = w[j];
  return r;
}

// Host-side launches of the point kernels over F, behind the C entry points
// of ec.cu (Fe) and ec2.cu (Fe2): pointers to device memory, the caller's
// stream; each returns cudaGetLastError().  They run kThreads a block.
typedef const uint4* In;
typedef uint4* Out;

template <class F>
int launch_affine_denom(const uint32_t* curve26, const void* lx,
                        const void* ly, const void* lv, const void* rx,
                        const void* ry, const void* rv, void* out, long long n,
                        void* stream) {
  if (n > 0) {
    affine_denom_kernel<F><<<grid_for(n, kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>(
        make_curve(curve26), (In)lx, (In)ly, (const int*)lv, (In)rx, (In)ry,
        (const int*)rv, (Out)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
