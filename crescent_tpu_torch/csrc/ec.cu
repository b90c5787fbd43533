// Short-Weierstrass point kernels over Fq for Hopper (sm_90a): the G1 MSM's
// six, and the fixed base's mixed addition.
//
// Each replaces one Pallas TPU kernel of crescent_tpu/ops/pallas_ec.py:
//   * `inv`          -> PallasEC._inv_kernel    (:527, core :533; op :698)
//   * `affine_denom` -> PallasEC._adenom_kernel (:560, body :408; op :757)
//   * `affine_add`   -> PallasEC._aadd_kernel   (:566, body :421; op :771)
//   * `jadd`         -> PallasEC._jadd_kernel   (:505, body :300; op :670)
//   * `jdbl_n`       -> PallasEC._dbln_kernel   (:550, body :243; op :744)
//   * `jdbl`         -> PallasEC._dbl_kernel    (:545, body :243; op :735)
//   * `madd`         -> PallasEC._madd_kernel   (:495, body :261; op :657)
// Coordinates are packed (N, 8) planes of 32-byte rows (field.cuh), one
// plane per coordinate, where the TPU kept limb-major (16, N) u32 planes;
// validity flags are (N,) int32.  Every result is canonical, so it is
// bit-equal to the TPU kernel's on the same inputs.
//
// One thread per lane: it loads its rows with 128-bit accesses (adjacent
// threads on adjacent rows), keeps every intermediate of the formula in
// registers and stores the result rows.  No lane padding (a bounds check),
// the curve constants arrive by value in the constant bank, `inv` reads
// its exponent p - 2 from there, and `jdbl_n`'s count is a kernel argument.
//
// What bounds them on this card.  `affine_denom` (4 rows in, 1 out, a few
// subtractions) is bound by bytes.  `affine_add` (5 rows in, 2 out, three
// products) and `jadd` (6 in, 3 out, sixteen products) sit near the point
// where integer multiply-adds overtake bytes; `jadd` is the register-heavy
// one, so its rare doubling case is a branch taken only by lanes with
// P == Q instead of a second formula evaluated by every lane (the value is
// the same).  `inv` and `jdbl_n` run a long dependent chain on few lanes
// (512 lanes x ~380 products; at most 16 lanes x 176 doublings): they are
// bound by latency, so they launch small blocks that spread the lanes over
// many SMs, and `inv` skips the product for a zero exponent bit (uniform
// over the grid).  `madd` (5 rows in, 3 out, eleven products) is bound by
// operations; it is the template of point.cuh, which ec2.cu builds over
// Fq2, with `jadd`'s branch for the doubling.
//
// Plain C entry points, loaded with ctypes: pointers to device memory, the
// caller's CUDA stream; each returns cudaGetLastError().  Outputs may alias
// inputs: a thread reads its rows before it writes them.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "point.cuh"

using crescent::Curve;
using crescent::Fe;
using crescent::Mod;
using crescent::fe_add;
using crescent::fe_dbl;
using crescent::fe_is_zero;
using crescent::fe_load;
using crescent::fe_mont_mul;
using crescent::fe_select;
using crescent::fe_sqr;
using crescent::fe_store;
using crescent::fe_sub;

namespace {

using crescent::PtT;
using crescent::grid_for;
using crescent::kChainThreads;
using crescent::kThreads;
using crescent::lane;
using crescent::make_curve;
using crescent::pt_double;
using crescent::pt_load;
using crescent::pt_store;
using Pt = PtT<Fe>;

// out = x^(p-2) (field.cuh fe_inv); 0 -> 0.
__global__ void inv_kernel(Curve C, const uint4* x, uint4* out, long long n) {
  const long long i = lane();
  if (i >= n) return;
  fe_store(out + 2 * i, crescent::fe_inv(fe_load(x + 2 * i), C.one, C.M));
}

// Denominator of the affine sum L + R: 2*ly if L == R; 1 if a side is
// invalid or L == -R; else rx - lx.
__global__ void affine_denom_kernel(Curve C, const uint4* lx, const uint4* ly,
                                    const int* lv, const uint4* rx,
                                    const uint4* ry, const int* rv, uint4* out,
                                    long long n) {
  const long long i = lane();
  if (i >= n) return;
  const Mod& M = C.M;
  const Fe Lx = fe_load(lx + 2 * i), Ly = fe_load(ly + 2 * i);
  const Fe Rx = fe_load(rx + 2 * i), Ry = fe_load(ry + 2 * i);
  const bool both = lv[i] != 0 && rv[i] != 0;
  const Fe dx = fe_sub(Rx, Lx, M);
  const bool same_x = fe_is_zero(dx);
  const bool same_y = fe_is_zero(fe_sub(Ry, Ly, M));
  Fe d = fe_select(same_x && same_y, fe_dbl(Ly, M), dx);
  d = fe_select(both && !(same_x && !same_y), d, crescent::fe_from(C.one));
  fe_store(out + 2 * i, d);
}

// Affine L + R given inv = 1/denominator: chord, tangent (3x^2 + a),
// infinity for L == -R, passthrough of the one valid side.
__global__ void affine_add_kernel(Curve C, const uint4* lx, const uint4* ly,
                                  const int* lv, const uint4* rx,
                                  const uint4* ry, const int* rv,
                                  const uint4* inv, uint4* ox, uint4* oy,
                                  int* ov, long long n) {
  const long long i = lane();
  if (i >= n) return;
  const Mod& M = C.M;
  const Fe Lx = fe_load(lx + 2 * i), Ly = fe_load(ly + 2 * i);
  const Fe Rx = fe_load(rx + 2 * i), Ry = fe_load(ry + 2 * i);
  const bool l = lv[i] != 0, r = rv[i] != 0;
  const bool both = l && r;
  const bool same_x = fe_is_zero(fe_sub(Rx, Lx, M));
  const bool same_y = fe_is_zero(fe_sub(Ry, Ly, M));
  const bool dbl_case = same_x && same_y;
  const bool inf_case = same_x && !same_y;

  const Fe xx = fe_sqr(Lx, M);
  Fe num_dbl = fe_add(fe_add(xx, xx, M), xx, M);
  if (!C.a_is_zero) num_dbl = fe_add(num_dbl, crescent::fe_from(C.a), M);
  const Fe num = fe_select(dbl_case, num_dbl, fe_sub(Ry, Ly, M));
  const Fe lam = fe_mont_mul(num, fe_load(inv + 2 * i), M);
  const Fe x3 = fe_sub(fe_sub(fe_sqr(lam, M), Lx, M), Rx, M);
  const Fe y3 = fe_sub(fe_mont_mul(lam, fe_sub(Lx, x3, M), M), Ly, M);

  fe_store(ox + 2 * i, fe_select(both, x3, fe_select(l, Lx, Rx)));
  fe_store(oy + 2 * i, fe_select(both, y3, fe_select(l, Ly, Ry)));
  ov[i] = ((l || r) && !(both && inf_case)) ? 1 : 0;
}

// Complete Jacobian addition (add-2007-bl; pallas_ec._jadd_body).
__global__ void jadd_kernel(Curve C, const uint4* x1, const uint4* y1,
                            const uint4* z1, const uint4* x2, const uint4* y2,
                            const uint4* z2, uint4* ox, uint4* oy, uint4* oz,
                            long long n) {
  const long long i = lane();
  if (i >= n) return;
  const Mod& M = C.M;
  const Pt P = pt_load<Fe>(x1, y1, z1, i);
  const Pt Q = pt_load<Fe>(x2, y2, z2, i);
  const Fe Z1Z1 = fe_sqr(P.z, M);
  const Fe Z2Z2 = fe_sqr(Q.z, M);
  const Fe U1 = fe_mont_mul(P.x, Z2Z2, M);
  const Fe U2 = fe_mont_mul(Q.x, Z1Z1, M);
  const Fe S1 = fe_mont_mul(fe_mont_mul(P.y, Q.z, M), Z2Z2, M);
  const Fe S2 = fe_mont_mul(fe_mont_mul(Q.y, P.z, M), Z1Z1, M);
  const Fe H = fe_sub(U2, U1, M);
  const Fe r = fe_sub(S2, S1, M);

  const bool h_zero = fe_is_zero(H);
  const bool r_zero = fe_is_zero(r);
  const bool p_inf = fe_is_zero(P.z);
  const bool q_inf = fe_is_zero(Q.z);
  const bool finite = !p_inf && !q_inf;

  Pt R;
  if (finite && h_zero && r_zero) {
    // P == Q: the doubling.  The TPU kernel evaluates it in every lane and
    // selects; here only the lanes that need it pay for it.
    R = pt_double(C, P);
  } else {
    const Fe I = fe_sqr(fe_add(H, H, M), M);
    const Fe J = fe_mont_mul(H, I, M);
    const Fe rr = fe_add(r, r, M);
    const Fe V = fe_mont_mul(U1, I, M);
    R.x = fe_sub(fe_sub(fe_sqr(rr, M), J, M), fe_add(V, V, M), M);
    const Fe SJ = fe_mont_mul(S1, J, M);
    R.y = fe_sub(fe_mont_mul(rr, fe_sub(V, R.x, M), M), fe_add(SJ, SJ, M), M);
    R.z = fe_mont_mul(
        fe_sub(fe_sub(fe_sqr(fe_add(P.z, Q.z, M), M), Z1Z1, M), Z2Z2, M), H, M);
  }
  R.x = fe_select(p_inf, Q.x, fe_select(q_inf, P.x, R.x));
  R.y = fe_select(p_inf, Q.y, fe_select(q_inf, P.y, R.y));
  R.z = fe_select(p_inf, Q.z, fe_select(q_inf, P.z, R.z));
  // P == -Q: the identity (Z == 0; x and y stay what the formula gave)
  R.z = fe_select(finite && h_zero && !r_zero, crescent::fe_zero(), R.z);
  pt_store<Fe>(ox, oy, oz, i, R);
}

// `count` chained doublings.
__global__ void jdbl_n_kernel(Curve C, const uint4* x, const uint4* y,
                              const uint4* z, uint4* ox, uint4* oy, uint4* oz,
                              long long n, int count) {
  const long long i = lane();
  if (i >= n) return;
  Pt P = pt_load<Fe>(x, y, z, i);
#pragma unroll 1
  for (int k = 0; k < count; ++k) P = pt_double(C, P);
  pt_store<Fe>(ox, oy, oz, i, P);
}

// One doubling.
__global__ void jdbl_kernel(Curve C, const uint4* x, const uint4* y,
                            const uint4* z, uint4* ox, uint4* oy, uint4* oz,
                            long long n) {
  const long long i = lane();
  if (i >= n) return;
  pt_store<Fe>(ox, oy, oz, i, pt_double(C, pt_load<Fe>(x, y, z, i)));
}

typedef const uint4* In;
typedef uint4* Out;

}  // namespace

extern "C" int crescent_inv(const uint32_t* curve26, const void* x, void* out,
                            long long n, void* stream) {
  if (n > 0) {
    inv_kernel<<<grid_for(n, kChainThreads), kChainThreads, 0,
                 (cudaStream_t)stream>>>(make_curve(curve26), (In)x, (Out)out,
                                         n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_affine_denom(const uint32_t* curve26, const void* lx,
                                     const void* ly, const void* lv,
                                     const void* rx, const void* ry,
                                     const void* rv, void* out, long long n,
                                     void* stream) {
  if (n > 0) {
    affine_denom_kernel<<<grid_for(n, kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(
        make_curve(curve26), (In)lx, (In)ly, (const int*)lv, (In)rx, (In)ry,
        (const int*)rv, (Out)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_affine_add(const uint32_t* curve26, const void* lx,
                                   const void* ly, const void* lv,
                                   const void* rx, const void* ry,
                                   const void* rv, const void* inv, void* ox,
                                   void* oy, void* ov, long long n,
                                   void* stream) {
  if (n > 0) {
    affine_add_kernel<<<grid_for(n, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
        make_curve(curve26), (In)lx, (In)ly, (const int*)lv, (In)rx, (In)ry,
        (const int*)rv, (In)inv, (Out)ox, (Out)oy, (int*)ov, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_jadd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  if (n > 0) {
    jadd_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        make_curve(curve26), (In)x1, (In)y1, (In)z1, (In)x2, (In)y2, (In)z2,
        (Out)ox, (Out)oy, (Out)oz, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_jdbl_n(const uint32_t* curve26, const void* x,
                               const void* y, const void* z, void* ox, void* oy,
                               void* oz, long long n, int count, void* stream) {
  if (n > 0) {
    jdbl_n_kernel<<<grid_for(n, kChainThreads), kChainThreads, 0,
                    (cudaStream_t)stream>>>(make_curve(curve26), (In)x, (In)y,
                                            (In)z, (Out)ox, (Out)oy, (Out)oz, n,
                                            count);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_jdbl(const uint32_t* curve26, const void* x,
                             const void* y, const void* z, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  if (n > 0) {
    jdbl_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        make_curve(curve26), (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_madd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* qx,
                             const void* qy, long long qxs, long long qys,
                             const void* valid, const void* sign, void* ox,
                             void* oy, void* oz, long long n, void* stream) {
  if (n > 0) {
    crescent::madd_kernel<Fe><<<grid_for(n, kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        make_curve(curve26), (In)x1, (In)y1, (In)z1, (In)qx, (In)qy, qxs, qys,
        (const int*)valid, (const int*)sign, (Out)ox, (Out)oy, (Out)oz, n);
  }
  return (int)cudaGetLastError();
}
