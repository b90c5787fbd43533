// Fq2 kernels for Hopper (sm_90a): the G2 fixed base's four, the G2 MSM's
// five more and its fused bucket aggregate, and the Fq2 butterfly.
//
// Each replaces one op of the Pallas TPU class QuadPallasEC
// (crescent_tpu/ops/pallas_ec.py:831), which runs PallasEC's kernels at
// ROWS = 32 over the field `_F2` (:337):
//   * `mul`          -> PallasEC.mul at ROWS = 32 (op :680; body _F2.mont_mul :362)
//   * `inv`          -> QuadPallasEC.inv (op :698; core _inv_core :858)
//   * `madd`         -> PallasEC.madd at ROWS = 32 (op :657; body :261)
//   * `fixed_base`   -> the reference's scan of row gathers and
//                       PallasEC.madd at ROWS = 32
//                       (crescent_tpu/ops/fixed_base.py:138-144): one
//                       launch a batch (madd.cuh)
//   * `affine_denom` -> PallasEC.affine_denom at ROWS = 32 (op :757; kernel
//                       :560; body :408)
//   * `affine_add`   -> PallasEC.affine_add at ROWS = 32 (op :771; kernel
//                       :566; body :421)
//   * `jadd`         -> PallasEC.jadd at ROWS = 32 (op :670; kernel :505;
//                       body :300)
//   * `jdbl_n`       -> PallasEC.jdbl_n at ROWS = 32 (op :744; kernel :550;
//                       body :243)
//   * `jdbl`         -> PallasEC.jdbl at ROWS = 32 (op :735; kernel :545)
//   * `bucket_reduce` -> QuadPallasEC.bucket_reduce: PallasEC.bucket_reduce
//                       at ROWS = 32 (op :790; kernel :575; call :805)
//   * `butterfly`    -> PallasEC.butterfly at ROWS = 32 (op :689; kernel
//                       _bfly_kernel :517 over `_F2`)
//   * `batch_inv`    -> the reference's product tree of `mul` with `inv`
//                       on its root level (crescent_tpu/ops/msm_affine.py:75)
//                       at ROWS = 32: one launch, a block a root
//                       (batch_inv.cuh over Fe2)
// An element is one 64-byte row of an (N, 16) int32 plane: c0's eight
// words, then c1's (field.cuh Fe2).  Results are canonical, so they equal
// the TPU kernels' bit for bit.
//
// One thread per lane, as in ec.cu, but for `jdbl_n`, `jadd`, `jdbl`,
// `affine_add` and `batch_inv`.  `mul` (3 base products, 192 bytes a
// lane) is bound by bytes; it takes row strides (every second row of a
// plane, or one row broadcast).  `inv` is the norm map: the norm
// x0^2 + x1^2, its inverse by field.cuh's constant-time divsteps
// (`fe_inv_divsteps`, as Fq `inv` in ec.cu; the reference runs a Fermat
// chain there), then two products; it
// is latency, so it launches one warp a block.  `batch_inv` runs the
// reference's product tree in one launch, one block a root, with the same
// inversion on each root (batch_inv.cuh).  `jdbl_n` (16 down to 1 lanes of 11
// to 176 doublings in the window combine) is latency too: warp.cuh's two
// warps a lane, each doubling's 16 base products in three rounds of
// side-by-side 8-thread products.  `jadd` (43 base products, the bucket
// aggregate's and the combine's 27 launches a chunk, 25,625 lanes down to
// 1) is warp.cuh's `jadd_rounds` over Fe2: five rounds of at most sixteen
// base products on four warps' groups a lane up to 256 lanes, six rounds
// of at most eight on eight threads a lane (one product a thread) above;
// one thread a lane ran them in a row at the 255-register limit and
// spilled.
// `affine_add` (460 bytes a lane; 8 base products at the least, 10 on a
// tangent lane) is affine_add.cuh's two threads a lane, each holding one
// half (c0 or c1) of every element, so that a lane's loads are in flight
// on enough warps to be bound by bytes.  The other point kernels are
// point.cuh's templates over Fe2, with ec.cu's launch shapes:
// `affine_denom` (328 bytes a lane, no product) is bound by bytes.  `jdbl`
// (17 base products a lane; the small-N MSM's 256 doublings of 1,024 lanes
// a G2 MSM) ran them in a row on one thread a lane at 220 registers, on 8
// SMs at that width: bound by the chain's latency.  It is warp.cuh's
// `launch_jdbl_lanes` over Fe2: the `jdbl_n` lane body with one doubling
// (16 base products in three rounds on two warps) up to
// kJdblGroupLanesMax<Fe2> lanes, eight product threads a lane above.
// `madd` and the window kernel `fixed_base` (29 base products an addition
// at least, 30 as madd.cuh runs them) are bound by operations too: one
// thread a lane on warp.cuh's `madd_rounds`, which writes the sum over P
// as the rounds free its coordinates so that an Fq2 lane fits in 255
// registers without spilling; the doubling is inlined (kMaddDoubleCall).
// `bucket_reduce` is bucket.cuh's cluster of blocks a window over Fe2, its
// additions on eight product threads a lane.  `butterfly` (a, b, tw in, two
// rows out: 320 bytes and 3 base products a lane) is bound by bytes; no
// path of the reference calls it.
// BN254 G2 has a = 0, which the wrapper requires and `jdbl_n`, `jadd`,
// `jdbl` and `affine_add` check.
//
// Plain C entry points, loaded with ctypes: pointers to device memory, the
// caller's CUDA stream; each returns cudaGetLastError().  Outputs may alias
// inputs: a thread reads its rows before it writes them.

#include <cuda_runtime.h>

#include <cstdint>

#include "affine_add.cuh"
#include "batch_inv.cuh"
#include "bucket.cuh"
#include "field.cuh"
#include "madd.cuh"
#include "point.cuh"
#include "warp.cuh"

using crescent::Curve;
using crescent::Fe2;
using crescent::FieldRow;
using crescent::In;
using crescent::Out;
using crescent::grid_for;
using crescent::kChainThreads;
using crescent::kThreads;
using crescent::lane;
using crescent::make_curve;

namespace {

typedef FieldRow<Fe2> Row2;

// out[i * os] = x[i * xs] * y[i * ys] (strides in 16-byte vectors; ys = 0
// broadcasts one row of y).
__global__ void fq2_mul_kernel(Curve C, const uint4* x, const uint4* y,
                               uint4* out, long long n, long long xs,
                               long long ys, long long os) {
  const long long i = lane();
  if (i >= n) return;
  Row2::store(out + os * i,
              crescent::fe_mont_mul(Row2::load(x + xs * i), Row2::load(y + ys * i),
                                    C.M));
}

// out = 1/x (field.cuh fe_inv over Fe2); 0 -> 0.  r3 = R^3 mod p.
__global__ void fq2_inv_kernel(Curve C, crescent::Words8 r3, const uint4* x,
                               uint4* out, long long n) {
  const long long i = lane();
  if (i >= n) return;
  Row2::store(out + 4 * i, crescent::fe_inv(Row2::load(x + 4 * i), r3.w, C.M));
}

// (o0, o1) = (a + b*tw, a - b*tw): b*tw the Karatsuba product of
// fq2_mul_kernel (pallas_ec._bfly_kernel over `_F2`).
__global__ void fq2_butterfly_kernel(Curve C, const uint4* a, const uint4* b,
                                     const uint4* tw, uint4* o0, uint4* o1,
                                     long long n) {
  const long long i = lane();
  if (i >= n) return;
  const crescent::Mod& M = C.M;
  const Fe2 t = crescent::fe_mont_mul(Row2::load(b + 4 * i), Row2::load(tw + 4 * i), M);
  const Fe2 x = Row2::load(a + 4 * i);
  Row2::store(o0 + 4 * i, crescent::fe_add(x, t, M));
  Row2::store(o1 + 4 * i, crescent::fe_sub(x, t, M));
}

}  // namespace

extern "C" int crescent_fq2_mul(const uint32_t* curve26, const void* x,
                                const void* y, void* out, long long n,
                                long long xs, long long ys, long long os,
                                void* stream) {
  if (n > 0) {
    fq2_mul_kernel<<<grid_for(n, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(make_curve(curve26), (In)x, (In)y,
                                             (Out)out, n, xs, ys, os);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_fq2_inv(const uint32_t* curve26, const uint32_t* r3,
                                const void* x, void* out, long long n,
                                void* stream) {
  if (n > 0) {
    fq2_inv_kernel<<<grid_for(n, kChainThreads), kChainThreads, 0,
                     (cudaStream_t)stream>>>(make_curve(curve26),
                                             crescent::words8(r3), (In)x,
                                             (Out)out, n);
  }
  return (int)cudaGetLastError();
}

// out = 1/d for n leaves in runs of 2^log_s, a block a run (batch_inv.cuh)
extern "C" int crescent_fq2_batch_inv(const uint32_t* curve26, const uint32_t* r3,
                                      const void* d, void* out, long long n,
                                      int log_s, void* stream) {
  return crescent::launch_batch_inv<Fe2>(curve26, r3, d, out, n, log_s, stream);
}

extern "C" int crescent_fq2_madd(const uint32_t* curve26, const void* x1,
                                 const void* y1, const void* z1, const void* qx,
                                 const void* qy, long long qxs, long long qys,
                                 const void* valid, const void* sign, void* ox,
                                 void* oy, void* oz, long long n, void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  const crescent::MaddRows in{(const uint4*)x1, (const uint4*)y1, (const uint4*)z1,
                              (const uint4*)qx, (const uint4*)qy, qxs, qys,
                              (const int*)valid, (const int*)sign};
  return crescent::launch_madd_lanes<Fe2, true>(C, in, ox, oy, oz, n, stream);
}

// k_i * G for n scalars (n, 8) from the (8192, 32) table, one launch
// (madd.cuh)
extern "C" int crescent_fq2_fixed_base(const uint32_t* curve26, const void* table,
                                       const void* sc, void* ox, void* oy, void* oz,
                                       long long n, void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  return crescent::launch_fixed_base<Fe2, true>(C, table, sc, ox, oy, oz, n, stream);
}

extern "C" int crescent_fq2_affine_denom(const uint32_t* curve26,
                                         const void* lx, const void* ly,
                                         const void* lv, const void* rx,
                                         const void* ry, const void* rv,
                                         void* out, long long n, void* stream) {
  return crescent::launch_affine_denom<Fe2>(curve26, lx, ly, lv, rx, ry, rv,
                                            out, n, stream);
}

extern "C" int crescent_fq2_affine_add(const uint32_t* curve26, const void* lx,
                                       const void* ly, const void* lv,
                                       const void* rx, const void* ry,
                                       const void* rv, const void* inv,
                                       void* ox, void* oy, void* ov,
                                       long long n, void* stream) {
  // two threads a lane, a half element each (affine_add.cuh)
  return crescent::launch_affine_add<Fe2>(curve26, lx, ly, lv, rx, ry, rv, inv, ox, oy, ov, n,
                                          stream);
}

extern "C" int crescent_fq2_jadd(const uint32_t* curve26, const void* x1,
                                 const void* y1, const void* z1, const void* x2,
                                 const void* y2, const void* z2, void* ox,
                                 void* oy, void* oz, long long n,
                                 void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  return crescent::launch_jadd_lanes<Fe2, true>(C, x1, y1, z1, x2, y2, z2, ox, oy, oz, n,
                                                stream);
}

extern "C" int crescent_fq2_jdbl_n(const uint32_t* curve26, const void* x,
                                   const void* y, const void* z, void* ox,
                                   void* oy, void* oz, long long n, int count,
                                   void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  if (n > 0) {  // two warps a lane (warp.cuh)
    crescent::warp_jdbl_n_kernel<Fe2, true><<<(unsigned)n, crescent::kLaneThreads<Fe2>,
                                              0, (cudaStream_t)stream>>>(
        C, (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n, count);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_fq2_jdbl(const uint32_t* curve26, const void* x,
                                 const void* y, const void* z, void* ox,
                                 void* oy, void* oz, long long n, void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  // two warps a lane on few lanes, the design by the lane count (warp.cuh)
  return crescent::launch_jdbl_lanes<Fe2, true>(C, x, y, z, ox, oy, oz, n, stream);
}

extern "C" int crescent_fq2_bucket_reduce(const uint32_t* curve26, const void* x,
                                          const void* y, const void* z, void* ox,
                                          void* oy, void* oz, long long W, long long B,
                                          void* stream) {
  const Curve C = make_curve(curve26);
  if (!C.a_is_zero) return (int)cudaErrorInvalidValue;  // a = 0 only
  return crescent::launch_bucket_reduce<Fe2, true>(C, x, y, z, ox, oy, oz, W, B, stream);
}

extern "C" int crescent_fq2_bucket_reduce_fit(long long W, long long B, int* out4) {
  return crescent::bucket_reduce_fit<Fe2, true>(W, B, out4);
}

extern "C" int crescent_fq2_butterfly(const uint32_t* curve26, const void* a,
                                      const void* b, const void* tw, void* o0,
                                      void* o1, long long n, void* stream) {
  if (n > 0) {
    fq2_butterfly_kernel<<<grid_for(n, kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(make_curve(curve26), (In)a,
                                                   (In)b, (In)tw, (Out)o0,
                                                   (Out)o1, n);
  }
  return (int)cudaGetLastError();
}
