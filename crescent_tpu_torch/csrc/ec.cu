// Short-Weierstrass point kernels over Fq for Hopper (sm_90a): the G1 MSM's
// six, its fused bucket aggregate, and the fixed base's mixed addition.
//
// Each replaces one Pallas TPU kernel of crescent_tpu/ops/pallas_ec.py:
//   * `inv`          -> PallasEC._inv_kernel    (:527, core :533; op :698)
//   * `affine_denom` -> PallasEC._adenom_kernel (:560, body :408; op :757)
//   * `affine_add`   -> PallasEC._aadd_kernel   (:566, body :421; op :771)
//   * `jadd`         -> PallasEC._jadd_kernel   (:505, body :300; op :670)
//   * `jdbl_n`       -> PallasEC._dbln_kernel   (:550, body :243; op :744)
//   * `jdbl`         -> PallasEC._dbl_kernel    (:545, body :243; op :735)
//   * `madd`         -> PallasEC._madd_kernel   (:495, body :261; op :657)
//   * `bucket_reduce` -> PallasEC._bucket_reduce_kernel (:575; op :790, call
//                       :805)
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
// operations, with `jadd`'s branch for the doubling.  `bucket_reduce`
// (one window of the dense bucket table a block, 12,298 dependent-level
// jadds a window at c = 11) is bound by operations in principle; with one
// block per window it runs on W of the card's SMs, 44 jadds in a row a
// thread (point.cuh).
//
// Every kernel but `inv` is a template of point.cuh instantiated here over
// Fe; ec2.cu instantiates the same bodies over Fe2.
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
using crescent::In;
using crescent::Out;
using crescent::fe_load;
using crescent::fe_store;
using crescent::grid_for;
using crescent::kChainThreads;
using crescent::lane;
using crescent::make_curve;

namespace {

// out = x^(p-2) (field.cuh fe_inv); 0 -> 0.
__global__ void inv_kernel(Curve C, const uint4* x, uint4* out, long long n) {
  const long long i = lane();
  if (i >= n) return;
  fe_store(out + 2 * i, crescent::fe_inv(fe_load(x + 2 * i), C.one, C.M));
}

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
  return crescent::launch_affine_denom<Fe>(curve26, lx, ly, lv, rx, ry, rv, out,
                                           n, stream);
}

extern "C" int crescent_affine_add(const uint32_t* curve26, const void* lx,
                                   const void* ly, const void* lv,
                                   const void* rx, const void* ry,
                                   const void* rv, const void* inv, void* ox,
                                   void* oy, void* ov, long long n,
                                   void* stream) {
  return crescent::launch_affine_add<Fe>(curve26, lx, ly, lv, rx, ry, rv, inv,
                                         ox, oy, ov, n, stream);
}

extern "C" int crescent_jadd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  return crescent::launch_jadd<Fe>(curve26, x1, y1, z1, x2, y2, z2, ox, oy, oz,
                                   n, stream);
}

extern "C" int crescent_jdbl_n(const uint32_t* curve26, const void* x,
                               const void* y, const void* z, void* ox, void* oy,
                               void* oz, long long n, int count, void* stream) {
  return crescent::launch_jdbl_n<Fe>(curve26, x, y, z, ox, oy, oz, n, count,
                                     stream);
}

extern "C" int crescent_jdbl(const uint32_t* curve26, const void* x,
                             const void* y, const void* z, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  return crescent::launch_jdbl<Fe>(curve26, x, y, z, ox, oy, oz, n, stream);
}

extern "C" int crescent_madd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* qx,
                             const void* qy, long long qxs, long long qys,
                             const void* valid, const void* sign, void* ox,
                             void* oy, void* oz, long long n, void* stream) {
  return crescent::launch_madd<Fe>(curve26, x1, y1, z1, qx, qy, qxs, qys, valid,
                                   sign, ox, oy, oz, n, stream);
}

// Fq: the jadd body takes 166 registers, so a block of 384 threads fits
// one SM's 65,536 (three passes over B = 1025 columns a level).
extern "C" int crescent_bucket_reduce(const uint32_t* curve26, const void* x,
                                      const void* y, const void* z,
                                      void* scratch, void* ox, void* oy,
                                      void* oz, long long W, long long B,
                                      void* stream) {
  return crescent::launch_bucket_reduce<Fe, 384>(curve26, x, y, z, scratch, ox,
                                                 oy, oz, W, B, stream);
}
