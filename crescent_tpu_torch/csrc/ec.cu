// Short-Weierstrass point kernels over Fq for Hopper (sm_90a): the G1 MSM's
// six, its fused bucket aggregate, and the fixed base's mixed addition and
// window kernel.
//
// Each replaces one Pallas TPU kernel of crescent_tpu/ops/pallas_ec.py:
//   * `inv`          -> PallasEC._inv_kernel    (:527, core :533; op :698)
//   * `affine_denom` -> PallasEC._adenom_kernel (:560, body :408; op :757)
//   * `affine_add`   -> PallasEC._aadd_kernel   (:566, body :421; op :771)
//   * `jadd`         -> PallasEC._jadd_kernel   (:505, body :300; op :670)
//   * `jdbl_n`       -> PallasEC._dbln_kernel   (:550, body :243; op :744)
//   * `jdbl`         -> PallasEC._dbl_kernel    (:545, body :243; op :735)
//   * `madd`         -> PallasEC._madd_kernel   (:495, body :261; op :657)
//   * `fixed_base`   -> the reference's scan of row gathers and
//                       `_madd_kernel` (crescent_tpu/ops/fixed_base.py:
//                       138-144): one launch a batch, a lane's 32 windows
//                       in turn (madd.cuh)
//   * `bucket_reduce` -> PallasEC._bucket_reduce_kernel (:575; op :790, call
//                       :805)
//   * `batch_inv`    -> the reference's product tree of `mul` (:680) with
//                       `inv` (:698) on its root level
//                       (crescent_tpu/ops/msm_affine.py:75): one launch,
//                       one block a root (batch_inv.cuh)
// Coordinates are packed (N, 8) planes of 32-byte rows (field.cuh), one
// plane per coordinate, where the TPU kept limb-major (16, N) u32 planes;
// validity flags are (N,) int32.  Every result is canonical, so it is
// bit-equal to the TPU kernel's on the same inputs.
//
// One thread per lane but for `jdbl_n`, `jadd` and `jdbl` (several threads
// a lane, warp.cuh): it loads its rows with 128-bit accesses (adjacent
// threads on adjacent rows), keeps every intermediate of the formula in
// registers and stores the result rows.  No lane padding (a bounds check),
// the curve constants arrive by value in the constant bank, and `jdbl_n`'s
// count is a kernel argument.
//
// What bounds them on this card.  `affine_denom` (4 rows in, 1 out, a few
// subtractions) is bound by bytes.  `affine_add` (5 rows in, 2 out, three
// dependent products on a chord) was bound by the issue of its integer
// instructions: affine_add.cuh runs it one thread a lane with PTX carry
// chains in its sums and x^2 only on a warp with a valid tangent lane.
// `madd` (5 rows in, 3 out, eleven products) and `fixed_base` (a scalar
// in, three rows out, eleven products a nonzero window, the table rows
// from L2) are bound by operations: madd.cuh runs them one
// thread a lane on warp.cuh's `madd_rounds`, their rare doubling a call
// of its own taken only by lanes with P == Q.  `bucket_reduce` (a window of the dense bucket table, 12,298
// additions in 21 dependent levels at c = 11) is bound by the latency of
// its levels: bucket.cuh runs a window on a cluster of blocks, its level
// tables in their distributed shared memory, each level's additions on
// warp.cuh's executors (four product threads a lane, or a warp's groups
// where a block's share of the level is narrow).
//
// `inv`, `jdbl_n` and `jadd` run long dependent chains of products on few
// lanes, so they are bound by latency, not by the card's throughput:
//   * `inv` (pallas_ec.py:527-543, `_inv_kernel` and `_inv_core`; op :698)
//     inverted batch_inv's 512-lane root; its body now runs on each root
//     inside `batch_inv`, and the kernel has no caller on the prove path.
//     The Fermat chain it replaces was about 381 dependent Montgomery
//     products a thread, each a 64-bit carry chain one thread cannot hide
//     (0.25 ms a launch).  This one is
//     field.cuh's constant-time divstep inversion: 25 batches of 30
//     divsteps on the low words, each followed by two short 2x2 matrix
//     updates of nine signed 30-bit limbs, about 25.7k integer operations
//     a thread against the chain's 51.8k multiply-adds, with no branch on
//     the data (the 32 lanes of a warp never diverge), then one product by
//     R^3 mod p (an argument) back to Montgomery form.  One thread a lane,
//     one warp a block, so the 16 warps of the root spread over 16 SMs.  64
//     registers, no spills (nvcc -Xptxas -v, sm_90a).
//   * `jdbl_n` (pallas_ec.py:550, `_dbln_kernel`; op :744) runs the window
//     combine's chains, 16 down to 1 lanes of 11 to 176 doublings.  One
//     thread a lane ran dbl-2007-bl's eight products in a row.  This one is
//     warp.cuh's warp a lane: each doubling in three rounds of independent
//     products, each product shared by 8 threads, one word a thread, with
//     shuffles and warp votes for the carries, and the sums between the
//     rounds as PTX carry chains; an instance for a == 0 (the BN254 curves)
//     and one for a != 0.  63 and 58 registers, no spills.
//   * `jdbl` (pallas_ec.py:545, `_dbl_kernel`; op :735) runs verify's
//     public-input MSM and the small MSM's scalar_mul, 256 launches of 1 to
//     1,024 lanes each.  One thread a lane ran dbl-2007-bl's eight products
//     in a row there.  It is warp.cuh's `launch_jdbl_lanes`, as over Fq2:
//     the `jdbl_n` lane body with one doubling (a warp a lane) on few
//     lanes, four product threads a lane on more, and point.cuh's one
//     thread a lane where the card is full (the switch-overs measured,
//     PERF.md); a == 0 and a != 0 instances.
//   * `jadd` (pallas_ec.py:505, `_jadd_kernel`, body :300; op :670) runs
//     the bucket aggregate and the window combine, 27 launches a chunk of
//     25,625 lanes (11), 12,800 down to 25 (10) and 16 down to 1 (6).
//     One thread a lane ran add-2007-bl's 16 products in a row at 166
//     registers.  This one is warp.cuh's `jadd_rounds`: the products in
//     five rounds of at most four (the formula's dependent depth), on a
//     warp of 8-thread groups a lane up to 1,024 lanes, on four threads a
//     lane (one product a thread) up to 16,383, and on one thread a lane
//     (the rounds' products in turn) from 16,384 on, where more threads a
//     lane would repeat too much work; P == Q takes warp.cuh's doubling
//     on the same threads, where a lane run with it needs it.
//
// The modulus.  BN254's are below 2^254.  T-256's base field (Spartan's
// MSMs, ECDSA device binding) is above 2^255, where a sum of two elements
// and a Montgomery product's value before its last subtraction can carry
// out of 256 bits.  field.cuh's fe_add, fe_sub and fe_mont_mul keep that
// carry for any p < 2^256 (fe_reduce_once's carry word), so `mul`
// (ntt.cu) holds T-256 as it is; warp.cuh's carry chains and group
// products drop it, so `jadd` and `jdbl` have instances with kWide set
// (crescent_jadd_wide, crescent_jdbl_wide, a != 0), which keep it.  Every
// other entry here computes over p < 2^255 only; ops/cuda_ec.py refuses a
// wider modulus for them.
//
// Every other kernel is a template of point.cuh instantiated here over Fe;
// ec2.cu instantiates the same bodies over Fe2, warp.cuh's `jdbl_n` and
// `jadd` over Fe2 too, and inverts by the divsteps on the norm.
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

// out = 1/x (field.cuh fe_inv_divsteps); 0 -> 0.  r3 = R^3 mod p.
__global__ void divstep_inv_kernel(Curve C, crescent::Words8 r3,
                                   const uint4* x, uint4* out, long long n) {
  const long long i = lane();
  if (i >= n) return;
  fe_store(out + 2 * i, crescent::fe_inv_divsteps(fe_load(x + 2 * i), r3.w, C.M));
}

}  // namespace

extern "C" int crescent_inv(const uint32_t* curve26, const uint32_t* r3,
                            const void* x, void* out, long long n,
                            void* stream) {
  if (n > 0) {
    divstep_inv_kernel<<<grid_for(n, kChainThreads), kChainThreads, 0,
                         (cudaStream_t)stream>>>(make_curve(curve26),
                                                 crescent::words8(r3), (In)x,
                                                 (Out)out, n);
  }
  return (int)cudaGetLastError();
}

// out = 1/d for n leaves in runs of 2^log_s, a block a run (batch_inv.cuh)
extern "C" int crescent_batch_inv(const uint32_t* curve26, const uint32_t* r3,
                                  const void* d, void* out, long long n,
                                  int log_s, void* stream) {
  return crescent::launch_batch_inv<Fe>(curve26, r3, d, out, n, log_s, stream);
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
  // one thread a lane (affine_add.cuh)
  return crescent::launch_affine_add<Fe>(curve26, lx, ly, lv, rx, ry, rv, inv, ox, oy, ov, n,
                                         stream);
}

extern "C" int crescent_jadd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  // several threads a lane, the design by the lane count (warp.cuh)
  const Curve C = make_curve(curve26);
  return C.a_is_zero ? crescent::launch_jadd_lanes<Fe, true>(C, x1, y1, z1, x2, y2, z2, ox,
                                                             oy, oz, n, stream)
                     : crescent::launch_jadd_lanes<Fe, false>(C, x1, y1, z1, x2, y2, z2, ox,
                                                              oy, oz, n, stream);
}

// jadd over a modulus p >= 2^255 with a != 0 (T-256's base field, a =
// p - 3; Spartan's small MSMs under CRESCENT_NATIVE=0): the instances whose
// sums and group products keep the carry out of 256 bits (warp.cuh kWide).
extern "C" int crescent_jadd_wide(const uint32_t* curve26, const void* x1,
                                  const void* y1, const void* z1, const void* x2,
                                  const void* y2, const void* z2, void* ox, void* oy,
                                  void* oz, long long n, void* stream) {
  const Curve C = make_curve(curve26);
  if (C.a_is_zero) return (int)cudaErrorInvalidValue;  // no a == 0 instance
  return crescent::launch_jadd_lanes<Fe, false, true>(C, x1, y1, z1, x2, y2, z2, ox, oy, oz,
                                                      n, stream);
}

extern "C" int crescent_jdbl_n(const uint32_t* curve26, const void* x,
                               const void* y, const void* z, void* ox, void* oy,
                               void* oz, long long n, int count, void* stream) {
  if (n > 0) {  // one warp a lane (warp.cuh)
    const Curve C = make_curve(curve26);
    auto kernel = C.a_is_zero ? crescent::warp_jdbl_n_kernel<Fe, true>
                              : crescent::warp_jdbl_n_kernel<Fe, false>;
    kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(
        C, (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n, count);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_jdbl(const uint32_t* curve26, const void* x,
                             const void* y, const void* z, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  // several threads a lane on few lanes, the design by the lane count
  // (warp.cuh), a == 0 and a != 0
  const Curve C = make_curve(curve26);
  return C.a_is_zero
             ? crescent::launch_jdbl_lanes<Fe, true>(C, x, y, z, ox, oy, oz, n, stream)
             : crescent::launch_jdbl_lanes<Fe, false>(C, x, y, z, ox, oy, oz, n, stream);
}

// jdbl over a modulus p >= 2^255 with a != 0, as crescent_jadd_wide.
extern "C" int crescent_jdbl_wide(const uint32_t* curve26, const void* x,
                                  const void* y, const void* z, void* ox, void* oy,
                                  void* oz, long long n, void* stream) {
  const Curve C = make_curve(curve26);
  if (C.a_is_zero) return (int)cudaErrorInvalidValue;  // no a == 0 instance
  return crescent::launch_jdbl_lanes<Fe, false, true>(C, x, y, z, ox, oy, oz, n, stream);
}

extern "C" int crescent_madd(const uint32_t* curve26, const void* x1,
                             const void* y1, const void* z1, const void* qx,
                             const void* qy, long long qxs, long long qys,
                             const void* valid, const void* sign, void* ox,
                             void* oy, void* oz, long long n, void* stream) {
  // the lane body of the fixed base's windows (madd.cuh), a == 0 and a != 0
  const Curve C = make_curve(curve26);
  const crescent::MaddRows in{(const uint4*)x1, (const uint4*)y1, (const uint4*)z1,
                              (const uint4*)qx, (const uint4*)qy, qxs, qys,
                              (const int*)valid, (const int*)sign};
  return C.a_is_zero ? crescent::launch_madd_lanes<Fe, true>(C, in, ox, oy, oz, n, stream)
                     : crescent::launch_madd_lanes<Fe, false>(C, in, ox, oy, oz, n, stream);
}

// k_i * G for n scalars (n, 8) from the (8192, 16) table, one launch
// (madd.cuh), a == 0 and a != 0
extern "C" int crescent_fixed_base(const uint32_t* curve26, const void* table,
                                   const void* sc, void* ox, void* oy, void* oz,
                                   long long n, void* stream) {
  const Curve C = make_curve(curve26);
  return C.a_is_zero
             ? crescent::launch_fixed_base<Fe, true>(C, table, sc, ox, oy, oz, n, stream)
             : crescent::launch_fixed_base<Fe, false>(C, table, sc, ox, oy, oz, n, stream);
}

// W windows of B buckets, a cluster of blocks a window (bucket.cuh), a == 0
// and a != 0.
extern "C" int crescent_bucket_reduce(const uint32_t* curve26, const void* x,
                                      const void* y, const void* z, void* ox,
                                      void* oy, void* oz, long long W, long long B,
                                      void* stream) {
  const Curve C = make_curve(curve26);
  return C.a_is_zero
             ? crescent::launch_bucket_reduce<Fe, true>(C, x, y, z, ox, oy, oz, W, B, stream)
             : crescent::launch_bucket_reduce<Fe, false>(C, x, y, z, ox, oy, oz, W, B, stream);
}

// bucket_reduce's launch at W x B: cluster size, threads a block, dynamic
// shared bytes a block, clusters the card holds at once (out4)
extern "C" int crescent_bucket_reduce_fit(long long W, long long B, int* out4) {
  return crescent::bucket_reduce_fit<Fe, true>(W, B, out4);
}
