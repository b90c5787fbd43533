// The fixed base's mixed additions over Fq and Fq2: `madd` (one addition a
// lane) and `fixed_base` (a lane's 32 byte windows in one launch).
//
// Setup's fixed base computes k * G for millions of scalars k from one
// table of 32 x 256 affine multiples d * 2^(8w) * G (w-major rows [x | y]).
// The reference runs it as a scan over chunks of 2^16 scalars and over the
// 32 windows, each step a gather of table rows and one `_madd_kernel`
// (crescent_tpu/ops/fixed_base.py:138-144, pallas_ec.py:495, body :261).
// Here `fixed_base_kernel` runs a whole batch in one launch: each
// lane reads its scalar's words, and for w = 0..31 takes byte w as the
// digit; where it is nonzero the lane reads table row w * 256 + digit
// itself (the table, 512 KB over Fq and 1 MB over Fq2, stays in the 50 MB
// L2) and adds it to an accumulator kept in registers across the windows,
// which starts as the identity (Z = 0) and is written once.  The windows
// run in the reference's order with its additions, so the result equals
// the chain of 32 `madd` launches bit for bit.  Digit 0 adds nothing
// (the reference's valid = 0; its table row is a dummy multiple).
//
// Each addition is warp.cuh's `madd_rounds`: madd-2007-bl's products in
// five rounds of independent ones (11 over Fq, 30 base products over Fq2,
// the sum written over P as the rounds free its coordinates), one thread
// a lane running a round's products in turn (the compiler interleaves a
// round's independent products); Q itself where the accumulator is the
// identity, and the doubling where P == Q (over Fq a function of its own,
// whose registers stay out of the addition's; inlined over Fq2, where the
// card measured that faster: warp.cuh's kMaddDoubleCall).
// The single `madd` launch (`CurveCtx.add_mixed`, the reference's
// PallasEC.madd at :657) runs the same lane body with its sign and its
// strided Q.  What bounds them: the products (a window 11 products of 136
// multiply-adds against 64 bytes of L2 reads over Fq; 30 base products, 29
// at least, against 128 bytes over Fq2); with millions of lanes the card
// runs full waves, so the executor with the fewest instructions a lane
// wins where its registers let enough warps in (PERF.md,
// scripts/chain_designs.py).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "point.cuh"
#include "warp.cuh"

namespace crescent {

constexpr int kFixedBaseWindows = 32;  // byte windows of a 256-bit scalar
constexpr int kFixedBaseRows = 256;    // table rows a window

// Product threads a lane of `madd` and `fixed_base` over F: one, the
// rounds' products in turn, over Fq and Fq2 alike.  Measured on the card
// against four (Fq) and four or eight (Fq2) product threads and the
// doubling inlined (PERF.md, scripts/chain_designs.py): more threads a lane
// repeat the sums and pass every product on, and the window kernel's lanes
// fill the card without them.
template <class F>
constexpr int kMaddThreads = 1;

// The input rows of one `madd` launch: P's packed planes, Q's rows qxs and
// qys 16-byte vectors apart, the (n,) int32 flags.
struct MaddRows {
  const uint4 *x1, *y1, *z1, *qx, *qy;
  long long qxs, qys;
  const int *valid, *sign;
};

// (ox, oy, oz) = valid ? P + (sign ? -Q : Q) : P, one lane on T product
// threads, blocks of 128 threads.  Outputs may alias P.
template <class F, bool kAZero, int T>
__global__ void __launch_bounds__(128)
    madd_kernel(Curve C, MaddRows in, uint4* ox, uint4* oy, uint4* oz, long long n) {
  const long long i = ((long long)blockIdx.x * 128 + threadIdx.x) / T;
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;  // whole lanes
  ProductThreads<T> ex{C.M, (int)(threadIdx.x % T), live};
  PtT<F> P = pt_load<F>(in.x1, in.y1, in.z1, i);
  F qy = FieldRow<F>::load(in.qy + in.qys * i);
  if (in.sign[i] != 0) qy = fe_neg(qy, C.M);
  madd_rounds<kAZero>(C, ex, in.valid[i] != 0, FieldRow<F>::load(in.qx + in.qxs * i), qy, P);
  lane_sync<T>(live);
  store_coords<F, T>(ox, oy, oz, i, P, threadIdx.x % T);
}

// k_i * G in Jacobian form for n lanes, one lane on T product threads:
// `table` the (8192, 2 W) plane of Montgomery rows [x | y], `sc` the (n, 8)
// standard-form scalar words.  A window reads its scalar word again (from
// L1) rather than hold it; the accumulator lives in registers.
template <class F, bool kAZero, int T>
__global__ void __launch_bounds__(128)
    fixed_base_kernel(Curve C, const uint4* __restrict__ table, const uint32_t* __restrict__ sc,
                      uint4* ox, uint4* oy, uint4* oz, long long n) {
  constexpr int V = FieldRow<F>::kVec;
  const long long i = ((long long)blockIdx.x * 128 + threadIdx.x) / T;
  const unsigned live = __ballot_sync(kFullWarp, i < n);
  if (i >= n) return;  // whole lanes
  ProductThreads<T> ex{C.M, (int)(threadIdx.x % T), live};
  const uint32_t* k = sc + 8 * i;
  PtT<F> acc;  // the identity
  acc.x = acc.y = acc.z = FieldRow<F>::zero();
#pragma unroll 1
  for (int w = 0; w < kFixedBaseWindows; ++w) {
    const uint32_t d = k[w >> 2] >> (8 * (w & 3)) & 0xFFu;
    if (ex.any(d != 0)) {
      const uint4* row = table + 2 * V * (w * kFixedBaseRows + d);
      madd_rounds<kAZero>(C, ex, d != 0, FieldRow<F>::load(row), FieldRow<F>::load(row + V),
                          acc);
    }
  }
  store_coords<F, T>(ox, oy, oz, i, acc, threadIdx.x % T);
}

// Host side, behind the C entry points of ec.cu (Fe) and ec2.cu (Fe2):
// pointers to device memory, the caller's stream; kAZero must be
// C.a_is_zero.  Each returns cudaGetLastError().
template <class F, bool kAZero>
int launch_madd_lanes(const Curve& C, const MaddRows& in, void* ox, void* oy, void* oz,
                      long long n, void* stream) {
  if (n > 0) {
    constexpr int T = kMaddThreads<F>;
    madd_kernel<F, kAZero, T><<<grid_for(n * T, 128), 128, 0, (cudaStream_t)stream>>>(
        C, in, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
  }
  return (int)cudaGetLastError();
}

template <class F, bool kAZero>
int launch_fixed_base(const Curve& C, const void* table, const void* sc, void* ox, void* oy,
                      void* oz, long long n, void* stream) {
  if (n > 0) {
    constexpr int T = kMaddThreads<F>;
    fixed_base_kernel<F, kAZero, T><<<grid_for(n * T, 128), 128, 0, (cudaStream_t)stream>>>(
        C, (const uint4*)table, (const uint32_t*)sc, (uint4*)ox, (uint4*)oy, (uint4*)oz, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace crescent
