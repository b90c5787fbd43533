// Fq2 kernels for Hopper (sm_90a): the G2 fixed base's three.
//
// Each replaces one op of the Pallas TPU class QuadPallasEC
// (crescent_tpu/ops/pallas_ec.py:831), which runs PallasEC's kernels at
// ROWS = 32 over the field `_F2` (:337):
//   * `mul`  -> PallasEC.mul at ROWS = 32 (op :680; body _F2.mont_mul :362)
//   * `inv`  -> QuadPallasEC.inv (op :698; core _inv_core :858)
//   * `madd` -> PallasEC.madd at ROWS = 32 (op :657; body _madd_body :261)
// An element is one 64-byte row of an (N, 16) int32 plane: c0's eight
// words, then c1's (field.cuh Fe2).  Results are canonical, so they equal
// the TPU kernels' bit for bit.
//
// One thread per lane, as in ec.cu.  `mul` (3 base products, 192 bytes a
// lane) is bound by bytes; it takes row strides, so the product tree of
// batch_inv multiplies the even rows of a level by the odd ones and writes
// interleaved rows without copies.  `inv` is the norm map: a 256-bit
// Fermat chain over the base field on the norm x0^2 + x1^2, then two
// products; on batch_inv's 512-lane root it is latency, so it launches one
// warp a block.  `madd` is point.cuh's template over Fe2 (33 base
// products a lane, twice ec.cu's registers), bound by operations; BN254 G2
// has a = 0, which the wrapper requires.
//
// Plain C entry points, loaded with ctypes: pointers to device memory, the
// caller's CUDA stream; each returns cudaGetLastError().  Outputs may alias
// inputs: a thread reads its rows before it writes them.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "point.cuh"

using crescent::Curve;
using crescent::Fe2;
using crescent::FieldRow;
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

// out = 1/x, 0 -> 0.
__global__ void fq2_inv_kernel(Curve C, const uint4* x, uint4* out,
                               long long n) {
  const long long i = lane();
  if (i >= n) return;
  Row2::store(out + 4 * i, crescent::fe_inv(Row2::load(x + 4 * i), C.one, C.M));
}

typedef const uint4* In;
typedef uint4* Out;

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

extern "C" int crescent_fq2_inv(const uint32_t* curve26, const void* x,
                                void* out, long long n, void* stream) {
  if (n > 0) {
    fq2_inv_kernel<<<grid_for(n, kChainThreads), kChainThreads, 0,
                     (cudaStream_t)stream>>>(make_curve(curve26), (In)x,
                                             (Out)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_fq2_madd(const uint32_t* curve26, const void* x1,
                                 const void* y1, const void* z1, const void* qx,
                                 const void* qy, long long qxs, long long qys,
                                 const void* valid, const void* sign, void* ox,
                                 void* oy, void* oz, long long n, void* stream) {
  if (n > 0) {
    crescent::madd_kernel<Fe2><<<grid_for(n, kThreads), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        make_curve(curve26), (In)x1, (In)y1, (In)z1, (In)qx, (In)qy, qxs, qys,
        (const int*)valid, (const int*)sign, (Out)ox, (Out)oy, (Out)oz, n);
  }
  return (int)cudaGetLastError();
}
