// Montgomery multiply and radix-2 NTT butterfly for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of crescent_tpu/ops/pallas_ec.py:
//   * `mul`       -> PallasEC._mul_kernel  (:513, launched by `mul` :680)
//   * `butterfly` -> PallasEC._bfly_kernel (:517, launched by `butterfly` :689)
// Elements are 32-byte rows of eight u32 words (field.cuh), row-major
// (N, 8), where the TPU kept limb-major (16, N) u32 planes.
//
// What bounds them on this card: memory.  `mul` reads 64 B and writes 32 B
// per element for one CIOS product (~130 integer multiply-adds); the
// butterfly reads 96 B (a, b, twiddle) and writes 64 B per pair for one
// product plus an add and a sub.  At 3.35 TB/s the bytes take longer than
// the arithmetic on 132 SMs, so the design keeps every intermediate in
// registers, loads and stores each row as two 128-bit accesses (adjacent
// threads touch adjacent rows, so a warp's accesses coalesce), and updates
// a stage in place so no second plane is written.  A stage's twiddles are
// the `half` distinct values w^(j*n/2half); the kernel reads them by
// j = i mod half instead of a materialised n/2-wide plane (the JAX stage
// loop tiles one per stage, ntt.py:72), so small stages read their
// twiddles from L1/L2.  Fusing several stages through shared memory would
// cut device-memory passes and is left for later work.
//
// Plain C entry points, loaded with ctypes: pointers to device memory,
// the caller's CUDA stream; each returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "field.cuh"

using crescent::Fe;
using crescent::Mod;

namespace {

constexpr int kThreads = 256;

// out[i] = x[i] * y[i] * 2^-256 mod p.  Row i of each plane starts
// xs / ys / os 16-byte units after row i-1: 2 for packed rows, 4 for every
// second row of a packed plane, 0 for one row read by every lane.
// (out may alias x or y: each thread reads its rows before writing them)
__global__ void mul_kernel(Mod M, const uint4* x, const uint4* y, uint4* out,
                           long long n, long long xs, long long ys,
                           long long os) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe a = crescent::fe_load(x + xs * i);
  const Fe b = crescent::fe_load(y + ys * i);
  crescent::fe_store(out + os * i, crescent::fe_mont_mul(a, b, M));
}

// Pair i (blk = i >> log_half, j = i mod 2^log_half) sits at row
// off = blk * 2^(log_half+1) + j of `a` and of `b`:
//   (a[off], b[off]) <- (a + b*tw[j], a - b*tw[j]).
// A radix-2 stage passes a = x, b = x + half rows; separate planes pass
// log_half with 2^log_half >= npairs, so off = j = i.
__global__ void butterfly_kernel(Mod M, uint4* a, uint4* b,
                                 const uint4* __restrict__ tw,
                                 long long npairs, int log_half) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npairs) return;
  const long long j = i & ((1LL << log_half) - 1);
  const long long off = ((i >> log_half) << (log_half + 1)) + j;
  const Fe u = crescent::fe_load(a + 2 * off);
  const Fe v = crescent::fe_load(b + 2 * off);
  const Fe t = crescent::fe_mont_mul(v, crescent::fe_load(tw + 2 * j), M);
  crescent::fe_store(a + 2 * off, crescent::fe_add(u, t, M));
  crescent::fe_store(b + 2 * off, crescent::fe_sub(u, t, M));
}

Mod make_mod(const uint32_t* mod9) {
  Mod M;
  std::memcpy(M.p, mod9, sizeof(M.p));
  M.inv = mod9[8];
  return M;
}

unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// mod9: host array of nine u32, the modulus words then -p^-1 mod 2^32.
// xs, ys, os: row strides of x, y and out in 16-byte units (ys 0: one y row).
extern "C" int crescent_mul(const uint32_t* mod9, const void* x, const void* y,
                            void* out, long long n, long long xs, long long ys,
                            long long os, void* stream) {
  if (n > 0) {
    mul_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        make_mod(mod9), (const uint4*)x, (const uint4*)y, (uint4*)out, n, xs,
        ys, os);
  }
  return (int)cudaGetLastError();
}

extern "C" int crescent_butterfly(const uint32_t* mod9, void* a, void* b,
                                  const void* tw, long long npairs,
                                  int log_half, void* stream) {
  if (npairs > 0) {
    butterfly_kernel<<<grid_for(npairs), kThreads, 0, (cudaStream_t)stream>>>(
        make_mod(mod9), (uint4*)a, (uint4*)b, (const uint4*)tw, npairs,
        log_half);
  }
  return (int)cudaGetLastError();
}
