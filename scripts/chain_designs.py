#!/usr/bin/env python3
"""Times design alternatives of the chain kernels `jdbl_n`, `jadd`, `jdbl`
(csrc/warp.cuh), `batch_inv` (csrc/batch_inv.cuh) and `bucket_reduce`
(csrc/bucket.cuh), of `madd` and `fixed_base` (csrc/madd.cuh) and of the
Fq2 `affine_add` (csrc/affine_add.cuh) over Fq and Fq2 against this
checkout's, in turns, on one card.

    python3 scripts/chain_designs.py [--rounds N] [--designs NAME ...]
        [--kernels NAME ...] [--also ROOT ...]

Each design is a copy of this checkout's `crescent_tpu_torch/` under
`build/designs/<name>/` (gitignored) with one change to `csrc/warp.cuh`,
`csrc/batch_inv.cuh`, `csrc/bucket.cuh`, `csrc/madd.cuh` or
`csrc/affine_add.cuh`, or a change to several of the sources:

* `field_sums`: the sums and differences between the rounds of both
  doublings (and of the additions) by field.cuh's `fe_add` / `fe_sub`
  (64-bit accumulators, the other kernels' sums) in place of warp.cuh's
  PTX carry chains `fe_add_cc` / `fe_sub_cc`;
* `thread_product`: each product of an Fq round on groups computed whole
  by every thread of its group (`fe_mont_mul`, one thread a product, the
  rounds kept) in place of the group's 8-thread product, one word a
  thread;
* `one_warp`: the Fq2 doubling on one warp a lane (four 8-thread groups)
  in four rounds of four products (XX and YY; YYYY and (X + YY)^2; M^2,
  y0 z0 and y1 z1; M (S - X3) and (y0 + y1)(z0 + z1)), passed on by
  shuffles, in place of two warps' three rounds through shared memory;
* `jadd_groups`: `jadd` on 8-thread groups at every lane count (over Fq
  and Fq2), the kept kernel's executor of the narrow launches;
* `jadd_threads`: `jadd` on product threads (4 a lane over Fq, 8 over
  Fq2) at every lane count, the kept kernel's executor of the middle
  launches (and of the wide ones over Fq2);
* `jadd_one_thread`: `jadd` on one thread a lane, the rounds' products in
  turn (no shuffles), at every lane count: the kept kernel's executor of
  the widest launches over Fq; over Fq2 it spills;
* `jadd_threads_half`: `jadd` on half as many product threads a lane
  (two over Fq, four over Fq2), each thread up to two products of a
  round, at every lane count;
* `two_warps`: the Fq2 `jadd` on groups of two warps a lane (8 groups),
  its 43 base products in six rounds of at most eight (the product
  threads' plan) in place of four warps' five rounds of at most sixteen;
* `batch_inv_blocks_of_s`: `batch_inv` on blocks of min(128, S) threads
  (the threads that hold leaves of a run of S) in place of 128 threads a
  block whatever S is;
* `bucket_k2`, `bucket_k5`, `bucket_k8`: `bucket_reduce` on clusters of 2,
  5 or 8 blocks a window in place of 4 (50, 125 or 200 blocks at 25
  windows; 8 do not fit the card in one wave);
* `bucket_fq_320`: Fq blocks of 320 threads (10 warps, the same 168
  registers a thread): a block's 257 suffix pairs in four passes of 80
  lanes of four product threads, not three of 96;
* `bucket_inline`: each lane's addition inlined into the pass loop in
  place of a call of a function of its own (`__noinline__`);
* `madd_threads`: `madd` and `fixed_base` (csrc/madd.cuh) on four
  product threads a lane over Fq and eight over Fq2, in place of one;
* `madd_fq2_four`, `madd_fq2_eight`: over Fq2 on four or eight product
  threads a lane, in place of one;
* `madd_inline`: the doubling of `madd_rounds` (P == Q) over Fq inlined
  in place of a call of a function of its own (`__noinline__`);
* `madd_fq2_call`: the doubling over Fq2 such a call in place of inlined;
* `aadd_ring`: the Fq2 `affine_add` on persistent blocks, one tile of 64
  lanes at a time, the next tile's rows copied by cp.async into a
  double-buffered ring in shared memory while this one computes;
* `aadd_field_sums`: the Fq2 `affine_add`'s sums and differences by
  field.cuh's `fe_add` / `fe_sub` in place of warp.cuh's PTX carry chains
  (`fe_add_cc`, `fe_sub_cc`);
* `aadd_min5`: the Fq2 `affine_add` held to five blocks of 128 threads an
  SM (`__launch_bounds__(128, 5)`: at most 102 registers);
* `aadd_fq_ptx_product`: the Fq `affine_add`'s products by a CIOS with PTX
  carry chains (`fe_mont_mul_cc`: mad.lo.cc / madc.hi.cc, two
  multiply-adds a word and no 64-bit additions) in place of field.cuh's
  `fe_mont_mul` (64-bit accumulators);
* `aadd_fq_64`: the Fq `affine_add` on blocks of 64 threads in place of
  128 (twice the blocks, spread more evenly over the SMs at the chunk's
  narrow widths);
* `aadd_fq_field_sums`: the Fq `affine_add`'s sums and differences by
  field.cuh's `fe_add` / `fe_sub` in place of `fe_add_cc` / `fe_sub_cc`;
* `aadd_fq_x2_always`: the Fq `affine_add` computing x^2 on every lane (the
  kernel before it computed it so) in place of only on a warp with a
  tangent lane;
* `aadd_fq_min6`: the Fq `affine_add` held to six blocks of 128 threads an
  SM (`__launch_bounds__(kThreads, 6)`: at most 80 registers);
* `jdbl_groups`, `jdbl_threads`, `jdbl_one_thread`: `jdbl` over Fq and
  Fq2 on launch_jdbl_lanes's groups (a warp a lane over Fq, two over Fq2),
  its product threads (four over Fq, eight over Fq2) or point.cuh's one
  thread a lane (both fields' kernel before launch_jdbl_lanes) at every
  lane count, which time the switch-overs.

The designs are built at once with this checkout (one nvcc a source), then
`scripts/time_chain_kernels.py --turns` checks every build bit-equal to the
plain versions (`batch_inv` to the card's tree of `mul` and `inv`) and
times `inv`, `jdbl_n`, `jadd` and `batch_inv` (or the `--kernels` given)
over Fq and Fq2 at a chunk's shapes, this checkout, the designs and the
checkouts `--also` names (the parent, say: a `git archive` unpacked under
the gitignored `build/`) in turns.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "designs")

THREAD_PRODUCT = """template <int N, bool kWide>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N],
                                              Fe (&out)[N], const Mod& M,
                                              int g, int k, uint32_t pk) {
  Fe x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = fe_select(g == j, a[j], x);
    y = fe_select(g == j, b[j], y);
  }
  const Fe r = fe_mont_mul(x, y, M);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = __shfl_sync(kFullWarp, r.w[i], 8 * j);
  }
}
"""


def _replace_function(src: str, head: str, new: str) -> str:
    """`src` with the definition that starts with `head` (up to its closing
    brace in column 0) replaced by `new`."""
    a = src.index(head)
    b = src.index("\n}\n", a) + 3
    return src[:a] + new + src[b:]


ONE_WARP = """// One Fq2 doubling on one warp (a = 0): 16 base products in four rounds
// on the warp's four groups, passed on by shuffles:
//   1. XX and YY;
//   2. YYYY and (X + YY)^2;
//   3. M^2 (M = 3 XX), y0 z0 and y1 z1;
//   4. M (S - X3) as m0 d0, m1 d1 and (m0 + m1)(d0 + d1), and
//      (y0 + y1)(z0 + z1).
template <bool kAZero, class X>
__device__ __forceinline__ PtT<Fe2> warp_double(const Curve& C, const PtT<Fe2>& P, X& ex) {
  static_assert(kAZero, "the Fq2 doubling serves a = 0 only");
  const Mod& M = C.M;
  const Fe ys = fe_add_cc(P.y.c0, P.y.c1, M);
  Fe r1[4];
  {
    const Fe a[4] = {fe_add_cc(P.x.c0, P.x.c1, M), P.x.c0, ys, P.y.c0};
    const Fe b[4] = {fe_sub_cc(P.x.c0, P.x.c1, M), P.x.c1,
                     fe_sub_cc(P.y.c0, P.y.c1, M), P.y.c1};
    ex.run(a, b, r1);
  }
  const Fe2 XX = fe2_make(r1[0], fe_add_cc(r1[1], r1[1], M));
  const Fe2 YY = fe2_make(r1[2], fe_add_cc(r1[3], r1[3], M));
  const Fe2 T = fe2_add_cc(P.x, YY, M);
  Fe r2[4];
  {
    const Fe a[4] = {fe_add_cc(YY.c0, YY.c1, M), YY.c0, fe_add_cc(T.c0, T.c1, M), T.c0};
    const Fe b[4] = {fe_sub_cc(YY.c0, YY.c1, M), YY.c1, fe_sub_cc(T.c0, T.c1, M), T.c1};
    ex.run(a, b, r2);
  }
  const Fe2 YYYY = fe2_make(r2[0], fe_add_cc(r2[1], r2[1], M));
  const Fe2 TT = fe2_make(r2[2], fe_add_cc(r2[3], r2[3], M));
  Fe2 S = fe2_sub_cc(fe2_sub_cc(TT, XX, M), YYYY, M);
  S = fe2_add_cc(S, S, M);
  const Fe2 Mm = fe2_add_cc(fe2_add_cc(XX, XX, M), XX, M);
  Fe r3[4];
  {
    const Fe a[4] = {fe_add_cc(Mm.c0, Mm.c1, M), Mm.c0, P.y.c0, P.y.c1};
    const Fe b[4] = {fe_sub_cc(Mm.c0, Mm.c1, M), Mm.c1, P.z.c0, P.z.c1};
    ex.run(a, b, r3);
  }
  PtT<Fe2> R;
  R.x = fe2_sub_cc(fe2_make(r3[0], fe_add_cc(r3[1], r3[1], M)), fe2_add_cc(S, S, M), M);
  const Fe2 D = fe2_sub_cc(S, R.x, M);
  Fe r4[4];
  {
    const Fe a[4] = {Mm.c0, Mm.c1, fe_add_cc(Mm.c0, Mm.c1, M), ys};
    const Fe b[4] = {D.c0, D.c1, fe_add_cc(D.c0, D.c1, M), fe_add_cc(P.z.c0, P.z.c1, M)};
    ex.run(a, b, r4);
  }
  const Fe2 MD = fe2_make(fe_sub_cc(r4[0], r4[1], M),
                          fe_sub_cc(fe_sub_cc(r4[2], r4[0], M), r4[1], M));
  Fe2 e8 = fe2_add_cc(YYYY, YYYY, M);
  e8 = fe2_add_cc(e8, e8, M);
  R.y = fe2_sub_cc(MD, fe2_add_cc(e8, e8, M), M);
  const Fe2 YZ = fe2_make(fe_sub_cc(r3[2], r3[3], M),
                          fe_sub_cc(fe_sub_cc(r4[3], r3[2], M), r3[3], M));
  R.z = fe2_add_cc(YZ, YZ, M);
  return R;
}
"""


AADD_RING = """// Design (c): persistent blocks (as many as the card holds at once), each
// walking tiles of kRingLanes lanes; a tile's rows (Lx, Ly, Rx, Ry, inv:
// 64 bytes a lane each) and flags are copied by cp.async into a
// double-buffered ring in shared memory, the next tile's copies in flight
// while this one computes.
constexpr int kRingLanes = kThreads / 2;  // a tile: the block's pairs

struct AaddTile {
  uint4 row[5][4 * kRingLanes];
  int flag[2][kRingLanes];
};

__device__ __forceinline__ void aadd_tile_copy(AaddTile& t, const uint4* lx, const uint4* ly,
                                               const uint4* rx, const uint4* ry,
                                               const uint4* inv, const int* lv,
                                               const int* rv, long long tile, long long n) {
  const long long base = tile * kRingLanes;
  const int lanes = (int)(n - base < kRingLanes ? n - base : kRingLanes);
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const uint4* src = p == 0 ? lx : p == 1 ? ly : p == 2 ? rx : p == 3 ? ry : inv;
    for (int q = threadIdx.x; q < 4 * lanes; q += kThreads)
      __pipeline_memcpy_async(&t.row[p][q], src + 4 * base + q, 16);
  }
  for (int q = threadIdx.x; q < 2 * kRingLanes; q += kThreads) {
    const int f = q / kRingLanes, k = q % kRingLanes;
    if (k < lanes) __pipeline_memcpy_async(&t.flag[f][k], (f ? rv : lv) + base + k, 4);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
    affine_add_ring_kernel(Curve C, const uint4* lx, const uint4* ly, const int* lv,
                           const uint4* rx, const uint4* ry, const int* rv,
                           const uint4* inv, uint4* ox, uint4* oy, int* ov, long long n) {
  __shared__ AaddTile ring[2];
  const long long tiles = (n + kRingLanes - 1) / kRingLanes;
  const int li = threadIdx.x >> 1, h = threadIdx.x & 1, q = 4 * li + 2 * h;
  long long t = blockIdx.x;
  if (t < tiles) aadd_tile_copy(ring[0], lx, ly, rx, ry, inv, lv, rv, t, n);
  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    if (t + gridDim.x < tiles) {
      aadd_tile_copy(ring[(k + 1) & 1], lx, ly, rx, ry, inv, lv, rv, t + gridDim.x, n);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const AaddTile& T = ring[k & 1];
    Fe x, y;
    bool valid;
    affine_add_half(C.M, fe_load(&T.row[0][q]), fe_load(&T.row[1][q]), fe_load(&T.row[2][q]),
                    fe_load(&T.row[3][q]), fe_load(&T.row[4][q]), T.flag[0][li] != 0,
                    T.flag[1][li] != 0, h, kFullWarp, x, y, valid);
    const long long i = t * kRingLanes + li;
    if (i < n) {
      fe_store(ox + 4 * i + 2 * h, x);
      fe_store(oy + 4 * i + 2 * h, y);
      if (h == 0) ov[i] = valid ? 1 : 0;
    }
    __syncthreads();
  }
}

"""
AADD_RING_LAUNCH = """    static int grid = 0;
    if (!grid) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, affine_add_ring_kernel, kThreads, 0);
      grid = sms * per_sm;
    }
    const long long tiles = (n + kRingLanes - 1) / kRingLanes;
    affine_add_ring_kernel<<<(unsigned)(tiles < grid ? tiles : grid), kThreads, 0,
                             (cudaStream_t)stream>>>("""


def _aadd_ring(src: str) -> str:
    head = "// Host side: n pair additions over F"
    src = _set_constant(src, head, AADD_RING + head)
    src = _set_constant(src, "#include <cuda_runtime.h>\n",
                        "#include <cuda_pipeline.h>\n#include <cuda_runtime.h>\n")
    return _set_constant(src, """      affine_add_halves_kernel<true><<<grid_for(2 * n, kThreads), kThreads, 0, s>>>(""",
                         AADD_RING_LAUNCH)


def _field_sums(src: str) -> str:
    body = src[src.index("__device__ __forceinline__ PtT<Fe> warp_double("):]
    assert "fe_add_cc<X::kWide>(" in body and "fe_sub_cc(" in body
    new = re.sub(r"fe_add_cc(<X::kWide>)?\(", "fe_add(", body).replace("fe_sub_cc(", "fe_sub(")
    return src[:len(src) - len(body)] + new


def _thread_product(src: str) -> str:
    return _replace_function(
        src, "template <int N, bool kWide>\n__device__ __forceinline__ void warp_products(",
        THREAD_PRODUCT)


def _one_warp(src: str) -> str:
    src = _replace_function(
        src, "template <bool kAZero, class X>\n__device__ __forceinline__ PtT<Fe2> warp_double(",
        ONE_WARP)
    return src.replace("constexpr int kLaneThreads<Fe2> = 64;", "constexpr int kLaneThreads<Fe2> = 32;")


def _set_constant(src: str, old: str, new: str) -> str:
    assert old in src, old
    return src.replace(old, new)


def _lanes(src: str, group_max: str, one_thread_min: str) -> str:
    """`jadd` on groups up to group_max lanes, on one thread a lane from
    one_thread_min on (0: never), on product threads between (over Fq and
    Fq2)."""
    for name, value in (("kJaddGroupLanesMax", group_max),
                        ("kJaddOneThreadLanesMin", one_thread_min)):
        src = _set_constant(src, f"{name} = ", f"{name} = {value}; //")
        src = _set_constant(src, f"{name}<Fe2> = ", f"{name}<Fe2> = {value}; //")
    return src


def _jadd_groups(src: str) -> str:
    return _lanes(src, "1LL << 40", "0")


def _jadd_threads(src: str) -> str:
    return _lanes(src, "0", "0")


def _jadd_one_thread(src: str) -> str:
    return _lanes(src, "0", "1")


def _jadd_threads_half(src: str) -> str:
    src = _jadd_threads(src)
    src = _set_constant(src, "constexpr int kJaddProductThreads = 4;",
                        "constexpr int kJaddProductThreads = 2;")
    return _set_constant(src, "constexpr int kJaddProductThreads<Fe2> = 8;",
                         "constexpr int kJaddProductThreads<Fe2> = 4;")


def _two_warps(src: str) -> str:
    # BlockGroups<2> takes the generic plan of six rounds of at most eight
    return _set_constant(src, "constexpr int kJaddGroupThreads<Fe2> = 128;",
                         "constexpr int kJaddGroupThreads<Fe2> = 64;")


def _blocks_of_s(src: str) -> str:
    return src.replace("<<<(unsigned)(n >> log_s), kBatchInvThreads,",
                       "<<<(unsigned)(n >> log_s), "
                       "(int)(log_s < 7 ? 1LL << log_s : kBatchInvThreads),")


def _bucket(name: str, value: str, field: str = ""):
    """bucket.cuh with kBucket<name> (its specialisation for `field`, or the
    generic one) set to value."""
    spec = f"<{field}>" if field else ""

    def design(src: str) -> str:
        head = f"constexpr int kBucket{name}{spec} = "
        a = src.index(head) + len(head)
        return src[:a] + value + src[src.index(";", a):]
    return design


DESIGNS = {"field_sums": _field_sums, "thread_product": _thread_product, "one_warp": _one_warp,
           "jadd_groups": _jadd_groups, "jadd_threads": _jadd_threads,
           "jadd_threads_half": _jadd_threads_half, "jadd_one_thread": _jadd_one_thread,
           "two_warps": _two_warps,
           "batch_inv_blocks_of_s": _blocks_of_s,
           "bucket_k2": _bucket("Cluster", "2"), "bucket_k5": _bucket("Cluster", "5"),
           "bucket_k8": _bucket("Cluster", "8"),
           "bucket_fq_320": lambda src: _bucket("Threads", "320")(
               _bucket("GroupLanesMax", "20")(src)),
           "bucket_inline": lambda src: _set_constant(
               src, "template <class F, bool kAZero, int G, class X>\n__device__ __noinline__ "
               "void bucket_add(", "template <class F, bool kAZero, int G, class X>\n"
               "__device__ __forceinline__ void bucket_add(")}
# csrc/madd.cuh's executors (kMaddThreads<F>) and warp.cuh's madd_double
def _madd_threads(fq: int, fq2: int):
    """madd.cuh with kMaddThreads fq over Fq and fq2 over Fq2."""
    old = "constexpr int kMaddThreads = 1;\n"
    return lambda src: _set_constant(src, old, f"constexpr int kMaddThreads = {fq};\n"
                                     f"template <>\nconstexpr int kMaddThreads<Fe2> = {fq2};\n")


MADD_DESIGNS = {
    "madd_threads": _madd_threads(4, 8), "madd_fq2_four": _madd_threads(1, 4),
    "madd_fq2_eight": _madd_threads(1, 8),
    "madd_inline": lambda src: _set_constant(
        src, "__device__ __noinline__ void madd_double(",
        "__device__ __forceinline__ void madd_double("),
    "madd_fq2_call": lambda src: _set_constant(
        src, "constexpr bool kMaddDoubleCall<Fe2> = false;",
        "constexpr bool kMaddDoubleCall<Fe2> = true;")}
DESIGNS.update(MADD_DESIGNS)
MADD_WARP = ("madd_inline", "madd_fq2_call")  # designs of warp.cuh, not madd.cuh


def _jdbl_lanes(group_max: str, one_thread_min: str):
    """warp.cuh with `jdbl` on groups up to group_max lanes and on one
    thread a lane from one_thread_min on (0: never), over Fq and Fq2."""
    def design(src: str) -> str:
        for name, value in (("kJdblGroupLanesMax", group_max),
                            ("kJdblOneThreadLanesMin", one_thread_min)):
            src = _set_constant(src, f"{name} = ", f"{name} = {value}; //")
            if name + "<Fe2> = " in src:
                src = _set_constant(src, f"{name}<Fe2> = ", f"{name}<Fe2> = {value}; //")
        return src
    return design


DESIGNS.update({name: _jdbl_lanes(*lanes)
                for name, lanes in (("jdbl_groups", ("1LL << 40", "0")),
                                    ("jdbl_threads", ("0", "0")),
                                    ("jdbl_one_thread", ("0", "1")))})
MULTI = {}


def _aadd_field_sums(src: str) -> str:
    """affine_add.cuh's sums as field.cuh's fe_add / fe_sub in place of
    warp.cuh's PTX carry chains."""
    a = src.index("// Half h of the Fq2 product u v")
    b = src.index("// Threads 2i and 2i + 1 on lane i")
    body = src[a:b].replace("fe_sub_cc(fe_zero(), uo, M)", "fe_neg(uo, M)")
    assert "fe_neg(uo, M)" in body
    body = body.replace("fe_add_cc(", "fe_add(").replace("fe_sub_cc(", "fe_sub(")
    return src[:a] + body + src[b:]


MULTI["aadd_ring"] = {"affine_add.cuh": _aadd_ring}
MULTI["aadd_field_sums"] = {"affine_add.cuh": _aadd_field_sums}
MULTI["aadd_min5"] = {"affine_add.cuh": lambda src: _set_constant(
    src, "__global__ void __launch_bounds__(kThreads)\n    affine_add_halves_kernel(",
    "__global__ void __launch_bounds__(kThreads, 5)\n    affine_add_halves_kernel(")}


PTX_PRODUCT = r"""// One CIOS step of fe_mont_mul_cc: t = (t + a b_i + m p) / 2^32 with
// m = t_0 (-p^-1) mod 2^32, as one asm statement (the carry flag lives
// only within one).  t is nine words; t + a b_i + m p <= 2^33 p - 2^32 <
// 2^288 for p < 2^255, so neither chain carries out of t_8 (the last
// madc.hi drops no carry).  The low halves of a_j b_i go into t_j, the high
// halves into t_(j+1), then the same for m p_j; t_0 ends at 0 and the
// caller's renaming shifts t down a word.
#define CRESCENT_T9 "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), \
                    "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
__device__ __forceinline__ void cios_step_cc(uint32_t (&t)[9], const Fe& a, uint32_t bi,
                                             const Mod& M) {
  asm("{\n\t.reg .u32 m;\n\t"
      "mad.lo.cc.u32 %0, %9, %17, %0;\n\tmadc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\tmadc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\tmadc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\tmadc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\tmadc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\tmadc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\tmadc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\tmadc.hi.u32 %8, %16, %17, %8;\n\t"
      "mul.lo.u32 m, %0, %26;\n\t"
      "mad.lo.cc.u32 %0, m, %18, %0;\n\tmadc.lo.cc.u32 %1, m, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, m, %20, %2;\n\tmadc.lo.cc.u32 %3, m, %21, %3;\n\t"
      "madc.lo.cc.u32 %4, m, %22, %4;\n\tmadc.lo.cc.u32 %5, m, %23, %5;\n\t"
      "madc.lo.cc.u32 %6, m, %24, %6;\n\tmadc.lo.cc.u32 %7, m, %25, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, m, %18, %1;\n\tmadc.hi.cc.u32 %2, m, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, m, %20, %3;\n\tmadc.hi.cc.u32 %4, m, %21, %4;\n\t"
      "madc.hi.cc.u32 %5, m, %22, %5;\n\tmadc.hi.cc.u32 %6, m, %23, %6;\n\t"
      "madc.hi.cc.u32 %7, m, %24, %7;\n\tmadc.hi.u32 %8, m, %25, %8;\n\t}"
      : CRESCENT_T9
      : CRESCENT_IN8(a), "r"(bi), "r"(M.p[0]), "r"(M.p[1]), "r"(M.p[2]), "r"(M.p[3]),
        "r"(M.p[4]), "r"(M.p[5]), "r"(M.p[6]), "r"(M.p[7]), "r"(M.inv));
}
#undef CRESCENT_T9

// Montgomery product a b 2^-256 mod p, canonical, the value fe_mont_mul
// computes: eight cios_step_cc, each followed by the shift down a word
// (t < 2p after each, as in CIOS), then one conditional subtraction of p
// (2p < 2^256: the ninth word is 0 at the end).
__device__ __forceinline__ Fe fe_mont_mul_cc(const Fe& a, const Fe& b, const Mod& M) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cios_step_cc(t, a, b.w[i], M);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fe r, d;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  const uint32_t borrow = sub_chain(d, r, fe_from(M.p));
  return fe_select(borrow != 0, r, d);
}

"""


def _lane_body(src: str, change) -> str:
    """affine_add.cuh with `change` made to the Fq kernel and the launcher
    alone."""
    body = src[src.index("// Lane i over Fq"):]
    return src[:len(src) - len(body)] + change(body)


MULTI["aadd_fq_ptx_product"] = {"affine_add.cuh": lambda src: _lane_body(
    _set_constant(src, "__device__ __forceinline__ bool fe_equal(",
                  PTX_PRODUCT + "__device__ __forceinline__ bool fe_equal("),
    lambda b: b.replace("fe_mont_mul(", "fe_mont_mul_cc("))}
MULTI["aadd_fq_64"] = {"affine_add.cuh": lambda src: _lane_body(src, lambda b: _set_constant(
    _set_constant(b, "__launch_bounds__(kThreads)", "__launch_bounds__(64)"),
    "kernel<<<grid_for(n, kThreads), kThreads, 0, s>>>(",
    "kernel<<<grid_for(n, 64), 64, 0, s>>>("))}
MULTI["aadd_fq_field_sums"] = {"affine_add.cuh": lambda src: _lane_body(
    src, lambda b: b.replace("fe_add_cc(", "fe_add(").replace("fe_sub_cc(", "fe_sub("))}
MULTI["aadd_fq_x2_always"] = {"affine_add.cuh": lambda src: _set_constant(
    src, "if (__any_sync(live, both && dbl_case)) {", "{")}
MULTI["aadd_fq_min6"] = {"affine_add.cuh": lambda src: _set_constant(
    src, "__global__ void __launch_bounds__(kThreads)\n    affine_add_lane_kernel(",
    "__global__ void __launch_bounds__(kThreads, 6)\n    affine_add_lane_kernel(")}
DESIGNS.update({name: None for name in MULTI})


def make(name: str) -> str:
    """Copy the port into build/designs/<name>/ with the design's change to
    its sources."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "crescent_tpu_torch"),
                    os.path.join(root, "crescent_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = next((h for k, h in (("batch_inv", "batch_inv.cuh"), ("bucket", "bucket.cuh"))
                   if name.startswith(k)), "warp.cuh")
    if name in MADD_DESIGNS and name not in MADD_WARP:
        header = "madd.cuh"
    for header, change in (MULTI.get(name) or {header: DESIGNS[name]}).items():
        path = os.path.join(root, "crescent_tpu_torch", "csrc", header)
        with open(path) as f:
            src = f.read()
        new = change(src)
        assert new != src, name
        with open(path, "w") as f:
            f.write(new)
    return root


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--designs", nargs="+", choices=sorted(DESIGNS), default=sorted(DESIGNS))
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from time_chain_kernels import KERNELS, build

    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--also", metavar="ROOT", nargs="+", default=[],
                    help="other checkouts timed in the same turns (the parent, say)")
    args = ap.parse_args()

    roots = [make(name) for name in args.designs] + [os.path.abspath(r) for r in args.also]
    for root, out in build([HERE] + roots).items():
        lines = out.splitlines()
        for i, line in enumerate(lines):  # the chain kernels' registers and spills
            if "Compiling entry" in line and any(
                    k in line for k in ("jdbl_n", "jadd_kernel", "batch_inv_kernel",
                                        "bucket_reduce_kernel", "madd_kernel",
                                        "fixed_base_kernel", "jdbl_kernel",
                                        "affine_add")):
                info = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                print(os.path.relpath(root, HERE), line.split("'")[1], "|",
                      f"{regs and regs.group(1)} registers, {spill and spill.group(1)} bytes "
                      "spill stores", flush=True)
            elif "Function properties for" in line and (
                    "bucket_add" in line or "madd_double" in line):  # a callee
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
                print(os.path.relpath(root, HERE), line.split()[-1], "|",
                      f"{spill and spill.group(1)} bytes spill stores", flush=True)
    res = subprocess.run([sys.executable, os.path.join(HERE, "scripts", "time_chain_kernels.py"),
                          "--turns", *roots, "--rounds", str(args.rounds),
                          "--kernels", *args.kernels])
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
