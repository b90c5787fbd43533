#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's CUDA kernels from crescent_tpu_torch/csrc with nvcc
   (one nvcc per source, started together, into build/kernels/) and prints
   the build time and each kernel's registers and spills.
3. Kernel phase: holds each of the twenty-four kernels against its plain
   PyTorch version on the card at its path's shapes, with the edge cases planted
   (field: 0, 1, p-1, Montgomery 1, and u over Fq2; points: L == R,
   L == -R, one side only, neither; P + P, P + (-P), the identity on either
   side and on both; for madd (2^16 lanes, Fq with a = 0 and a != 0, Fq2;
   and at the scan Pippenger's step, 4,224 lanes over Fq and 2,112 over
   Fq2, timed as a CUDA graph) also valid == 0 and sign == 1; the window kernel `fixed_base` over Fq
   and Fq2 at 2^16 scalars x 32 windows against fixed_base_plain (the
   chain of row gathers and madd_plain), on G1's and G2's tables of
   multiples and on two planted ones, every row G (the second valid window
   doubles) and G in even windows, -G in odd ones (sums at the identity
   mid-chain), the scalars 0, 1, n-1, (n+1)/2 and zero digits among them,
   then at setup's two batches on dummy_circuit(21) (8,388,613 seeded G1
   scalars; 2,097,156 G2 scalars, zero but for four as a setup's) on the
   real tables, 4,101 sampled lanes, the first and the last among them,
   against fixed_base_plain on their scalars, timed with the bound
   counted from the batch's digits, and over a curve with a != 0 on seeded
   rows and one row repeated; for
   bucket_reduce, at the fused aggregate's 25 windows of 1025 buckets,
   at 1 and 3 windows of 3, 5, 17 and 1025 buckets and at one window of
   the most it takes (4,097 over Fq, 2,049 over Fq2), empty buckets, P == Q
   and P == -Q in neighbouring buckets, also against the card's unfused
   levels (bucket_levels over the `jadd` kernel, the launches it
   replaces), with the card's room for its clusters printed; Fq `inv` at 512
   lanes with 0, 1, p-1, Montgomery 1 and 2^k among them, and Fq2 `inv`
   with the norm's edges, (1, 0), (0, 1), (p-1, 0), (a, a) and 2^k in c0
   and in c1, x * inv(x) == 1; `jdbl_n` over Fq and Fq2 at the window
   combine's five launches, 16 lanes x 11 down to 1 lane x 176 doublings,
   identities among the lanes, then 100 lanes x 0, 1 and 3; `jadd` over Fq
   and Fq2 at every shape of a chunk's 27 launches, 25,625 lanes down to
   1, and at 2^17, P + P, P + (-P) and the identity on either side run at
   each; `affine_add` over Fq and Fq2 at 2^21 lanes and at the widths of a
   chunk's 22 pair-level calls (timed as one CUDA graph of the 22), the
   pair cases (L == R, L == -R, one side, neither, L == R on an invalid
   side) planted at every position of the kernel's warp, and a warp with
   L == -R alone and one with a tangent alone; `jdbl` over Fq and Fq2 at
   its callers' shapes, verify's one lane and the small MSM's 1,024, and
   at 2^17, and one below, at and one above each switch of its executors
   (read out of csrc/warp.cuh), identities planted, also against
   jadd(P, P), and over Fq with a != 0 at the same shapes; `batch_inv` over Fq and Fq2
   at the distinct shapes of a chunk's 22
   calls, 2^21 down to 32,768 leaves of affine_denom output with a zero
   planted in the second run, also against the card's own tree of `mul`
   launches with `inv` on its root level, the launches it replaces), and
   once over a curve with a != 0 (2^14 lanes, `jadd` at the chunk's
   shapes and `bucket_reduce` at 25 x 1025); then `jadd` and `jdbl` over
   T-256's base field (p >= 2^255, a = p - 3: warp.cuh's kWide instances)
   at 64, 128, 256, 1,024, 8,192 and 16,384 lanes (`jdbl` also at 32,768),
   coordinates at p - 1 and 2^255, sums and products across 2^256, the
   identity, P + P and P + (-P) planted, and `mul` over T-256 at 34, 129
   and 2^20 rows by R^2 (points_to_device's conversion).  Tolerance:
   none, the results must be bit-identical (exact integer arithmetic).
   Prints the kernel's and the plain version's times (CUDA events; `jadd`'s,
   `batch_inv`'s and `bucket_reduce`'s around a CUDA graph of their
   launches, whose kernels at the narrow shapes are shorter than the host's
   time a call, the tree's beside `batch_inv`'s, both summed over a chunk's
   calls, and the unfused levels' beside `bucket_reduce`'s) and the
   least time the card could take (`bound_ms`: bytes over 3.35 TB/s
   against 32-bit multiply-adds over 16.75e12/s, and for `inv` over Fq and
   Fq2 the divsteps' integer operations too, whichever is larger, counted
   for this run's data; for `batch_inv` the least work of n inverses,
   3 (n - 1) products and one inversion, with the inversion's latency floor
   of a chunk's 22 serial calls printed apart), and nvcc's register count;
   fails if a `jdbl_n`,
   `jadd`, `jdbl` (warp.cuh), `batch_inv`, `bucket_reduce` (bucket.cuh),
   `madd`, `fixed_base` (madd.cuh) or `affine_add` (affine_add.cuh)
   kernel spills.
4. MSM phase: one sorted-segment affine MSM of 2^17 seeded points on the
   card against the native host MSM, with PyTorch's synchronisation check
   set to raise, and one of 512 points (c = 5) on the card against the
   same through the plain versions on the CPU, (x, y, z) bit-equal.  Then
   G2: one 2^17-point chunk over Fq2 (points made on the card by the G2
   fixed base, the cases planted) under the same check, and
   get_g2_msm().run_device of 2^21 points (16 chunks and the Fq2 jadd
   tree), both against the native host G2 MSM.  Small N: get_msm(G1) and
   get_g2_msm() run_device of 1000 seeded points each (padded to 1024, the
   direct path: scalar_mul by jdbl and jadd, then a jadd tree) against the
   native MSMs.
5. Fixed-base phase: one FixedBaseMSM run per group (G1, and G2 over Fq2)
   of 2^17 scalars (one `fixed_base` launch) on the
   card; 4,096 sampled rows, 0, 1, n-1 and (n+1)/2 among them, equal the
   native fixed base.
6. Setup cross-check: dummy_circuit(14) set up through the device branch
   and through the native branch from one seed gives equal keys, table
   for table; a small circuit is proved on the card in both MSM
   configurations and on the CPU, and h and the proofs must be equal.
7. Main path: Groth16 on dummy_circuit(21) (the reference's proof-benchmark
   circuit, domain 2^21) with random keys from a fixed seed: `setup` on the
   card (the device branch: each SRS fixed-base batch one `fixed_base`
   launch, G1's over Fq and G2's over Fq2, and no `madd`; its affine
   conversion by `batch_inv` and `mul`), then `prove(..., device="cuda")` in its default
   configuration (h(x) and the four G1 MSMs on the card, the G2 MSM on the
   host beside them) on that key, each with launch counts reset just
   before it and read just after (`batch_inv` 22 launches a chunk, the
   chunks counted from the circuit's sizes, the tree's `mul` and `inv`
   none), and `verify`, which must accept the proof
   and reject it against a wrong public input.  The same witness and
   blinding under CRESCENT_PROVE_MSM=native must give the same proof, and
   so must a warm prove under CRESCENT_NATIVE=0 (the G2 MSM on the card
   too, behind the fold), whose launch counts are read the same way and
   which must run every Fq2 kernel but `jdbl`, `madd`, `bucket_reduce`,
   `butterfly` and the tree's `mul` and `inv`; and a warm prove under CRESCENT_MSM_FUSED_AGG=1 and
   CRESCENT_NATIVE=0 together, whose chunks aggregate by one
   `bucket_reduce` launch each over Fq (66) and Fq2 (17) in place of 21
   `jadd` launches, which must give the same proof; `verify` under
   CRESCENT_NATIVE=0 then takes the public-input MSM on the card (the
   direct path: `jdbl`'s caller).
8. CRESCENT_NATIVE=0 at dummy_circuit(15): `setup` takes its host branch
   (Python QAP evaluations and h scalars; both fixed-base batches by
   fixed_base_mul's double-and-add on the card, 256 `jadd` and 256 `jdbl`
   launches over Fq (2^18 lanes) and over Fq2 (2^16), no `fixed_base`),
   and its key must equal the default route's (the device branch) from
   the same seed; `prove` takes the Python matvec (`_compute_h`) and its
   proof must equal the default route's for the same r and s, and verify.
   `jadd` and `jdbl` are also held against their plain versions and timed
   at fixed_base_mul's widths (256, 2^18 over Fq; 2^16 over Fq2).
9. The show path at rs256's public-IO shape (show_circuit: 17 revealed
   RSA-2048 modulus limbs of 121 bits, a committed expiry, two hidden
   claim values, 2^16 constraints): setup and prove on the card, the
   32-bit range setup natively and under CRESCENT_NATIVE=0 (its two KZG
   batches of 256 lanes on the card; the keys must be equal), then
   show_groth16 and show_range of the expiry shifted by the current time,
   as credentials/api.py create_show_proof builds them; both must verify,
   and a tampered revealed input must not.  Prints the show and verify
   seconds with the card's name and power limit.
10. rs256 end to end through the port's CLI (cli.main in this process, in a
   temporary directory) at max_cred_len 2048, the real JWT statement
   (about 1.5 M constraints, domain 2^21): gen-fixtures, zksetup, prove,
   prove again (the compiled witness program replayed natively), show and
   verify, each returning 0 and verify printing PASS; prints each
   command's seconds and trace spans, the circuit's sizes and the peak
   host RSS.  zksetup must take setup's device branch (one `fixed_base`
   launch a group, no `madd`), each prove the fold with 22 `batch_inv`
   launches a chunk and no `inv` (the chunks counted from the circuit's
   sizes), the replayed prove's proof must verify, and a show whose
   revealed email limb is changed must fail verify_show.
11. The scan Pippenger (CRESCENT_MSM_AFFINE=0, c = 8): 2^16 seeded G1
   points through MSM(c=8, lanes=128, small_cutoff=0) (512 `madd`
   launches over 4,224 lanes, 417 `jadd`, 33 `jdbl_n`), again under
   CRESCENT_MSM_PALLAS=0 (its XLA form of phases 1-2, the same (x, y, z)),
   and 2^14 G2 points made on the card through MSM(c=8, lanes=64) (Fq2
   `madd` over 2,112 lanes), the identity, 0, -1, P == Q and P == -Q
   planted, each against the native MSM, each run's launches held to
   `scan_launches`; run_device_many over three G1 problems of 2^16, 40,000
   and 3,000 points (one scan, `madd` over 12,672 lanes a step), each equal
   to its own run_device.
12. prove under CRESCENT_PROVE_FUSED=0 (h(x) from the lists, the four G1
   MSMs as one run_device_many): dummy_circuit(18) on the affine route
   (each problem on its own, 22 `batch_inv` a chunk, no `madd`) and
   dummy_circuit(15) also under CRESCENT_MSM_AFFINE=0 (one scan over the
   four problems, no `batch_inv`); each proof, with fixed r and s, equals
   the default route's and verifies.
13. rs256-db (device bound) end to end through the port's CLI in this
   process at its max_cred_len, 576 (563,377 constraints, domain 2^20):
   gen-fixtures (issuer and device keys), zksetup and two proves as
   rs256's, show (with the DeviceProof: a Spartan proof of the device's
   ECDSA signature on the digest of the presentation message) and verify,
   which must print PASS; a presentation message other than the signed one
   and a flipped byte of the device proof must each be refused; prints
   each command's seconds and spans, Spartan's prove and verify seconds and
   the device proof's size.  Then show and verify once more from the same
   artifacts under CRESCENT_NATIVE=0 (Spartan's T-256 MSMs on the card:
   `mul`, `jadd` and `jdbl` over T-256, which must launch), verify printing
   PASS and a flipped device-proof byte refused, the spans "show::device
   proof" and "verify::device proof" printed.  And a DeviceProof on the
   ECDSA statement, its randomness and Spartan's tape fixed, built with the
   native backend on and off: the same bytes, each verifying under the
   other route.
14. mdl1 (an ISO 18013-5 mDL) end to end through the port's CLI
   in this process at its max_cred_len, 1792 (the real mDL statement:
   SHA-256 over the COSE MSO, ES256 verified in the circuit with
   non-native P-256 arithmetic, the validUntil, device-key and attribute
   digest blocks): gen-fixtures (an X.509 chain for an ES256 issuer key, a
   signed MSO, a P-256 device key), zksetup and two proves as rs256's
   (device branch, the fold with 22 `batch_inv` a chunk and no `inv`, the
   replay), show (the Groth16 show, the validUntil range proof, the
   birth date's "over 18" range proof and the DeviceProof) and verify,
   which must print PASS with resident_state WA, height 170,
   family_name Example and given_name Alice; a changed revealed input, a
   family_name preimage replaced by "Mallory", cur_time moved back
   1000 s, a flipped byte of the device proof and another presentation
   message must each be refused by verify_show_mdl.  Prints each command's
   seconds, spans and peak host RSS, the circuit's sizes, Spartan's prove
   and verify seconds and the show proof's size by part.
15. Prints {"kernels": [...]} (each kernel's launches in every run, those
   of rs256's, rs256-db's and mdl1's zksetup and two proves, the scan
   MSMs' and the CRESCENT_PROVE_FUSED=0 proves' among them; the T-256
   rows t256_mul, t256_jadd and t256_jdbl with the launches of the
   CRESCENT_NATIVE=0 show, verify and DeviceProof) and, last,
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

LOG_SIZE = 21      # dummy_circuit(21): domain 2^21
SMALL_LOG = 8      # cross-check circuit, card vs CPU
SETUP_LOG = 14     # setup cross-check circuit, device branch vs native
NATIVE_OFF_LOG = 15  # setup and prove under CRESCENT_NATIVE=0 (the host branch)
SHOW_LOG = 16      # the show circuit: rs256's public IOs, padded to 2^16 constraints
RANGE_BITS = 32    # the show's range proof (not expired)
FB_CHUNK_LOG = 16  # the reference's fixed-base chunk: lanes of the madd checks
SEED = 20261016
REPS = 50
CHUNK_LOG = 17     # points per chunk MSM on the prove path
AFFINE_C = 11      # its window width: W = 25 windows of B = 1025 buckets
HBM_BYTES_PER_S = 3.35e12
# sm_90 issues 64 32-bit integer multiply-adds per SM and clock against 128
# float32 ones: half of the data sheet's 67 TFLOP/s (33.5e12 FMA/s)
IMAD_PER_S = 16.75e12
MONT_MUL_MADS = 136  # 8 x (8 + 8 + 1) in fe_mont_mul
# Fq `inv` a lane (csrc/field.cuh fe_inv_divsteps): 25 batches, each of 30
# divsteps of 28 integer operations and two matrix updates of 90 32x32->64
# products (two multiply-adds each) and two 32-bit products, then one
# Montgomery product by R^3
DIVSTEP_INV_OPS = 25 * (30 * 28 + 2 * 90 + 2) + MONT_MUL_MADS
# jdbl_n's launches in a chunk's window combine at c = 11 (W = 25 padded to
# 32): (lanes, doublings)
FOLD_DBL_SHAPES = ((16, AFFINE_C), (8, 2 * AFFINE_C), (4, 4 * AFFINE_C),
                   (2, 8 * AFFINE_C), (1, 16 * AFFINE_C))
# a chunk's 27 jadd launches: the aggregate's suffix sums (11 levels of W * B
# lanes) and weight tree (W * 512 down to W), the window combine (16 down to
# 1), the fold's accumulator (1); W = 25 windows of B = 1025 buckets
_W, _B = (256 + AFFINE_C - 1) // AFFINE_C + 1, (1 << (AFFINE_C - 1)) + 1
JADD_CHUNK = ([_W * _B] * AFFINE_C + [_W * ((_B - 1) >> k) for k in range(1, AFFINE_C)]
              + [16, 8, 4, 2, 1, 1])
JADD_SHAPES = sorted(set(JADD_CHUNK), reverse=True) + [1 << CHUNK_LOG]
INV_FLOOR = 512  # batch_inv's floor in a chunk's rounds
# the scan Pippenger (CRESCENT_MSM_AFFINE=0): window width, its MSMs' sizes
# and lanes (get_msm's 128 for G1, get_g2_msm's 64 for G2), its signed
# windows and buckets: a step's madd runs over lanes x 33 windows
SCAN_C = 8
SCAN_LOGS = {"": 16, "fq2_": 14}
SCAN_LANES = {"": 128, "fq2_": 64}
SCAN_W = (256 + SCAN_C - 1) // SCAN_C + 1
SCAN_B = (1 << (SCAN_C - 1)) + 1
SCAN_MANY = (1 << 16, 40000, 3000)  # run_device_many's three G1 problems
FUSED_OFF = ((18, {"CRESCENT_PROVE_FUSED": "0"}, "affine"),
             (15, {"CRESCENT_PROVE_FUSED": "0", "CRESCENT_MSM_AFFINE": "0"}, "scan"))
DB_CRED_LEN = 576  # rs256-db's max_cred_len (cli.DEFAULT_CONFIGS)
MDL_CRED_LEN = 1792  # mdl1's max_cred_len (cli.MDL1_CONFIG)



def _registers(reports: dict) -> dict:
    """nvcc's -Xptxas -v report per library -> {(library, mangled entry):
    (registers, spill store bytes)}, an entry's spills with those of the
    functions it calls (a `__noinline__` callee's report follows the
    entry's)."""
    import re

    out = {}
    for lib, rep in reports.items():
        entry = None
        spill = 0
        for ln in rep.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and entry:
                spill += int(m.group(1))
                if (lib, entry) in out:  # a callee's, after the entry's registers
                    out[(lib, entry)] = (out[(lib, entry)][0], spill)
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                out[(lib, entry)] = (int(m.group(1)), spill)
    return out


# the kernels with several instances (a == 0 and a != 0, executors): a
# pattern of their mangled names, {f} the field type's
INSTANCES = {"jadd": "_jadd_kernelINS_{f}E", "bucket_reduce": "bucket_reduce_kernelINS_{f}E",
             "madd": "11madd_kernelINS_{f}E", "fixed_base": "fixed_base_kernelINS_{f}E",
             # jdbl: warp.cuh's thread_jdbl_kernel (product threads),
             # point.cuh's jdbl_kernel (one thread) and the jdbl_n lane
             # body warp_jdbl_n_kernel (one doubling a lane on few lanes)
             "jdbl": "jdbl(?:_n)?_kernelI(?:NS_|N8crescent){f}E",
             # affine_add.cuh's: over Fq one thread a lane, over Fq2 the
             # halves (each library holds only its own)
             "affine_add": "affine_add_(?:lane|halves)_kernelI"}


# an instance over Fq or Fq2 with a != 0 (kAZero, the first bool after the
# field type, false)
A_NONZERO = r"(?:2Fe|3Fe2)ELb0E"
# warp.cuh's kWide instances (a != 0, p >= 2^255: T-256's jadd and jdbl)
WIDE_ENTRY = r"ELb0E(?:Li\d+E)?Lb1EE"
def _jadd_registers(regs: dict, name: str) -> dict:
    """(registers, spill store bytes) of each instance of warp.cuh's `jadd`
    and `jdbl` kernels over Fq (`jadd`) or Fq2 (`fq2_jadd`), of bucket.cuh's
    `bucket_reduce` kernel, of madd.cuh's `madd` and `fixed_base` kernels,
    or of the `affine_add` kernels, by mangled name."""
    import re

    lib, field = ("ec2", "3Fe2") if name.startswith("fq2_") else ("ec", "2Fe")
    kernel = INSTANCES[name[4:] if name.startswith("fq2_") else name].format(f=field)
    return {e: v for (l, e), v in regs.items() if l == lib and re.search(kernel, e)}


def _kernel_registers(regs: dict, name: str):
    """(registers, spill store bytes) of the port's kernel `name` (fq2_ for
    the Fq2 set), or None where its library was not built in this run."""
    import re

    base = name[4:] if name.startswith("fq2_") else name
    # jdbl_n: warp.cuh's warp_jdbl_n_kernel<Fe or Fe2, a == 0> (the template
    # arguments as the mangled name spells them)
    warp = r"warp_jdbl_n_kernelI(?:NS_|N8crescent){}ELb1E"
    if name.startswith("fq2_"):
        lib = "ec2"
        key = {"jdbl_n": warp.format("3Fe2")}.get(
            base, (name if base in ("mul", "inv", "butterfly") else base) + "_kernel")
    else:
        lib = "ntt" if base in ("mul", "butterfly") else "ec"
        key = {"inv": "divstep_inv_kernel",
               "jdbl_n": warp.format("2Fe")}.get(base, base + "_kernel")
    if base in INSTANCES:  # the most registers and spills of any but a != 0's
        hits = [v for e, v in _jadd_registers(regs, name).items()
                if not re.search(A_NONZERO, e)]
        return (max(h[0] for h in hits), max(h[1] for h in hits)) if hits else None
    hits = [v for (l, e), v in regs.items() if l == lib and re.search(rf"\d{key}", e)]
    return hits[0] if len(hits) == 1 else None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def _rand_elems(torch, n: int, p: int, seed: int):
    """(n, 8) int32 canonical elements (< p) on the card from a numpy seed
    (the top word is drawn below p's top word)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w[:, 7] = rng.integers(0, p >> 224, size=n, dtype=np.uint64)  # < p
    w = w.astype(np.uint32).view(np.int32)
    return torch.from_numpy(w).cuda()


def _edges(ctx, device, first: bool):
    """16 rows holding every pair of the edge values (0, 1, p-1, Montgomery
    1): value i // 4 as the first operand, i % 4 as the second."""
    p = ctx.modulus
    vals = [0, 1, p - 1, ctx.r_mod_n]
    order = [vals[i // 4] if first else vals[i % 4] for i in range(16)]
    return ctx.words(order, device)


def _time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the card, `reps` calls captured
    in one CUDA graph and replayed (CUDA events around the replay): the
    kernel's time without the host's time a call, which is longer than a
    narrow launch's kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def _bound(nbytes: float, mads: float) -> tuple[float, str]:
    """The least milliseconds the card could take: (ms, 'bytes' or
    'operations')."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = mads / IMAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def setup_batches(log_size: int) -> tuple[int, int]:
    """The scalars of setup's two fixed-base batches on
    dummy_circuit(log_size), nv = 2^log_size + 1 variables and a domain of
    2^log_size: G1's 3 nv + (2^log_size - 1) + 3, G2's nv + 3."""
    nv = (1 << log_size) + 1
    return 3 * nv + (1 << log_size) + 2, nv + 3


def fixed_base_adds(torch, sc) -> int:
    """Additions the fixed base's 32 windows need on the (n, 8) standard-form
    scalar words `sc` (reduced mod the group order n) over a table of
    distinct multiples d 2^(8w) G, a setup's: one for each nonzero digit
    after a lane's first, which Q only copies.  No window doubles or
    cancels there: before window w the sum is k G with k < 2^(8w), and
    k -+ d 2^(8w) lies strictly between -n and n and is not 0
    (setup_kernel_phase checks it against the plain chain's count)."""
    nz = (sc.view(torch.uint8) != 0).sum(1)
    return int((nz - 1).clamp(min=0).sum().item())


def fixed_base_cost(n: int, width: int, adds: int) -> tuple[float, float]:
    """(bytes, multiply-adds) of the fixed base over n lanes of `width` words
    (8: Fq, 16: Fq2) with `adds` additions: the table, the scalars and the
    three output planes; 11 products an addition (29 base products over
    Fq2, the least; `_madd_products`' count)."""
    sqr, mul = (2, 3) if width == 16 else (1, 1)
    return (8192 * 2 * width * 4 + 32 * n + 3 * 4 * width * n,
            adds * (4 * sqr + 7 * mul) * MONT_MUL_MADS)


def fixed_base_bound(n: int, width: int, adds: int) -> tuple[float, str]:
    """The fixed base's bound (ms, 'bytes' or 'operations'): fixed_base_cost
    over the card's rates."""
    return _bound(*fixed_base_cost(n, width, adds))


def _timed_once(torch, fn):
    """(fn(), its milliseconds on the card by CUDA events), one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def _record(out: dict, name: str, label: str, shape: str, err: int, ms: float,
            plain_ms: float, nbytes: float, mads: float) -> None:
    """Print one kernel's check and times, fail if it differs from its plain
    version, and keep its row for the kernels line."""
    bound_ms, bound_by = _bound(nbytes, mads)
    say(f"kernel {name} [{label}] {shape}: max_abs_err={err} kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    if err:
        fail(f"{name} [{label}] at {shape} differs from its plain version")
    out.setdefault(name, []).append((shape, err, ms, plain_ms, bound_ms, bound_by))


def _errs(torch, got, want) -> int:
    """Largest absolute difference over a tuple of results."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(_max_abs_err(torch, g, w) for g, w in zip(got, want))


def kernel_phase(torch, fields, ntt, get_cuda_ec) -> dict:
    """Each kernel against its plain version at the path's shapes."""
    out = {}
    n = 1 << LOG_SIZE
    for label, p in (("BN254 Fr", fields.BN254_FR), ("BN254 Fq", fields.BN254_FQ)):
        ec = get_cuda_ec(p)
        x = _rand_elems(torch, n, p, SEED + 1)
        y = _rand_elems(torch, n, p, SEED + 2)
        x[:16] = _edges(ec.ctx, "cuda", True)
        y[:16] = _edges(ec.ctx, "cuda", False)

        got = ec.mul(x, y)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, ec.mul_plain(x, y))
        err = max(err, _max_abs_err(torch, ec.mul(x, y[5:6]), ec.mul_plain(x, y[5:6])))
        ms = _time_ms(torch, lambda: ec.mul(x, y, out=got), REPS)
        plain_ms = _time_ms(torch, lambda: ec.mul_plain(x, y), 3)
        say(f"kernel mul [{label}] n=2^{LOG_SIZE}: max_abs_err={err} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        if err:
            fail(f"mul over {label} differs from its plain version")
        out.setdefault("mul", []).append(
            (label, err, ms, plain_ms, *_bound(96 * n, MONT_MUL_MADS * n)))

        # butterfly on separate planes: 2^20 pairs
        h = n // 2
        a, b, tw = x[:h].contiguous(), y[:h].contiguous(), y[h:].contiguous()
        o0, o1 = ec.butterfly(a, b, tw)
        q0, q1 = ec.butterfly_plain(a, b, tw)
        err = max(_max_abs_err(torch, o0, q0), _max_abs_err(torch, o1, q1))
        # every stage of a 2^21 transform in place, against the plain stage
        tabs = ntt.get_domain(p, n).tables("cuda") if p == fields.BN254_FR else None
        tws = tabs["tw_fwd"] if tabs else y[: n - 1].contiguous()
        k_plane = x.clone()
        p_plane = x.clone()
        for s in range(LOG_SIZE):
            half = 1 << s
            t = ntt.stage_twiddles(tws, s)
            ec.butterfly_stage_(k_plane, t, half)
            v = p_plane.view(n // (2 * half), 2, half, 8)
            r0, r1 = ec.butterfly_plain(v[:, 0], v[:, 1], t)
            v[:, 0] = r0
            v[:, 1] = r1
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(torch, k_plane, p_plane))

        def all_stages():
            for s in range(LOG_SIZE):
                ec.butterfly_stage_(k_plane, ntt.stage_twiddles(tws, s), 1 << s)

        def plain_stage():
            v = p_plane.view(n // 2048, 2, 1024, 8)
            ec.butterfly_plain(v[:, 0], v[:, 1], ntt.stage_twiddles(tws, 10))

        ms = _time_ms(torch, all_stages, 10) / LOG_SIZE
        plain_ms = _time_ms(torch, plain_stage, 3)
        say(f"kernel butterfly [{label}] 2^{LOG_SIZE - 1} pairs + {LOG_SIZE} stages: "
            f"max_abs_err={err} kernel {ms:.4f} ms/stage, plain {plain_ms:.3f} ms/stage")
        if err:
            fail(f"butterfly over {label} differs from its plain version")
        # per stage: a and b read and written, the stage's twiddles read once
        out.setdefault("butterfly", []).append(
            (label, err, ms, plain_ms,
             *_bound(128 * h + 32 * (n - 1) / LOG_SIZE, MONT_MUL_MADS * h)))
    return out


def _rand_elems2(torch, n: int, p: int, seed: int):
    """(n, 16) int32 canonical Fq2 elements (c0, then c1) on the card."""
    return torch.cat([_rand_elems(torch, n, p, seed), _rand_elems(torch, n, p, seed + 1000)],
                     dim=1)


def _elems_for(torch, ec, n: int):
    """Seeded rows of ec's field: (n, 8) over Fq, (n, 16) over Fq2."""
    rand = _rand_elems2 if ec.WIDTH == 16 else _rand_elems
    return lambda seed: rand(torch, n, ec.modulus, seed)


def _point_inputs(torch, ec, n: int, seed: int):
    """Two Jacobian batches P, Q of n lanes of seeded field elements with the
    cases planted in the first lanes: P + P (the same triple), P + P through
    another representative ((x l^2, y l^3, z l)), P + (-P), P at infinity,
    Q at infinity, both at infinity."""
    elems = _elems_for(torch, ec, n)
    x1, y1, z1, x2, y2, z2 = (elems(seed + k) for k in range(6))
    ctx = ec.ctx
    x2[0], y2[0], z2[0] = x1[0], y1[0], z1[0]
    lam = x2[1:2].clone()
    l2 = ctx.mont_sqr(lam)
    x2[1:2] = ctx.mont_mul(x1[1:2], l2)
    y2[1:2] = ctx.mont_mul(y1[1:2], ctx.mont_mul(l2, lam))
    z2[1:2] = ctx.mont_mul(z1[1:2], lam)
    x2[2], y2[2], z2[2] = x1[2], ctx.neg_mod(y1[2:3])[0], z1[2]
    z1[3] = 0
    z2[4] = 0
    z1[5] = 0
    z2[5] = 0
    return x1, y1, z1, x2, y2, z2


def _pair_inputs(torch, ec, n: int, seed: int):
    """Affine pair batches (lx, ly, lv, rx, ry, rv) of n lanes with the cases
    planted in the first lanes: L == R, L == -R, left only, right only,
    neither; the validity of the other lanes is seeded."""
    import numpy as np

    elems = _elems_for(torch, ec, n)
    lx, ly, rx, ry = (elems(seed + k) for k in range(4))
    rng = np.random.default_rng(seed + 9)
    lv = torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)).cuda()
    rv = torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)).cuda()
    rx[0], ry[0] = lx[0], ly[0]
    rx[1], ry[1] = lx[1], ec.ctx.neg_mod(ly[1:2])[0]
    for lane, (l, r) in enumerate([(1, 1), (1, 1), (1, 0), (0, 1), (0, 0)]):
        lv[lane], rv[lane] = l, r
    # and the two equal-x cases on an invalid side
    rx[5], ry[5], lv[5], rv[5] = lx[5], ly[5], 1, 0
    rx[6], ry[6], lv[6], rv[6] = lx[6], ec.ctx.neg_mod(ly[6:7])[0], 0, 1
    _plant_warp_cases(torch, ec, (lx, ly, lv, rx, ry, rv))
    return lx, ly, lv, rx, ry, rv


# the pair cases _plant_warp_cases plants: (L == R, L == -R), flags
PAIR_CASES = {"tangent": (True, False, 1, 1), "opposite": (True, True, 1, 1),
              "left_only": (False, False, 1, 0), "right_only": (False, False, 0, 1),
              "neither": (False, False, 0, 0), "tangent_invalid": (True, False, 0, 1)}


def _plant_warp_cases(torch, ec, pair) -> None:
    """Plant the pair cases at every position of a warp of the affine_add
    kernel (32 lanes over Fq, one thread a lane; 16 over Fq2, two threads
    a lane) from lane 64 on (past _pair_inputs' first cases): warp w < the warp's lanes holds every case
    of PAIR_CASES from position w on, the next warp L == -R alone and the
    one after a tangent alone, both among valid chords; every width of a
    chunk's calls (a prefix of the lanes) holds them."""
    lx, ly, lv, rx, ry, rv = pair
    warp = 16 if ec.WIDTH == 16 else 32
    lanes = {c: [] for c in PAIR_CASES}
    for w in range(warp + 2):
        start = 64 + w * warp
        plant = list(PAIR_CASES) if w < warp else ["opposite" if w == warp else "tangent"]
        if w >= warp:
            lv[start:start + warp] = 1
            rv[start:start + warp] = 1
        for k, case in enumerate(plant):
            lanes[case].append(start + (w + k) % warp)
    for case, idx in lanes.items():
        same_x, neg, lf, rf = PAIR_CASES[case]
        idx = torch.tensor(idx, dtype=torch.long, device=lx.device)
        if same_x:
            rx[idx] = lx[idx]
            ry[idx] = ec.ctx.neg_mod(ly[idx]) if neg else ly[idx]
        lv[idx], rv[idx] = lf, rf


def _bucket_table(torch, ec, W: int, B: int, seed: int):
    """A dense (W * B)-row Jacobian bucket table of seeded rows with the
    cases planted in every window, as far as B has room: bucket 2 equal to
    bucket 1 (P == Q at the first level), empty buckets (zero rows, as the
    scatter leaves them: bucket 3 and the top bucket) and bucket 5 the
    negative of bucket 4 (P == -Q)."""
    elems = _elems_for(torch, ec, W * B)
    x, y, z = (elems(seed + k).view(W, B, -1) for k in range(3))
    for a in (x, y, z):
        a[:, 2] = a[:, 1]
        a[:, min(3, B - 1)] = 0
        a[:, B - 1] = 0
    if B > 6:
        x[:, 5], z[:, 5] = x[:, 4], z[:, 4]
        y[:, 5] = ec.ctx.neg_mod(y[:, 4].contiguous())
    return tuple(a.view(W * B, -1) for a in (x, y, z))


# bucket_reduce's shapes besides the fused aggregate's W x B: one window and
# three, a few buckets and the path's 1025
BUCKET_SHAPES = [(w, b) for w in (1, 3) for b in (3, 5, 17, (1 << (AFFINE_C - 1)) + 1)]


def _bucket_reduce_checks(torch, ec, label: str, prefix: str, seed: int, record=None):
    """`bucket_reduce` (one launch) bit-equal to its plain version
    (bucket_levels over jadd_plain) and to the card's unfused levels
    (bucket_levels over the `jadd` kernel, the 21 launches it replaces at
    c = 11), the cases planted: at the fused aggregate's 25 windows x 1025
    buckets, and with `record` also at BUCKET_SHAPES and at one window of
    the most buckets the kernel takes (BUCKET_B_MAX), timing the kernel
    and the levels at 25 x 1025 in CUDA graphs.  Bound: the table read and
    the sums written once; the products of the pair additions with both
    sides finite (the others take none).  Returns (largest difference,
    levels' ms, the launch's shape)."""
    from crescent_tpu_torch.ops.cuda_ec import bucket_levels

    f = ec.ctx
    e, sqr, mul = (64, 2, 3) if ec.WIDTH == 16 else (32, 1, 1)
    W = (256 + AFFINE_C - 1) // AFFINE_C + 1
    B = (1 << (AFFINE_C - 1)) + 1
    worst = 0
    levels_ms = None
    shapes = BUCKET_SHAPES + [(1, ec.BUCKET_B_MAX)] if record is not None else []
    for w, b in [(W, B)] + shapes:
        table = _bucket_table(torch, ec, w, b, seed + 40 + b)
        got = ec.bucket_reduce(*table, w, b)
        torch.cuda.synchronize()
        finite = [0, 0]

        def counted_jadd(*a):
            # the pairs that need the addition's products: both sides finite
            finite[0] += int((~f.is_zero(a[2]) & ~f.is_zero(a[5])).sum().item())
            finite[1] += a[0].shape[0]
            return ec.jadd_plain(*a)

        want, plain_ms = _timed_once(torch, lambda: bucket_levels(counted_jadd, *table, w, b))
        err = max(_errs(torch, got, want), _errs(torch, got, bucket_levels(ec.jadd, *table, w, b)))
        worst = max(worst, err)
        if (w, b) != (W, B):
            say(f"  {prefix}bucket_reduce [{label}] {w} x {b}: max_abs_err={err} against the "
                "plain version and the card's levels")
            if err:
                fail(f"{prefix}bucket_reduce [{label}] at {w} x {b} differs")
            continue
        if record is None:
            continue
        levels_ms = _graph_ms(torch, lambda: bucket_levels(ec.jadd, *table, w, b), 20)
        record("bucket_reduce", f"{w} windows x {b} buckets", err,
               _graph_ms(torch, lambda: ec.bucket_reduce(*table, w, b), 20), plain_ms,
               3 * e * (w * b + w), (5 * sqr + 11 * mul) * MONT_MUL_MADS * finite[0])
        say(f"  {prefix}bucket_reduce [{label}]: {finite[0]} of its {finite[1]} pair additions "
            f"have both sides finite (counted in its bound); the unfused levels (bucket_levels "
            f"over the jadd kernel, a graph) {levels_ms:.4f} ms")
    return worst, levels_ms, ec.bucket_reduce_fit(W, B)


def _jadd_shapes(torch, ec, prefix: str, seed: int, record=None) -> int:
    """`jadd` against jadd_plain at every shape of a chunk's launches and at
    2^17 lanes, P + P (twice), P + (-P) and the identity on either side and
    on both planted in lanes 0..5: a shape of fewer lanes runs over those
    lanes in turn.  With `record`, times each shape on the lanes from 16 on
    (none planted, as on the path, where P == Q is as good as never met) in
    a CUDA graph and records it; returns the largest difference."""
    e, sqr, mul = (64, 2, 3) if ec.WIDTH == 16 else (32, 1, 1)
    pq = _point_inputs(torch, ec, (1 << CHUNK_LOG) + 16, seed)
    worst = 0
    for lanes in JADD_SHAPES:
        offsets = range(0, 6, lanes) if lanes < 6 else [0]
        err = 0
        for o in offsets:
            args = tuple(a[o:o + lanes].contiguous() for a in pq)
            got = ec.jadd(*args)
            torch.cuda.synchronize()
            err = max(err, _errs(torch, got, ec.jadd_plain(*args)))
        if lanes >= 6:
            z = got[2]
            if z[2].any().item() or z[5].any().item() or not z[0].any().item():
                fail(f"{prefix}jadd: P + (-P) or inf + inf is not the identity, or P + P is")
            if not (torch.equal(got[0][3], pq[3][3]) and torch.equal(got[0][4], pq[0][4])):
                fail(f"{prefix}jadd: the identity on one side does not return the other side")
        worst = max(worst, err)
        if record is not None:  # timed past the planted lanes, as on the path
            args = tuple(a[16:16 + lanes].contiguous() for a in pq)
            record("jadd", f"{lanes} lanes", err, _graph_ms(torch, lambda: ec.jadd(*args), REPS),
                   _time_ms(torch, lambda: ec.jadd_plain(*args), 2),
                   9 * e * lanes, (5 * sqr + 11 * mul) * MONT_MUL_MADS * lanes)
    return worst


# jdbl's shapes: verify's public input (one lane, G1), the small MSM's
# 1,024 lanes (1000 points padded, G1 and G2), and 2^17
JDBL_SHAPES = (1, 1024, 1 << CHUNK_LOG)


def _jdbl_edges(fq2: bool) -> tuple:
    """The lane counts where `jdbl` changes executor (csrc/warp.cuh
    kJdblGroupLanesMax and kJdblOneThreadLanesMin, read out of the source,
    over Fe or Fe2: 0 for never), one below, at and one above each."""
    import re

    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "crescent_tpu_torch",
                            "csrc", "warp.cuh")).read()
    edges = set()
    for name in ("kJdblGroupLanesMax", "kJdblOneThreadLanesMin"):
        vals = dict(re.findall(rf"constexpr long long {name}(<Fe2>)? = (\d+);", src))
        k = int(vals.get("<Fe2>" if fq2 and "<Fe2>" in vals else "", 0))
        edges.update((k - 1, k, k + 1) if k else ())
    return tuple(sorted(e for e in edges if e > 0))


def _jdbl_check(torch, ec, pt, lanes: int):
    """jdbl on the first `lanes` of the planes pt (identities in lanes 3 and
    5) against jdbl_plain and, off the identities, against jadd(P, P) (the
    doubling on the addition's P == Q lanes); one lane runs lane 0 and the
    identity in lane 3 alone.  Returns (the largest difference, the planes
    of `lanes` lanes)."""
    err = 0
    for o in ((0, 3) if lanes == 1 else (0,)):
        pl = tuple(a[o:o + lanes].contiguous() for a in pt)
        got = ec.jdbl(*pl)
        torch.cuda.synchronize()
        err = max(err, _errs(torch, got, ec.jdbl_plain(*pl)))
        fin = pl[2].ne(0).any(dim=1)
        if fin.any().item():
            twice = ec.jadd(*pl, *pl)
            err = max(err, _errs(torch, tuple(g[fin] for g in got),
                                 tuple(w[fin] for w in twice)))
        if got[2][~fin].any().item():
            fail("jdbl: the identity does not stay the identity")
    return err, tuple(a[:lanes].contiguous() for a in pt)


def _chunk_batch_inv_shapes() -> list[int]:
    """The leaves of a chunk's 22 batch_inv calls: each of its 11 rounds'
    two pair levels, 2 mn and mn lanes (AffineMSM._round_schedule of
    2^CHUNK_LOG points at c = AFFINE_C)."""
    from crescent_tpu_torch.core.curves import BN254_G1
    from crescent_tpu_torch.ops.ec import get_curve_ctx
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    ctx = get_curve_ctx(BN254_G1)
    schedule = AffineMSM(ctx, ctx.ec, c=AFFINE_C)._round_schedule(1 << CHUNK_LOG)
    return [w for mn in schedule for w in (2 * mn, mn)]


def _batch_inv_shapes(torch, ec, d, label: str, prefix: str, out: dict) -> None:
    """`batch_inv` at the distinct shapes of a chunk's 22 calls, on the
    first rows of `d` (affine_denom output) with a zero planted in the
    second run: against batch_inv_plain and the card's own tree of `mul`
    and `inv` (the launches it replaces), the zero's run all zeros.  Times
    the kernel and the tree in CUDA graphs and sums both over a chunk.
    Bound: d read and out written once; the least work of n inverses,
    Montgomery's trick, 3 (n - 1) products and one inversion.  Apart from
    it, the inversion's latency floor: a chunk's calls run one after
    another, each behind one serial inversion (`inv` at INV_FLOOR lanes,
    timed)."""
    from crescent_tpu_torch.ops.cuda_ec import batch_inv_tree, tree_halvings

    e, mul = (64, 3) if ec.WIDTH == 16 else (32, 1)
    inv_ops = DIVSTEP_INV_OPS + (4 * MONT_MUL_MADS if ec.WIDTH == 16 else 0)
    calls = _chunk_batch_inv_shapes()
    chunk = tree_chunk = bound_chunk = 0.0
    tree_ms = {}
    for lanes in sorted(set(calls), reverse=True):
        S = 1 << tree_halvings(lanes, INV_FLOOR)
        roots = lanes // S
        x = d[:lanes].clone()
        x[S + 5] = 0
        got = ec.batch_inv(x, INV_FLOOR)
        torch.cuda.synchronize()
        tree = batch_inv_tree(ec.mul, ec.inv, x, INV_FLOOR)
        want, plain_ms = _timed_once(torch, lambda: ec.batch_inv_plain(x, INV_FLOOR))
        err = max(_errs(torch, got, want), _errs(torch, got, tree))
        if got[S:2 * S].any().item() or not got[:S].any(dim=1).all().item():
            fail(f"{prefix}batch_inv [{label}] {lanes} lanes: the zero's run is not "
                 "exactly the zeroed one")
        reps = max(10, min(REPS, (1 << 24) // lanes))
        ms = _graph_ms(torch, lambda: ec.batch_inv(x, INV_FLOOR), reps)
        tree_ms[lanes] = _graph_ms(
            torch, lambda: batch_inv_tree(ec.mul, ec.inv, x, INV_FLOOR), reps)
        _record(out, prefix + "batch_inv", label, f"{lanes} lanes", err, ms, plain_ms,
                2 * e * lanes, 3 * (lanes - 1) * mul * MONT_MUL_MADS + inv_ops)
        say(f"  {prefix}batch_inv [{label}] {lanes} lanes ({roots} roots of {S}): "
            f"the tree of mul and inv {tree_ms[lanes]:.4f} ms")
        n_calls = calls.count(lanes)
        chunk += n_calls * ms
        tree_chunk += n_calls * tree_ms[lanes]
        bound_chunk += n_calls * out[prefix + "batch_inv"][-1][4]
        del x, got, tree, want
    root = d[:INV_FLOOR].contiguous()
    inv_floor_ms = len(calls) * _graph_ms(torch, lambda: ec.inv(root), REPS)
    say(f"{prefix}batch_inv [{label}] a chunk's {len(calls)} calls: {chunk:.4f} ms "
        f"in {len(calls)} launches; the tree {tree_chunk:.4f} ms; bound {bound_chunk:.5f} ms; "
        f"the inversion's latency floor ({len(calls)} x inv at {INV_FLOOR} lanes) "
        f"{inv_floor_ms:.4f} ms")
    out[prefix + "batch_inv_tree"] = {"tree_ms": tree_ms, "chunk_ms": chunk,
                                      "tree_chunk_ms": tree_chunk,
                                      "bound_chunk_ms": bound_chunk,
                                      "inv_latency_floor_chunk_ms": inv_floor_ms}


def _affine_add_products(torch, f, pair, sqr: int, mul: int) -> int:
    """Base products that affine_add needs on these pairs: none where a
    side is invalid (the other passes through) or L == -R (the identity);
    lam, lam^2 and lam (Lx - x3) on a chord, and x^2 too on a tangent
    (L == R).  `sqr` and `mul`: base products a square and a product."""
    lx, ly, lv, rx, ry, rv = pair
    both = (lv != 0) & (rv != 0)
    same_x = f.is_zero(f.sub_mod(rx, lx))
    same_y = f.is_zero(f.sub_mod(ry, ly))
    chord = int((both & ~same_x).sum().item())
    tangent = int((both & same_x & same_y).sum().item())
    return chord * (sqr + 2 * mul) + tangent * (2 * sqr + 2 * mul)


def _point_kernel_checks(torch, ec, label: str, prefix: str, seed: int, batch_inv,
                         out: dict) -> None:
    """The MSM path's point kernels of one field against their plain
    versions, with the cases planted: affine_denom and affine_add at 2^21
    lanes (the first pair level of a chunk), jadd at every shape of a
    chunk's launches and at 2^17, jdbl at 2^17, jdbl_n at the window combine's five
    shapes (16 lanes x 11 .. 1 lane x 176; then 100 lanes x 0, 1 and 3),
    bucket_reduce on the fused aggregate's (W * B)-row table and at
    BUCKET_SHAPES, also against the card's unfused levels.
    Bounds count an element's bytes (32 over Fq, 64 over Fq2) and its base
    products (a square and a product are 1 and 1 over Fq, 2 and 3 over
    Fq2)."""
    f = ec.ctx
    one = f.one_mont("cuda")
    fq2 = ec.WIDTH == 16
    e, sqr, mul = (64, 2, 3) if fq2 else (32, 1, 1)
    n = 1 << LOG_SIZE
    nck = 1 << CHUNK_LOG

    def record(name, *row):
        _record(out, prefix + name, label, *row)

    # -- affine_denom, affine_add: 2^21 lanes ----------------------------------
    pair = _pair_inputs(torch, ec, n, seed)
    d = ec.affine_denom(*pair)
    torch.cuda.synchronize()
    err = _errs(torch, d, ec.affine_denom_plain(*pair))
    if d[:7].ne(torch.cat([f.add_mod(pair[1][:1], pair[1][:1])] + [one] * 6)).any().item():
        fail(f"{prefix}affine_denom: a planted case has the wrong denominator")
    record("affine_denom", f"2^{LOG_SIZE} lanes", err,
           _time_ms(torch, lambda: ec.affine_denom(*pair), REPS),
           _time_ms(torch, lambda: ec.affine_denom_plain(*pair), 2), (5 * e + 8) * n, 0)
    _batch_inv_shapes(torch, ec, d, label, prefix, out)
    inv = batch_inv(ec, d)
    torch.cuda.synchronize()
    if not (ec.mul(d, inv) == one).all().item():
        fail(f"batch_inv [{label}]: d * inv(d) is not Montgomery 1")
    got = ec.affine_add(*pair, inv)
    torch.cuda.synchronize()
    err = _errs(torch, got, ec.affine_add_plain(*pair, inv))
    if got[2][:7].tolist() != [1, 0, 1, 1, 0, 1, 1]:
        fail(f"{prefix}affine_add: planted cases give valid flags {got[2][:7].tolist()}")
    record("affine_add", f"2^{LOG_SIZE} lanes", err,
           _graph_ms(torch, lambda: ec.affine_add(*pair, inv), 20),
           _time_ms(torch, lambda: ec.affine_add_plain(*pair, inv), 2),
           (7 * e + 12) * n, _affine_add_products(torch, f, pair, sqr, mul) * MONT_MUL_MADS)
    # a chunk's 22 pair-level calls (2 mn and mn lanes a round), the cases
    # of the first warps planted in each, timed as one CUDA graph of the 22
    widths = _chunk_batch_inv_shapes()
    calls = [tuple(a[:w] for a in pair) + (inv[:w],) for w in widths]
    err = plain_ms = nbytes = products = 0
    for w, args in zip(widths, calls):
        want, ms = _timed_once(torch, lambda: ec.affine_add_plain(*args))
        err = max(err, _errs(torch, ec.affine_add(*args), want))
        plain_ms += ms
        nbytes += (7 * e + 12) * w
        products += _affine_add_products(torch, f, args[:6], sqr, mul)
    record("affine_add", f"a chunk's {len(widths)} calls", err,
           _graph_ms(torch, lambda: [ec.affine_add(*args) for args in calls], 5), plain_ms,
           nbytes, products * MONT_MUL_MADS)
    del d, inv, pair, got, calls

    # -- jadd: every shape of a chunk's launches, and 2^17 lanes --------------
    _jadd_shapes(torch, ec, prefix, seed + 10, record)

    # -- jdbl: its callers' shapes (verify's one lane, the small MSM's 1,024)
    #    and 2^17 lanes; jdbl_n: the window combine's shapes ----------------
    dbl = (7 * sqr + mul) * MONT_MUL_MADS
    pt = _point_inputs(torch, ec, nck, seed + 20)[:3]
    # the caller's shape first: verify's one lane over Fq, the small G2
    # MSM's 1,024 lanes over Fq2
    for lanes in sorted(JDBL_SHAPES, key=lambda w: (w != 1024) if fq2 else 0):
        err, pl = _jdbl_check(torch, ec, pt, lanes)
        if err:
            fail(f"{prefix}jdbl differs from its plain version or from jadd(P, P) at {lanes} "
                 "lanes")
        record("jdbl", f"{lanes} lane{'s' * (lanes > 1)}", err,
               _graph_ms(torch, lambda: ec.jdbl(*pl), REPS),
               _time_ms(torch, lambda: ec.jdbl_plain(*pl), 2), 6 * e * lanes, dbl * lanes)
    # and one below, at and one above each switch of its executors
    edges = _jdbl_edges(fq2)
    err = max(_jdbl_check(torch, ec, pt, lanes)[0] for lanes in edges)
    say(f"  {prefix}jdbl at its executors' switches, {', '.join(map(str, edges))} lanes: "
        f"max_abs_err={err}")
    if err:
        fail(f"{prefix}jdbl differs from its plain version or from jadd(P, P) at a switch")
    # the window combine's five launches a chunk: 16 lanes x c doublings down
    # to 1 lane x 16c (lanes 3 and 5 are identities, Z = 0, as the
    # combine's padding rows are); then counts 0 and 1, and 100 lanes.  The
    # Fq2 doubling of warp.cuh takes 16 base products (five squares and
    # two products: Z3 = 2 Y Z, as a == 0 allows)
    dbl_n = (5 * sqr + 2 * mul) * MONT_MUL_MADS if fq2 else dbl
    for lanes, count in FOLD_DBL_SHAPES:
        pl = tuple(a[:lanes].contiguous() for a in pt)
        got = ec.jdbl_n(*pl, count)
        torch.cuda.synchronize()
        want, plain_ms = _timed_once(torch, lambda: ec.jdbl_n_plain(*pl, count))
        record("jdbl_n", f"{lanes} lanes x {count}", _errs(torch, got, want),
               _time_ms(torch, lambda: ec.jdbl_n(*pl, count), 20), plain_ms,
               6 * e * lanes, dbl_n * lanes * count)
    p100 = tuple(a[:100].contiguous() for a in pt)
    err = max(_errs(torch, ec.jdbl_n(*p100, count), ec.jdbl_n_plain(*p100, count))
              for count in (0, 1, 3))
    if err:
        fail(f"{prefix}jdbl_n differs from its plain version at 100 lanes x 0, 1 or 3")

    # -- bucket_reduce: the fused aggregate's table, W = 25 windows of B = 1025
    _, levels_ms, fit = _bucket_reduce_checks(torch, ec, label, prefix, seed, record)
    out[prefix + "bucket_reduce_levels"] = {"levels_ms": levels_ms, **fit}
    say(f"  {prefix}bucket_reduce [{label}]: clusters of {fit['cluster']} blocks of "
        f"{fit['threads']} threads, {fit['smem_bytes']} B of shared memory a block; the card "
        f"holds {fit['max_active_clusters']} such clusters at once")
    if fit["max_active_clusters"] < 1:
        fail(f"{prefix}bucket_reduce [{label}]: its cluster does not fit the card")


def ec_kernel_phase(torch, fields, get_cuda_ec, batch_inv) -> dict:
    """The point kernels and `batch_inv` against their plain versions over
    BN254 Fq at the MSM path's shapes, and once over a curve with a != 0."""
    p = fields.BN254_FQ
    ec = get_cuda_ec(p, 0)
    ctx = ec.ctx
    one = ctx.one_mont("cuda")
    out = {}

    # -- inv: 512 lanes, a root level of the tree that batch_inv replaces ----
    x = _rand_elems(torch, 512, p, SEED + 20)
    x[:10] = ctx.words([0, 1, p - 1, ctx.r_mod_n] + [1 << k for k in (1, 31, 32, 64, 128, 253)],
                       "cuda")
    got = ec.inv(x)
    torch.cuda.synchronize()
    want = ec.inv_plain(x)
    err = _errs(torch, got, want)
    # x * x^-1 == 1 where x != 0, 0 -> 0
    prod = ec.mul(x, got)
    if not (prod[1:] == one).all().item() or prod[0].any().item():
        fail("inv: x * inv(x) is not Montgomery 1 (or inv(0) is not 0)")
    _record(out, "inv", "BN254 Fq", "512 lanes", err, _time_ms(torch, lambda: ec.inv(x), 20),
            _time_ms(torch, lambda: ec.inv_plain(x), 1), 64 * 512, 512 * DIVSTEP_INV_OPS)

    _point_kernel_checks(torch, ec, "BN254 Fq", "", SEED + 30, batch_inv, out)

    # -- a != 0: the a-terms of jdbl, jdbl_n and affine_add (and jadd's
    #    doubling branch), over BN254 Fq with an arbitrary a ------------------
    eca = get_cuda_ec(p, 0x1234567)
    na = 1 << 14
    pt = _point_inputs(torch, eca, na, SEED + 60)
    pair = _pair_inputs(torch, eca, na, SEED + 70)
    inv = batch_inv(eca, eca.affine_denom(*pair))
    pt17 = _point_inputs(torch, eca, 1 << CHUNK_LOG, SEED + 65)[:3]
    err = max(
        *(_jdbl_check(torch, eca, pt17, lanes)[0]
          for lanes in sorted(set(JDBL_SHAPES) | set(_jdbl_edges(False)))),
        _errs(torch, eca.jdbl_n(*pt[:3], 3), eca.jdbl_n_plain(*pt[:3], 3)),
        _errs(torch, eca.jadd(*pt), eca.jadd_plain(*pt)),
        _errs(torch, eca.affine_add(*pair, inv), eca.affine_add_plain(*pair, inv)),
        _jadd_shapes(torch, eca, "a != 0: ", SEED + 80),
        _bucket_reduce_checks(torch, eca, "BN254 Fq, a != 0", "", SEED + 85)[0],
    )
    if torch.equal(eca.jdbl(*pt[:3])[0], ec.jdbl(*pt[:3])[0]):
        fail("a != 0 does not reach the doubling")
    say(f"kernels jdbl_n, jadd, affine_add [BN254 Fq, a = 0x1234567] 2^14 lanes, jdbl at "
        f"{', '.join(map(str, sorted(set(JDBL_SHAPES) | set(_jdbl_edges(False)))))} lanes, "
        "jadd at the chunk's shapes and "
        f"2^{CHUNK_LOG}, bucket_reduce at the fused aggregate's 25 x 1025: max_abs_err={err}")
    if err:
        fail("a kernel differs from its plain version over a curve with a != 0")
    return out


def _madd_inputs(torch, f, elems, n: int, seed: int):
    """Jacobian P, affine Q and flags for madd, n lanes, seeded, with the
    cases planted in lanes 0..6: P == Q, P == -Q, P the identity,
    valid == 0, sign with -Q == P (the doubling), sign with -Q == -P (the
    identity), sign generic; elsewhere valid is 0 for about one lane in 64
    and sign is seeded.  `elems(seed)` gives (n, W) canonical elements."""
    import numpy as np

    x1, y1, z1, qx, qy = (elems(seed + k) for k in range(5))
    for lane, neg in ((0, False), (1, True), (4, True), (5, False)):
        z = z1[lane : lane + 1]
        z2 = f.mont_sqr(z)
        x1[lane : lane + 1] = f.mont_mul(qx[lane : lane + 1], z2)
        y = f.mont_mul(qy[lane : lane + 1], f.mont_mul(z2, z))
        y1[lane : lane + 1] = f.neg_mod(y) if neg else y
    z1[2] = 0
    rng = np.random.default_rng(seed + 9)
    valid = torch.from_numpy((rng.integers(0, 64, size=n) != 0).astype(np.int32)).cuda()
    sign = torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)).cuda()
    valid[:7] = torch.tensor([1, 1, 1, 0, 1, 1, 1], dtype=torch.int32)
    sign[:7] = torch.tensor([0, 0, 0, 0, 1, 1, 1], dtype=torch.int32)
    return x1, y1, z1, qx, qy, valid, sign


def _madd_products(torch, f, args, sqr: int, mul: int, a_terms: int) -> int:
    """Base-field products this run's madd inputs need, lane by lane: none
    where valid == 0 or P is the identity (the sum is Q, copied); the first
    square and three products (Z1^2, U2, S2) and the doubling's six squares
    and one product (plus `a_terms` for a != 0) where P == Q; the first four
    and the addition's three squares and four products elsewhere (P == -Q
    too).  `sqr` and `mul` count base products per field square and product
    (1 and 1 over Fq; 2 and 3 over Fq2)."""
    x1, y1, z1, qx, qy, valid, sign = args
    qy = f.select(sign != 0, f.neg_mod(qy), qy)
    zz = f.mont_sqr(z1)
    h = f.is_zero(f.sub_mod(f.mont_mul(qx, zz), x1))
    r = f.is_zero(f.sub_mod(f.mont_mul(f.mont_mul(qy, z1), zz), y1))
    inf = f.is_zero(z1)
    v = valid != 0
    first = sqr + 3 * mul
    n_inf = int((v & inf).sum().item())
    n_dbl = int((v & ~inf & h & r).sum().item())
    n_add = int(v.sum().item()) - n_inf - n_dbl
    return n_dbl * (first + 6 * sqr + mul + a_terms) + n_add * (first + 3 * sqr + 4 * mul)


def _fixed_base_scalars(torch, n: int, order: int, seed: int):
    """n standard-form scalar words on the card: seeded, with 0, 1, n - 1
    and (n + 1) / 2 first and two zero bytes (digits) in every eighth."""
    from crescent_tpu_torch.ops import limb

    import numpy as np

    w = _rand_scalars(n, order, seed)
    w[:4] = limb.limbs_to_u64(limb.ints_to_limbs([0, 1, order - 1, (order + 1) // 2]))
    b = w.view("u1").reshape(n, 32)
    rows = np.arange(4, n, 8)
    b[rows, rows % 30] = 0
    b[rows, rows % 30 + 1] = 0
    return limb.u64_to_words(w, "cuda")


def _setup_batch_scalars(torch, n: int, order: int, sparse: bool, seed: int):
    """n scalar words like those of a setup's batch on dummy_circuit: seeded
    (G1's), or (`sparse`, G2's: the circuit's B column holds one nonzero
    entry, variable b) zero but for lane 3 and the last three (beta, 1,
    delta)."""
    from crescent_tpu_torch.ops import limb

    if not sparse:
        return _fixed_base_scalars(torch, n, order, seed)
    import numpy as np

    w = np.zeros((n, 4), dtype=np.uint64)
    w[[3, n - 3, n - 1]] = _rand_scalars(3, order, seed + 1)
    w[n - 2, 0] = 1
    return limb.u64_to_words(w, "cuda")


def _fixed_base_products(torch, ec, table, sc, sqr: int, mul: int, a_terms: int) -> int:
    """Base-field products the fixed base's 32 windows need on these inputs:
    _madd_products over each window's madd, along the plain chain of row
    gathers and madd_plain (fixed_base_plain's)."""
    from crescent_tpu_torch.ops.cuda_ec import fixed_base_windows

    total = 0

    def madd(*args):
        nonlocal total
        total += _madd_products(torch, ec.ctx, args, sqr, mul, a_terms)
        return ec.madd_plain(*args)

    fixed_base_windows(madd, table, sc)
    return total


def _fixed_base_checks(torch, ec, name: str, label: str, tables: dict, sc, sqr: int,
                       mul: int, a_terms: int, out: dict) -> None:
    """The window kernel against fixed_base_plain on each of `tables` (the
    first, the real one, timed with its bound), one launch each; on the
    real table the plain chain's count of products must be
    fixed_base_adds's."""
    W = ec.WIDTH
    n = sc.shape[0]
    for k, (tname, table) in enumerate(tables.items()):
        before = ec.fixed_base_launches
        got = ec.fixed_base(table, sc)
        torch.cuda.synchronize()
        if ec.fixed_base_launches != before + 1:
            fail(f"{name} [{label}, {tname}]: not one launch")
        want = ec.fixed_base_plain(table, sc)
        err = _errs(torch, got, want)
        shape = f"2^{FB_CHUNK_LOG} lanes x 32 windows"
        if k:
            say(f"kernel {name} [{label}] {shape}, {tname}: max_abs_err={err}")
            if err:
                fail(f"{name} [{label}, {tname}] differs from fixed_base_plain")
            continue
        products = _fixed_base_products(torch, ec, table, sc, sqr, mul, a_terms)
        adds = fixed_base_adds(torch, sc)
        if products != adds * (4 * sqr + 7 * mul):
            fail(f"{name} [{label}]: the plain chain's {products} products are not "
                 f"fixed_base_adds's {adds} additions")
        _record(out, name, f"{label}, {tname}", shape, err,
                _time_ms(torch, lambda: ec.fixed_base(table, sc), 20),
                _time_ms(torch, lambda: ec.fixed_base_plain(table, sc), 1),
                *fixed_base_cost(n, W, adds))


def _fixed_base_batch(torch, ec, name: str, label: str, table, sc, out: dict) -> None:
    """The window kernel at one of setup's batches, one launch, against
    fixed_base_plain on a strided sample of its lanes (the first, the last
    and the nonzero scalars of a sparse batch among them: the plain chain
    is lane by lane, so these are the same inputs); timed with its bound."""
    import numpy as np

    n = sc.shape[0]
    before = ec.fixed_base_launches
    got = ec.fixed_base(table, sc)
    torch.cuda.synchronize()
    if ec.fixed_base_launches != before + 1:
        fail(f"{name} [{label}] at {n} lanes: not one launch")
    lanes = set(np.linspace(0, n - 1, 4096).astype(np.int64).tolist()) | {
        0, 1, 2, 3, n - 3, n - 2, n - 1}
    idx = torch.tensor(sorted(lanes), dtype=torch.int64, device="cuda")
    sub = sc[idx]
    want, plain_ms = _timed_once(torch, lambda: ec.fixed_base_plain(table, sub))
    err = _errs(torch, tuple(g[idx] for g in got), want)
    del got
    adds = fixed_base_adds(torch, sc)
    _record(out, name, label, f"setup's batch of {n} lanes x 32 windows, {adds} additions "
            f"(plain: {len(idx)} sampled lanes)", err,
            _time_ms(torch, lambda: ec.fixed_base(table, sc), 5), plain_ms,
            *fixed_base_cost(n, ec.WIDTH, adds))


def setup_kernel_phase(torch, fields, curves, nb, get_cuda_ec, get_cuda_quad_ec,
                       batch_inv) -> dict:
    """The kernels of setup's fixed base against their plain versions: the
    window kernel `fixed_base` over Fq (a = 0 on G1's table and the planted
    ones, a != 0 on seeded rows) and over Fq2 (G2's) at 2^16 lanes x 32
    windows, and at setup's two batches on dummy_circuit(LOG_SIZE) (G1's
    seeded, G2's as sparse as a setup's) on a sample of their lanes; madd
    over Fq (a = 0 and a != 0) and Fq2 at 2^16 lanes (its lane body), and
    over Fq2 mul at 2^22 lanes and inv at 512 lanes."""
    from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx
    from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM

    p = fields.BN254_FQ
    out = {}
    nm = 1 << FB_CHUNK_LOG

    # -- fixed_base: a table of G1 (or G2) multiples, and two planted ones:
    # every row G (the second valid window doubles) and G in even windows,
    # -G in odd ones (sums at the identity mid-chain)
    for name, ctx, curve, g, native, costs in (
            ("fixed_base", get_curve_ctx(curves.BN254_G1), curves.BN254_G1,
             curves.BN254_G1.generator, lambda b, ks: nb.fixed_base("bn254_g1", b, ks),
             (1, 1, 0)),
            ("fq2_fixed_base", get_g2_ctx(), curves.BN254G2, curves.BN254G2.generator(),
             nb.fixed_base_g2, (2, 3, 0))):
        fb = FixedBaseMSM(ctx)
        tables = {"real table": fb.table_planes(native(g, fb.table_scalars()), "cuda"),
                  "every row G": fb.table_planes([g] * 8192, "cuda"),
                  "G and -G": fb.table_planes([g if i // 256 % 2 == 0 else curve.neg(g)
                                               for i in range(8192)], "cuda")}
        sc = _fixed_base_scalars(torch, nm, ctx.n, SEED + 160)
        label = "BN254 Fq2" if ctx.quad else "BN254 Fq"
        _fixed_base_checks(torch, ctx.ec, name, label, tables, sc, *costs, out)
        # setup's batch on dummy_circuit(LOG_SIZE), on the real table
        nbatch = setup_batches(LOG_SIZE)[1 if ctx.quad else 0]
        sc = _setup_batch_scalars(torch, nbatch, ctx.n, ctx.quad, SEED + 164)
        _fixed_base_batch(torch, ctx.ec, name, label, tables["real table"], sc, out)
        del sc, tables
    # a != 0: seeded rows (the formulas hold for any elements), and one row
    # repeated (P == Q at the second valid window)
    ec = get_cuda_ec(p, 0x1234567)
    rows = torch.cat([_rand_elems(torch, 8192, p, SEED + 161),
                      _rand_elems(torch, 8192, p, SEED + 162)], dim=1)
    sc = _fixed_base_scalars(torch, 1 << 12, curves.BN254_G1.n, SEED + 163)
    for tname, table in (("seeded rows", rows), ("one row", rows[:1].expand(8192, -1))):
        table = table.contiguous()
        err = _errs(torch, ec.fixed_base(table, sc), ec.fixed_base_plain(table, sc))
        say(f"kernel fixed_base [BN254 Fq, a = 0x1234567] 2^12 lanes x 32 windows, {tname}: "
            f"max_abs_err={err}")
        if err:
            fail(f"fixed_base [a != 0, {tname}] differs from fixed_base_plain")

    def check_madd(name, label, ec, args, width, sqr, mul, a_terms, time_it):
        # Q as the halves of gathered [x | y] rows, as the fixed base passes it
        q = torch.cat([args[3], args[4]], dim=1)
        strided = args[:3] + (q[:, :width], q[:, width:]) + args[5:]
        got = ec.madd(*strided)
        torch.cuda.synchronize()
        want = ec.madd_plain(*args)
        err = _errs(torch, got, want)
        z = got[2]
        if z[1].any().item() or z[5].any().item() or not z[4].any().item():
            fail(f"{name} [{label}]: P + (-P) is not the identity or P + P is")
        if not torch.equal(got[0][3], args[0][3]):
            fail(f"{name} [{label}]: a lane with valid == 0 does not pass P through")
        if not time_it:
            say(f"kernel {name} [{label}] 2^{FB_CHUNK_LOG} lanes: max_abs_err={err}")
            if err:
                fail(f"{name} [{label}] differs from its plain version")
            return
        mads = _madd_products(torch, ec.ctx, args, sqr, mul, a_terms) * MONT_MUL_MADS
        _record(out, name, label, f"2^{FB_CHUNK_LOG} lanes", err,
               _time_ms(torch, lambda: ec.madd(*strided), REPS),
               _time_ms(torch, lambda: ec.madd_plain(*args), 2),
               (5 * 4 * width + 8 + 3 * 4 * width) * nm, mads)

    # -- madd over Fq: the G1 fixed base's accumulation ---------------------
    for a in (0, 0x1234567):
        ec = get_cuda_ec(p, a)
        args = _madd_inputs(torch, ec.ctx, lambda sd: _rand_elems(torch, nm, p, sd),
                            nm, SEED + 90)
        check_madd("madd", "BN254 Fq" + (f", a = {a:#x}" if a else ""), ec, args, 8,
                   1, 1, 2, time_it=a == 0)

    # -- Fq2: mul at 2^22 lanes, inv at 512, madd at 2^16 --------------------
    ec2 = get_cuda_quad_ec(p)
    f2 = ec2.ctx
    label = "BN254 Fq2"

    def elems2(n, seed):
        return _rand_elems2(torch, n, p, seed)

    def edges2(first: bool):
        vals = [fields.Fq2(0, 0), fields.Fq2(1, 0), fields.Fq2(p - 1, 0), fields.Fq2(0, 1)]
        return f2.words([vals[i // 4] if first else vals[i % 4] for i in range(16)], "cuda")

    nq = 1 << (LOG_SIZE + 1)
    x, y = elems2(nq, SEED + 100), elems2(nq, SEED + 101)
    x[:16], y[:16] = edges2(True), edges2(False)
    got = ec2.mul(x, y)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, got, ec2.mul_plain(x, y))
    # the product tree's strided rows
    half = torch.empty((nq // 2, 16), dtype=torch.int32, device="cuda")
    ec2.mul(x[0::2], x[1::2], out=half)
    err = max(err, _max_abs_err(torch, half, ec2.mul_plain(x[0::2], x[1::2])))
    _record(out, "fq2_mul", label, f"2^{LOG_SIZE + 1} lanes", err,
           _time_ms(torch, lambda: ec2.mul(x, y, out=got), REPS),
           _time_ms(torch, lambda: ec2.mul_plain(x, y), 1),
           192 * nq, 3 * MONT_MUL_MADS * nq)
    del x, y, got, half

    # the divsteps on the norm x0^2 + x1^2: (0, 0) first, then the norm's
    # edges (1, 0), (0, 1), (p-1, 0), (0, p-1), Montgomery 1, (a, a),
    # (a, p-a) and 2^k in c0 and in c1
    z = elems2(512, SEED + 110)
    a = 0x1234567890ABCDEF
    ks = (1, 31, 32, 64, 128, 253)
    z[:20] = f2.words([fields.Fq2(0, 0), fields.Fq2(1, 0), fields.Fq2(0, 1),
                       fields.Fq2(p - 1, 0), fields.Fq2(0, p - 1),
                       fields.Fq2(f2.base.r_mod_n, 0), fields.Fq2(a, a), fields.Fq2(a, p - a)]
                      + [fields.Fq2(1 << k, 0) for k in ks]
                      + [fields.Fq2(0, 1 << k) for k in ks], "cuda")
    got = ec2.inv(z)
    torch.cuda.synchronize()
    err = _errs(torch, got, ec2.inv_plain(z))
    if got[0].any().item() or not (ec2.mul(z[1:], got[1:]) == f2.one_mont("cuda")).all().item():
        fail("fq2_inv: x * inv(x) is not Montgomery 1 (or inv(0) is not 0)")
    # a lane: the divsteps on the norm, and its two squares and two products
    _record(out, "fq2_inv", label, "512 lanes", err, _time_ms(torch, lambda: ec2.inv(z), 20),
           _time_ms(torch, lambda: ec2.inv_plain(z), 1), 128 * 512,
           512 * (DIVSTEP_INV_OPS + 4 * MONT_MUL_MADS))
    d = elems2(1 << 14, SEED + 111)
    if not (ec2.mul(d, batch_inv(ec2, d)) == f2.one_mont("cuda")).all().item():
        fail("batch_inv over Fq2: d * inv(d) is not Montgomery 1")

    args = _madd_inputs(torch, f2, lambda sd: elems2(nm, sd), nm, SEED + 120)
    check_madd("fq2_madd", label, ec2, args, 16, 2, 3, 0, time_it=True)

    # -- Fq2 butterfly: 2^20 pairs (no caller on the path) -------------------
    nb_ = 1 << (LOG_SIZE - 1)
    a, b, tw = (elems2(nb_, SEED + 125 + k) for k in range(3))
    a[:16], b[:16], tw[:16] = edges2(False), edges2(True), edges2(False)
    got = ec2.butterfly(a, b, tw)
    torch.cuda.synchronize()
    _record(out, "fq2_butterfly", label, f"2^{LOG_SIZE - 1} pairs",
            _errs(torch, got, ec2.butterfly_plain(a, b, tw)),
            _time_ms(torch, lambda: ec2.butterfly(a, b, tw), REPS),
            _time_ms(torch, lambda: ec2.butterfly_plain(a, b, tw), 2),
            5 * 64 * nb_, 3 * MONT_MUL_MADS * nb_)
    return out


def fixed_base_phase(torch, curves, nb) -> None:
    """One FixedBaseMSM run per group of 2^17 scalars (two of the
    reference's chunks) on the card; 4,096 sampled rows
    against the native fixed base on the same scalars."""
    from crescent_tpu_torch.ops import limb
    from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx
    from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM

    n = 2 << FB_CHUNK_LOG
    for label, ctx, base, native in (
            ("G1", get_curve_ctx(curves.BN254_G1), curves.BN254_G1.generator,
             lambda b, ks: nb.fixed_base("bn254_g1", b, ks)),
            ("G2", get_g2_ctx(), curves.BN254G2.generator(), nb.fixed_base_g2)):
        rng = random.Random(SEED + 130)
        ks = [rng.randrange(ctx.n) for _ in range(n)]
        ks[:4] = [0, 1, ctx.n - 1, (ctx.n + 1) // 2]
        fb = FixedBaseMSM(ctx)
        table = native(base, fb.table_scalars())
        limbs = limb.ints_to_limbs(ks)
        fb.run(table, limbs[: 1 << FB_CHUNK_LOG], "cuda")  # warm: allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fb.run(table, limbs, "cuda")
        run_s = time.perf_counter() - t0
        rows = sorted(set(range(4)) | set(rng.sample(range(n), 4092)))
        want = native(base, [ks[i] for i in rows])
        if [res[i] for i in rows] != want or not res.inf[0] or res.inf[1:].any():
            fail(f"FixedBaseMSM {label} of 2^{FB_CHUNK_LOG + 1} scalars differs from the "
                 "native fixed base")
        say(f"fixed base {label}: 2^{FB_CHUNK_LOG + 1} scalars on the card in {run_s:.3f} s "
            f"(upload, one fixed_base launch, affine conversion, download); {len(rows)} "
            "sampled rows equal the native fixed base")


def _keys_differ(a, b) -> str | None:
    """The first table or key element in which two proving keys differ
    (lists and ArrayPointVecs compare by value), or None."""
    for f in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query", "beta_g1",
              "delta_g1"):
        if getattr(a, f) != getattr(b, f):
            return f
    for f in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2", "gamma_abc_g1"):
        if getattr(a.vk, f) != getattr(b.vk, f):
            return "vk." + f
    return None


def setup_crosscheck(torch, groth16) -> None:
    """dummy_circuit(SETUP_LOG): the device branch's key equals the native
    branch's, table for table, from one seed."""
    r1cs, _ = groth16.dummy_circuit(SETUP_LOG, random.Random(SEED + 140))
    t0 = time.perf_counter()
    pk_dev = groth16.setup(r1cs, random.Random(SEED + 141), device="cuda")
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk_nat = _with_env("CRESCENT_SETUP_TPU", "0",
                       lambda: groth16.setup(r1cs, random.Random(SEED + 141), device="cuda"))
    nat_s = time.perf_counter() - t0
    from crescent_tpu_torch.utils.pointvec import ArrayPointVec

    if not isinstance(pk_dev.a_query, ArrayPointVec):
        fail("setup of dummy_circuit(14) on the card did not take the device branch")
    diff = _keys_differ(pk_dev, pk_nat)
    if diff:
        fail(f"setup cross-check: {diff} of the device branch differs from the native one")
    say(f"setup cross-check dummy_circuit({SETUP_LOG}) ({r1cs.num_vars} vars): device branch "
        f"{dev_s:.3f} s, native branch {nat_s:.3f} s, keys equal table for table")


def msm_phase(torch, curves, nb) -> dict:
    """One chunk-sized MSM on the card against the native host MSM, and a
    small one on the card against the plain versions on the CPU."""
    import numpy as np

    from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, points_valid
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    G1 = curves.BN254_G1
    ctx = get_curve_ctx(G1)
    rng = random.Random(SEED + 80)
    n = 1 << CHUNK_LOG
    pts = nb.fixed_base("bn254_g1", G1.generator,
                        [rng.randrange(1, G1.n) for _ in range(n)])
    ks = [rng.randrange(G1.n) for _ in range(n)]
    pts[5] = None                      # an identity in the table
    ks[6] = 0                          # a zero scalar
    ks[7] = G1.n - 1                   # -1
    pts[9], ks[9] = pts[8], ks[8]      # the same point twice in a bucket: L == R
    pts[11], ks[11] = G1.neg(pts[10]), ks[10]  # and its negative: L == -R
    P = ctx.points_to_device(pts, "cuda")
    valid = torch.from_numpy(points_valid(pts)).cuda()
    sc = ctx.fctx.words(ks, "cuda")
    am = AffineMSM(ctx, ctx.ec, c=AFFINE_C)
    am.run(P.x, P.y, valid, sc)        # warm: allocator, constant tables
    torch.cuda.synchronize()
    # nothing in a chunk may wait for the card: PyTorch raises if it does
    torch.cuda.set_sync_debug_mode("error")
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = am.run(P.x, P.y, valid, sc)
        end.record()
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    chunk_ms = start.elapsed_time(end)
    got = ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]
    t0 = time.perf_counter()
    want = nb.msm("bn254_g1", ks, pts)
    native_s = time.perf_counter() - t0
    if got != want:
        fail(f"AffineMSM of 2^{CHUNK_LOG} points differs from the native host MSM")
    say(f"msm 2^{CHUNK_LOG} points (c={AFFINE_C}) on the card: equals the native MSM; "
        f"{chunk_ms:.3f} ms on the card, {enqueue_s * 1e3:.3f} ms to enqueue, no "
        f"synchronisation; native host MSM {native_s * 1e3:.1f} ms")

    ns = 512
    small = AffineMSM(ctx, ctx.ec, c=5)
    args = (P.x[:ns], P.y[:ns], valid[:ns], sc[:ns])
    on_card = small.run(*args)
    on_cpu = small.run(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        fail("AffineMSM of 512 points: the card's (x, y, z) differ from the CPU's")
    small_pt = ctx.points_to_host(JPoints(*(a[None] for a in on_card)))[0]
    if small_pt != nb.msm("bn254_g1", ks[:ns], pts[:ns]):
        fail("AffineMSM of 512 points differs from the native host MSM")
    say(f"msm {ns} points (c=5): (x, y, z) bit-equal on the card and on the CPU "
        "(plain versions), equals the native MSM")
    return {"chunk_ms": chunk_ms, "enqueue_ms": enqueue_s * 1e3}


def _g2_points_on_card(torch, nb, ctx, n: int, seed: int):
    """n random G2 points, made on the card by the ported G2 fixed base from
    seeded scalars in [1, r), as an ArrayPointVec."""
    from crescent_tpu_torch.ops import limb
    from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM

    fb = FixedBaseMSM(ctx)
    table = nb.fixed_base_g2(ctx.curve.generator(), fb.table_scalars())
    words = _rand_scalars(n, ctx.n, seed)
    words[:, 0] |= 1  # never 0: every point is finite
    return fb.run(table, limb.u64_to_limbs(words), "cuda")


def _rand_scalars(n: int, order: int, seed: int):
    """(n, 4) u64 standard-form scalars below `order`, from a numpy seed (the
    top word drawn below the order's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64) * 2 + rng.integers(
        0, 2, size=(n, 4), dtype=np.uint64)
    w[:, 3] = rng.integers(0, order >> 192, size=n, dtype=np.uint64)
    return w


def g2_msm_phase(torch, curves, nb) -> dict:
    """The G2 MSM of prove on the card against the native host G2 MSM: one
    2^17-point chunk (c = 11) with the cases planted, under PyTorch's
    synchronisation check, and get_g2_msm's run_device of 2^21 points (16
    chunks added by the Fq2 jadd)."""
    import numpy as np

    from crescent_tpu_torch.ops import limb
    from crescent_tpu_torch.ops.ec import JPoints, get_g2_ctx, points_valid
    from crescent_tpu_torch.ops.msm import get_g2_msm
    from crescent_tpu_torch.ops.msm_affine import AffineMSM
    from crescent_tpu_torch.utils.pointvec import ArrayPointVec

    G2 = curves.BN254G2
    ctx = get_g2_ctx()
    n = 1 << CHUNK_LOG
    t0 = time.perf_counter()
    pts = _g2_points_on_card(torch, nb, ctx, n, SEED + 180)
    make_s = time.perf_counter() - t0
    words = _rand_scalars(n, ctx.n, SEED + 181)
    pts.inf[5] = True                          # an identity in the table
    pts.xs[5] = pts.ys[5] = 0
    words[6] = 0                               # a zero scalar
    words[7] = np.frombuffer((ctx.n - 1).to_bytes(32, "little"), dtype="<u8")  # -1
    pts.xs[9], pts.ys[9], words[9] = pts.xs[8], pts.ys[8], words[8]  # L == R in a bucket
    neg = ArrayPointVec.from_points([G2.neg(pts[10])], g2=True)
    pts.xs[11], pts.ys[11], words[11] = pts.xs[10], neg.ys[0], words[10]  # and L == -R
    P = ctx.points_to_device(pts, "cuda")
    valid = torch.from_numpy(points_valid(pts)).cuda()
    sc = limb.u64_to_words(words, "cuda")
    am = AffineMSM(ctx, ctx.ec, c=AFFINE_C)
    am.run(P.x, P.y, valid, sc)        # warm: allocator, constant tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    # nothing in a chunk may wait for the card: PyTorch raises if it does
    torch.cuda.set_sync_debug_mode("error")
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = am.run(P.x, P.y, valid, sc)
        end.record()
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    chunk_ms = start.elapsed_time(end)
    peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    got = ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]
    t0 = time.perf_counter()
    want = nb.msm_g2_raw(words, pts.to_u64())
    native_s = time.perf_counter() - t0
    if got != want:
        fail(f"G2 AffineMSM of 2^{CHUNK_LOG} points differs from the native host G2 MSM")
    say(f"g2 msm 2^{CHUNK_LOG} points (c={AFFINE_C}) on the card: equals the native G2 MSM; "
        f"{chunk_ms:.3f} ms on the card, {enqueue_s * 1e3:.3f} ms to enqueue, no "
        f"synchronisation, peak {peak_mib:.0f} MiB above its inputs; native host G2 MSM "
        f"{native_s * 1e3:.1f} ms; its points made on the card in {make_s:.3f} s")
    del P, valid, sc, res, pts

    # -- get_g2_msm().run_device: 2^21 points, 16 chunks ----------------------
    nbig = 1 << LOG_SIZE
    pts = _g2_points_on_card(torch, nb, ctx, nbig, SEED + 182)
    words = _rand_scalars(nbig, ctx.n, SEED + 183)
    P = ctx.points_to_device(pts, "cuda")
    valid = torch.from_numpy(points_valid(pts)).cuda()
    sc = limb.u64_to_words(words, "cuda")
    m = get_g2_msm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = m.run_device(P.x, P.y, valid, sc)
    got = ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]
    big_s = time.perf_counter() - t0
    big_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    t0 = time.perf_counter()
    want = nb.msm_g2_raw(words, pts.to_u64())
    big_native_s = time.perf_counter() - t0
    if got != want:
        fail(f"get_g2_msm().run_device of 2^{LOG_SIZE} points differs from the native G2 MSM")
    say(f"g2 msm 2^{LOG_SIZE} points (get_g2_msm().run_device, "
        f"{nbig // m.max_chunk} chunks + jadd tree): equals the native G2 MSM; "
        f"{big_s:.3f} s on the card (enqueue to result), peak {big_peak:.0f} MiB above its "
        f"inputs; native host G2 MSM {big_native_s:.3f} s")
    return {"g2_chunk_ms": chunk_ms, "g2_enqueue_ms": enqueue_s * 1e3,
            "g2_chunk_peak_mib": peak_mib, "g2_big_s": big_s}


def small_msm_phase(torch, curves, nb) -> dict:
    """get_msm(G1) and get_g2_msm() run_device of 1000 seeded points each
    (padded to 1024, at small_cutoff: the direct path) on the card, the
    identity, 0 and n - 1 planted, against the native MSMs; each must take
    one `jdbl` launch a scalar bit (256).  Returns the times and each run's
    launches by kernel name (fq2_ for G2's)."""
    from crescent_tpu_torch.ops import limb
    from crescent_tpu_torch.ops.ec import JPoints, points_valid
    from crescent_tpu_torch.ops.msm import get_g2_msm, get_msm

    out = {}
    n = 1000
    rng = random.Random(SEED + 190)
    for label, m, make, native in (
            ("G1", get_msm(curves.BN254_G1),
             lambda ks: nb.fixed_base("bn254_g1", curves.BN254_G1.generator, ks),
             lambda ks, pts: nb.msm("bn254_g1", ks, pts)),
            ("G2", get_g2_msm(), lambda ks: nb.fixed_base_g2(curves.BN254G2.generator(), ks),
             nb.msm_g2)):
        ctx = m.ctx
        pts = make([rng.randrange(1, ctx.n) for _ in range(n)])
        ks = [rng.randrange(ctx.n) for _ in range(n)]
        pts[3] = None
        ks[4], ks[5] = 0, ctx.n - 1
        P = ctx.points_to_device(pts, "cuda")
        valid = torch.from_numpy(points_valid(pts)).cuda()
        sc = limb.limbs_to_words(limb.ints_to_limbs(ks), "cuda")
        if not m.small_cutoff >= 1 << (n - 1).bit_length():
            fail(f"small MSM {label}: {n} points are not at or under small_cutoff")
        torch.cuda.synchronize()
        ctx.ec.reset_launches()
        t0 = time.perf_counter()
        res = m.run_device(P.x, P.y, valid, sc)
        got = ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]
        dev_s = time.perf_counter() - t0
        if got != native(ks, pts):
            fail(f"small MSM {label} of {n} points (run_device's direct path) differs from "
                 "the native MSM")
        launches = ctx.ec.launches()
        if launches["jdbl"] != 256:
            fail(f"small MSM {label} launched jdbl {launches['jdbl']} times, not once a "
                 "scalar bit")
        say(f"small msm {label}: {n} points through run_device's direct path on the card "
            f"in {dev_s:.3f} s (enqueue to result); equals the native MSM; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        out[f"small_{label}_s"] = dev_s
        pre = "fq2_" if label == "G2" else ""
        out.setdefault("small_launches", {}).update(
            {pre + k: v for k, v in launches.items()})
    return out


def _tree_replaced(launches: dict, run: str, chunks: dict) -> None:
    """A prove's chunks each take 22 batch_inv launches (two a round) and
    the tree's inv none.  chunks: {prefix: the prove's chunk count over
    that field}."""
    for pre, n in chunks.items():
        if launches[pre + "batch_inv"] != 22 * n or launches[pre + "inv"]:
            fail(f"{run}: {launches[pre + 'batch_inv']} {pre}batch_inv and "
                 f"{launches[pre + 'inv']} {pre}inv launches for {n} chunks, "
                 "expected 22 and 0 a chunk")


def _proof_ints(proof) -> tuple:
    """A proof as plain ints, for comparison."""
    return (proof.a, (proof.b[0].c0, proof.b[0].c1, proof.b[1].c0, proof.b[1].c1),
            proof.c)


def _with_env(name: str, value: str, fn):
    """fn() with the environment variable set, then restored."""
    return _with_envs({name: value}, fn)


def _with_envs(env: dict, fn):
    """fn() with the environment variables set, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def small_crosscheck(torch, groth16) -> None:
    """A small circuit proved on the card in both MSM configurations (the
    device fold with one 512-point chunk per problem) and on the CPU (plain
    versions of the h(x) kernels, native MSMs): h and the proofs must be
    identical, and the proof must verify.  (The plain versions of the MSM
    kernels are held against the card in the MSM phase, at c = 5: a chunk at
    the path's c = 11 through them on a CPU takes minutes.)"""
    from crescent_tpu_torch.ops import limb, msm

    r1cs, z = groth16.dummy_circuit(SMALL_LOG, random.Random(SEED))
    # below CRESCENT_SETUP_TPU_MIN: the reference's routing takes the native
    # branch on any device
    pk = groth16.setup(r1cs, random.Random(SEED + 1), device="cuda")
    dom = groth16._domain_for(r1cs)
    zu = groth16.nb.ints_to_u64(z)
    h_gpu = groth16._compute_h_device(r1cs, zu, dom, "cuda")
    h_cpu = groth16._compute_h_device(r1cs, zu, dom, "cpu")
    if not (h_gpu == h_cpu).all():
        fail("h(x) on the card differs from the plain CPU pipeline")

    def prove(device):
        return _proof_ints(groth16.prove(pk, r1cs, z, random.Random(7), device=device))

    def fold_on_card():
        msm.get_msm.cache_clear()   # an MSM reads its chunk size when it is made
        try:
            return _with_env("CRESCENT_PROVE_MSM", "device", lambda: prove("cuda"))
        finally:
            msm.get_msm.cache_clear()

    p_fold = _with_env("CRESCENT_MSM_CHUNK", "512", fold_on_card)
    p_native = _with_env("CRESCENT_PROVE_MSM", "native", lambda: prove("cuda"))
    p_cpu = prove("cpu")            # auto on the CPU: the native MSMs
    if not p_fold == p_native == p_cpu:
        fail("small proofs differ between the card's fold, the card's native "
             "configuration and the CPU")
    proof = groth16.prove(pk, r1cs, z, random.Random(7), device="cpu")
    if not groth16.verify(pk.vk.prepare(), proof, z[1 : r1cs.num_instance]):
        fail("small proof does not verify")
    say(f"cross-check dummy_circuit({SMALL_LOG}): h equal on card and CPU "
        f"({len(limb.limbs_to_ints(h_gpu))} coefficients); proofs equal for the fold "
        "on the card, the native configuration on the card and the CPU; verify ok")


# fixed_base_mul's double-and-add (CurveCtx.scalar_mul: one jadd and one jdbl
# a scalar bit) at its callers' widths: the range setup's two KZG batches
# (129 and 130 scalars, 256 lanes), and the host branch's batches at
# dummy_circuit(NATIVE_OFF_LOG): G1 3 nv + 2^15 + 2 scalars in 2^18 lanes,
# G2 nv + 3 in 2^16
SCALAR_MUL_SHAPES = {"": (256, 1 << (NATIVE_OFF_LOG + 3)), "fq2_": (1 << (NATIVE_OFF_LOG + 1),)}


def scalar_mul_kernel_phase(torch, ec, label: str, prefix: str, seed: int, out: dict) -> None:
    """`jadd` and `jdbl` against their plain versions at fixed_base_mul's
    widths (SCALAR_MUL_SHAPES), the cases planted in the first lanes (P + P,
    P + (-P), the identity on either side and both; identities doubled),
    each timed as a CUDA graph of its launches."""
    fq2 = ec.WIDTH == 16
    e, sqr, mul = (64, 2, 3) if fq2 else (32, 1, 1)
    for lanes in SCALAR_MUL_SHAPES[prefix]:
        pq = _point_inputs(torch, ec, lanes, seed + lanes)
        got = ec.jadd(*pq)
        torch.cuda.synchronize()
        want, plain_ms = _timed_once(torch, lambda: ec.jadd_plain(*pq))
        _record(out, prefix + "jadd", label, f"{lanes} lanes (scalar_mul)", _errs(torch, got, want),
                _graph_ms(torch, lambda: ec.jadd(*pq), REPS), plain_ms,
                9 * e * lanes, (5 * sqr + 11 * mul) * MONT_MUL_MADS * lanes)
        err, pl = _jdbl_check(torch, ec, pq[:3], lanes)
        _, plain_ms = _timed_once(torch, lambda: ec.jdbl_plain(*pl))
        _record(out, prefix + "jdbl", label, f"{lanes} lanes (scalar_mul)", err,
                _graph_ms(torch, lambda: ec.jdbl(*pl), REPS), plain_ms,
                6 * e * lanes, (7 * sqr + mul) * MONT_MUL_MADS * lanes)


# T-256 (Spartan's MSMs under CRESCENT_NATIVE=0, the device-bound show): the
# small MSM's scalar_mul runs jadd and jdbl over 64 to 16,384 lanes (an MSM of
# 34 to 129 points padded to a power of two; the 64 row commits of
# poly_commit as one batch of 64 x 256 lanes), and points_to_device's mul
# over the bases (34 to 129 rows); jdbl also at 32,768, its one-thread
# executor's first width
T256_LANES = (64, 128, 256, 1024, 8192, 16384)
T256_JDBL_LANES = T256_LANES + (32768,)
T256_MUL_ROWS = (34, 129, 1 << 20)


def _plant_t256(torch, ec, pq) -> None:
    """Plant in lanes 6..13 of the batches P, Q (past _point_inputs' cases)
    coordinates whose Montgomery words are p - 1 and 2^255, sums and
    products that cross 2^256 (p - 1 + p - 1, 2^255 + 2^255), and P + P and
    P + (-P) at those words."""
    p = ec.modulus
    f = ec.ctx
    top, half = f.words([p - 1], "cuda")[0], f.words([1 << 255], "cuda")[0]
    neg_half = f.words([p - (1 << 255)], "cuda")[0]
    x1, y1, z1, x2, y2, z2 = pq
    z1[6] = top
    x1[7], x2[7] = top, top
    y1[8], z2[8] = half, half
    x1[9], y1[9], z1[9] = top, top, top
    x1[10], y1[10], z1[10] = half, half, half
    for i, left, right in ((11, (top, top, top), (top, top, top)),  # P + P
                           (12, (half, half, half), (half, half, half)),  # P + P
                           (13, (half, half, half), (half, neg_half, half))):  # P + (-P)
        x1[i], y1[i], z1[i] = left
        x2[i], y2[i], z2[i] = right


def t256_kernel_phase(torch, curves, get_cuda_ec, out: dict) -> None:
    """`jadd` and `jdbl` over T-256's base field (p >= 2^255, a = p - 3:
    csrc/warp.cuh's kWide instances, crescent_jadd_wide and
    crescent_jdbl_wide) against their plain versions at T256_LANES (jdbl
    also at 32,768), bit for bit, with _point_inputs' cases (the identity
    on either side and both, P + P (a tangent with a != 0), P + (-P)) and
    _plant_t256's; `jdbl` also against jadd(P, P) off the identities; and
    `mul` (ntt.cu, as it is) at T256_MUL_ROWS against mul_plain, a row of R^2
    broadcast as points_to_device gives it, with 0, 1, p - 1, 2^255 and
    R mod p planted.  Each timed as a CUDA graph of its launches (mul by
    CUDA events) beside its plain version and its bound: 16 products a
    jadd lane and 10 a jdbl lane (a != 0)."""
    T256 = curves.T256
    ec = get_cuda_ec(T256.p, T256.a)
    if not ec.wide or ec.a_is_zero:
        fail("T-256's kernel set is not the wide one with a != 0")
    label = "T-256 Fp, a = p - 3"
    for lanes in T256_JDBL_LANES:
        pq = _point_inputs(torch, ec, lanes, SEED + 300 + lanes)
        _plant_t256(torch, ec, pq)
        if lanes in T256_LANES:
            got = ec.jadd(*pq)
            torch.cuda.synchronize()
            want, plain_ms = _timed_once(torch, lambda: ec.jadd_plain(*pq))
            z = got[2]
            if z[2].any().item() or z[5].any().item() or z[13].any().item() or (
                    not z[0].any().item()) or not z[11].any().item():
                fail("t256_jadd: P + (-P) or inf + inf is not the identity, or P + P is")
            _record(out, "t256_jadd", label, f"{lanes} lanes", _errs(torch, got, want),
                    _graph_ms(torch, lambda: ec.jadd(*pq), REPS), plain_ms,
                    9 * 32 * lanes, 16 * MONT_MUL_MADS * lanes)
        err, pl = _jdbl_check(torch, ec, pq[:3], lanes)
        _, plain_ms = _timed_once(torch, lambda: ec.jdbl_plain(*pl))
        _record(out, "t256_jdbl", label, f"{lanes} lanes", err,
                _graph_ms(torch, lambda: ec.jdbl(*pl), REPS), plain_ms,
                6 * 32 * lanes, 10 * MONT_MUL_MADS * lanes)
    base = get_cuda_ec(T256.p)
    f = base.ctx
    r2 = f.const_words(f.r2, "cuda")
    for rows in T256_MUL_ROWS:
        x = _rand_elems(torch, rows, T256.p, SEED + 400 + rows)
        x[:5] = f.words([0, 1, T256.p - 1, 1 << 255, f.r_mod_n], "cuda")
        got = base.mul(x, r2)
        torch.cuda.synchronize()
        want, plain_ms = _timed_once(torch, lambda: base.mul_plain(x, r2))
        _record(out, "t256_mul", label, f"{rows} rows x R^2", _errs(torch, got, want),
                _time_ms(torch, lambda: base.mul(x, r2), REPS), plain_ms,
                64 * rows, MONT_MUL_MADS * rows)


def native_off_phase(torch, groth16, reset, counts, card: str) -> dict:
    """(a) dummy_circuit(NATIVE_OFF_LOG) set up and proved with the native
    backend off (CRESCENT_NATIVE=0), the reference's route there: setup's
    host branch (Python QAP evaluations and h scalars, both fixed-base
    batches by fixed_base_mul's double-and-add on the card: 256 `jadd` and
    256 `jdbl` launches a batch, over Fq and over Fq2), and prove's h(x)
    from the Python matvec.  The key must equal the default route's (the
    device branch) from the same seed, the proof with fixed r and s the
    default route's, and it must verify.  Returns each run's launches."""
    from crescent_tpu_torch.utils.pointvec import ArrayPointVec

    r1cs, z = groth16.dummy_circuit(NATIVE_OFF_LOG, random.Random(SEED + 210))
    nv, dom_n = r1cs.num_vars, groth16._domain_for(r1cs).n
    t0 = time.perf_counter()
    pk = groth16.setup(r1cs, random.Random(SEED + 211), device="cuda")
    default_s = time.perf_counter() - t0
    if not isinstance(pk.a_query, ArrayPointVec):
        fail(f"setup of dummy_circuit({NATIVE_OFF_LOG}) did not take the device branch")
    reset()
    timings: dict = {}
    t0 = time.perf_counter()
    pk_off = _with_env("CRESCENT_NATIVE", "0", lambda: groth16.setup(
        r1cs, random.Random(SEED + 211), device="cuda", timings=timings))
    off_s = time.perf_counter() - t0
    setup_launches = counts()
    if isinstance(pk_off.a_query, ArrayPointVec) or "g1_fixed_base" not in timings:
        fail("setup under CRESCENT_NATIVE=0 did not take the host branch")
    for k in ("jadd", "jdbl", "fq2_jadd", "fq2_jdbl"):
        if setup_launches[k] != 256:
            fail(f"setup under CRESCENT_NATIVE=0 launched {k} {setup_launches[k]} times, "
                 "not once a scalar bit of its one batch")
    if any(setup_launches[k] for k in ("fixed_base", "fq2_fixed_base", "madd", "fq2_madd")):
        fail("setup under CRESCENT_NATIVE=0 launched the device branch's fixed base")
    diff = _keys_differ(pk_off, pk)
    if diff:
        fail(f"setup under CRESCENT_NATIVE=0: {diff} differs from the default route's key")
    g1_n, g2_n = 3 * nv + dom_n + 2, nv + 3
    say(f"setup dummy_circuit({NATIVE_OFF_LOG}) under CRESCENT_NATIVE=0 (host branch, "
        f"fixed_base_mul on the card: G1 {g1_n} scalars in {1 << (g1_n - 1).bit_length()} "
        f"lanes, G2 {g2_n} in {1 << (g2_n - 1).bit_length()}): total {off_s:.3f} s; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; the default route (device branch) {default_s:.3f} s; keys equal; [{card}]")
    say(f"launches during that setup: { {k: v for k, v in setup_launches.items() if v} }")

    rs = random.Random(SEED + 212)
    r, s = rs.randrange(groth16.R), rs.randrange(groth16.R)
    proof = groth16.prove(pk, r1cs, z, random.Random(0), r=r, s=s, device="cuda")
    reset()
    timings = {}
    t0 = time.perf_counter()
    proof_off = _with_env("CRESCENT_NATIVE", "0", lambda: groth16.prove(
        pk_off, r1cs, z, random.Random(0), r=r, s=s, device="cuda", timings=timings))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    prove_launches = counts()
    for k in ("mul", "butterfly", "affine_add", "jadd", "fq2_affine_add", "fq2_jadd"):
        if not prove_launches[k]:
            fail(f"the {k} kernel was not launched during the CRESCENT_NATIVE=0 prove of "
                 f"dummy_circuit({NATIVE_OFF_LOG})")
    if _proof_ints(proof_off) != _proof_ints(proof):
        fail(f"the CRESCENT_NATIVE=0 proof of dummy_circuit({NATIVE_OFF_LOG}) differs from the "
             "default route's")
    if not groth16.verify(pk.vk.prepare(), proof_off, z[1 : r1cs.num_instance]):
        fail(f"the CRESCENT_NATIVE=0 proof of dummy_circuit({NATIVE_OFF_LOG}) does not verify")
    say(f"prove dummy_circuit({NATIVE_OFF_LOG}) under CRESCENT_NATIVE=0 (Python matvec, h(x) "
        f"and every MSM on the card): total {prove_s:.3f} s; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; equals the default route's proof; verify ok; [{card}]")
    return {"setup": setup_launches, "prove": prove_launches}


def show_circuit(groth16, seed: int):
    """rs256's public-IO shape (credentials/circuits.py StubJWTFrontend):
    17 RSA-2048 modulus limbs of 121 bits, then exp_value, then two claim
    values, 20 public inputs each bound to a private copy by one constraint
    (copy * 1 = input), padded with dummy_circuit's chain (w_k * b =
    w_{k+1}) to a domain of 2^SHOW_LOG.  Returns (r1cs, z, the IO
    locations: name -> position, expiry)."""
    rng = random.Random(seed)
    now = int(time.time())
    expiry = now + 30 * 86400
    names = [f"modulus[{i}]" for i in range(17)] + ["exp_value", "given_name_value",
                                                   "family_name_value"]
    pubs = [rng.getrandbits(121) for _ in range(17)] + [expiry] + [
        rng.randrange(groth16.R) for _ in range(2)]
    npub = len(pubs)
    ninst = 1 + npub
    # witness: the copies, then the chain a, b, a b, a b^2, ...
    n_chain = (1 << SHOW_LOG) - ninst - npub
    a, b = rng.randrange(groth16.R), rng.randrange(groth16.R)
    chain, cur = [a, b], a
    for _ in range(n_chain):
        cur = cur * b % groth16.R
        chain.append(cur)
    z = [1] + pubs + pubs + chain
    cons = [([(ninst + i, 1)], [(0, 1)], [(1 + i, 1)]) for i in range(npub)]
    va, vb = ninst + npub, ninst + npub + 1
    prev = va
    for k in range(n_chain):
        cons.append(([(prev, 1)], [(vb, 1)], [(vb + 1 + k, 1)]))
        prev = vb + 1 + k
    r1cs = groth16.R1CS(ninst, len(z) - ninst, cons)
    return r1cs, z, {name: 1 + i for i, name in enumerate(names)}, expiry


def show_phase(torch, groth16, reset, counts, card: str) -> dict:
    """(b) A show at rs256's public-IO shape (show_circuit): setup (device
    branch) and prove on the card, the range setup of RANGE_BITS bits
    natively and under CRESCENT_NATIVE=0 (its two KZG batches by
    fixed_base_mul on the card; the keys must be equal), then
    show_groth16 with the modulus revealed, exp_value committed and the
    claims hidden, and show_range of the expiry shifted by the current time,
    as credentials/api.py create_show_proof builds them; both must verify
    as api.verify_show checks them, and a tampered revealed input must
    not.  Returns each run's launches."""
    from crescent_tpu_torch.credentials import groth16rand, rangeproof
    from crescent_tpu_torch.credentials.dlog import PedersenOpening
    from crescent_tpu_torch.credentials.structs import IOLocations, PublicIOType

    G1 = groth16.G1
    r1cs, z, locs, expiry = show_circuit(groth16, SEED + 220)
    if not r1cs.is_satisfied(z):
        fail("the show circuit is not satisfied by its witness")
    dom_n = groth16._domain_for(r1cs).n
    out = {}
    reset()
    t0 = time.perf_counter()
    pk = groth16.setup(r1cs, random.Random(SEED + 221), device="cuda")
    proof = groth16.prove(pk, r1cs, z, random.Random(SEED + 222), device="cuda")
    torch.cuda.synchronize()
    out["credential"] = counts()
    cred_s = time.perf_counter() - t0
    pvk = pk.vk.prepare()
    inputs = z[1 : r1cs.num_instance]
    if not groth16.verify(pvk, proof, inputs):
        fail("the show circuit's proof does not verify")

    t0 = time.perf_counter()
    range_pk, range_vk = rangeproof.setup(RANGE_BITS, random.Random(SEED + 223), device="cuda")
    range_native_s = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    off_pk, off_vk = _with_env("CRESCENT_NATIVE", "0", lambda: rangeproof.setup(
        RANGE_BITS, random.Random(SEED + 223), device="cuda"))
    torch.cuda.synchronize()
    range_off_s = time.perf_counter() - t0
    out["range_setup_native0"] = launches = counts()
    if launches["jadd"] != 512 or launches["jdbl"] != 512:
        fail(f"the range setup under CRESCENT_NATIVE=0 launched jadd {launches['jadd']} and "
             f"jdbl {launches['jdbl']} times, not 256 each for each of its two batches")
    keys = (range_pk.powers.powers_of_g, range_pk.powers.powers_of_gamma_g, range_vk.com_f_basis,
            range_vk.kzg_vk.g, range_vk.kzg_vk.gamma_g, range_vk.kzg_vk.h, range_vk.kzg_vk.beta_h)
    if keys != (off_pk.powers.powers_of_g, off_pk.powers.powers_of_gamma_g, off_vk.com_f_basis,
                off_vk.kzg_vk.g, off_vk.kzg_vk.gamma_g, off_vk.kzg_vk.h, off_vk.kzg_vk.beta_h):
        fail("the range setup under CRESCENT_NATIVE=0 differs from the native one")
    say(f"range setup ({RANGE_BITS} bits, KZG degree {4 * RANGE_BITS}): native "
        f"{range_native_s:.3f} s; under CRESCENT_NATIVE=0 (fixed_base_mul on the card, 129 and "
        f"130 scalars in 256 lanes each) {range_off_s:.3f} s; keys equal; [{card}]")

    io_locations = IOLocations(dict(locs))
    exp_pos = io_locations.get_io_location("exp_value")
    io_types = [PublicIOType.HIDDEN] * len(inputs)
    io_types[exp_pos - 1] = PublicIOType.COMMITTED
    for i in io_locations.get_public_key_indices():
        io_types[i] = PublicIOType.REVEALED
    revealed = [inputs[i] for i in io_locations.get_public_key_indices()]
    cs = groth16rand.ClientState(inputs=inputs, aux=None, proof=proof, vk=pk.vk, pvk=pvk,
                                 config_str="{}")
    context = b'{"proof_spec": "chip_smoke"}'
    rng = random.Random(SEED + 224)
    reset()
    t0 = time.perf_counter()
    show = cs.show_groth16(context, io_types, rng=rng)
    cur_time = int(time.time())
    com_exp = cs.committed_input_openings[0]
    shifted = PedersenOpening(
        bases=list(com_exp.bases), m=(com_exp.m - cur_time) % groth16.R, r=com_exp.r,
        c=G1.add(com_exp.c, G1.neg(G1.mul(cur_time, com_exp.bases[0]))))
    show_range = cs.show_range(shifted, RANGE_BITS, range_pk, rng=rng)
    show_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = show.verify(pk.vk, pvk, context, io_types, revealed)
    ped_com_exp = G1.add(show.committed_inputs[0],
                         G1.neg(G1.mul(cur_time, pk.vk.gamma_abc_g1[exp_pos])))
    ok_range = show_range.verify(ped_com_exp, RANGE_BITS, range_vk, io_locations, pk.vk,
                                 "exp_value")
    verify_s = time.perf_counter() - t0
    out["show"] = counts()
    if not ok or not ok_range:
        fail(f"the show does not verify (groth16 {ok}, range {ok_range})")
    tampered = list(revealed)
    tampered[3] += 1
    if show.verify(pk.vk, pvk, context, io_types, tampered):
        fail("the show verifies against a tampered revealed input")
    if show_range.verify(G1.double(ped_com_exp), RANGE_BITS, range_vk, io_locations, pk.vk,
                         "exp_value"):
        fail("the range proof verifies against another commitment")
    say(f"show circuit: {len(inputs)} public inputs ({len(revealed)} revealed, 1 committed, "
        f"{len(inputs) - len(revealed) - 1} hidden), {len(r1cs.constraints)} constraints, "
        f"domain 2^{dom_n.bit_length() - 1}; setup and prove on the card {cred_s:.3f} s")
    say(f"show: show_groth16 + show_range ({RANGE_BITS} bits, expiry in "
        f"{expiry - cur_time} s) {show_s:.3f} s; verify (groth16 and range) {verify_s:.3f} s; "
        f"both verify, a tampered revealed input does not; [{card}]")
    return out


def scan_launches(n: int, lanes: int) -> dict:
    """The launches of one scan Pippenger run over problems padded to n
    points on at most `lanes` lanes (ops/msm.py): a madd a step, a jadd a
    lane of the fold, two a bucket of the suffix sums and one a window of
    Horner's, a jdbl_n a window; the same whatever the number of
    problems."""
    L = max(1, min(lanes, n >> SCAN_C))
    return {"madd": -(-n // L), "jadd": L + 2 * (SCAN_B - 1) + SCAN_W, "jdbl_n": SCAN_W}


def scan_kernel_phase(torch, fields, get_cuda_ec, get_cuda_quad_ec) -> dict:
    """madd over Fq and Fq2 at the scan Pippenger's widths (a step's lanes x
    33 windows: 4,224 and 2,112), the cases of _madd_inputs planted (P ==
    Q, P == -Q, the identity, valid == 0 and sign set, mixed sign flags and
    invalid lanes elsewhere), against madd_plain, timed as a CUDA graph of
    launches (the step's kernel is shorter than the host's time a call)."""
    p = fields.BN254_FQ
    out = {}
    for pre, ec, width, sqr, mul, elems in (
            ("", get_cuda_ec(p), 8, 1, 1, lambda n, sd: _rand_elems(torch, n, p, sd)),
            ("fq2_", get_cuda_quad_ec(p), 16, 2, 3,
             lambda n, sd: _rand_elems2(torch, n, p, sd))):
        n = SCAN_LANES[pre] * SCAN_W
        args = _madd_inputs(torch, ec.ctx, lambda sd: elems(n, sd), n, SEED + 220)
        got = ec.madd(*args)
        torch.cuda.synchronize()
        err = _errs(torch, got, ec.madd_plain(*args))
        z = got[2]
        if z[1].any().item() or z[5].any().item() or not z[4].any().item():
            fail(f"{pre}madd at {n} lanes: P + (-P) is not the identity or P + P is")
        if not torch.equal(got[0][3], args[0][3]):
            fail(f"{pre}madd at {n} lanes: a lane with valid == 0 does not pass P through")
        mads = _madd_products(torch, ec.ctx, args, sqr, mul, 0) * MONT_MUL_MADS
        _record(out, pre + "madd", "BN254 Fq2" if pre else "BN254 Fq",
                f"{n} lanes (scan step: {SCAN_LANES[pre]} lanes x {SCAN_W} windows)", err,
                _graph_ms(torch, lambda: ec.madd(*args), REPS),
                _time_ms(torch, lambda: ec.madd_plain(*args), 2),
                (8 * 4 * width + 8) * n, mads)
    return out


def scan_msm_phase(torch, curves, nb, reset, counts, card: str) -> dict:
    """The scan Pippenger (CRESCENT_MSM_AFFINE=0) on the card: 2^16 seeded
    G1 points through MSM(curve, c=8, lanes=128, small_cutoff=0) and 2^14
    G2 points (made on the card by the G2 fixed base) through MSM(G2, c=8,
    lanes=64, small_cutoff=0), the cases planted, each against the native
    MSM, each run's launches counted and held to scan_launches; the G1 one
    also under CRESCENT_MSM_PALLAS=0 (the reference's XLA form of phases
    1-2), whose (x, y, z) must be the kernel form's; then run_device_many
    over three G1 problems of unequal N (SCAN_MANY) in one batch, each
    result its own run_device's.  Returns each run's launches."""
    import numpy as np

    from crescent_tpu_torch.ops import limb
    from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid
    from crescent_tpu_torch.ops.msm import MSM
    from crescent_tpu_torch.utils.pointvec import ArrayPointVec

    G1 = curves.BN254_G1
    off = {"CRESCENT_MSM_AFFINE": "0"}
    out = {}

    def host(ctx, res):
        return ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]

    def run(m, key, args, env=off):
        """One run_device on the scan route, timed enqueue to result, its
        launches into out[key]."""
        reset()
        t0 = time.perf_counter()
        res = _with_envs(env, lambda: m.run_device(*args))
        pt = host(m.ctx, res)
        secs = time.perf_counter() - t0
        out[key] = counts()
        return res, pt, secs

    # -- G1: 2^16 points ------------------------------------------------------
    ctx = get_curve_ctx(G1)
    rng = random.Random(SEED + 230)
    n = 1 << SCAN_LOGS[""]
    pts = nb.fixed_base("bn254_g1", G1.generator, [rng.randrange(1, G1.n) for _ in range(n)])
    ks = [rng.randrange(G1.n) for _ in range(n)]
    pts[5] = None                      # an identity in the table
    ks[6] = 0                          # a zero scalar
    ks[7] = G1.n - 1                   # -1: negative digits in every window
    pts[9], ks[9] = pts[8], ks[8]      # the same point twice: P == Q in its buckets
    pts[11], ks[11] = G1.neg(pts[10]), ks[10]  # and its negative: P == -Q
    P = ctx.points_to_device(pts, "cuda")
    valid = torch.from_numpy(points_valid(pts)).cuda()
    sc = ctx.fctx.words(ks, "cuda")
    m = MSM(ctx, c=SCAN_C, lanes=SCAN_LANES[""], small_cutoff=0)
    res, got, g1_s = run(m, "scan_g1", (P.x, P.y, valid, sc))
    want = nb.msm("bn254_g1", ks, pts)
    if got != want:
        fail(f"the scan MSM of 2^{SCAN_LOGS['']} G1 points differs from the native MSM")
    plain, _, plain_s = run(m, "scan_g1_xla_form", (P.x, P.y, valid, sc),
                            {**off, "CRESCENT_MSM_PALLAS": "0"})
    if not all(torch.equal(a, b) for a, b in zip(res, plain)):
        fail("the scan MSM's XLA form of phases 1-2 (CRESCENT_MSM_PALLAS=0) gives other "
             "(x, y, z) than its kernel form")

    # -- G2: 2^14 points over Fq2 ----------------------------------------------
    ctx2 = get_g2_ctx()
    n2 = 1 << SCAN_LOGS["fq2_"]
    pts2 = _g2_points_on_card(torch, nb, ctx2, n2, SEED + 231)
    words = _rand_scalars(n2, ctx2.n, SEED + 232)
    pts2.inf[5] = True
    pts2.xs[5] = pts2.ys[5] = 0
    words[6] = 0
    words[7] = np.frombuffer((ctx2.n - 1).to_bytes(32, "little"), dtype="<u8")
    pts2.xs[9], pts2.ys[9], words[9] = pts2.xs[8], pts2.ys[8], words[8]
    neg = ArrayPointVec.from_points([curves.BN254G2.neg(pts2[10])], g2=True)
    pts2.xs[11], pts2.ys[11], words[11] = pts2.xs[10], neg.ys[0], words[10]
    P2 = ctx2.points_to_device(pts2, "cuda")
    m2 = MSM(ctx2, c=SCAN_C, lanes=SCAN_LANES["fq2_"], small_cutoff=0)
    _, got2, g2_s = run(m2, "scan_g2", (P2.x, P2.y, torch.from_numpy(points_valid(pts2)).cuda(),
                                        limb.u64_to_words(words, "cuda")))
    if got2 != nb.msm_g2_raw(words, pts2.to_u64()):
        fail(f"the scan MSM of 2^{SCAN_LOGS['fq2_']} G2 points differs from the native G2 MSM")

    for key, pre, npts in (("scan_g1", "", n), ("scan_g1_xla_form", "", n),
                           ("scan_g2", "fq2_", n2)):
        want_l = scan_launches(npts, SCAN_LANES[pre])
        got_l = {k: out[key][pre + k] for k in want_l}
        if got_l != want_l:
            fail(f"{key}: launches {got_l}, expected {want_l}")
    say(f"scan msm G1 2^{SCAN_LOGS['']} points (c={SCAN_C}, {SCAN_LANES['']} lanes: madd over "
        f"{SCAN_LANES[''] * SCAN_W} lanes a step) on the card: equals the native MSM; "
        f"{g1_s:.3f} s enqueue to result (XLA form {plain_s:.3f} s, the same (x, y, z)); "
        f"launches { {k: v for k, v in out['scan_g1'].items() if v} }; [{card}]")
    say(f"scan msm G2 2^{SCAN_LOGS['fq2_']} points ({SCAN_LANES['fq2_']} lanes: Fq2 madd over "
        f"{SCAN_LANES['fq2_'] * SCAN_W} lanes a step): equals the native G2 MSM; {g2_s:.3f} s; "
        f"launches { {k: v for k, v in out['scan_g2'].items() if v} }; [{card}]")

    # -- run_device_many: three G1 problems of unequal N in one batch -----------
    problems = [(P.x[:k], P.y[:k], valid[:k], sc[:k]) for k in SCAN_MANY]
    reset()
    t0 = time.perf_counter()
    many = _with_envs(off, lambda: m.run_device_many(problems))
    got_many = ctx.points_to_host(many)
    many_s = time.perf_counter() - t0
    out["scan_many"] = counts()
    singles = [_with_envs(off, lambda: host(ctx, m.run_device(*p))) for p in problems]
    if got_many != singles or singles[0] != want:
        fail("run_device_many on the scan route differs from each problem's run_device")
    want_l = scan_launches(max(SCAN_MANY), SCAN_LANES[""])
    if {k: out["scan_many"][k] for k in want_l} != want_l:
        fail(f"run_device_many launched other than one scan over the batch: {out['scan_many']}")
    say(f"run_device_many over {len(SCAN_MANY)} G1 problems ({', '.join(map(str, SCAN_MANY))} "
        f"points, padded to {1 << (max(SCAN_MANY) - 1).bit_length()}): one scan, madd over "
        f"{len(SCAN_MANY) * SCAN_LANES[''] * SCAN_W} lanes a step; each equals its own "
        f"run_device; {many_s:.3f} s; [{card}]")
    return out


def fused_off_phase(torch, groth16, reset, counts, card: str) -> dict:
    """prove under CRESCENT_PROVE_FUSED=0 (h(x) from the Python lists, the
    four G1 MSMs as one run_device_many batch): dummy_circuit(18) on the
    affine route (each problem on its own: its 2^18 + 1 variables pad to
    four chunks of 2^17, 22 batch_inv launches each, no madd) and dummy_circuit(15) under CRESCENT_MSM_AFFINE=0
    too (the scan Pippenger over all four problems at once: madd launched,
    batch_inv not).  Each proof, with fixed r and s, must equal the default
    route's and verify.  Returns each run's launches."""
    out = {}
    for log, env, route in FUSED_OFF:
        r1cs, z = groth16.dummy_circuit(log, random.Random(SEED + 240 + log))
        pk = groth16.setup(r1cs, random.Random(SEED + 241 + log), device="cuda")
        rs = random.Random(SEED + 242 + log)
        r, s = rs.randrange(groth16.R), rs.randrange(groth16.R)
        t0 = time.perf_counter()
        want = groth16.prove(pk, r1cs, z, random.Random(0), r=r, s=s, device="cuda")
        default_s = time.perf_counter() - t0
        reset()
        timings: dict = {}
        t0 = time.perf_counter()
        got = _with_envs(env, lambda: groth16.prove(pk, r1cs, z, random.Random(0), r=r, s=s,
                                                     device="cuda", timings=timings))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = counts()
        key = f"prove_fused_off_{route}"
        out[key] = launches
        if route == "scan":
            nv, dom_n = r1cs.num_vars, groth16._domain_for(r1cs).n
            npad = 1 << (max(nv, dom_n - 1) - 1).bit_length()
            want_l = scan_launches(npad, SCAN_LANES[""])
            if {k: launches[k] for k in want_l} != want_l or launches["batch_inv"]:
                fail(f"{key}: launches {launches}, expected one scan over the four problems "
                     f"({want_l}) and no batch_inv")
        else:
            # each problem on its own, padded to whole chunks of 2^CHUNK_LOG
            nmax = max(r1cs.num_vars, groth16._domain_for(r1cs).n - 1)
            chunks = 4 * -(-(1 << (nmax - 1).bit_length()) // (1 << CHUNK_LOG))
            _tree_replaced(launches, key, {"": chunks})
            if launches["madd"]:
                fail(f"{key}: launches {launches}, expected the affine route (no madd)")
        if _proof_ints(got) != _proof_ints(want):
            fail(f"{key}: the proof of dummy_circuit({log}) differs from the default route's")
        if not groth16.verify(pk.vk.prepare(), got, z[1 : r1cs.num_instance]):
            fail(f"{key}: the proof of dummy_circuit({log}) does not verify")
        say(f"prove dummy_circuit({log}) under {' '.join(f'{k}={v}' for k, v in env.items())} "
            f"({route} route, run_device_many): total {secs:.3f} s; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; the default route {default_s:.3f} s; equal proofs; verify ok; [{card}]")
        say(f"launches during that prove: { {k: v for k, v in launches.items() if v} }")
    return out


def _peak_rss_gib() -> float:
    """This process's peak resident set so far (ru_maxrss is in KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _cli_runner(base: str, name: str, out: dict, reset, counts, card: str):
    """A function run(cmd, key=None) that runs `crescent cmd --name name` in
    this process on the card, its launches into out[key] if a key is
    given, prints what it printed, its seconds and its trace spans
    (utils/trace.py `recording`), fails unless it returns 0, and returns
    what it printed and its spans as (depth, label, seconds)."""
    import contextlib
    import io

    from crescent_tpu_torch import cli
    from crescent_tpu_torch.utils import trace

    def run(cmd: str, key: str | None = None) -> tuple[str, list]:
        buf = io.StringIO()
        if key:
            reset()
        t0 = time.perf_counter()
        with trace.recording() as spans, contextlib.redirect_stdout(buf):
            rc = cli.main(["--base", base, cmd, "--name", name, "--device", "cuda"])
        if key:
            out[key] = counts()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for ln in text.splitlines():
            say(f"  | {ln}")
        if rc != 0:
            fail(f"{name}: `crescent {cmd}` returned {rc}")
        say(f"{name} {cmd}{' (' + key + ')' if key else ''}: {secs:.3f} s; peak host RSS "
            f"{_peak_rss_gib():.2f} GiB; [{card}]")
        for depth, label, dt in spans:
            say(f"    {'  ' * depth}{label}: {dt:.3f} s")
        return text, [tuple(sp) for sp in spans]

    return run


def _cli_setup_and_proves(api, groth16, run, base: str, name: str, out: dict, key: str):
    """zksetup, then prove twice (the second replays the compiled witness
    program natively) through `run`; setup must take the device branch,
    each prove h(x) and the fold on the card (every kernel of the default
    prove launched, 22 batch_inv launches a chunk), and the replayed
    prove's proof must verify.  Returns the CachePaths."""
    import os

    run("zksetup", f"{key}_setup")
    launches = out[f"{key}_setup"]
    want = {"fixed_base": 1, "fq2_fixed_base": 1, "madd": 0, "fq2_madd": 0}
    if any(launches[k] != v for k, v in want.items()) or not launches["batch_inv"]:
        fail(f"{name} zksetup did not take setup's device branch: launches {launches}")
    say(f"launches during {name} zksetup: { {k: v for k, v in launches.items() if v} }")

    _, first = run("prove", f"{key}_prove")
    (r1cs, _, prog), = api._WITNESS_CACHE.values()
    if prog is None:
        fail(f"{name}: the witness program did not compile, so no replay")
    nv, ni = r1cs.num_vars, r1cs.num_instance
    dom_n = groth16._domain_for(r1cs).n
    pck = 1 << CHUNK_LOG
    g1_chunks = sum(-(-m // pck) for m in (nv, nv, dom_n - 1, nv - ni))
    say(f"{name} circuit: {len(r1cs.constraints)} constraints, {nv} variables, "
        f"num_instance {ni}, domain 2^{dom_n.bit_length() - 1}; {g1_chunks} G1 chunks "
        "a prove")
    _, second = run("prove", f"{key}_prove_replay")
    first, second = [sp[1] for sp in first], [sp[1] for sp in second]
    if ("prove::frontend.synthesize (witness)" not in first
            or "prove::witness replay (native)" not in second
            or "prove::frontend.synthesize (witness)" in second):
        fail(f"{name}: the first prove did not synthesize or the second did not replay")
    for k in (f"{key}_prove", f"{key}_prove_replay"):
        _tree_replaced(out[k], f"the {k} run", {"": g1_chunks})
        for kernel in ("mul", "butterfly", "affine_denom", "affine_add", "jadd", "jdbl_n"):
            if not out[k][kernel]:
                fail(f"the {kernel} kernel was not launched during the {k} run")
        say(f"launches during {k}: { {k2: v for k2, v in out[k].items() if v} }")
    paths = api.CachePaths(os.path.join(base, name))
    cs = api.read_from_file(paths.client_state)
    if not groth16.verify(cs.pvk, cs.proof, cs.inputs):
        fail(f"{name}: the replayed prove's proof does not verify")
    return paths


def _verifier_params(api, paths):
    with open(paths.io_locations) as f:
        io_str = f.read()
    with open(paths.issuer_pem) as f:
        issuer_pem = f.read()
    with open(paths.config) as f:
        config_str = f.read()
    return api.VerifierParams(
        vk=api.read_from_file(paths.groth16_vk), pvk=api.read_from_file(paths.groth16_pvk),
        range_vk=api.read_from_file(paths.range_vk), io_locations_str=io_str,
        issuer_pem=issuer_pem, config_str=config_str)


def rs256_phase(torch, groth16, reset, counts, card: str) -> dict:
    """(c) rs256 end to end through the port's CLI, in this process, at
    max_cred_len 2048 (the real JWT statement: SHA-256, RSA-65537, base64
    and the claim blocks): gen-fixtures, zksetup, prove, prove again (the
    native witness replay), show and verify, each of which must return 0,
    verify printing PASS.  Prints each command's seconds and its trace spans
    (utils/trace.py `recording`), the circuit's sizes and the peak host RSS.
    Setup must take the device branch (one `fixed_base` launch a group, no
    `madd`), each prove the fold with 22 `batch_inv` launches a chunk and no
    `inv`, the second prove's proof must verify and a show whose revealed
    email limb is changed must fail verify_show.  Returns each run's
    launches."""
    import tempfile

    from crescent_tpu_torch.credentials import api
    from crescent_tpu_torch.credentials.prep_inputs import ProofSpec

    out = {}
    api._WITNESS_CACHE.clear()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rs256_") as base:
        run = _cli_runner(base, "rs256", out, reset, counts, card)
        run("gen-fixtures")
        paths = _cli_setup_and_proves(api, groth16, run, base, "rs256", out, "rs256")
        run("show")
        text, _ = run("verify")
        if "verify: PASS" not in text:
            fail("rs256: verify did not print PASS")
        vp = _verifier_params(api, paths)
        with open(paths.proof_spec + ".resolved") as f:
            spec = ProofSpec.from_json(f.read())
        show = api.read_from_file(paths.show_proof)
        if spec.revealed != ["email"] or not api.verify_show(vp, show, spec)[0]:
            fail("rs256: the show does not verify as the email's")
        show.revealed_inputs[0] += 1
        if api.verify_show(vp, show, spec)[0]:
            fail("rs256: a show whose revealed email limb is changed verifies")
        say(f"rs256: the replayed prove's proof verifies; a changed email limb is refused; "
            f"[{card}]")
    api._WITNESS_CACHE.clear()
    return out


def _span_seconds(spans: list, prefix: str) -> float:
    secs = [dt for _, label, dt in spans if label.startswith(prefix)]
    if len(secs) != 1:
        fail(f"expected one trace span {prefix!r}, found {len(secs)}")
    return secs[0]


def _device_proof(seed: int):
    """A DeviceProof on the real ECDSA statement, every draw from one seeded
    rng (the device key, its signature on a digest, the commitments to the
    split key under two BN254 base pairs, the sigma proofs) and Spartan's
    tape entropy (RandomTape's os.urandom) fixed.  Returns the proof and the
    verifier's statement (com0, com1, bases0, bases1)."""
    import hashlib
    import types

    from crescent_tpu_torch.core.curves import BN254_G1
    from crescent_tpu_torch.core.fields import BN254_FR
    from crescent_tpu_torch.credentials import device, dlog, ecdsa_pop
    from crescent_tpu_torch.models import spartan

    saved = spartan._os
    spartan._os = types.SimpleNamespace(urandom=lambda n: bytes(range(7, 7 + n)))
    try:
        rng = random.Random(seed)
        dev = device.TestDevice(rng=rng)
        bases = [[BN254_G1.mul(rng.randrange(1, BN254_FR), BN254_G1.generator)
                  for _ in range(2)] for _ in range(2)]
        q0, q1 = ecdsa_pop.split_public_key_x(dev.public[0])
        com0 = dlog.pedersen_commit(q0, bases[0], rng=rng)
        com1 = dlog.pedersen_commit(q1, bases[1], rng=rng)
        digest = hashlib.sha256(b"presentation message").digest()
        sig = device.ECDSASig.from_bytes(digest, dev.sign(digest))
        proof = device.DeviceProof.prove(com0, com1, sig, *dev.public, rng=rng)
    finally:
        spartan._os = saved
    return proof, (com0.c, com1.c, bases[0], bases[1])


def device_proof_phase(torch, reset, counts, card: str) -> dict:
    """(d') The DeviceProof with Spartan's T-256 MSMs on the card: built from
    one seed with the native backend on (its MSMs native) and off
    (CRESCENT_NATIVE=0: commit_vector, _t256_msm and poly_commit's row
    commits by get_msm(T256) on the card, jadd and jdbl over T-256), the two
    proofs' bytes must be equal and each must verify under the other route.
    Prints each one's seconds; reset and counts are T-256's launch counts.
    Returns the launches of the prove and the verify under
    CRESCENT_NATIVE=0."""
    from crescent_tpu_torch.credentials.device import DeviceProof
    from crescent_tpu_torch.utils import ark

    out = {}
    (native, stmt), native_s = _timed_wall(torch, lambda: _device_proof(1717))
    reset()
    (off, _), off_s = _timed_wall(torch, lambda: _with_env(
        "CRESCENT_NATIVE", "0", lambda: _device_proof(1717)))
    out["t256_device_proof_prove"] = counts()
    if ark.serialize(native) != ark.serialize(off):
        fail("the DeviceProof under CRESCENT_NATIVE=0 differs from the native route's")
    reset()
    ok, off_verify_s = _timed_wall(torch, lambda: _with_env(
        "CRESCENT_NATIVE", "0", lambda: DeviceProof.verify(native, *stmt)))
    out["t256_device_proof_verify"] = counts()
    if not ok:
        fail("the native route's DeviceProof does not verify under CRESCENT_NATIVE=0")
    ok, native_verify_s = _timed_wall(torch, lambda: DeviceProof.verify(off, *stmt))
    if not ok:
        fail("the CRESCENT_NATIVE=0 DeviceProof does not verify on the native route")
    for key, launches in out.items():
        if not all(launches[k] for k in ("mul", "jadd", "jdbl")):
            fail(f"{key}: mul, jadd or jdbl over T-256 was not launched")
        say(f"T-256 launches during {key} (CRESCENT_NATIVE=0): "
            f"{ {k: v for k, v in launches.items() if v} }")
    say(f"DeviceProof ({len(ark.serialize(off))} bytes): prove native {native_s:.3f} s, "
        f"CRESCENT_NATIVE=0 {off_s:.3f} s, the same bytes; verify CRESCENT_NATIVE=0 "
        f"{off_verify_s:.3f} s, native {native_verify_s:.3f} s, each the other's proof; "
        f"[{card}]")
    return out


def _timed_wall(torch, fn):
    """(fn(), its seconds on the host's clock, the card synchronised)."""
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def rs256db_phase(torch, groth16, reset, counts, card: str, t256_reset, t256_counts) -> dict:
    """(d) rs256-db (device bound) end to end through the port's CLI in this
    process at its own max_cred_len, DB_CRED_LEN: gen-fixtures (an issuer
    key, a P-256 device key whose public x rides in the JWT as
    device_key_0/1), zksetup and two proves as rs256's (device branch, the
    fold, the replay), show (the Groth16 show, the expiry's range proof and
    the DeviceProof: sigma proofs tying the committed key to a Spartan proof
    of the device's ECDSA signature on the digest of the presentation
    message) and verify, which must print PASS.  A presentation message
    other than the signed one and a flipped byte of the device proof must
    each be refused.  Then show and verify again from the same artifacts
    under CRESCENT_NATIVE=0 (Spartan's T-256 MSMs on the card: jadd and jdbl
    over T-256, counted by t256_reset and t256_counts): PASS again, and a
    flipped byte of that show's device proof refused.  Prints each
    command's seconds and spans, Spartan's prove and verify seconds and the
    device proof's size.  Returns each run's launches (T-256's under
    t256_show and t256_verify)."""
    import hashlib
    import tempfile

    from crescent_tpu_torch import cli
    from crescent_tpu_torch.credentials import api
    from crescent_tpu_torch.credentials.prep_inputs import ProofSpec
    from crescent_tpu_torch.utils import ark

    name = "rs256-db"
    if cli.DEFAULT_CONFIGS[name]["max_cred_len"] != DB_CRED_LEN:
        fail(f"{name}'s max_cred_len is not {DB_CRED_LEN}")
    out = {}
    api._WITNESS_CACHE.clear()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rs256db_") as base:
        run = _cli_runner(base, name, out, reset, counts, card)
        run("gen-fixtures")
        paths = _cli_setup_and_proves(api, groth16, run, base, name, out, "rs256db")
        text, show_spans = run("show")
        spartan_prove = _span_seconds(show_spans, "show::device proof")
        text, verify_spans = run("verify")
        if "verify: PASS" not in text:
            fail(f"{name}: verify did not print PASS")
        spartan_verify = _span_seconds(verify_spans, "verify::device proof")
        vp = _verifier_params(api, paths)
        with open(paths.proof_spec + ".resolved") as f:
            spec = ProofSpec.from_json(f.read())
        show = api.read_from_file(paths.show_proof)
        if (not spec.device_bound or show.device_proof is None
                or not api.verify_show(vp, show, spec)[0]):
            fail(f"{name}: the show carries no device proof or does not verify")
        dp_bytes = len(ark.serialize(show.device_proof))
        other = ProofSpec.from_json(spec.to_json())
        other.presentation_message = hashlib.sha256(b"another presentation message").digest()
        if api.verify_show(vp, show, other)[0]:
            fail(f"{name}: a show verifies against a presentation message it did not sign")
        pi2 = bytearray(show.device_proof.pi2)
        pi2[len(pi2) // 2] ^= 1
        show.device_proof.pi2 = bytes(pi2)
        if api.verify_show(vp, show, spec)[0]:
            fail(f"{name}: a show with a flipped byte of its device proof verifies")
        say(f"{name}: Spartan (ECDSA proof of possession) prove {spartan_prove:.3f} s, verify "
            f"{spartan_verify:.3f} s; device proof {dp_bytes} bytes; another presentation "
            f"message and a flipped device-proof byte are refused; [{card}]")
        # the native backend off: Spartan's T-256 MSMs on the card
        t256_reset()
        _, show_spans = _with_env("CRESCENT_NATIVE", "0", lambda: run("show"))
        out["t256_show"] = t256_counts()
        t256_reset()
        text, verify_spans = _with_env("CRESCENT_NATIVE", "0", lambda: run("verify"))
        out["t256_verify"] = t256_counts()
        if "verify: PASS" not in text:
            fail(f"{name}: verify under CRESCENT_NATIVE=0 did not print PASS")
        show = api.read_from_file(paths.show_proof)
        if show.device_proof is None:
            fail(f"{name}: the CRESCENT_NATIVE=0 show carries no device proof")
        pi2 = bytearray(show.device_proof.pi2)
        pi2[len(pi2) // 3] ^= 1
        show.device_proof.pi2 = bytes(pi2)
        if _with_env("CRESCENT_NATIVE", "0", lambda: api.verify_show(vp, show, spec)[0]):
            fail(f"{name}: under CRESCENT_NATIVE=0 a flipped device-proof byte verifies")
        for key in ("t256_show", "t256_verify"):
            if not all(out[key][k] for k in ("mul", "jadd", "jdbl")):
                fail(f"{name}: the {key} run did not launch mul, jadd and jdbl over T-256")
            say(f"T-256 launches during {name} {key} (CRESCENT_NATIVE=0): "
                f"{ {k: v for k, v in out[key].items() if v} }")
        say(f"{name} under CRESCENT_NATIVE=0 (Spartan's T-256 MSMs on the card): "
            f"show::device proof {_span_seconds(show_spans, 'show::device proof'):.3f} s, "
            f"verify::device proof {_span_seconds(verify_spans, 'verify::device proof'):.3f} s;"
            f" verify PASS, a flipped device-proof byte refused; [{card}]")
    api._WITNESS_CACHE.clear()
    return out


def mdl1_phase(torch, groth16, reset, counts, card: str) -> dict:
    """mdl1 end to end through the port's CLI in this process at
    MDL_CRED_LEN, the real mDL statement: gen-fixtures (real issuance),
    zksetup and two proves as rs256's, show and verify, which must print
    PASS with the four revealed values; five tampered shows must each be
    refused by verify_show_mdl.  Prints each command's seconds, spans and
    peak host RSS, Spartan's prove and verify seconds and the show proof's
    size by part.  Returns each run's launches."""
    import copy
    import hashlib
    import tempfile

    from crescent_tpu_torch import cli
    from crescent_tpu_torch.credentials import api
    from crescent_tpu_torch.credentials.prep_inputs import ProofSpec

    name = "mdl1"
    if cli.MDL1_CONFIG["max_cred_len"] != MDL_CRED_LEN:
        fail(f"{name}'s max_cred_len is not {MDL_CRED_LEN}")
    out = {}
    # the circuit is specialised to its issuer's key; the cache keys on the config
    api._WITNESS_CACHE.clear()
    api._PARAMS_CACHE.clear()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mdl1_") as base:
        run = _cli_runner(base, name, out, reset, counts, card)
        run("gen-fixtures")
        paths = api.CachePaths(os.path.join(base, name))
        files = ("config.json", "issuer.pub", "issuer.prv", "issuer_chain.pem", "device.prv",
                 "device.pub", "prover_inputs.json", "prover_aux.json", "proof_spec.json")
        missing = [f for f in files if not os.path.exists(paths.base + f)]
        if missing:
            fail(f"{name}: gen-fixtures did not write {missing}")
        with open(paths.config) as f:
            if json.load(f) != cli.MDL1_CONFIG:
                fail(f"{name}: gen-fixtures' config.json is not cli.MDL1_CONFIG")
        paths = _cli_setup_and_proves(api, groth16, run, base, name, out, "mdl1")
        text, show_spans = run("show")
        spartan_prove = _span_seconds(show_spans, "show::device proof")
        size = [ln for ln in text.splitlines() if ln.startswith("Show proof size:")]
        text, verify_spans = run("verify")
        if "verify: PASS" not in text:
            fail(f"{name}: verify did not print PASS")
        spartan_verify = _span_seconds(verify_spans, "verify::device proof")
        revealed = json.loads(text.split("revealed: ", 1)[1].splitlines()[0])
        want = {"resident_state_value": "WA", "height_value": "170",
                "family_name": "Example", "given_name": "Alice"}
        if revealed != want:
            fail(f"{name}: verify revealed {revealed}, not {want}")
        vp = _verifier_params(api, paths)
        with open(paths.proof_spec + ".resolved") as f:
            spec = ProofSpec.from_json(f.read())
        show = api.read_from_file(paths.show_proof)
        now = show.cur_time + 10
        if (not spec.device_bound or show.device_proof is None or len(show.show_range_attr) != 1
                or not api.verify_show_mdl(vp, show, spec, now_seconds=now)[0]):
            fail(f"{name}: the show lacks its device or age proof, or does not verify")
        tampered = {}
        t = tampered["a changed revealed input"] = copy.deepcopy(show)
        t.revealed_inputs[0] += 1
        t = tampered["the family_name preimage replaced by Mallory"] = copy.deepcopy(show)
        pre = json.loads(t.revealed_preimages)
        pre["family_name"] = "Mallory"
        t.revealed_preimages = json.dumps(pre)
        t = tampered["cur_time moved back 1000 s"] = copy.deepcopy(show)
        t.cur_time -= 1000
        t = tampered["a flipped byte of the device proof's pi2"] = copy.deepcopy(show)
        pi2 = bytearray(t.device_proof.pi2)
        pi2[len(pi2) // 2] ^= 1
        t.device_proof.pi2 = bytes(pi2)
        for what, t in tampered.items():
            if api.verify_show_mdl(vp, t, spec, now_seconds=now)[0]:
                fail(f"{name}: a show with {what} verifies")
        other = ProofSpec.from_json(spec.to_json())
        other.presentation_message = hashlib.sha256(b"another presentation message").digest()
        if api.verify_show_mdl(vp, show, other, now_seconds=now)[0]:
            fail(f"{name}: a show verifies against a presentation message it did not sign")
        say(f"{name}: Spartan (ECDSA proof of possession) prove {spartan_prove:.3f} s, verify "
            f"{spartan_verify:.3f} s; {size[0] if size else 'no size line'}; refused: "
            f"{', '.join(tampered)}, another presentation message; [{card}]")
    api._WITNESS_CACHE.clear()
    api._PARAMS_CACHE.clear()
    return out


def main() -> None:
    import torch

    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: the smoke takes none")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "crescent_tpu_torch")):
        fail(f"no crescent_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, root)
    from crescent_tpu_torch.core import curves, fields
    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops import _build, ntt
    from crescent_tpu_torch.ops.cuda_ec import (KERNELS, QUAD_KERNELS, get_cuda_ec,
                                                get_cuda_quad_ec)
    from crescent_tpu_torch.ops.msm_affine import batch_inv

    t0 = time.perf_counter()
    reports = _build.build_all()
    say(f"build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(sorted(reports)) or 'already built'})")
    for name, rep in reports.items():
        for ln in rep.splitlines():
            if "Compiling entry function" in ln:
                say(f"  {name}: {ln.split('Compiling entry function')[1].strip()}")
            elif "registers" in ln or "spill" in ln:
                say(f"  {name}:     {ln.strip()}")
    t0 = time.perf_counter()
    if not nb.available():
        fail("the native host backend did not build")
    say(f"native host backend: ready in {time.perf_counter() - t0:.3f} s")

    kres = kernel_phase(torch, fields, ntt, get_cuda_ec)
    kres.update(ec_kernel_phase(torch, fields, get_cuda_ec, batch_inv))
    kres.update(setup_kernel_phase(torch, fields, curves, nb, get_cuda_ec, get_cuda_quad_ec,
                                   batch_inv))
    # madd's path is the scan Pippenger's: its step widths lead its rows
    for name, rows in scan_kernel_phase(torch, fields, get_cuda_ec, get_cuda_quad_ec).items():
        kres[name][:0] = rows
    # the G2 MSM's five Fq2 point kernels
    _point_kernel_checks(torch, get_cuda_quad_ec(fields.BN254_FQ), "BN254 Fq2", "fq2_",
                         SEED + 150, batch_inv, kres)
    # fixed_base_mul's jadd and jdbl at its callers' widths
    scalar_mul_kernel_phase(torch, get_cuda_ec(fields.BN254_FQ), "BN254 Fq", "", SEED + 160,
                            kres)
    scalar_mul_kernel_phase(torch, get_cuda_quad_ec(fields.BN254_FQ), "BN254 Fq2", "fq2_",
                            SEED + 170, kres)
    # jadd, jdbl and mul over T-256 (p >= 2^255) at Spartan's widths
    t256_kernel_phase(torch, curves, get_cuda_ec, kres)
    mres = msm_phase(torch, curves, nb)
    mres.update(g2_msm_phase(torch, curves, nb))
    mres.update(small_msm_phase(torch, curves, nb))
    fixed_base_phase(torch, curves, nb)
    setup_crosscheck(torch, groth16)
    small_crosscheck(torch, groth16)

    # -- main path --------------------------------------------------------
    ecs = (get_cuda_ec(fields.BN254_FR), get_cuda_ec(fields.BN254_FQ))
    ec2 = get_cuda_quad_ec(fields.BN254_FQ)
    names = list(KERNELS) + [f"fq2_{k}" for k in QUAD_KERNELS]

    def reset():
        torch.cuda.synchronize()
        for ec in ecs + (ec2,):
            ec.reset_launches()

    def counts() -> dict:
        c = {k: sum(ec.launches()[k] for ec in ecs) for k in KERNELS}
        c.update({f"fq2_{k}": v for k, v in ec2.launches().items()})
        return c

    # T-256's kernel sets: jadd and jdbl (a = p - 3), and the base field's
    # mul (points_to_device's conversion)
    ecs_t256 = (get_cuda_ec(curves.T256.p, curves.T256.a), get_cuda_ec(curves.T256.p))

    def t256_reset():
        torch.cuda.synchronize()
        for ec in ecs_t256:
            ec.reset_launches()

    def t256_counts() -> dict:
        torch.cuda.synchronize()
        return {k: sum(ec.launches()[k] for ec in ecs_t256) for k in KERNELS}

    t0 = time.perf_counter()
    r1cs, z = groth16.dummy_circuit(LOG_SIZE, random.Random(SEED))
    circuit_s = time.perf_counter() - t0
    say(f"circuit: dummy_circuit({LOG_SIZE}) {len(r1cs.constraints)} constraints, "
        f"{r1cs.num_vars} vars, {circuit_s:.3f} s")

    reset()
    torch.cuda.reset_peak_memory_stats()
    setup_t: dict = {}
    t0 = time.perf_counter()
    pk = groth16.setup(r1cs, random.Random(SEED + 1), device="cuda", timings=setup_t)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = counts()
    say(f"setup (device branch): total {setup_s:.3f} s; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in setup_t.items()))
    say(f"launches during that setup: {setup_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for k in ("fixed_base", "fq2_mul", "fq2_batch_inv", "fq2_fixed_base", "mul", "batch_inv"):
        if setup_launches[k] == 0:
            fail(f"the {k} kernel was not launched during setup")
    if setup_launches["inv"] or setup_launches["fq2_inv"]:
        fail("setup launched inv: the fixed base's inversion is batch_inv's")
    # the fixed base: one window-kernel launch a batch (G1's, G2's), no madd
    want = {"fixed_base": 1, "fq2_fixed_base": 1, "madd": 0, "fq2_madd": 0}
    if any(setup_launches[k] != v for k, v in want.items()):
        fail(f"setup's fixed-base launches {setup_launches} differ from one window kernel "
             f"a batch: {want}")
    nv = r1cs.num_vars
    dom_n = groth16._domain_for(r1cs).n
    if setup_batches(LOG_SIZE) != (3 * nv + dom_n + 2, nv + 3):
        fail(f"setup's batches on this circuit differ from setup_batches({LOG_SIZE}), the "
             "kernel phase's")
    # prove's chunks of 2^CHUNK_LOG points: G1's a, b1, h (dom_n - 1) and l
    # (nv - num_instance) in one fold, G2's b on its own
    pck = 1 << CHUNK_LOG
    g1_chunks = sum(-(-m // pck) for m in (nv, nv, dom_n - 1, nv - r1cs.num_instance))
    g2_chunks = -(-nv // pck)

    rs = random.Random(SEED + 2)
    r_blind, s_blind = rs.randrange(groth16.R), rs.randrange(groth16.R)

    def timed_prove(label: str):
        timings: dict = {}
        t0 = time.perf_counter()
        proof = groth16.prove(pk, r1cs, z, random.Random(0), r=r_blind, s=s_blind,
                              device="cuda", timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        say(f"prove ({label}): total {total:.3f} s; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
        return proof, total, timings

    reset()
    torch.cuda.reset_peak_memory_stats()
    proof, _, _ = timed_prove("fold on the card, first: uploads the four tables")
    prove_launches = counts()
    say(f"launches during that prove: {prove_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for k in KERNELS:
        # no caller in prove; bucket_reduce: the opt-in aggregate, below;
        # inv: its body runs inside batch_inv
        if prove_launches[k] == 0 and k not in ("jdbl", "madd", "fixed_base", "bucket_reduce",
                                                "inv"):
            fail(f"the {k} kernel was not launched during prove")
    _tree_replaced(prove_launches, "the default prove", {"": g1_chunks})

    # warm second prove: tables and twiddles on the card
    proof2, _, _ = timed_prove("fold on the card, warm")
    # the same witness and blinding, all MSMs on the host
    proof_native, _, _ = _with_env("CRESCENT_PROVE_MSM", "native",
                                   lambda: timed_prove("native configuration"))
    if not _proof_ints(proof) == _proof_ints(proof2) == _proof_ints(proof_native):
        fail("the fold's proof differs from the native configuration's")
    say("proofs: the fold's (twice) and the native configuration's are equal")

    # the native backend off: the G2 MSM joins the fold on the card (its
    # table uploaded first, so that this prove is warm)
    from crescent_tpu_torch.ops.msm import get_g2_msm

    pk.device_table("b_g2_query", get_g2_msm(), "cuda")
    reset()
    torch.cuda.reset_peak_memory_stats()
    proof_dev, _, _ = _with_env("CRESCENT_NATIVE", "0",
                                lambda: timed_prove("CRESCENT_NATIVE=0: G2 on the card too, warm"))
    native0_launches = counts()
    say(f"launches during that prove: {native0_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    unused = ("jdbl", "madd", "fixed_base", "bucket_reduce", "inv", "fq2_jdbl", "fq2_madd",
              "fq2_fixed_base", "fq2_bucket_reduce", "fq2_butterfly", "fq2_mul", "fq2_inv")
    for k in names:
        if native0_launches[k] == 0 and k not in unused:
            fail(f"the {k} kernel was not launched during the CRESCENT_NATIVE=0 prove")
    _tree_replaced(native0_launches, "the CRESCENT_NATIVE=0 prove",
                   {"": g1_chunks, "fq2_": g2_chunks})
    if native0_launches["fq2_mul"]:
        fail("the CRESCENT_NATIVE=0 prove launched the Fq2 mul: its only caller was the tree")
    if _proof_ints(proof_dev) != _proof_ints(proof):
        fail("the CRESCENT_NATIVE=0 proof differs from the default configuration's")
    say("proofs: the CRESCENT_NATIVE=0 proof equals the default configuration's")

    # the fused aggregate: each chunk's suffix sums and weighting in one
    # bucket_reduce launch, with the native backend off (G1 and G2 chunks)
    reset()
    torch.cuda.reset_peak_memory_stats()
    proof_fused, _, _ = _with_env("CRESCENT_NATIVE", "0", lambda: _with_env(
        "CRESCENT_MSM_FUSED_AGG", "1",
        lambda: timed_prove("CRESCENT_MSM_FUSED_AGG=1 CRESCENT_NATIVE=0, warm")))
    fused_launches = counts()
    say(f"launches during that prove: {fused_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    chunks = (native0_launches["jadd"] - fused_launches["jadd"],
              native0_launches["fq2_jadd"] - fused_launches["fq2_jadd"])
    say(f"fused aggregate: bucket_reduce {fused_launches['bucket_reduce']} (Fq), "
        f"{fused_launches['fq2_bucket_reduce']} (Fq2) launches; jadd launches "
        f"{chunks[0]} (Fq) and {chunks[1]} (Fq2) fewer than without it")
    if not fused_launches["bucket_reduce"] or not fused_launches["fq2_bucket_reduce"]:
        fail("the fused prove did not launch bucket_reduce over Fq and over Fq2")
    if chunks != (21 * fused_launches["bucket_reduce"], 21 * fused_launches["fq2_bucket_reduce"]):
        fail("the fused prove does not save 21 jadd launches a bucket_reduce launch")
    if (fused_launches["bucket_reduce"], fused_launches["fq2_bucket_reduce"]) != (
            g1_chunks, g2_chunks):
        fail(f"the fused prove launched bucket_reduce other than once a chunk "
             f"({g1_chunks} G1 and {g2_chunks} G2 chunks)")
    _tree_replaced(fused_launches, "the fused prove",
                   {"": g1_chunks, "fq2_": g2_chunks})
    if _proof_ints(proof_fused) != _proof_ints(proof):
        fail("the fused-aggregate proof differs from the default configuration's")
    say("proofs: the fused-aggregate proof equals the default configuration's")

    t0 = time.perf_counter()
    pvk = pk.vk.prepare()
    pubs = z[1 : r1cs.num_instance]
    if not groth16.verify(pvk, proof, pubs) or not groth16.verify(pvk, proof_dev, pubs):
        fail("verify rejected the proof")
    if groth16.verify(pvk, proof, [(pubs[0] + 1) % groth16.R]):
        fail("verify accepted the proof against a wrong public input")
    say(f"verify: ok ({time.perf_counter() - t0:.3f} s)")
    # the native backend off: the public-input MSM on the card (direct path)
    reset()
    t0 = time.perf_counter()
    ok = _with_env("CRESCENT_NATIVE", "0",
                   lambda: groth16.verify(pvk, proof_fused, pubs, device="cuda"))
    verify_launches = counts()
    if not ok:
        fail("verify under CRESCENT_NATIVE=0 rejected the fused-aggregate proof")
    if not verify_launches["jdbl"] or not verify_launches["jadd"]:
        fail("verify under CRESCENT_NATIVE=0 did not run its MSM on the card")
    say(f"verify (CRESCENT_NATIVE=0, public-input MSM on the card): ok "
        f"({time.perf_counter() - t0:.3f} s); launches {verify_launches}")
    # (a) setup and prove under CRESCENT_NATIVE=0; (b) the show path
    off_runs = native_off_phase(torch, groth16, reset, counts, card)
    # the scan Pippenger (CRESCENT_MSM_AFFINE=0) and prove under
    # CRESCENT_PROVE_FUSED=0 (run_device_many)
    scan_runs = scan_msm_phase(torch, curves, nb, reset, counts, card)
    fused_off_runs = fused_off_phase(torch, groth16, reset, counts, card)
    show_runs = show_phase(torch, groth16, reset, counts, card)
    # (c) rs256 through the CLI
    rs256_runs = rs256_phase(torch, groth16, reset, counts, card)
    # (d) rs256-db through the CLI: device binding, Spartan's T-256 MSMs on
    # the card under CRESCENT_NATIVE=0 too
    db_runs = rs256db_phase(torch, groth16, reset, counts, card, t256_reset, t256_counts)
    t256_runs = {k: db_runs.pop(k) for k in ("t256_show", "t256_verify")}
    t256_runs.update(device_proof_phase(torch, t256_reset, t256_counts, card))
    # (e) mdl1 through the CLI: the mDL statement, its age proof, device binding
    mdl_runs = mdl1_phase(torch, groth16, reset, counts, card)
    say(f"chunk MSM 2^{CHUNK_LOG}: {mres['chunk_ms']:.3f} ms on the card, "
        f"{mres['enqueue_ms']:.3f} ms to enqueue; G2: {mres['g2_chunk_ms']:.3f} ms on the "
        f"card, {mres['g2_enqueue_ms']:.3f} ms to enqueue")

    pallas = "crescent_tpu/ops/pallas_ec.py"
    # the TPU kernel each replaces: the kernel function (PallasEC); for the
    # Fq2 ops of QuadPallasEC the `_F2` body or override that makes them, or
    # the op that runs the shared kernel at ROWS = 32
    replaces = {"mul": 513, "butterfly": 517, "inv": 527, "affine_denom": 560,
                "affine_add": 566, "jadd": 505, "jdbl_n": 550, "jdbl": 545,
                "madd": 495, "bucket_reduce": 575, "fq2_mul": 362, "fq2_inv": 858,
                "fq2_madd": 831, "fq2_affine_denom": 757, "fq2_affine_add": 771,
                # the window kernel: the madd kernel that the reference's scan
                # (crescent_tpu/ops/fixed_base.py:138-144) runs 32 times
                "fixed_base": 495, "fq2_fixed_base": 831,
                "fq2_jadd": 670, "fq2_jdbl_n": 744, "fq2_jdbl": 735,
                "fq2_bucket_reduce": 790, "fq2_butterfly": 689}
    regs = _registers(reports)
    # warp.cuh's doublings keep P in registers; batch_inv one wave in 128
    for name in ("jdbl_n", "fq2_jdbl_n", "batch_inv", "fq2_batch_inv"):
        spill = (_kernel_registers(regs, name) or (None, None))[1]
        if spill:
            fail(f"{name}'s kernel spills {spill} bytes (nvcc -Xptxas -v)")
    # and its additions and `jdbl`'s executors (warp.cuh), the fused
    # aggregate (bucket.cuh), the fixed base's mixed additions (madd.cuh)
    # and the pair additions (affine_add.cuh), every instance
    for name in ("jadd", "fq2_jadd", "jdbl", "fq2_jdbl", "bucket_reduce", "fq2_bucket_reduce",
                 "madd", "fq2_madd", "fixed_base", "fq2_fixed_base", "affine_add",
                 "fq2_affine_add"):
        for entry, (r, spill) in _jadd_registers(regs, name).items():
            say(f"{name}: {entry} {r} registers, {spill} bytes spill stores")
            if spill:
                fail(f"{name}'s kernel {entry} spills {spill} bytes (nvcc -Xptxas -v)")
    runs = (setup_launches, prove_launches, native0_launches, fused_launches,
            verify_launches, *off_runs.values(), *show_runs.values(), *rs256_runs.values(),
            *scan_runs.values(), *fused_off_runs.values(), *db_runs.values(),
            *mdl_runs.values())
    source = {"mul": "ntt.cu", "butterfly": "ntt.cu"}
    source.update({k: "ec2.cu" for k in names if k.startswith("fq2_")})
    source.update(batch_inv="batch_inv.cuh", fq2_batch_inv="batch_inv.cuh")
    source.update({k: "madd.cuh" for k in ("madd", "fq2_madd", "fixed_base", "fq2_fixed_base")})
    source.update(affine_add="affine_add.cuh", fq2_affine_add="affine_add.cuh",
                  jdbl="warp.cuh", fq2_jdbl="warp.cuh")
    kernels = []
    for name in names:
        rows = kres[name]
        # the row of the path's main shape: Fr for the two field kernels of
        # h(x), the widest shape for the point kernels
        label, _, ms, plain_ms, bound_ms, bound_by = rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "crescent_tpu_torch/csrc/" + source.get(name, "ec.cu"),
            "replaces": (f"{pallas}:{replaces[name]}" if name in replaces else
                         # the reference's tree over the mul (:680) and inv
                         # (:698) kernels
                         "crescent_tpu/ops/msm_affine.py:75"),
            "shape": label,
            "launches": sum(r[name] for r in runs),
            "launches_setup": setup_launches[name],
            "launches_prove": prove_launches[name],
            "launches_prove_native0": native0_launches[name],
            "launches_prove_fused_native0": fused_launches[name],
            "launches_verify_native0": verify_launches[name],
            f"launches_setup_native0_2^{NATIVE_OFF_LOG}": off_runs["setup"][name],
            f"launches_prove_native0_2^{NATIVE_OFF_LOG}": off_runs["prove"][name],
            "launches_show_credential": show_runs["credential"][name],
            "launches_range_setup_native0": show_runs["range_setup_native0"][name],
            "launches_show": show_runs["show"][name],
            "launches_rs256_setup": rs256_runs["rs256_setup"][name],
            "launches_rs256_prove": rs256_runs["rs256_prove"][name],
            "launches_rs256_prove_replay": rs256_runs["rs256_prove_replay"][name],
            "launches_rs256db_setup": db_runs["rs256db_setup"][name],
            "launches_rs256db_prove": db_runs["rs256db_prove"][name],
            "launches_rs256db_prove_replay": db_runs["rs256db_prove_replay"][name],
            "launches_mdl1_setup": mdl_runs["mdl1_setup"][name],
            "launches_mdl1_prove": mdl_runs["mdl1_prove"][name],
            "launches_mdl1_prove_replay": mdl_runs["mdl1_prove_replay"][name],
            # the scan Pippenger: 2^16 G1 points (kernel form), the same
            # under CRESCENT_MSM_PALLAS=0, 2^14 G2 points, run_device_many
            **{f"launches_{k}": v[name] for k, v in scan_runs.items()},
            **{f"launches_{k}": v[name] for k, v in fused_off_runs.items()},
            # the 1000-point small MSM of its group (the direct path)
            "launches_small_msm": mres["small_launches"][name],
            "registers": (_kernel_registers(regs, name) or (None, None))[0],
            "spill_store_bytes": (_kernel_registers(regs, name) or (None, None))[1],
            "max_abs_err": max(r[1] for r in rows),
            "bit_exact": all(r[1] == 0 for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes these
        })
        if name.endswith(tuple(INSTANCES)):  # every instance, a == 0 and a != 0
            kernels[-1]["registers_by_entry"] = {
                e: r for e, (r, _) in _jadd_registers(regs, name).items()}
        if name.endswith("fixed_base"):  # the scan of the reference it replaces
            kernels[-1]["replaces_scan"] = "crescent_tpu/ops/fixed_base.py:138"
        if name.endswith("bucket_reduce"):  # the unfused levels beside it, its launch
            kernels[-1].update(kres[name + "_levels"])
        if len(rows) > 1:  # every shape the kernel phase timed
            kernels[-1]["shapes"] = [
                {"shape": r[0], "ms": r[2], "plain_ms": r[3], "bound_ms": r[4]} for r in rows]
        if name.endswith("batch_inv"):  # the tree it replaces, timed beside it
            tree = kres[name + "_tree"]
            kernels[-1]["replaces_kernels"] = [f"{pallas}:680", f"{pallas}:698"]
            kernels[-1].update({k: v for k, v in tree.items() if k != "tree_ms"})
            for row in kernels[-1]["shapes"]:
                row["tree_ms"] = tree["tree_ms"][int(row["shape"].split()[0])]
    import re

    # T-256's kernels (the wide jadd and jdbl, ntt.cu's mul): the
    # device-bound show's path under CRESCENT_NATIVE=0
    for name, kernel, main_shape, src in (
            ("t256_mul", "mul", "129 rows x R^2", "ntt.cu"),
            ("t256_jadd", "jadd", "16384 lanes", "warp.cuh"),
            ("t256_jdbl", "jdbl", "16384 lanes", "warp.cuh")):
        rows = kres[name]
        label, _, ms, plain_ms, bound_ms, bound_by = next(r for r in rows if r[0] == main_shape)
        if kernel == "mul":
            hits = [_kernel_registers(regs, "mul") or (None, None)]
        else:  # the kWide instances, and point.cuh's one thread a lane
            hits = [v for e, v in _jadd_registers(regs, kernel).items()
                    if re.search(WIDE_ENTRY, e) or "jdbl_kernelINS_2FeEEEv" in e]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "crescent_tpu_torch/csrc/" + src,
            "replaces": f"{pallas}:{replaces[kernel]}",
            "shape": label,
            "launches": sum(r[kernel] for r in t256_runs.values()),
            **{f"launches_{k}": v[kernel] for k, v in t256_runs.items()},
            "registers": max((h[0] for h in hits if h[0] is not None), default=None),
            "spill_store_bytes": max((h[1] for h in hits if h[1] is not None), default=None),
            "max_abs_err": max(r[1] for r in rows),
            "bit_exact": all(r[1] == 0 for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shapes": [{"shape": r[0], "ms": r[2], "plain_ms": r[3], "bound_ms": r[4]}
                       for r in rows],
        })
        if kernel != "mul":
            kernels[-1]["registers_by_entry"] = {
                e: r for e, (r, _) in _jadd_registers(regs, kernel).items()
                if re.search(WIDE_ENTRY, e)}
    say(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
