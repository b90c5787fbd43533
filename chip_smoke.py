#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's CUDA kernels from crescent_tpu_torch/csrc with nvcc
   (one nvcc per source, started together, into build/kernels/) and prints
   the build time and each kernel's registers and spills.
3. Kernel phase: holds each of the eight kernels against its plain PyTorch
   version on the card at the prove path's shapes, with the edge cases
   planted (field: 0, 1, p-1, Montgomery 1; points: L == R, L == -R, one
   side only, neither; P + P, P + (-P), the identity on either side and on
   both), and once over a curve with a != 0.  Tolerance: none, the results
   must be bit-identical (exact integer arithmetic).  Prints the kernel's
   and the plain version's times (CUDA events) and the least time the card
   could take (`bound_ms`: bytes over 3.35 TB/s against 32-bit
   multiply-adds over 16.75e12/s, whichever is larger).
4. MSM phase: one sorted-segment affine MSM of 2^17 seeded points on the
   card against the native host MSM, with PyTorch's synchronisation check
   set to raise, and one of 512 points (c = 5) on the card against the
   same through the plain versions on the CPU, (x, y, z) bit-equal.
5. Main path: Groth16 on dummy_circuit(21) (the reference's proof-benchmark
   circuit, domain 2^21) with random keys from a fixed seed: port `setup`
   on the host, `prove(..., device="cuda")` in its default configuration
   (h(x) and the four G1 MSMs on the card, the G2 MSM on the host beside
   them) with launch counts reset just before it, and `verify`, which must
   accept the proof and reject it against a wrong public input.  The same
   witness and blinding under CRESCENT_PROVE_MSM=native must give the same
   proof.  A small circuit is proved on the card in both configurations
   and on the CPU; h and the proofs must be equal.
6. Prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

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
SEED = 20261016
REPS = 50
CHUNK_LOG = 17     # points per chunk MSM on the prove path
AFFINE_C = 11      # its window width: W = 25 windows of B = 1025 buckets
HBM_BYTES_PER_S = 3.35e12
# sm_90 issues 64 32-bit integer multiply-adds per SM and clock against 128
# float32 ones: half of the data sheet's 67 TFLOP/s (33.5e12 FMA/s)
IMAD_PER_S = 16.75e12
MONT_MUL_MADS = 136  # 8 x (8 + 8 + 1) in fe_mont_mul


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


def _max_abs_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def _bound(nbytes: float, mads: float) -> tuple[float, str]:
    """The least milliseconds the card could take: (ms, 'bytes' or
    'operations')."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = mads / IMAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def _point_inputs(torch, ec, n: int, seed: int):
    """Two Jacobian batches P, Q of n lanes of seeded field elements with the
    cases planted in the first lanes: P + P (the same triple), P + P through
    another representative ((x l^2, y l^3, z l)), P + (-P), P at infinity,
    Q at infinity, both at infinity."""
    p = ec.modulus
    x1, y1, z1, x2, y2, z2 = (_rand_elems(torch, n, p, seed + k) for k in range(6))
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

    p = ec.modulus
    lx, ly, rx, ry = (_rand_elems(torch, n, p, seed + k) for k in range(4))
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
    return lx, ly, lv, rx, ry, rv


def ec_kernel_phase(torch, fields, get_cuda_ec, batch_inv) -> dict:
    """The six point kernels against their plain versions over BN254 Fq at
    the MSM path's shapes, and once over a curve with a != 0."""
    p = fields.BN254_FQ
    ec = get_cuda_ec(p, 0)
    ctx = ec.ctx
    one = ctx.one_mont("cuda")
    out = {}
    n = 1 << LOG_SIZE          # lanes of the first pair level of a chunk
    nb_lanes = ((256 + AFFINE_C - 1) // AFFINE_C + 1) * ((1 << (AFFINE_C - 1)) + 1)  # W * B
    nck = 1 << CHUNK_LOG

    def record(name, shape, err, ms, plain_ms, nbytes, mads):
        bound_ms, bound_by = _bound(nbytes, mads)
        say(f"kernel {name} [BN254 Fq] {shape}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}")
        if err:
            fail(f"{name} at {shape} differs from its plain version")
        out.setdefault(name, []).append((shape, err, ms, plain_ms, bound_ms, bound_by))

    # -- inv: 512 lanes, the root of every batch_inv --------------------------
    x = _rand_elems(torch, 512, p, SEED + 20)
    x[:4] = ctx.words([0, 1, p - 1, ctx.r_mod_n], "cuda")
    got = ec.inv(x)
    torch.cuda.synchronize()
    want = ec.inv_plain(x)
    err = _errs(torch, got, want)
    # x * x^-1 == 1 where x != 0, 0 -> 0
    prod = ec.mul(x, got)
    if not (prod[1:] == one).all().item() or prod[0].any().item():
        fail("inv: x * inv(x) is not Montgomery 1 (or inv(0) is not 0)")
    e = p - 2
    record("inv", "512 lanes", err, _time_ms(torch, lambda: ec.inv(x), 20),
           _time_ms(torch, lambda: ec.inv_plain(x), 1), 64 * 512,
           512 * (256 + bin(e).count("1")) * MONT_MUL_MADS)

    # -- affine_denom, affine_add: 2^21 lanes ----------------------------------
    pair = _pair_inputs(torch, ec, n, SEED + 30)
    d = ec.affine_denom(*pair)
    torch.cuda.synchronize()
    err = _errs(torch, d, ec.affine_denom_plain(*pair))
    record("affine_denom", f"2^{LOG_SIZE} lanes", err,
           _time_ms(torch, lambda: ec.affine_denom(*pair), REPS),
           _time_ms(torch, lambda: ec.affine_denom_plain(*pair), 2), 168 * n, 0)
    if d[:7].ne(torch.stack([
            ctx.add_mod(pair[1][0], pair[1][0]), one[0], one[0], one[0], one[0],
            one[0], one[0]])).any().item():
        fail("affine_denom: a planted case has the wrong denominator")

    inv = batch_inv(ec, d)  # the mul tree down to 512 lanes, inv, the unwind
    torch.cuda.synchronize()
    if not (ec.mul(d, inv) == one).all().item():
        fail("batch_inv: d * inv(d) is not Montgomery 1")
    got = ec.affine_add(*pair, inv)
    torch.cuda.synchronize()
    want = ec.affine_add_plain(*pair, inv)
    err = _errs(torch, got, want)
    if got[2][:7].tolist() != [1, 0, 1, 1, 0, 1, 1]:
        fail(f"affine_add: planted cases give valid flags {got[2][:7].tolist()}")
    record("affine_add", f"2^{LOG_SIZE} lanes", err,
           _time_ms(torch, lambda: ec.affine_add(*pair, inv), REPS),
           _time_ms(torch, lambda: ec.affine_add_plain(*pair, inv), 2),
           236 * n, 4 * MONT_MUL_MADS * n)

    # -- mul over the widths of that batch_inv tree ----------------------------
    tree_ms = 0.0
    width = n
    while width > 512:
        cur = d[:width]
        half = torch.empty((width // 2, 8), dtype=torch.int32, device="cuda")
        up = _time_ms(torch, lambda: ec.mul(cur[0::2], cur[1::2], out=half), 20)
        down = _time_ms(torch, lambda: (ec.mul(half, cur[1::2], out=cur[0::2]),
                                        ec.mul(half, cur[0::2], out=cur[1::2])), 20)
        tree_ms += up + down
        width //= 2
    bi_ms = _time_ms(torch, lambda: batch_inv(ec, d), 10)
    say(f"batch_inv [BN254 Fq] 2^{LOG_SIZE} lanes: {bi_ms:.4f} ms in all; its mul "
        f"launches over the tree widths 2^{LOG_SIZE}..2^10 sum to {tree_ms:.4f} ms")
    out["batch_inv_ms"] = bi_ms
    del d, inv, pair, got, want

    # -- jadd: the dense table (W*B lanes) and 2^17 lanes ----------------------
    for lanes, shape in ((nb_lanes, f"{nb_lanes} lanes"), (nck, f"2^{CHUNK_LOG} lanes")):
        pq = _point_inputs(torch, ec, lanes, SEED + 40)
        got = ec.jadd(*pq)
        torch.cuda.synchronize()
        want = ec.jadd_plain(*pq)
        err = _errs(torch, got, want)
        z = got[2]
        if z[2].any().item() or z[5].any().item() or not z[0].any().item():
            fail("jadd: P + (-P) or inf + inf is not the identity, or P + P is")
        if not (torch.equal(got[0][3], pq[3][3]) and torch.equal(got[0][4], pq[0][4])):
            fail("jadd: the identity on one side does not return the other side")
        record("jadd", shape, err, _time_ms(torch, lambda: ec.jadd(*pq), REPS),
               _time_ms(torch, lambda: ec.jadd_plain(*pq), 2),
               288 * lanes, 16 * MONT_MUL_MADS * lanes)

    # -- jdbl: 2^17 lanes; jdbl_n: 16 lanes, 11 and 176 doublings --------------
    pt = _point_inputs(torch, ec, nck, SEED + 50)[:3]
    got = ec.jdbl(*pt)
    torch.cuda.synchronize()
    err = _errs(torch, got, ec.jdbl_plain(*pt))
    # P + P takes the doubling (past the planted identities, which jadd
    # passes through)
    tail = tuple(a[8:] for a in pt)
    err = max(err, _errs(torch, tuple(a[8:] for a in got), ec.jadd(*tail, *tail)))
    record("jdbl", f"2^{CHUNK_LOG} lanes", err, _time_ms(torch, lambda: ec.jdbl(*pt), REPS),
           _time_ms(torch, lambda: ec.jdbl_plain(*pt), 2),
           192 * nck, 8 * MONT_MUL_MADS * nck)
    p16 = tuple(a[:16].contiguous() for a in pt)
    for count in (AFFINE_C, 16 * AFFINE_C):
        got = ec.jdbl_n(*p16, count)
        torch.cuda.synchronize()
        err = _errs(torch, got, ec.jdbl_n_plain(*p16, count))
        record("jdbl_n", f"16 lanes x {count}", err,
               _time_ms(torch, lambda: ec.jdbl_n(*p16, count), 20),
               _time_ms(torch, lambda: ec.jdbl_n_plain(*p16, count), 1),
               192 * 16, 8 * MONT_MUL_MADS * 16 * count)

    # -- a != 0: the a-terms of jdbl, jdbl_n and affine_add (and jadd's
    #    doubling branch), over BN254 Fq with an arbitrary a ------------------
    eca = get_cuda_ec(p, 0x1234567)
    na = 1 << 14
    pt = _point_inputs(torch, eca, na, SEED + 60)
    pair = _pair_inputs(torch, eca, na, SEED + 70)
    inv = batch_inv(eca, eca.affine_denom(*pair))
    err = max(
        _errs(torch, eca.jdbl(*pt[:3]), eca.jdbl_plain(*pt[:3])),
        _errs(torch, eca.jdbl_n(*pt[:3], 3), eca.jdbl_n_plain(*pt[:3], 3)),
        _errs(torch, eca.jadd(*pt), eca.jadd_plain(*pt)),
        _errs(torch, eca.affine_add(*pair, inv), eca.affine_add_plain(*pair, inv)),
    )
    if torch.equal(eca.jdbl(*pt[:3])[0], ec.jdbl(*pt[:3])[0]):
        fail("a != 0 does not reach the doubling")
    say(f"kernels jdbl, jdbl_n, jadd, affine_add [BN254 Fq, a = 0x1234567] 2^14 lanes: "
        f"max_abs_err={err}")
    if err:
        fail("a kernel differs from its plain version over a curve with a != 0")
    return out


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


def _proof_ints(proof) -> tuple:
    """A proof as plain ints, for comparison."""
    return (proof.a, (proof.b[0].c0, proof.b[0].c1, proof.b[1].c0, proof.b[1].c1),
            proof.c)


def _with_env(name: str, value: str, fn):
    """fn() with the environment variable set, then restored."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def small_crosscheck(torch, groth16) -> None:
    """A small circuit proved on the card in both MSM configurations (the
    device fold with one 512-point chunk per problem) and on the CPU (plain
    versions of the h(x) kernels, native MSMs): h and the proofs must be
    identical, and the proof must verify.  (The plain versions of the MSM
    kernels are held against the card in the MSM phase, at c = 5: a chunk at
    the path's c = 11 through them on a CPU takes minutes.)"""
    from crescent_tpu_torch.ops import limb, msm

    r1cs, z = groth16.dummy_circuit(SMALL_LOG, random.Random(SEED))
    pk = groth16.setup(r1cs, random.Random(SEED + 1))
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
    from crescent_tpu_torch.ops.cuda_ec import KERNELS, get_cuda_ec
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
    mres = msm_phase(torch, curves, nb)
    small_crosscheck(torch, groth16)

    # -- main path --------------------------------------------------------
    t0 = time.perf_counter()
    r1cs, z = groth16.dummy_circuit(LOG_SIZE, random.Random(SEED))
    circuit_s = time.perf_counter() - t0
    say(f"circuit: dummy_circuit({LOG_SIZE}) {len(r1cs.constraints)} constraints, "
        f"{r1cs.num_vars} vars, {circuit_s:.3f} s")
    t0 = time.perf_counter()
    pk = groth16.setup(r1cs, random.Random(SEED + 1))
    say(f"setup (host, native backend): {time.perf_counter() - t0:.3f} s")

    ecs = (get_cuda_ec(fields.BN254_FR), get_cuda_ec(fields.BN254_FQ))
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

    torch.cuda.synchronize()
    for ec in ecs:
        ec.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    proof, _, _ = timed_prove("fold on the card, first: uploads the four tables")
    launches = {k: sum(ec.launches()[k] for ec in ecs) for k in KERNELS}
    say(f"launches during that prove: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for k, v in launches.items():
        if v == 0 and k != "jdbl":  # jdbl has no caller on the path
            fail(f"the {k} kernel was not launched during prove")

    # warm second prove: tables and twiddles on the card
    proof2, _, _ = timed_prove("fold on the card, warm")
    # the same witness and blinding, all MSMs on the host
    proof_native, _, _ = _with_env("CRESCENT_PROVE_MSM", "native",
                                   lambda: timed_prove("native configuration"))
    if not _proof_ints(proof) == _proof_ints(proof2) == _proof_ints(proof_native):
        fail("the fold's proof differs from the native configuration's")
    say("proofs: the fold's (twice) and the native configuration's are equal")

    t0 = time.perf_counter()
    pvk = pk.vk.prepare()
    pubs = z[1 : r1cs.num_instance]
    if not groth16.verify(pvk, proof, pubs):
        fail("verify rejected the proof")
    if groth16.verify(pvk, proof, [(pubs[0] + 1) % groth16.R]):
        fail("verify accepted the proof against a wrong public input")
    say(f"verify: ok ({time.perf_counter() - t0:.3f} s)")
    say(f"chunk MSM 2^{CHUNK_LOG}: {mres['chunk_ms']:.3f} ms on the card, "
        f"{mres['enqueue_ms']:.3f} ms to enqueue")

    pallas = "crescent_tpu/ops/pallas_ec.py"
    replaces = {"mul": 513, "butterfly": 517, "inv": 527, "affine_denom": 560,
                "affine_add": 566, "jadd": 505, "jdbl_n": 550, "jdbl": 545}
    kernels = []
    for name in KERNELS:
        rows = kres[name]
        # the row of the prove path's main shape: Fr for the two field
        # kernels of h(x), the widest shape for the point kernels
        label, _, ms, plain_ms, bound_ms, bound_by = rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "crescent_tpu_torch/csrc/"
                      + ("ntt.cu" if name in ("mul", "butterfly") else "ec.cu"),
            "replaces": f"{pallas}:{replaces[name]}",
            "shape": label,
            "launches": launches[name],
            "max_abs_err": max(r[1] for r in rows),
            "bit_exact": all(r[1] == 0 for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes these
        })
    say(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
