"""The round plans of the `jadd` kernels (crescent_tpu_torch/csrc/warp.cuh
`jadd_rounds`), modelled in Python ints: each addition's base products in
rounds, each product taking its inputs only from earlier rounds, no round
with more products than its executor has groups (or than the lane's
product threads at one product a thread).  Fq: five rounds of at most four
(a warp's four 8-thread groups, four product threads, or one thread a lane
in turn); Fq2: six rounds of at most eight (eight product threads, or the
two-warp design alternative of scripts/chain_designs.py), and five rounds
of at most sixteen (the four-warp groups of the narrow launches).  P == Q
takes the doubling's plan (warp.cuh `warp_double`).  The round sizes are
read out of the source.  The models' sums are held exactly (tolerance 0)
against the port's plain `jadd_plain` over `ModCtx` (a = 0 and a != 0) and
`QuadCtx`, and against the JAX package's host addition (BN254 G1, a curve
with a != 0 over the same field, and `BN254G2`); the inputs plant P == Q
(twice), P == -Q and either side at the identity.  No card needed.
"""

import os

import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254_G1 as RefG1
from crescent_tpu.core.curves import BN254G2 as RefG2
from crescent_tpu.core.curves import Curve as RefCurve
from crescent_tpu.core.fields import Fq2 as RefFq2
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import BN254_FR, Fq2
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec
from test_torch_warp_fq2 import Rounds, V, round_sizes, two_warps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP_CUH = os.path.join(ROOT, "crescent_tpu_torch", "csrc", "warp.cuh")
R = 1 << 256
RINV = pow(R, -1, P)
A_NONZERO = 0x1234567


# -- Fq ----------------------------------------------------------------------

def fq_double(X, Y, Z, a: int, rounds: Rounds):
    """warp.cuh's Fq `warp_double`: (1) XX, YY, ZZ, (Y + Z)^2; (2) YYYY,
    (X + YY)^2, M^2 (a = 0) or ZZ^2, then a ZZ^2 and M^2; (3) M (S - X3)."""
    XX, YY, ZZ, YZ2 = rounds.products([(X, X), (Y, Y), (Z, Z), (Y + Z, Y + Z)])
    Z3 = YZ2 - YY - ZZ
    Mm = XX + XX + XX
    if a == 0:
        YYYY, T, MM = rounds.products([(YY, YY), (X + YY, X + YY), (Mm, Mm)])
    else:
        YYYY, T, Z4 = rounds.products([(YY, YY), (X + YY, X + YY), (ZZ, ZZ)])
        (aZ4,) = rounds.products([(V(a * R % P, 0), Z4)])
        Mm = Mm + aZ4
        (MM,) = rounds.products([(Mm, Mm)])
    S = T - XX - YYYY
    S = S + S
    X3 = MM - (S + S)
    (MD,) = rounds.products([(Mm, S - X3)])
    e8 = YYYY + YYYY
    e8 = e8 + e8
    return X3, MD - (e8 + e8), Z3


def fq_jadd(Pt, Qt, a: int, rounds: Rounds):
    """warp.cuh's Fq `jadd_rounds`: five rounds of at most four."""
    X1, Y1, Z1 = Pt
    X2, Y2, Z2 = Qt
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = rounds.products([(Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1)])
    U1, U2, S1, S2 = rounds.products([(X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1)])
    H, r = U2 - U1, S2 - S1
    p_inf, q_inf = Z1.v == 0, Z2.v == 0
    finite = not p_inf and not q_inf
    if finite and H.v == 0 and r.v == 0:
        out = fq_double(X1, Y1, Z1, a, rounds)
    else:
        rr = r + r
        I, RR, ZS2 = rounds.products([(H + H, H + H), (rr, rr), (Z1 + Z2, Z1 + Z2)])
        J, Vv, Z3 = rounds.products([(H, I), (U1, I), (ZS2 - Z1Z1 - Z2Z2, H)])
        X3 = RR - J - (Vv + Vv)
        SJ, T = rounds.products([(S1, J), (rr, Vv - X3)])
        out = (X3, T - (SJ + SJ), Z3)
        if finite and H.v == 0:  # P == -Q
            out = (out[0], out[1], V(0, 0))
    return Qt if p_inf else Pt if q_inf else out


# -- Fq2: (c0, c1) pairs of V --------------------------------------------------

def sq(x):
    """A square's two base products: (x0 + x1)(x0 - x1) and x0 x1."""
    return [(x[0] + x[1], x[0] - x[1]), (x[0], x[1])]


def kar(x, y):
    """A Karatsuba product's three: x0 y0, x1 y1, (x0 + x1)(y0 + y1)."""
    return [(x[0], y[0]), (x[1], y[1]), (x[0] + x[1], y[0] + y[1])]


def from_sq(t):
    return (t[0], t[1] + t[1])


def from_kar(t):
    return (t[0] - t[1], t[2] - t[0] - t[1])


def add2(x, y):
    return (x[0] + y[0], x[1] + y[1])


def sub2(x, y):
    return (x[0] - y[0], x[1] - y[1])


def fq2_jadd_eight(Pt, Qt, rounds: Rounds):
    """warp.cuh's Fq2 `jadd_rounds` on eight product threads: six rounds of
    at most eight."""
    X1, Y1, Z1 = Pt
    X2, Y2, Z2 = Qt
    r1 = rounds.products(sq(Z1) + sq(Z2) + kar(Y1, Z2) + kar(Y2, Z1)[:1])
    Z1Z1, Z2Z2, Y1Z2 = from_sq(r1[0:2]), from_sq(r1[2:4]), from_kar(r1[4:7])
    r2 = rounds.products(kar(Y2, Z1)[1:] + kar(X1, Z2Z2) + kar(X2, Z1Z1))
    Y2Z1 = from_kar([r1[7]] + r2[0:2])
    U1 = from_kar(r2[2:5])
    H = sub2(from_kar(r2[5:8]), U1)
    r3 = rounds.products(kar(Y1Z2, Z2Z2) + kar(Y2Z1, Z1Z1) + sq(add2(Z1, Z2)))
    S1 = from_kar(r3[0:3])
    r = sub2(from_kar(r3[3:6]), S1)
    if _is_dbl(Z1, Z2, H, r):
        return _edges(Pt, Qt, H, r, two_warps(X1, Y1, Z1, rounds))
    rr = add2(r, r)
    Zt = sub2(sub2(from_sq(r3[6:8]), Z1Z1), Z2Z2)
    r4 = rounds.products(sq(add2(H, H)) + sq(rr) + kar(Zt, H))
    I, RR, Z3 = from_sq(r4[0:2]), from_sq(r4[2:4]), from_kar(r4[4:7])
    r5 = rounds.products(kar(H, I) + kar(U1, I))
    J, Vv = from_kar(r5[0:3]), from_kar(r5[3:6])
    X3 = sub2(sub2(RR, J), add2(Vv, Vv))
    r6 = rounds.products(kar(S1, J) + kar(rr, sub2(Vv, X3)))
    SJ = from_kar(r6[0:3])
    return _edges(Pt, Qt, H, r, (X3, sub2(from_kar(r6[3:6]), add2(SJ, SJ)), Z3))


def fq2_jadd_sixteen(Pt, Qt, rounds: Rounds):
    """warp.cuh's Fq2 `jadd_rounds` on four warps' sixteen groups: five
    rounds of at most sixteen."""
    X1, Y1, Z1 = Pt
    X2, Y2, Z2 = Qt
    r1 = rounds.products(sq(Z1) + sq(Z2) + kar(Y1, Z2) + kar(Y2, Z1) + sq(add2(Z1, Z2)))
    Z1Z1, Z2Z2 = from_sq(r1[0:2]), from_sq(r1[2:4])
    Y1Z2, Y2Z1 = from_kar(r1[4:7]), from_kar(r1[7:10])
    Zt = sub2(sub2(from_sq(r1[10:12]), Z1Z1), Z2Z2)
    r2 = rounds.products(kar(X1, Z2Z2) + kar(X2, Z1Z1) + kar(Y1Z2, Z2Z2) + kar(Y2Z1, Z1Z1))
    U1 = from_kar(r2[0:3])
    H = sub2(from_kar(r2[3:6]), U1)
    S1 = from_kar(r2[6:9])
    r = sub2(from_kar(r2[9:12]), S1)
    if _is_dbl(Z1, Z2, H, r):
        return _edges(Pt, Qt, H, r, two_warps(X1, Y1, Z1, rounds))
    rr = add2(r, r)
    r3 = rounds.products(sq(add2(H, H)) + sq(rr) + kar(Zt, H))
    I, RR, Z3 = from_sq(r3[0:2]), from_sq(r3[2:4]), from_kar(r3[4:7])
    r4 = rounds.products(kar(H, I) + kar(U1, I))
    J, Vv = from_kar(r4[0:3]), from_kar(r4[3:6])
    X3 = sub2(sub2(RR, J), add2(Vv, Vv))
    r5 = rounds.products(kar(S1, J) + kar(rr, sub2(Vv, X3)))
    SJ = from_kar(r5[0:3])
    return _edges(Pt, Qt, H, r, (X3, sub2(from_kar(r5[3:6]), add2(SJ, SJ)), Z3))


def _zero2(x) -> bool:
    return x[0].v == 0 and x[1].v == 0


def _is_dbl(Z1, Z2, H, r) -> bool:
    return not _zero2(Z1) and not _zero2(Z2) and _zero2(H) and _zero2(r)


def _edges(Pt, Qt, H, r, out):
    """pt_jadd's end: a side at the identity gives the other; P == -Q
    gives Z = 0."""
    if _zero2(Pt[2]):
        return Qt
    if _zero2(Qt[2]):
        return Pt
    if _zero2(H) and not _zero2(r):
        return (out[0], out[1], (V(0, 0), V(0, 0)))
    return out


# plan -> (its addition, field, slots a round, a line of its signature in
# warp.cuh (the first function that has it), its rounds)
PLANS = {
    "fq": (fq_jadd, "fq", 4, "long long i, PtT<Fe>& R) {", [4, 4, 3, 3, 2]),
    "fq2": (fq2_jadd_eight, "fq2", 8, "X& ex, const JaddRows& in,\n" + " " * 45
            + "long long i, PtT<Fe2>& R) {", [8, 8, 8, 7, 6, 6]),
    "fq2_four_warps": (fq2_jadd_sixteen, "fq2", 16, "BlockGroups<4>& ex,", [12, 12, 7, 6, 6]),
}


def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % P


def _points(field: str, n: int, seed: int):
    """n pairs (P, Q) of seeded Jacobian points in standard form, with P == Q
    (lane 0), P == Q through another representative (1), P == -Q (2), P at
    the identity (3), Q at the identity (4), both (5)."""
    rng = np.random.default_rng(seed)
    if field == "fq":
        el, mul, neg, zero = (lambda: _rand(rng)), (lambda u, v: u * v % P), \
            (lambda u: -u % P), 0
    else:
        el, mul, neg, zero = (lambda: Fq2(_rand(rng), _rand(rng))), (lambda u, v: u * v), \
            (lambda u: -u), Fq2(0, 0)
    pts = [([el() for _ in range(3)], [el() for _ in range(3)]) for _ in range(n)]
    pts[0] = (pts[0][0], list(pts[0][0]))
    x, y, z = pts[1][0]
    lam = el()
    pts[1] = (pts[1][0], [mul(x, mul(lam, lam)), mul(y, mul(lam, mul(lam, lam))), mul(z, lam)])
    x, y, z = pts[2][0]
    pts[2] = (pts[2][0], [x, neg(y), z])
    pts[3][0][2] = zero
    pts[4][1][2] = zero
    pts[5][0][2] = pts[5][1][2] = zero
    return pts


def _mont(field: str, c):
    """A coordinate in standard form -> V (Fq) or a pair of V (Fq2), in
    Montgomery form."""
    if field == "fq":
        return V(c * R % P, 0)
    return (V(c.c0 * R % P, 0), V(c.c1 * R % P, 0))


def _model(plan: str, pts, a: int = 0):
    """The plan's sums (coordinates in Montgomery form as ints, or Fq2) and
    the round sizes of its generic lanes (P != +-Q, both finite)."""
    add, field, slots = PLANS[plan][:3]
    out, sizes = [], []
    for lane, (p, q) in enumerate(pts):
        rounds = Rounds(slots)
        Pt, Qt = ([_mont(field, c) for c in pt] for pt in (p, q))
        s = add(Pt, Qt, a, rounds) if field == "fq" else add(Pt, Qt, rounds)
        if lane > 5:
            sizes.append(rounds.counts)
        out.append([c.v if field == "fq" else Fq2(c[0].v, c[1].v) for c in s])
    assert all(c == sizes[0] for c in sizes)
    return out, sizes[0]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_round_plan_fits_the_slots_and_the_source(plan):
    """Fq: 16 products in five rounds of at most four; Fq2: 43 base products
    in six of at most eight, or in five of at most sixteen on four warps.
    The source's addition runs the same rounds."""
    _, field, slots, head, sizes = PLANS[plan]
    _, counts = _model(plan, _points(field, 8, 1))
    assert counts == sizes and max(counts) <= slots
    assert sum(counts) == (16 if field == "fq" else 43)
    assert round_sizes(WARP_CUH, head) == sizes


def _plain(field: str, a: int, pts, got):
    """jadd_plain on the same inputs (Montgomery words) against the model's
    sums."""
    mont = (lambda c: c * R % P) if field == "fq" else (lambda c: Fq2(c.c0 * R % P, c.c1 * R % P))
    ec = get_cuda_ec(P, a) if field == "fq" else get_cuda_quad_ec(P)
    planes = [ec.ctx.words([mont(pt[side][j]) for pt in pts]) for side in (0, 1) for j in range(3)]
    want = ec.jadd_plain(*planes)
    for j, plane in enumerate(want):
        assert torch.equal(plane, ec.ctx.words([s[j] for s in got])), j


@pytest.mark.parametrize("plan, a", [("fq", 0), ("fq", A_NONZERO), ("fq2", 0),
                                     ("fq2_four_warps", 0)],
                         ids=["fq", "fq_a_nonzero", "fq2", "fq2_four_warps"])
def test_round_plan_matches_plain_jadd(plan, a):
    """The plan's sums are bit-equal to jadd_plain (pt_jadd's formula, which
    the kernels are held to on the card), the edge lanes included."""
    field = PLANS[plan][1]
    pts = _points(field, 12, 2)
    got, _ = _model(plan, pts, a)
    _plain(field, a, pts, got)


@pytest.mark.parametrize("plan, a", [("fq", 0), ("fq", A_NONZERO), ("fq2", 0)],
                         ids=["fq", "fq_a_nonzero", "fq2"])
def test_round_plan_matches_reference_addition(plan, a):
    """In affine form, the kernels' plans add as the JAX package's host
    group law does (BN254 G1, a curve with a != 0 over the same field, and
    BN254G2); P == -Q and a sum at the identity give Z = 0."""
    field = PLANS[plan][1]
    pts = _points(field, 12, 3)
    got, _ = _model(plan, pts, a)
    if field == "fq":
        ref = RefG1 if a == 0 else RefCurve("a_nonzero", P, a, 3, BN254_FR, 1, 2)
        conv = int
        back = (lambda c: c * RINV % P)
        inv = (lambda c: pow(c, -1, P))
    else:
        ref = RefG2
        conv = (lambda c: RefFq2(c.c0, c.c1))
        back = (lambda c: RefFq2(c.c0 * RINV % P, c.c1 * RINV % P))
        inv = (lambda c: c.inv())

    def affine(X, Y, Z):
        if (Z == 0) if field == "fq" else Z.is_zero():
            return None
        zi = inv(Z)
        if field == "fq":
            return (X * zi * zi % P, Y * zi * zi * zi % P)
        return (X * zi * zi, Y * zi * zi * zi)

    for (p, q), s in zip(pts, got):
        want = ref.add(affine(*map(conv, p)), affine(*map(conv, q)))
        assert affine(*map(back, s)) == want
