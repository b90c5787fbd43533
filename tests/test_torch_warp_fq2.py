"""The round plans of the Fq2 `jdbl_n` kernel (crescent_tpu_torch/csrc/warp.cuh,
`warp_double` over `Fe2`: two warps a lane) and of its one-warp design
alternative (scripts/chain_designs.py `one_warp`), modelled in Python ints:
each doubling's base products in rounds of at most eight (two warps' eight
8-thread groups) or four (one warp's four), each product taking its inputs
only from earlier rounds.  The models' doublings are held exactly
(tolerance 0) against the port's plain `double_plain` over `QuadCtx` and
against the JAX package's host G2 doubling; no card needed.
"""

import os
import re

import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254G2 as RefG2
from crescent_tpu.core.fields import Fq2 as RefFq2
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.ops.cuda_ec import double_plain
from crescent_tpu_torch.ops.quadratic import get_fq2_ctx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP_CUH = os.path.join(ROOT, "crescent_tpu_torch", "csrc", "warp.cuh")
DESIGNS_PY = os.path.join(ROOT, "scripts", "chain_designs.py")
R = 1 << 256
RINV = pow(R, -1, P)


def round_sizes(path: str, head: str) -> list[int]:
    """The products of each round of the function whose signature contains
    `head` (up to its closing brace in column 0): the sizes of the arrays
    that its executor's `run` calls fill, in order (a doubling branch is a
    call of its own)."""
    with open(path) as f:
        src = f.read()
    body = src[src.index(head):]
    body = body[: body.index("\n}\n")]
    sizes = dict(re.findall(r"Fe (\w+)\[(\d+)\];", body))
    return [int(sizes[name]) for name in re.findall(r"\b\w+\.run\([^;]*?(\w+)\);", body)]


class V:
    """A canonical base-field element in Montgomery form and the round after
    which every thread holds it (0: the doubling's input)."""

    def __init__(self, v: int, ready: int):
        assert 0 <= v < P
        self.v, self.ready = v, ready

    def __add__(self, o):
        return V((self.v + o.v) % P, max(self.ready, o.ready))

    def __sub__(self, o):
        return V((self.v - o.v) % P, max(self.ready, o.ready))


class Rounds:
    """Counts the base products of each round and checks their inputs."""

    def __init__(self, groups: int):
        self.groups = groups  # 8-thread groups: products a round
        self.counts: list[int] = []

    def products(self, pairs):
        r = len(self.counts) + 1
        assert len(pairs) <= self.groups, f"round {r} has {len(pairs)} products"
        for a, b in pairs:
            assert a.ready < r and b.ready < r, f"round {r} reads a value of its own round"
        self.counts.append(len(pairs))
        return [V(a.v * b.v * RINV % P, r) for a, b in pairs]


def _sqr(c0, c1):
    """An Fq2 square's two base products: (c0 + c1)(c0 - c1) and c0 c1."""
    return [(c0 + c1, c0 - c1), (c0, c1)]


def _karatsuba(a, b, t0, t1, t2):
    """(a0 + a1 u)(b0 + b1 u) from t0 = a0 b0, t1 = a1 b1,
    t2 = (a0 + a1)(b0 + b1)."""
    return (t0 - t1, t2 - t0 - t1)


def two_warps(X, Y, Z, rounds: Rounds):
    """One doubling as warp.cuh runs it: (X, Y, Z) are (c0, c1) pairs of V."""
    x0, x1 = X
    y0, y1 = Y
    z0, z1 = Z
    ys = y0 + y1
    r1 = rounds.products(_sqr(x0, x1) + _sqr(y0, y1) + [(y0, z0), (y1, z1), (ys, z0 + z1)])
    XX = (r1[0], r1[1] + r1[1])
    YY = (r1[2], r1[3] + r1[3])
    YZ = _karatsuba(Y, Z, *r1[4:7])
    T = (x0 + YY[0], x1 + YY[1])
    Mm = tuple(a + a + a for a in XX)
    r2 = rounds.products(_sqr(*YY) + _sqr(*T) + _sqr(*Mm))
    YYYY = (r2[0], r2[1] + r2[1])
    TT = (r2[2], r2[3] + r2[3])
    S = tuple(t - a - b for t, a, b in zip(TT, XX, YYYY))
    S = tuple(s + s for s in S)
    X3 = tuple(m - (s + s) for m, s in zip((r2[4], r2[5] + r2[5]), S))
    D = tuple(s - x for s, x in zip(S, X3))
    r3 = rounds.products([(Mm[0], D[0]), (Mm[1], D[1]), (Mm[0] + Mm[1], D[0] + D[1])])
    return X3, _y3(_karatsuba(Mm, D, *r3), YYYY), tuple(a + a for a in YZ)


def one_warp(X, Y, Z, rounds: Rounds):
    """The one-warp design alternative: four rounds of four."""
    x0, x1 = X
    y0, y1 = Y
    z0, z1 = Z
    ys = y0 + y1
    r1 = rounds.products(_sqr(x0, x1) + _sqr(y0, y1))
    XX = (r1[0], r1[1] + r1[1])
    YY = (r1[2], r1[3] + r1[3])
    T = (x0 + YY[0], x1 + YY[1])
    r2 = rounds.products(_sqr(*YY) + _sqr(*T))
    YYYY = (r2[0], r2[1] + r2[1])
    TT = (r2[2], r2[3] + r2[3])
    S = tuple(t - a - b for t, a, b in zip(TT, XX, YYYY))
    S = tuple(s + s for s in S)
    Mm = tuple(a + a + a for a in XX)
    r3 = rounds.products(_sqr(*Mm) + [(y0, z0), (y1, z1)])
    X3 = tuple(m - (s + s) for m, s in zip((r3[0], r3[1] + r3[1]), S))
    D = tuple(s - x for s, x in zip(S, X3))
    r4 = rounds.products([(Mm[0], D[0]), (Mm[1], D[1]), (Mm[0] + Mm[1], D[0] + D[1]),
                          (ys, z0 + z1)])
    YZ = _karatsuba(Y, Z, r3[2], r3[3], r4[3])
    return X3, _y3(_karatsuba(Mm, D, *r4[:3]), YYYY), tuple(a + a for a in YZ)


def _y3(MD, YYYY):
    """Y3 = M (S - X3) - 8 YYYY."""
    e8 = tuple(e + e for e in YYYY)
    e8 = tuple(e + e for e in e8)
    return tuple(m - (e + e) for m, e in zip(MD, e8))


# plan -> (its doubling, groups a round, the source that runs it, the
# rounds' sizes)
PLANS = {
    "two_warps": (two_warps, 8, WARP_CUH, [7, 6, 3]),
    "one_warp": (one_warp, 4, DESIGNS_PY, [4, 4, 4, 4]),
}


def _points(n: int, seed: int):
    """n Jacobian points of seeded Fq2 coordinates (standard form), the
    identity (Z = 0) in lane 3 and Y = 0 in lane 5."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % P

    pts = [[Fq2(rand(), rand()) for _ in range(3)] for _ in range(n)]
    pts[3][2] = Fq2(0, 0)
    pts[5][1] = Fq2(0, 0)
    return pts


def _model(plan: str, pts, count: int):
    """The plan's `count` doublings of each point -> Fq2 coordinates in
    Montgomery form, and each round's product count."""
    double, groups = PLANS[plan][:2]
    out, counts = [], None
    for pt in pts:
        X, Y, Z = ((V(c.c0 * R % P, 0), V(c.c1 * R % P, 0)) for c in pt)
        for _ in range(count):
            rounds = Rounds(groups)
            X, Y, Z = double(X, Y, Z, rounds)
            X, Y, Z = ((V(a.v, 0), V(b.v, 0)) for a, b in (X, Y, Z))
            assert counts in (None, rounds.counts)
            counts = rounds.counts
        out.append([Fq2(a.v, b.v) for a, b in (X, Y, Z)])
    return out, counts


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_round_plan_fits_the_groups_and_the_source(plan):
    """16 base products (dbl-2007-bl's 17 less the one that Z3 = 2 Y Z saves
    with a = 0): two warps in three rounds (7, 6, 3), one warp in four of
    four; the source's Fq2 doubling passes on the same rounds."""
    _, groups, path, sizes = PLANS[plan]
    _, counts = _model(plan, _points(6, 1), 1)
    assert counts == sizes and sum(counts) == 16 and max(counts) <= groups
    assert round_sizes(path, "PtT<Fe2> warp_double(") == sizes


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("count", [1, 3])
def test_round_plan_matches_plain_double(plan, count):
    """The plan's doublings are bit-equal to double_plain over QuadCtx
    (pt_double's formula, which the kernel is held to on the card)."""
    pts = _points(8, 2)
    got, _ = _model(plan, pts, count)
    q = get_fq2_ctx()
    x, y, z = (q.words([Fq2(pt[j].c0 * R, pt[j].c1 * R) for pt in pts]) for j in range(3))
    for _ in range(count):
        x, y, z = double_plain(q, None, x, y, z)
    for j, plane in enumerate((x, y, z)):
        assert torch.equal(plane, q.words([pt[j] for pt in got])), j


def test_round_plan_matches_reference_g2_doubling():
    """In affine form, the kernel's plan doubles as the JAX package's host
    G2 doubling (BN254G2.add(P, P)) does; the identity doubles to the
    identity."""
    pts = _points(6, 3)
    got, _ = _model("two_warps", pts, 1)
    for pt, dbl in zip(pts, got):
        X, Y, Z = (RefFq2(c.c0, c.c1) for c in pt)
        X3, Y3, Z3 = (RefFq2(c.c0 * RINV, c.c1 * RINV) for c in dbl)
        if Z.is_zero():
            assert Z3.is_zero()
            continue
        zi = Z.inv()
        ref = RefG2.add((X * zi * zi, Y * zi * zi * zi), (X * zi * zi, Y * zi * zi * zi))
        if ref is None:  # y = 0: 2P is the identity
            assert Z3.is_zero()
            continue
        z3i = Z3.inv()
        assert (X3 * z3i * z3i, Y3 * z3i * z3i * z3i) == ref
