"""The round plans of the `madd` lane body (crescent_tpu_torch/csrc/warp.cuh
`madd_sum` and `madd_rounds`, run by csrc/madd.cuh's `madd` and
`fixed_base` kernels), modelled in Python ints, and the window kernel's
plain version `fixed_base_plain` against the JAX package's fixed base.

* The mixed addition's products in rounds, each product taking its inputs
  only from earlier rounds: Fq 11 products in five rounds (2, 2, 3, 2, 2),
  Fq2 30 base products in five rounds (5, 6, 7, 6, 6; Z3 as 2 Z1 H, a
  Karatsuba product, in place of (Z1 + H)^2 - Z1Z1 - HH), none with more than
  the eight product threads of the widest executor; P == Q takes the
  doubling's plan (warp.cuh `warp_double`), P the identity takes Q with
  Z = 1 and no product.  The round sizes are read out of the source.  The
  models' sums equal `madd_plain` over `ModCtx` (a = 0 and a != 0) and
  `QuadCtx` bit for bit, with P == Q, P == -Q, P the identity, valid == 0
  and sign set planted.
* `fixed_base_plain` (the reference's scan of row gathers and `madd`) on a
  G1 table against the JAX package's `FixedBaseMSM.run` on the CPU (its
  XLA adapter, as tests/test_fixed_base.py runs it), affine ints exact.

Tolerance 0 throughout; no card needed.
"""

import os
import random

import numpy as np
import pytest
import torch

from crescent_tpu.models.groth16 import G1 as RefG1
from crescent_tpu.ops import limb as ref_limb
from crescent_tpu.ops.ec import get_curve_ctx as ref_curve_ctx
from crescent_tpu.ops.fixed_base import FixedBaseMSM as RefFixedBaseMSM
from crescent_tpu_torch.core.curves import BN254_G1
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec
from crescent_tpu_torch.ops.ec import get_curve_ctx
from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM
from test_torch_jadd_rounds import add2, fq_double, from_kar, from_sq, kar, sq, sub2
from test_torch_warp_fq2 import Rounds, V, round_sizes, two_warps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP_CUH = os.path.join(ROOT, "crescent_tpu_torch", "csrc", "warp.cuh")
R = 1 << 256
RINV = pow(R, -1, P)
A_NONZERO = 0x1234567
SLOTS = 8  # the most product threads a lane (Fq2)


def fq_madd(Pt, qx, qy, a: int, rounds: Rounds):
    """warp.cuh's Fq `madd_sum` (P finite; the doubling where P == Q)."""
    X1, Y1, Z1 = Pt
    Z1Z1, QZ = rounds.products([(Z1, Z1), (qy, Z1)])
    U2, S2 = rounds.products([(qx, Z1Z1), (QZ, Z1Z1)])
    H, r = U2 - X1, S2 - Y1
    if H.v == 0 and r.v == 0:
        return fq_double(X1, Y1, Z1, a, rounds)
    rr = r + r
    HH, RR, ZH2 = rounds.products([(H, H), (rr, rr), (Z1 + H, Z1 + H)])
    I = HH + HH
    I = I + I
    J, Vv = rounds.products([(H, I), (X1, I)])
    X3 = RR - J - (Vv + Vv)
    YJ, T = rounds.products([(Y1, J), (rr, Vv - X3)])
    return X3, T - (YJ + YJ), ZH2 - Z1Z1 - HH


def fq2_madd(Pt, qx, qy, rounds: Rounds):
    """warp.cuh's Fq2 `madd_sum`: (c0, c1) pairs of V."""
    X1, Y1, Z1 = Pt
    r1 = rounds.products(sq(Z1) + kar(qy, Z1))
    Z1Z1, QZ = from_sq(r1[0:2]), from_kar(r1[2:5])
    r2 = rounds.products(kar(qx, Z1Z1) + kar(QZ, Z1Z1))
    H = sub2(from_kar(r2[0:3]), X1)
    r = sub2(from_kar(r2[3:6]), Y1)
    if all(c.v == 0 for c in H + r):
        return two_warps(X1, Y1, Z1, rounds)
    rr = add2(r, r)
    r3 = rounds.products(sq(H) + sq(rr) + kar(Z1, H))
    HH = from_sq(r3[0:2])
    I = add2(HH, HH)
    I = add2(I, I)
    r4 = rounds.products(kar(H, I) + kar(X1, I))
    J, Vv = from_kar(r4[0:3]), from_kar(r4[3:6])
    X3 = sub2(sub2(from_sq(r3[2:4]), J), add2(Vv, Vv))
    r5 = rounds.products(kar(Y1, J) + kar(rr, sub2(Vv, X3)))
    YJ = from_kar(r5[0:3])
    ZH = from_kar(r3[4:7])
    return X3, sub2(from_kar(r5[3:6]), add2(YJ, YJ)), add2(ZH, ZH)


# field -> (a line of madd_sum's signature in warp.cuh, its rounds)
PLANS = {"fq": ("const Fe& qy, PtT<Fe>& P) {", [2, 2, 3, 2, 2]),
         "fq2": ("const Fe2& qy, PtT<Fe2>& P) {", [5, 6, 7, 6, 6])}


def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % P


def _inputs(field: str, n: int, seed: int):
    """n lanes (P Jacobian, Q affine, valid, sign) in standard form, with
    P == Q (lane 0), P == -Q (1), P the identity (2), valid == 0 (3), sign
    with -Q == P (4: the doubling), sign with -Q == -P (5: the identity),
    sign generic (6); seeded elsewhere, valid 0 in one lane of eight."""
    rng = np.random.default_rng(seed)
    if field == "fq":
        el, mul, neg, zero = (lambda: _rand(rng)), (lambda u, v: u * v % P), \
            (lambda u: -u % P), 0
    else:
        el, mul, neg, zero = (lambda: Fq2(_rand(rng), _rand(rng))), (lambda u, v: u * v), \
            (lambda u: -u), Fq2(0, 0)
    lanes = []
    for i in range(n):
        (x, y, z), (qx, qy) = [el() for _ in range(3)], [el() for _ in range(2)]
        if i in (0, 1, 4, 5):  # P the Jacobian form of Q or -Q
            zz = mul(z, z)
            x, y = mul(qx, zz), mul(qy, mul(zz, z))
            y = neg(y) if i in (1, 4) else y
        if i == 2:
            z = zero
        lanes.append(([x, y, z], [qx, qy], int(i != 3 and (i < 7 or i % 8)),
                      int(i in (4, 5, 6) or (i > 6 and rng.integers(2)))))
    return lanes


def _mont(field: str, c):
    if field == "fq":
        return V(c * R % P, 0)
    return (V(c.c0 * R % P, 0), V(c.c1 * R % P, 0))


def _neg(field: str, c):
    if field == "fq":
        return V(-c.v % P, c.ready)
    return tuple(V(-x.v % P, x.ready) for x in c)


def _model(field: str, lanes, a: int = 0):
    """madd_rounds on each lane (Montgomery ints, or Fq2 of them) and the
    round sizes of its generic lanes."""
    out, sizes = [], []
    one = _mont(field, 1 if field == "fq" else Fq2(1, 0))
    for i, (p, q, valid, sign) in enumerate(lanes):
        Pt = [_mont(field, c) for c in p]
        qx, qy = (_mont(field, c) for c in q)
        qy = _neg(field, qy) if sign else qy
        p_inf = Pt[2].v == 0 if field == "fq" else all(c.v == 0 for c in Pt[2])
        rounds = Rounds(SLOTS)
        if not valid:
            s = Pt
        elif p_inf:
            s = (qx, qy, one)
        else:
            s = fq_madd(Pt, qx, qy, a, rounds) if field == "fq" else fq2_madd(Pt, qx, qy, rounds)
        if i > 6 and valid:
            sizes.append(rounds.counts)
        out.append([c.v if field == "fq" else Fq2(c[0].v, c[1].v) for c in s])
    assert sizes and all(c == sizes[0] for c in sizes)
    return out, sizes[0]


@pytest.mark.parametrize("field", sorted(PLANS))
def test_madd_round_plan_fits_and_matches_the_source(field):
    """Fq: 11 products in five rounds; Fq2: 30 base products in five rounds
    of at most eight (Z3 as 2 Z1 H).  The source's madd_sum runs the same
    rounds."""
    head, sizes = PLANS[field]
    _, counts = _model(field, _inputs(field, 16, 1))
    assert counts == sizes and max(counts) <= SLOTS
    assert sum(counts) == (11 if field == "fq" else 30)
    assert round_sizes(WARP_CUH, head) == sizes


@pytest.mark.parametrize("field, a", [("fq", 0), ("fq", A_NONZERO), ("fq2", 0)],
                         ids=["fq", "fq_a_nonzero", "fq2"])
def test_madd_round_plan_matches_plain_madd(field, a):
    """The plan's sums are bit-equal to madd_plain (pallas_ec._madd_body's
    formula, which the kernels are held to on the card), the planted lanes
    included:
    P == Q doubles, P == -Q and a signed -Q == -P give Z = 0, the identity
    gives Q, valid == 0 gives P."""
    lanes = _inputs(field, 24, 2 + a % 5)
    got, _ = _model(field, lanes, a)
    ec = get_cuda_ec(P, a) if field == "fq" else get_cuda_quad_ec(P)
    mont = (lambda c: c * R % P) if field == "fq" else \
        (lambda c: Fq2(c.c0 * R % P, c.c1 * R % P))
    planes = [ec.ctx.words([mont(ln[0][j]) for ln in lanes]) for j in range(3)]
    planes += [ec.ctx.words([mont(ln[1][j]) for ln in lanes]) for j in range(2)]
    valid, sign = (torch.tensor([ln[k] for ln in lanes], dtype=torch.int32) for k in (2, 3))
    want = ec.madd_plain(*planes, valid, sign)
    for j, plane in enumerate(want):
        assert torch.equal(plane, ec.ctx.words([s[j] for s in got])), j
    z = want[2]
    assert not z[1].any() and not z[5].any() and z[0].any() and z[4].any()
    assert torch.equal(want[0][3], planes[0][3])


def test_fixed_base_plain_matches_reference():
    """fixed_base_plain on a G1 table of 70 scalars (0, 1, n - 1 and
    (n + 1) / 2 among them, and zero digits) equals the JAX package's
    FixedBaseMSM.run (chunk 64: two chunks, padding lanes) on the CPU, in
    affine ints."""
    rng = random.Random(13)
    n = BN254_G1.n
    ks = [0, 1, n - 1, (n + 1) // 2] + [rng.randrange(n) for _ in range(66)]
    ks[5] &= ~(0xFFFFFF << 64)  # three zero digits
    ref = RefFixedBaseMSM(ref_curve_ctx(RefG1), chunk=64)
    table = nb.fixed_base("bn254_g1", BN254_G1.generator, ref.table_scalars())
    want = list(ref.run(table, ref_limb.ints_to_limbs(ks)))

    ctx = get_curve_ctx(BN254_G1)
    fb = FixedBaseMSM(ctx)
    assert fb.table_scalars() == ref.table_scalars()
    sc = limb.limbs_to_words(limb.ints_to_limbs(ks))
    X, Y, Z = ctx.ec.fixed_base_plain(fb.table_planes(table, "cpu"), sc)
    got = []
    for x, y, z in zip(*(limb.limbs_to_ints(limb.words_to_limbs(t)) for t in (X, Y, Z))):
        if z == 0:
            got.append(None)
            continue
        zi = pow(z * RINV % P, -1, P)
        got.append((x * RINV * zi * zi % P, y * RINV * zi * zi * zi % P))
    assert got == want
    assert got[0] is None and all(g is not None for g in got[1:])
