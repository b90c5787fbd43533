"""BN254 optimal-ate pairing, host-exact.

Pairings only appear on the *verifier* side of the stack (Groth16 verify:
3 pairings, KZG batch_check: 2 pairings — reference
forks/groth16/src/verifier.rs:44, forks/ark-poly-commit/src/kzg10/mod.rs:357),
cost a few ms, and need bit-exact interop — so they stay on host, per
SURVEY.md §2c.  The TPU carries the prover-side MSM/NTT load instead.

Implementation: generic affine Miller loop over E(Fq12) with the D-type
sextic twist untwisting map, loop count 6u+2, two Frobenius correction
lines, and a plain (p^12-1)/r final exponentiation split into easy/hard
parts.  The Python tower below is the exact oracle; production calls are
routed through the native C++ mirror of the same construction
(native/bigcurve.cpp pairing tower, ~1000x faster) and fall back here when
no toolchain exists.  CRESCENT_HOST_PAIRING=1 forces the Python path
(used by the bit-exactness tests).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .curves import AffinePoint, G2Point
from .fields import BN254_FQ as P
from .fields import BN254_FR as R
from .fields import Fq2, Fq6, Fq12

# BN parameter: p(u), r(u) for u below (standard alt_bn128 parameter).
BN_U = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_U + 2  # 29793968203157093288

Fq12Point = Optional[Tuple[Fq12, Fq12]]


def _fq12_from_fq(a: int) -> Fq12:
    return Fq12(Fq6(Fq2(a, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())


def _fq12_from_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


# w^2 and w^3 in the Fq12 tower (w is the Fq12 generator over Fq6):
#   w^2 = (0, v, 0)... in Fq6-coefficients of Fq12: w^2 = v (element of Fq6),
#   w^3 = v * w.
W2 = Fq12(Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()), Fq6.zero())
W3 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()))


def untwist(q: G2Point) -> Fq12Point:
    """E'(Fq2) -> E(Fq12): (x, y) -> (x * w^2, y * w^3)."""
    if q is None:
        return None
    x, y = q
    return (_fq12_from_fq2(x) * W2, _fq12_from_fq2(y) * W3)


def _add_eval(t: Fq12Point, q: Fq12Point, px: Fq12, py: Fq12) -> tuple[Fq12, Fq12Point]:
    """Line through t and q evaluated at p; returns (line_value, t+q)."""
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        lam = (x1 * x1 * _fq12_from_fq(3)) * (y1 * _fq12_from_fq(2)).inv()
    elif x1 == x2:
        # t = -q: vertical line X - x1
        return _sub(px, x1), None
    else:
        lam = _sub(y2, y1) * _sub(x2, x1).inv()
    line = _sub(_sub(py, y1), lam * _sub(px, x1))
    x3 = _sub(_sub(lam * lam, x1), x2)
    y3 = _sub(lam * _sub(x1, x3), y1)
    return line, (x3, y3)


def _sub(a: Fq12, b: Fq12) -> Fq12:
    return Fq12(a.c0 - b.c0, a.c1 - b.c1)


def _neg(a: Fq12) -> Fq12:
    return Fq12(-a.c0, -a.c1)


def _one() -> Fq12:
    return Fq12.one()


def miller_loop(p: AffinePoint, q: G2Point) -> Fq12:
    """Optimal-ate Miller loop f_{6u+2,Q}(P) with Frobenius correction lines."""
    if p is None or q is None:
        return Fq12.one()
    px = _fq12_from_fq(p[0])
    py = _fq12_from_fq(p[1])
    qt = untwist(q)

    f = Fq12.one()
    t = qt
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
    for b in bits:
        line, t = _add_eval(t, t, px, py)
        f = f * f * line
        if b == "1":
            line, t = _add_eval(t, qt, px, py)
            f = f * line

    # Frobenius corrections: Q1 = pi_p(Q), Q2 = -pi_p^2(Q), both in E(Fq12).
    q1 = (qt[0].frobenius(1), qt[1].frobenius(1))
    q2 = (qt[0].frobenius(2), _neg(qt[1].frobenius(2)))
    line, t = _add_eval(t, q1, px, py)
    f = f * line
    line, t = _add_eval(t, q2, px, py)
    f = f * line
    return f


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r), easy part via Frobenius, hard part by plain pow."""
    # easy: f^(p^6 - 1) = conj(f) * f^-1 ; then ^(p^2 + 1)
    f1 = f.conjugate() * f.inv()
    f2 = f1.frobenius(2) * f1
    # hard: ^((p^4 - p^2 + 1) / r)
    e = (P**4 - P**2 + 1) // R
    return f2.pow(e)


def _native_multi_pairing(pairs) -> Optional[Fq12]:
    """Native C++ path (bit-identical construction); None if unavailable."""
    if os.environ.get("CRESCENT_HOST_PAIRING") == "1":
        return None
    try:
        from ..native import backend

        vals = backend.multi_pairing_raw(pairs)
    except Exception:
        return None
    if vals is None:
        return None
    return Fq12(
        Fq6(Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]), Fq2(vals[4], vals[5])),
        Fq6(Fq2(vals[6], vals[7]), Fq2(vals[8], vals[9]), Fq2(vals[10], vals[11])),
    )


def pairing(p: AffinePoint, q: G2Point) -> Fq12:
    r = _native_multi_pairing([(p, q)])
    if r is not None:
        return r
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs) -> Fq12:
    """prod e(P_i, Q_i) with a single shared final exponentiation."""
    pairs = list(pairs)
    r = _native_multi_pairing(pairs)
    if r is not None:
        return r
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


def pairing_product_is_one(pairs) -> bool:
    return multi_pairing(pairs) == Fq12.one()
