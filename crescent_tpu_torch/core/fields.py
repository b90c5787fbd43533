"""Host-exact prime-field arithmetic (arbitrary precision, Python ints).

This layer is the *correctness oracle* for every TPU kernel in
``crescent_tpu.ops``: each limb-decomposed JAX/Pallas field op is validated
bit-exactly against these implementations.  It also runs the cold paths that
stay on host (pairings, transcript hashing, small sigma-protocol algebra).

Field inventory mirrors the reference stack (see SURVEY.md §1/L0):
  * BN254 scalar field Fr and base field Fq (+ Fq2/Fq6/Fq12 tower for the
    pairing) — reference: forks/halo2curves/src/bn256, ark-bn254.
  * P-256 (secp256r1) base/scalar fields — reference: forks/halo2curves/src/secp256r1.
  * T-256 ("Tom-256") base/scalar fields — reference: forks/halo2curves/src/t256/{fp,fq}.rs.
    T-256's scalar field equals P-256's base field, which is what lets the
    Spartan ECDSA proof-of-possession commit to P-256 coordinates natively.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Moduli (mathematical constants of the standard curves / reference curves)
# ---------------------------------------------------------------------------

# BN254 (alt_bn128), as used by circom --prime bn128 and arkworks ark-bn254.
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# NIST P-256 / secp256r1.
P256_FP = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_FQ = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551

# T-256 ("Tom-256"): curve whose scalar field is P-256's base field.
# Constants from forks/halo2curves/src/t256/{fp.rs:10,fq.rs:10}.
T256_FP = 0xFFFFFFFF0000000100000000000000017E72B42B30E7317793135661B1C4B117
T256_FQ = P256_FP  # t256/fq.rs modulus == P-256 base prime


def _egcd_inv(a: int, m: int) -> int:
    """Modular inverse via Python's built-in (3.8+) pow."""
    return pow(a, -1, m)


@dataclass(frozen=True)
class PrimeField:
    """A prime field GF(p) operating on plain ints in [0, p)."""

    p: int
    name: str = "Fp"

    # -- basic ops ----------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return _egcd_inv(a % self.p, self.p)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def exp(self, a: int, e: int) -> int:
        return pow(a % self.p, e, self.p)

    def sqrt(self, a: int) -> int | None:
        """Tonelli–Shanks; returns the even square root or None."""
        a %= self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        p = self.p
        if p % 4 == 3:
            r = pow(a, (p + 1) // 4, p)
        else:
            # general Tonelli–Shanks
            q, s = p - 1, 0
            while q % 2 == 0:
                q //= 2
                s += 1
            z = 2
            while self.legendre(z) != -1:
                z += 1
            m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
            while t != 1:
                i, t2 = 0, t
                while t2 != 1:
                    t2 = t2 * t2 % p
                    i += 1
                b = pow(c, 1 << (m - i - 1), p)
                m, c = i, b * b % p
                t, r = t * c % p, r * b % p
        return min(r, p - r)

    def legendre(self, a: int) -> int:
        ls = pow(a % self.p, (self.p - 1) // 2, self.p)
        return -1 if ls == self.p - 1 else ls

    # -- NTT support --------------------------------------------------------
    @functools.cached_property
    def two_adicity(self) -> int:
        s, q = 0, self.p - 1
        while q % 2 == 0:
            q //= 2
            s += 1
        return s

    @functools.cached_property
    def multiplicative_generator(self) -> int:
        """Smallest generator of the full multiplicative group."""
        p = self.p
        factors = _factorize_small(p - 1)
        for g in range(2, 1000):
            if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
                return g
        raise RuntimeError("no small generator found")

    def root_of_unity(self, order: int) -> int:
        """Primitive `order`-th root of unity (order must divide p-1, power of 2)."""
        assert (self.p - 1) % order == 0
        g = self.multiplicative_generator
        w = pow(g, (self.p - 1) // order, self.p)
        return w

    # -- serialization ------------------------------------------------------
    @functools.cached_property
    def nbytes(self) -> int:
        return (self.p.bit_length() + 7) // 8

    def to_bytes_le(self, a: int) -> bytes:
        return int(a % self.p).to_bytes(self.nbytes, "little")

    def from_bytes_le(self, b: bytes) -> int:
        v = int.from_bytes(b, "little")
        assert v < self.p, "non-canonical field repr"
        return v


def _factorize_small(n: int) -> list[int]:
    """Distinct prime factors; falls back to treating a large residue as prime."""
    out = []
    for d in [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43]:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
    if n > 1:
        out.append(n)  # good enough for generator checks on crypto primes
    return out


# Canonical instances -------------------------------------------------------
Fr = PrimeField(BN254_FR, "BN254::Fr")
Fq = PrimeField(BN254_FQ, "BN254::Fq")
P256Fp = PrimeField(P256_FP, "P256::Fp")
P256Fq = PrimeField(P256_FQ, "P256::Fq")
T256Fp = PrimeField(T256_FP, "T256::Fp")
T256Fq = PrimeField(T256_FQ, "T256::Fq")  # == P256Fp


# ---------------------------------------------------------------------------
# BN254 extension tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)),
# Fq12 = Fq6[w]/(w^2 - v).  Used host-side for pairings only (verifier path:
# a handful of ms; see SURVEY.md §2c "verifier-side pairings stay on host").
# ---------------------------------------------------------------------------

P = BN254_FQ


class Fq2:
    __slots__ = ("c0", "c1")
    NON_RESIDUE = (9, 1)  # xi = 9 + u

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero():
        return Fq2(0, 0)

    @staticmethod
    def one():
        return Fq2(1, 0)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 u)(b0 + b1 u), u^2 = -1
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        return Fq2((self.c0 + self.c1) * (self.c0 - self.c1), 2 * self.c0 * self.c1)

    def mul_by_nonresidue(self):
        # * (9 + u)
        return Fq2(9 * self.c0 - self.c1, self.c0 + 9 * self.c1)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        t = _egcd_inv((self.c0 * self.c0 + self.c1 * self.c1) % P, P)
        return Fq2(self.c0 * t, -self.c1 * t)

    def frobenius(self, power: int):
        if power % 2 == 0:
            return Fq2(self.c0, self.c1)
        return self.conjugate()

    def pow(self, e: int):
        r, b = Fq2.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __repr__(self):
        return f"Fq2({self.c0:#x}, {self.c1:#x})"


# Frobenius coefficients for the tower, computed once at import (exact math,
# standard for BN curves): xi^((p^k - 1)/d) for the relevant (k, d).
_XI = Fq2(9, 1)


FROB_C1_6 = [_XI.pow((P**k - 1) // 3) for k in range(6)]
FROB_C2_6 = [_XI.pow(2 * (P**k - 1) // 3) for k in range(6)]
FROB_C1_12 = [_XI.pow((P**k - 1) // 6) for k in range(12)]


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        # * v :  (c0, c1, c2) -> (xi*c2, c0, c1)
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        t = ((a2 * t1 + a1 * t2).mul_by_nonresidue() + a0 * t0).inv()
        return Fq6(t0 * t, t1 * t, t2 * t)

    def frobenius(self, power: int):
        return Fq6(
            self.c0.frobenius(power),
            self.c1.frobenius(power) * FROB_C1_6[power % 6],
            self.c2.frobenius(power) * FROB_C2_6[power % 6],
        )

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_nonresidue()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conjugate(self):
        return Fq12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def frobenius(self, power: int):
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power)
        g = FROB_C1_12[power % 12]
        return Fq12(c0, Fq6(c1.c0 * g, c1.c1 * g, c1.c2 * g))

    def pow(self, e: int):
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r
