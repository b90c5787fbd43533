"""Host-exact elliptic-curve arithmetic (affine/Jacobian, Python ints).

Correctness oracle for the batched TPU point kernels in
``crescent_tpu.ops.ec`` and reference implementation for cold host paths
(pairing preparation, tiny fixed-cost scalar muls in verifiers).

Curves (reference inventory, SURVEY.md §1/L0):
  * BN254 G1 (y^2 = x^3 + 3 over Fq) and G2 (y^2 = x^3 + 3/(9+u) over Fq2)
    — ark-bn254 / halo2curves bn256.
  * P-256 / secp256r1 (device signatures, mDL issuer signatures).
  * T-256 "Tom-256" — forks/halo2curves/src/t256/curve.rs:36-58 constants.

Points are affine tuples ``(x, y)`` with ``None`` as the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .fields import (
    BN254_FQ,
    BN254_FR,
    P256_FP,
    P256_FQ,
    T256_FP,
    T256_FQ,
    Fq2,
    PrimeField,
)

AffinePoint = Optional[Tuple[int, int]]


@dataclass(frozen=True)
class Curve:
    """Short Weierstrass curve y^2 = x^3 + a x + b over GF(p), order n."""

    name: str
    p: int
    a: int
    b: int
    n: int  # prime subgroup order (= scalar field modulus)
    gx: int
    gy: int

    @property
    def field(self) -> PrimeField:
        return PrimeField(self.p, f"{self.name}::Fp")

    @property
    def generator(self) -> AffinePoint:
        return (self.gx, self.gy)

    # -- affine group law ---------------------------------------------------
    def is_on_curve(self, pt: AffinePoint) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def neg(self, pt: AffinePoint) -> AffinePoint:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def add(self, p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        p = self.p
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def double(self, pt: AffinePoint) -> AffinePoint:
        return self.add(pt, pt)

    def mul(self, k: int, pt: AffinePoint) -> AffinePoint:
        k %= self.n
        r: AffinePoint = None
        q = pt
        while k:
            if k & 1:
                r = self.add(r, q)
            q = self.add(q, q)
            k >>= 1
        return r

    def msm(self, scalars, points) -> AffinePoint:
        """Naive host MSM (oracle only; the fast path is ops/msm.py)."""
        acc: AffinePoint = None
        for s, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(s, pt))
        return acc

    def lift_x(self, x: int, y_parity: int = 0) -> AffinePoint:
        """Decompress: find y with given parity for x, or raise."""
        f = self.field
        rhs = (x * x * x + self.a * x + self.b) % self.p
        y = f.sqrt(rhs)
        if y is None:
            raise ValueError("x not on curve")
        if y % 2 != y_parity:
            y = self.p - y
        return (x, y)

    def random_point(self, rng) -> AffinePoint:
        return self.mul(rng.randrange(1, self.n), self.generator)


# Canonical instances -------------------------------------------------------

BN254_G1 = Curve("bn254_g1", BN254_FQ, 0, 3, BN254_FR, 1, 2)

P256 = Curve(
    "p256",
    P256_FP,
    P256_FP - 3,
    0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    P256_FQ,
    0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

# T-256 constants from forks/halo2curves/src/t256/curve.rs:36-58 (a = p-3).
T256 = Curve(
    "t256",
    T256_FP,
    T256_FP - 3,
    0xB441071B12F4A0366FB552F8E21ED4AC36B06ACEEB354224863E60F20219FC56,
    T256_FQ,
    5,
    0x3E86C0CFEBF2C7165EFC7B55F6B24FBE0ED60B9E33CE397C5826108A653DE28D,
)


# ---------------------------------------------------------------------------
# BN254 G2: y^2 = x^3 + 3/(9+u) over Fq2.  Needed host-side for Groth16
# setup/verify (pairings) and the b_g2_query MSM oracle.
# ---------------------------------------------------------------------------

G2Point = Optional[Tuple[Fq2, Fq2]]

# Standard alt_bn128 G2 generator (EIP-197 / arkworks ark-bn254 g2::G2Affine).
G2_GEN_X = Fq2(
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = Fq2(
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

G2_B = Fq2(3, 0) * Fq2(9, 1).inv()  # 3 / (9 + u)


class BN254G2:
    """BN254 G2 affine group law over Fq2."""

    name = "bn254_g2"
    n = BN254_FR

    @staticmethod
    def generator() -> G2Point:
        return (G2_GEN_X, G2_GEN_Y)

    @staticmethod
    def is_on_curve(pt: G2Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return y.square() == x.square() * x + G2_B

    @staticmethod
    def neg(pt: G2Point) -> G2Point:
        if pt is None:
            return None
        return (pt[0], -pt[1])

    @staticmethod
    def add(p1: G2Point, p2: G2Point) -> G2Point:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if (y1 + y2).is_zero():
                return None
            lam = (x1.square() * 3) * (y1 * 2).inv()
        else:
            lam = (y2 - y1) * (x2 - x1).inv()
        x3 = lam.square() - x1 - x2
        y3 = lam * (x1 - x3) - y1
        return (x3, y3)

    @classmethod
    def mul(cls, k: int, pt: G2Point) -> G2Point:
        k %= cls.n
        r: G2Point = None
        q = pt
        while k:
            if k & 1:
                r = cls.add(r, q)
            q = cls.add(q, q)
            k >>= 1
        return r

    @classmethod
    def msm(cls, scalars, points) -> G2Point:
        acc: G2Point = None
        for s, pt in zip(scalars, points):
            acc = cls.add(acc, cls.mul(s, pt))
        return acc
