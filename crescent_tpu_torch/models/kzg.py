"""KZG10 polynomial commitments over BN254 (ark-poly-commit kzg10 semantics).

Counterpart of ``crescent_tpu/models/kzg.py``: the used subset of
forks/ark-poly-commit (src/kzg10/mod.rs: setup:55, commit:178, open:307,
check:334, batch_check:357), which backs the Crescent range proof.
Polynomials at this layer are tiny (degree <= 4*32), so poly math stays on
the host, and so do the commitment MSMs (``dlog.msm_select``).  `setup`'s
powers come from ``groth16.fixed_base_mul``: the native fixed base, or with
the native backend off batched double-and-add on `device`.

Structures mirror ark naming so the credentials layer reads like the
reference: Powers {powers_of_g, powers_of_gamma_g}, VerifierKey, Commitment
(affine G1), Randomness (blinding polynomial), Proof {w, random_v}.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from ..core import pairing as pr
from ..core.curves import AffinePoint, BN254G2, BN254_G1, G2Point
from ..core.fields import BN254_FR as R
from ..utils import poly

G1 = BN254_G1
G2 = BN254G2


@dataclass
class Powers:
    powers_of_g: list        # tau^i * G,       i in 0..=max_degree
    powers_of_gamma_g: list  # gamma * tau^i * G

    def msm(self, bases: list, scalars: list[int]) -> AffinePoint:
        from ..credentials.dlog import msm_select

        return msm_select(bases, scalars)


@dataclass
class VerifierKey:
    g: AffinePoint
    gamma_g: AffinePoint
    h: G2Point
    beta_h: G2Point


@dataclass
class Commitment:
    c: AffinePoint  # affine G1


@dataclass
class Randomness:
    blinding_polynomial: list  # coeffs over Fr; [] = no hiding

    @staticmethod
    def empty() -> "Randomness":
        return Randomness([])


@dataclass
class Proof:
    w: AffinePoint
    random_v: Optional[int]


def setup(max_degree: int, rng: random.Random, *,
          device="cuda") -> tuple[Powers, VerifierKey]:
    """KZG10::setup with hiding (kzg10/mod.rs:55): SRS from toxic tau, gamma
    (drawn in that order).  `device`: where ``fixed_base_mul`` runs its
    batches with the native backend off; it must exist either way."""
    tau = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    from .groth16 import fixed_base_mul

    taus = [pow(tau, i, R) for i in range(max_degree + 1)]
    powers_of_g = fixed_base_mul(G1.generator, taus, device=device)
    powers_of_gamma_g = fixed_base_mul(
        G1.generator,
        [gamma * t % R for t in taus] + [gamma * pow(tau, max_degree + 1, R) % R],
        device=device)
    h = G2.generator()
    beta_h = G2.mul(tau, h)
    return Powers(powers_of_g, powers_of_gamma_g), VerifierKey(
        powers_of_g[0], powers_of_gamma_g[0], h, beta_h
    )


def commit(
    powers: Powers,
    p: list[int],
    hiding_bound: Optional[int],
    rng: random.Random,
) -> tuple[Commitment, Randomness]:
    """com = p(tau)G + r(tau)*gamma*G, deg(r) = hiding_bound + 1
    (kzg10/mod.rs:178; blinding degree rule per Randomness::rand)."""
    com = powers.msm(powers.powers_of_g[: len(p)], p) if p else None
    rand = Randomness.empty()
    if hiding_bound is not None:
        rand = Randomness(poly.rand_poly(hiding_bound + 1, R, rng))
        hid = powers.msm(
            powers.powers_of_gamma_g[: len(rand.blinding_polynomial)],
            rand.blinding_polynomial,
        )
        com = G1.add(com, hid)
    return Commitment(com), rand


def open_proof(powers: Powers, p: list[int], point: int, rand: Randomness) -> Proof:
    """Witness polynomial psi = (p - p(z))/(X - z); hiding part likewise
    (kzg10/mod.rs:307)."""
    value = poly.evaluate(p, point, R)
    quo, rem = poly.div_by_linear(poly.sub(p, [value], R), point, R)
    assert rem == 0
    w = powers.msm(powers.powers_of_g[: len(quo)], quo) if quo else None
    random_v = None
    if rand.blinding_polynomial:
        bp = rand.blinding_polynomial
        random_v = poly.evaluate(bp, point, R)
        bquo, brem = poly.div_by_linear(poly.sub(bp, [random_v], R), point, R)
        assert brem == 0
        if bquo:
            w = G1.add(w, powers.msm(powers.powers_of_gamma_g[: len(bquo)], bquo))
    return Proof(w, random_v)


def check(vk: VerifierKey, com: Commitment, point: int, value: int, proof: Proof) -> bool:
    """e(com - v*G - rv*gamma_G + z*w, H) == e(w, beta_H)  (kzg10/mod.rs:334)."""
    inner = G1.add(com.c, G1.neg(G1.mul(value, vk.g)))
    if proof.random_v is not None:
        inner = G1.add(inner, G1.neg(G1.mul(proof.random_v, vk.gamma_g)))
    inner = G1.add(inner, G1.mul(point, proof.w))
    return pr.pairing_product_is_one(
        [(inner, vk.h), (G1.neg(proof.w), vk.beta_h)]
    )


def batch_check(
    vk: VerifierKey,
    commitments: list[Commitment],
    points: list[int],
    values: list[int],
    proofs: list[Proof],
    rng: random.Random,
) -> bool:
    """Randomized batch of `check`s with one pairing pair (kzg10/mod.rs:357)."""
    total_c: AffinePoint = None
    total_w: AffinePoint = None
    g_mult = 0
    gamma_mult = 0
    randomizer = 1
    for com, z, v, proof in zip(commitments, points, values, proofs):
        c = G1.add(com.c, G1.mul(z, proof.w))
        g_mult = (g_mult + randomizer * v) % R
        if proof.random_v is not None:
            gamma_mult = (gamma_mult + randomizer * proof.random_v) % R
        total_c = G1.add(total_c, G1.mul(randomizer, c))
        total_w = G1.add(total_w, G1.mul(randomizer, proof.w))
        randomizer = rng.getrandbits(128)
    total_c = G1.add(total_c, G1.neg(G1.mul(g_mult, vk.g)))
    total_c = G1.add(total_c, G1.neg(G1.mul(gamma_mult, vk.gamma_g)))
    return pr.pairing_product_is_one(
        [(total_w, vk.beta_h), (G1.neg(total_c), vk.h)]
    )
