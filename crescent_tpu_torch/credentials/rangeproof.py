"""KZG-based n-bit range proof (counterpart of
``crescent_tpu/credentials/rangeproof.py``; creds/src/rangeproof.rs).

Proves the value inside a Pedersen opening lies in [0, 2^n) (n = 32 for the
"not expired" / age checks, creds/src/lib.rs:50).  Construction (Boneh et
al., hackmd.io/@dabo/B1U4kx8XI; cited at rangeproof.rs:111-113):

  g's domain evaluations are the suffix-weighted bit accumulators
  (g_i = 2*g_{i+1} + bit_i, g_{n-1} = bit_{n-1}), so g(1) = value = f(1);
  quotients q1 = (g-f)/(X-1), q2 = g(1-g)/(X-w^{n-1}),
  q3 = (g-2gw)(1-g+2gw)(X-w^{n-1})/(X^n-1) certify the bit recurrence;
  q = q1 + c*q2 + c^2*q3 is committed and everything is batch-opened at
  rho and rho*w, with g blinded by (X^n-1)*rand_deg2 for zero knowledge.
  A DLEQ (DLogPoK with eq position (0,3)) links com_f to the Pedersen
  commitment of the value.

Transcript framing matches the reference byte-for-byte (merlin, labels
"com_f"/"com_g"/"com_q", 31-byte challenges under label [0x00]).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..core.curves import AffinePoint, BN254_G1
from ..core.fields import BN254_FR as R
from ..core.fields import Fr
from ..models import kzg
from ..utils import poly
from ..utils.merlin import Transcript
from ..utils.serialize import ser_g1_compressed
from .dlog import DLogPoK, PedersenOpening

G1 = BN254_G1


@dataclass
class RangeProofPK:
    powers: kzg.Powers


@dataclass
class RangeProofVK:
    kzg_vk: kzg.VerifierKey
    com_f_basis: list  # [gamma_g[0], gamma_g[1], gamma_g[2], g[0]]


def setup(n: int, rng: random.Random | None = None, *,
          device="cuda") -> tuple[RangeProofPK, RangeProofVK]:
    """KZG setup of degree 4n with hiding (rangeproof.rs:30-72); `device`
    as in ``kzg.setup``."""
    rng = rng or random.SystemRandom()
    powers, kzg_vk = kzg.setup(4 * n, rng, device=device)
    com_f_basis = [
        powers.powers_of_gamma_g[0],
        powers.powers_of_gamma_g[1],
        powers.powers_of_gamma_g[2],
        powers.powers_of_g[0],
    ]
    return RangeProofPK(powers), RangeProofVK(kzg_vk, com_f_basis)


@dataclass
class RangeProof:
    com_f: kzg.Commitment
    com_g: kzg.Commitment
    eval_g: int
    proof_g: kzg.Proof
    eval_gw: int
    proof_gw: kzg.Proof
    com_q: kzg.Commitment
    eval_w_hat: int
    proof_w_hat: kzg.Proof
    dleq_proof: DLogPoK


def _challenge(ts: Transcript) -> int:
    return int.from_bytes(ts.challenge_bytes(b"\x00", 31), "little")


def _domain(n: int):
    w = Fr.root_of_unity(n)
    return w, [pow(w, i, R) for i in range(n)]


def prove_n_bits(
    ped_open: PedersenOpening,
    n: int,
    powers: kzg.Powers,
    rng: random.Random | None = None,
) -> RangeProof:
    """rangeproof.rs:114-339.  All polynomial math is degree <= 4n (host);
    commitments and openings run through ``dlog.msm_select``."""
    assert n & (n - 1) == 0, "n must be a power of two"
    assert len(powers.powers_of_g) >= n + 2, "not enough powers of g"
    rng = rng or random.SystemRandom()

    elem = ped_open.m % R
    w, domain = _domain(n)

    bits = [(elem >> i) & 1 for i in range(n)]
    f = [elem]

    # g's domain evaluations: suffix bit accumulator
    g_evals = [0] * n
    g_evals[n - 1] = bits[n - 1]
    for i in range(n - 2, -1, -1):
        g_evals[i] = (2 * g_evals[i + 1] + bits[i]) % R
    g = _ifft_host(g_evals, w, n)

    blinding = poly.mul_by_vanishing(poly.rand_poly(2, R, rng), n, R)
    g_blinded = poly.add(g, blinding, R)

    # gw(X) = g(w*X): coeff i scaled by w^(i mod n)
    gw_blinded = [c * domain[i % n] % R for i, c in enumerate(g_blinded)]

    # q1 = (g - f)/(X - 1)
    q1, rem1 = poly.div_by_linear(poly.sub(g_blinded, f, R), 1, R)
    assert rem1 == 0
    # q2 = g(1-g)/(X - w^{n-1})
    q2, rem2 = poly.div_by_linear(
        poly.mul(g_blinded, poly.sub([1], g_blinded, R), R), domain[n - 1], R
    )
    assert rem2 == 0
    # q3 = (g-2gw)(1-g+2gw)(X - w^{n-1}) / (X^n - 1)
    g_2gw = poly.sub(g_blinded, poly.scale(gw_blinded, 2, R), R)
    w3 = poly.mul(g_2gw, poly.sub([1], g_2gw, R), R)
    w3 = poly.mul(w3, [(-domain[n - 1]) % R, 1], R)
    q3, rem3 = poly.div_by_vanishing(w3, n, R)
    assert rem3 == []

    com_f, rand_f = kzg.commit(powers, f, 1, rng)  # opened once

    com_f_basis = list(powers.powers_of_gamma_g[:3]) + [powers.powers_of_g[0]]
    com_f_scalars = list(rand_f.blinding_polynomial) + [elem]

    dleq_proof = DLogPoK.prove(
        None,
        [ped_open.c, com_f.c],
        [list(ped_open.bases), com_f_basis],
        [[ped_open.m, ped_open.r], com_f_scalars],
        eq_pos=[(0, 3)],
        rng=rng,
    )

    com_g, rand_g = kzg.commit(powers, g_blinded, 2, rng)  # opened twice

    ts = Transcript(b"\x00")
    ts.append_message(b"com_f", ser_g1_compressed(com_f.c))
    ts.append_message(b"com_g", ser_g1_compressed(com_g.c))
    c = _challenge(ts)

    q = poly.add(poly.add(q1, poly.scale(q2, c, R), R), poly.scale(q3, c * c % R, R), R)
    com_q, rand_q = kzg.commit(powers, q, 1, rng)  # opened once

    ts.append_message(b"com_q", ser_g1_compressed(com_q.c))
    rho = _challenge(ts)

    eval_g = poly.evaluate(g_blinded, rho, R)
    proof_g = kzg.open_proof(powers, g_blinded, rho, rand_g)
    rho_w = rho * w % R
    eval_gw = poly.evaluate(g_blinded, rho_w, R)
    proof_gw = kzg.open_proof(powers, g_blinded, rho_w, rand_g)

    # w_hat = f*(rho^n - 1)/(rho - 1) + q*(rho^n - 1)
    q_coeff = (pow(rho, n, R) - 1) % R
    f_coeff = q_coeff * pow(rho - 1, -1, R) % R
    w_hat = poly.add(poly.scale(f, f_coeff, R), poly.scale(q, q_coeff, R), R)
    rand_w_hat = kzg.Randomness(
        poly.add(
            poly.scale(rand_f.blinding_polynomial, f_coeff, R),
            poly.scale(rand_q.blinding_polynomial, q_coeff, R),
            R,
        )
    )
    eval_w_hat = poly.evaluate(w_hat, rho, R)
    proof_w_hat = kzg.open_proof(powers, w_hat, rho, rand_w_hat)

    return RangeProof(
        com_f, com_g, eval_g, proof_g, eval_gw, proof_gw, com_q, eval_w_hat,
        proof_w_hat, dleq_proof,
    )


def verify_n_bits(
    proof: RangeProof,
    ped_com: AffinePoint,
    bases: list,
    n: int,
    vk: RangeProofVK,
    rng: random.Random | None = None,
) -> bool:
    """rangeproof.rs:342-424."""
    rng = rng or random.SystemRandom()
    w, domain = _domain(n)

    ts = Transcript(b"\x00")
    ts.append_message(b"com_f", ser_g1_compressed(proof.com_f.c))
    ts.append_message(b"com_g", ser_g1_compressed(proof.com_g.c))
    c = _challenge(ts)
    ts.append_message(b"com_q", ser_g1_compressed(proof.com_q.c))
    rho = _challenge(ts)

    q_coeff = (pow(rho, n, R) - 1) % R
    f_coeff = q_coeff * pow(rho - 1, -1, R) % R
    com_w_hat = kzg.Commitment(
        G1.add(G1.mul(f_coeff, proof.com_f.c), G1.mul(q_coeff, proof.com_q.c))
    )

    ok = kzg.batch_check(
        vk.kzg_vk,
        [proof.com_g, proof.com_g, com_w_hat],
        [rho, rho * w % R, rho],
        [proof.eval_g, proof.eval_gw, proof.eval_w_hat],
        [proof.proof_g, proof.proof_gw, proof.proof_w_hat],
        rng,
    )
    if not ok:
        return False

    # w1 + c*w2 + c^2*w3 - q*(X^n-1) must vanish at rho
    partial_w1 = proof.eval_g * q_coeff % R * pow(rho - 1, -1, R) % R
    w2 = (
        proof.eval_g
        * (1 - proof.eval_g)
        % R
        * q_coeff
        % R
        * pow((rho - domain[n - 1]) % R, -1, R)
        % R
    )
    d = (proof.eval_g - 2 * proof.eval_gw) % R
    w3 = d * ((1 - d) % R) % R * ((rho - domain[n - 1]) % R) % R
    eval_w = (partial_w1 + c * w2 + c * c % R * w3 - proof.eval_w_hat) % R
    if eval_w != 0:
        return False

    return proof.dleq_proof.verify(
        None,
        [list(bases), list(vk.com_f_basis)],
        [ped_com, proof.com_f.c],
        eq_pos=[(0, 3)],
    )


def _ifft_host(evals: list[int], w: int, n: int) -> list[int]:
    """Inverse NTT on host (n <= 64 here; QAP sizes take ``ops/ntt.py``)."""
    w_inv = pow(w, -1, R)
    n_inv = pow(n, -1, R)
    out = []
    for k in range(n):
        acc = 0
        for j, e in enumerate(evals):
            acc += e * pow(w_inv, j * k, R)
        out.append(acc * n_inv % R)
    return poly.trim(out)
