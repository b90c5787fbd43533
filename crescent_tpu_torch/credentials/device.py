"""Device-binding proofs (reference: creds/src/device.rs).

A copy of ``crescent_tpu/credentials/device.py`` (host only; the
``cryptography`` calls of ``TestDevice`` as there).

Glues the BN254 show-proof commitments of the split device key
(q0 = com0.m, q1 = com1.m) to the T-256 Spartan ECDSA proof:
  * comz commits fresh randomness z; h_Q = Poseidon(q0, q1, z).
  * pi0: DLEQ that com1 (bases of com0) equals com1_orig (its own bases).
  * challenges e1, e2 = SHA-256(ctx || pi0.c || com0 || com1 || comz || h_Q)
    split 16/16 bytes; m = q0 + e1*q1 + e2*z is revealed, its commitment
    C_m = com0 + e1*com1 + e2*comz opens with only randomness unknown.
  * pi1: sigma proof for {(r, z, t): C_m / G^m = H^r AND C_z = G^z H^t}.
  * pi2: the Spartan ECDSA-PoP NIZK (ecdsa_pop.ECDSAProof).
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from ..core.curves import BN254_G1 as G1
from ..core.curves import P256, AffinePoint
from ..core.fields import BN254_FR as R
from . import ecdsa_pop
from .dlog import DLogPoK, PedersenOpening, pedersen_commit

CONTEXT_E = b"computing challenge for linking proof"
CONTEXT_PI0 = b"creating sigma proof pi0 for linking proof"
CONTEXT_PI1 = b"creating sigma proof pi1 for linking proof"


@dataclass
class ECDSASig:
    r: int
    s: int
    digest: bytes

    @staticmethod
    def from_bytes(digest: bytes, sig_bytes: bytes) -> "ECDSASig":
        assert len(sig_bytes) == 64
        return ECDSASig(
            int.from_bytes(sig_bytes[:32], "big"),
            int.from_bytes(sig_bytes[32:], "big"),
            bytes(digest),
        )


class TestDevice:
    """In-memory P-256 signer standing in for secure hardware
    (device.rs:26-78)."""

    def __init__(self, secret: int | None = None, rng: random.Random | None = None):
        rng = rng or random.SystemRandom()
        self.secret = secret or rng.randrange(1, P256.n)
        self.public = P256.mul(self.secret, P256.generator)
        self._rng = rng

    @classmethod
    def new_from_pem(cls, pem: str) -> "TestDevice":
        """Load the device secret from an EC (P-256) private-key PEM
        (device.rs TestDevice::new_from_pem; the browser client passes the
        key this way — wasm_lib.rs:110)."""
        from cryptography.hazmat.primitives.serialization import load_pem_private_key

        key = load_pem_private_key(pem.encode(), password=None)
        secret = key.private_numbers().private_value
        return cls(secret=secret)

    def sign(self, digest: bytes) -> bytes:
        """Sign a prehashed digest; returns r||s (64 bytes)."""
        n = P256.n
        h = int.from_bytes(digest[:32], "big") % n
        while True:
            k = self._rng.randrange(1, n)
            Rp = P256.mul(k, P256.generator)
            r = Rp[0] % n
            if r == 0:
                continue
            s = pow(k, -1, n) * (h + r * self.secret) % n
            if s == 0:
                continue
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def get_public_key(self) -> tuple[int, int]:
        return self.public

    def public_pem(self) -> str:
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat,
        )

        pub = ec.EllipticCurvePublicNumbers(
            self.public[0], self.public[1], ec.SECP256R1()
        ).public_key()
        return pub.public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo).decode()


def _ark_display_int(v: int) -> bytes:
    """ark-ff 0.4 `Fp::Display` bytes: decimal of the canonical integer.
    ark's impl runs `into_bigint().to_string().trim_start_matches('0')`,
    so zero renders as the EMPTY string — mirrored here for byte parity
    (never hit in practice: challenge scalars and random commitment
    coordinates are nonzero w.o.p.)."""
    return str(v).encode() if v else b""


def _point_repr(p: AffinePoint) -> bytes:
    """ark-ec 0.4 `Affine::Display` bytes, as hashed by the reference's
    challenge derivation (device.rs:128-131 hashes `to_string()`):
    `"({x}, {y})"` with decimal coordinates, `"infinity"` for the
    identity."""
    if p is None:
        return b"infinity"
    return b"(" + _ark_display_int(p[0]) + b", " + _ark_display_int(p[1]) + b")"


def challenge_e1_e2(pi0_c: int, com0: AffinePoint, com1: AffinePoint, comz: AffinePoint, h_q: bytes):
    sha = hashlib.sha256()
    sha.update(CONTEXT_E)
    sha.update(_ark_display_int(pi0_c))
    sha.update(_point_repr(com0))
    sha.update(_point_repr(com1))
    sha.update(_point_repr(comz))
    sha.update(h_q)
    digest = sha.digest()
    e1 = int.from_bytes(digest[0:16], "little")
    e2 = int.from_bytes(digest[16:32], "little")
    return e1, e2, digest[0:16], digest[16:32]


@dataclass
class DeviceProof:
    r_x: int
    r_y: int
    digest: bytes
    com1: AffinePoint   # re-committed under com0's bases
    comz: AffinePoint
    h_Q: bytes
    m: int
    pi0: DLogPoK
    pi1: DLogPoK
    pi2: bytes

    @staticmethod
    def prove(
        com0: PedersenOpening,
        com1_orig: PedersenOpening,
        sig: ECDSASig,
        pubkey_x: int,
        pubkey_y: int,
        rng: random.Random | None = None,
    ) -> "DeviceProof":
        """device.rs:98-166."""
        rng = rng or random.SystemRandom()
        z_val = rng.randrange(R)
        comz = pedersen_commit(z_val, com0.bases, rng=rng)

        q0, q1 = com0.m, com1_orig.m
        h_q = ecdsa_pop.compute_hQ(q0, q1, comz.m)

        # re-commit com1 under com0's bases + DLEQ pi0
        com1 = pedersen_commit(com1_orig.m, com0.bases, rng=rng)
        pi0 = DLogPoK.prove(
            CONTEXT_PI0,
            [com1_orig.c, com1.c],
            [list(com1_orig.bases), list(com0.bases)],
            [[com1_orig.m, com1_orig.r], [com1.m, com1.r]],
            eq_pos=[(0, 0)],
            rng=rng,
        )

        e1, e2, e1_bytes, e2_bytes = challenge_e1_e2(pi0.c, com0.c, com1.c, comz.c, h_q)
        m = (q0 + q1 * e1 + comz.m * e2) % R
        c_m = G1.add(G1.add(com0.c, G1.mul(e1, com1.c)), G1.mul(e2, comz.c))
        r_m = (com0.r + com1.r * e1 + comz.r * e2) % R

        # pi1: {(r, z, t): C_m/G^m = H^r AND C_z = G^z H^t}
        g, h = com0.bases
        lhs1 = G1.add(c_m, G1.neg(G1.mul(m, g)))
        assert lhs1 == G1.mul(r_m, h)
        pi1 = DLogPoK.prove(
            CONTEXT_PI1,
            [lhs1, comz.c],
            [[h], [g, h]],
            [[r_m], [comz.m, comz.r]],
            rng=rng,
        )

        # pi2: Spartan ECDSA-PoP NIZK over T-256
        r_x, r_y, pi2 = ecdsa_pop.ECDSAProof.prove(
            ecdsa_pop.ECDSAParams(), pubkey_x, pubkey_y, sig.r, sig.s,
            sig.digest, h_q, m, e1_bytes, e2_bytes, comz.m,
        )
        return DeviceProof(
            r_x, r_y, sig.digest, com1.c, comz.c, h_q, m, pi0, pi1, pi2
        )

    @staticmethod
    def verify(
        proof: "DeviceProof",
        com0: AffinePoint,
        com1: AffinePoint,
        bases: list,
        bases_com1: list,
    ) -> bool:
        """device.rs:168-225."""
        if not proof.pi0.verify(
            CONTEXT_PI0,
            [list(bases_com1), list(bases)],
            [com1, proof.com1],
            eq_pos=[(0, 0)],
        ):
            return False
        com1p = proof.com1

        e1, e2, e1_bytes, e2_bytes = challenge_e1_e2(
            proof.pi0.c, com0, com1p, proof.comz, proof.h_Q
        )
        c_m = G1.add(G1.add(com0, G1.mul(e1, com1p)), G1.mul(e2, proof.comz))
        g, h = bases
        lhs1 = G1.add(c_m, G1.neg(G1.mul(proof.m, g)))
        if not proof.pi1.verify(CONTEXT_PI1, [[h], [g, h]], [lhs1, proof.comz]):
            return False

        return ecdsa_pop.ECDSAProof.verify(
            ecdsa_pop.ECDSAParams(), proof.r_x, proof.r_y, proof.digest,
            proof.h_Q, proof.m, e1_bytes, e2_bytes, proof.pi2,
        )
