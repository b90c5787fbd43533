"""bincode-style byte encoding of the Spartan NIZK proof tree.

A copy of ``crescent_tpu/models/spartan_ser.py`` (host only).

The reference ships its device-bound proof as
``zlib::compress(bincode::serialize(&ECDSAProof))``
(ecdsa-pop/src/lib.rs:541-545).  bincode (1.x default
config) conventions implemented here:

  * integers: fixed-width little-endian (u64 for lengths/usize),
  * Vec<T>: u64 LE length + items,
  * fixed arrays (e.g. ProductProof.z: [Scalar; 5], Spartan-t256
    src/nizk/mod.rs:153): items raw, NO length prefix (serde tuples),
  * compressed points (CompressedGroup = serde_bytes::ByteArray<33>,
    src/group.rs:17): serialize_bytes => u64 length (= 33) + 33 bytes,
  * scalars (T-256 Fq, halo2curves derive field/common.rs:111
    serde_arrays): 32 raw LE bytes, NO length prefix,
  * struct fields in declaration order; the serialized object is the bare
    NIZK (lib.rs:544 `bincode::serialize_into(&mut encoder, &proof)`) — no
    shape header (the verifier re-synthesizes num_cons/num_vars/num_inputs).

Our circuit arithmetization differs from the reference's by design
(credentials/ecdsa_pop.py docstring), so these bytes are not expected to be
accepted by the Rust verifier verbatim — but the container format follows
bincode 1.x semantics for the reference's declarations exactly
(byte-offset goldens: tests/test_spartan_ser_goldens.py), no code execution
happens on decode (unlike pickle), and every field is bounds-checked.
"""

from __future__ import annotations

from . import spartan as sp

_PT = 33  # compressed T-256 point width (utils/serialize.py ser_t256_compressed)


class _W:
    def __init__(self):
        self.parts = []

    def raw(self, b: bytes, width: int | None = None):
        if width is not None and len(b) != width:
            raise ValueError(f"expected {width}-byte field, got {len(b)}")
        self.parts.append(bytes(b))

    def u64(self, x: int):
        self.parts.append(int(x).to_bytes(8, "little"))

    def scalar(self, x: int):
        self.parts.append(int(x).to_bytes(32, "little"))

    def point(self, b: bytes):
        # serde_bytes::ByteArray<33> -> bincode serialize_bytes:
        # u64 LE length (always 33) + raw bytes
        self.u64(_PT)
        self.raw(b, _PT)

    def vec(self, xs, item):
        self.u64(len(xs))
        for x in xs:
            item(x)

    def bytes_out(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def raw(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("spartan deserialize: unexpected EOF")
        self.pos += n
        return b

    def u64(self) -> int:
        return int.from_bytes(self.raw(8), "little")

    def scalar(self) -> int:
        return int.from_bytes(self.raw(32), "little")

    def point(self) -> bytes:
        n = self.u64()
        if n != _PT:
            raise ValueError(f"spartan deserialize: point length {n} != {_PT}")
        return self.raw(_PT)

    def vec(self, item) -> list:
        n = self.u64()
        if n > 1 << 24:
            raise ValueError("spartan deserialize: implausible length")
        return [item() for _ in range(n)]

    def done(self):
        if self.pos != len(self.buf):
            raise ValueError("spartan deserialize: trailing bytes")


# -- component encoders -------------------------------------------------------

def _w_knowledge(w: _W, p: sp.KnowledgeProof):
    w.point(p.alpha)
    w.scalar(p.z1)
    w.scalar(p.z2)


def _r_knowledge(r: _R) -> sp.KnowledgeProof:
    return sp.KnowledgeProof(alpha=r.point(), z1=r.scalar(), z2=r.scalar())


def _w_equality(w: _W, p: sp.EqualityProof):
    w.point(p.alpha)
    w.scalar(p.z)


def _r_equality(r: _R) -> sp.EqualityProof:
    return sp.EqualityProof(alpha=r.point(), z=r.scalar())


def _w_product(w: _W, p: sp.ProductProof):
    w.point(p.alpha)
    w.point(p.beta)
    w.point(p.delta)
    # z: [Scalar; 5] — fixed array, bincode emits NO length prefix
    if len(p.z) != 5:
        raise ValueError(f"ProductProof.z must have 5 scalars, got {len(p.z)}")
    for x in p.z:
        w.scalar(x)


def _r_product(r: _R) -> sp.ProductProof:
    return sp.ProductProof(
        alpha=r.point(), beta=r.point(), delta=r.point(),
        z=[r.scalar() for _ in range(5)],
    )


def _w_dotproduct(w: _W, p: sp.DotProductProof):
    w.point(p.delta)
    w.point(p.beta)
    w.vec(p.z, w.scalar)
    w.scalar(p.z_delta)
    w.scalar(p.z_beta)


def _r_dotproduct(r: _R) -> sp.DotProductProof:
    return sp.DotProductProof(
        delta=r.point(),
        beta=r.point(),
        z=r.vec(r.scalar),
        z_delta=r.scalar(),
        z_beta=r.scalar(),
    )


def _w_zksumcheck(w: _W, p: sp.ZKSumcheckInstanceProof):
    w.vec(p.comm_polys, w.point)
    w.vec(p.comm_evals, w.point)
    w.vec(p.proofs, lambda x: _w_dotproduct(w, x))


def _r_zksumcheck(r: _R) -> sp.ZKSumcheckInstanceProof:
    return sp.ZKSumcheckInstanceProof(
        comm_polys=r.vec(r.point),
        comm_evals=r.vec(r.point),
        proofs=r.vec(lambda: _r_dotproduct(r)),
    )


def _w_bullet(w: _W, p: sp.BulletReductionProof):
    w.vec(p.L_vec, w.point)
    w.vec(p.R_vec, w.point)


def _r_bullet(r: _R) -> sp.BulletReductionProof:
    return sp.BulletReductionProof(L_vec=r.vec(r.point), R_vec=r.vec(r.point))


def _w_dotproduct_log(w: _W, p: sp.DotProductProofLog):
    _w_bullet(w, p.bullet)
    w.point(p.delta)
    w.point(p.beta)
    w.scalar(p.z1)
    w.scalar(p.z2)


def _r_dotproduct_log(r: _R) -> sp.DotProductProofLog:
    return sp.DotProductProofLog(
        bullet=_r_bullet(r),
        delta=r.point(),
        beta=r.point(),
        z1=r.scalar(),
        z2=r.scalar(),
    )


def _w_poly_eval(w: _W, p: sp.PolyEvalProof):
    _w_dotproduct_log(w, p.proof)


def _r_poly_eval(r: _R) -> sp.PolyEvalProof:
    return sp.PolyEvalProof(proof=_r_dotproduct_log(r))


def _w_r1cs_proof(w: _W, p: sp.R1CSProof):
    w.vec(p.comm_vars.C, w.point)
    _w_zksumcheck(w, p.sc_proof_phase1)
    for c in p.claims_phase2:  # fixed 4-tuple: no length prefix
        w.point(c)
    _w_knowledge(w, p.pok_claims_phase2[0])
    _w_product(w, p.pok_claims_phase2[1])
    _w_equality(w, p.proof_eq_sc_phase1)
    _w_zksumcheck(w, p.sc_proof_phase2)
    w.point(p.comm_vars_at_ry)
    _w_poly_eval(w, p.proof_eval_vars_at_ry)
    _w_equality(w, p.proof_eq_sc_phase2)


def _r_r1cs_proof(r: _R) -> sp.R1CSProof:
    return sp.R1CSProof(
        comm_vars=sp.PolyCommitment(C=r.vec(r.point)),
        sc_proof_phase1=_r_zksumcheck(r),
        claims_phase2=tuple(r.point() for _ in range(4)),
        pok_claims_phase2=(_r_knowledge(r), _r_product(r)),
        proof_eq_sc_phase1=_r_equality(r),
        sc_proof_phase2=_r_zksumcheck(r),
        comm_vars_at_ry=r.point(),
        proof_eval_vars_at_ry=_r_poly_eval(r),
        proof_eq_sc_phase2=_r_equality(r),
    )


def nizk_to_bytes(nizk: sp.NIZK) -> bytes:
    w = _W()
    _w_r1cs_proof(w, nizk.r1cs_sat_proof)
    w.vec(nizk.rx, w.scalar)
    w.vec(nizk.ry, w.scalar)
    return w.bytes_out()


def nizk_from_bytes(buf: bytes) -> sp.NIZK:
    r = _R(buf)
    proof = _r_r1cs_proof(r)
    rx = r.vec(r.scalar)
    ry = r.vec(r.scalar)
    r.done()
    return sp.NIZK(r1cs_sat_proof=proof, rx=rx, ry=ry)


def ecdsa_proof_to_bytes(nizk: sp.NIZK) -> bytes:
    """The reference wire object is the bare NIZK (lib.rs:544); the verifier
    re-synthesizes the circuit shape, so no num_cons/num_vars/num_inputs
    header exists in the encoding."""
    return nizk_to_bytes(nizk)


def ecdsa_proof_from_bytes(buf: bytes) -> sp.NIZK:
    return nizk_from_bytes(buf)
