"""ark CanonicalSerialize (uncompressed) layouts for every CachePaths artifact.

The reference persists and ships all artifacts with arkworks
CanonicalSerialize in uncompressed mode (creds/src/utils.rs:140-197
write_to_file / write_to_b64url / read_from_file) — this byte schema is API
surface (SURVEY.md §5 checkpoint/resume).  This module implements those
layouts for the full artifact tree:

  VerifyingKey / PreparedVerifyingKey / ProvingKey / Proof
      forks/groth16/src/data_structures.rs (fork adds delta_g1 to the VK)
  G2Prepared (BN254 ell coefficients)
      ark-ec 0.4 models/bn/g2.rs doubling_step/addition_step, TwistType::D
  Powers / VerifierKey / Commitment / Proof (KZG10)
      forks/ark-poly-commit/src/kzg10/data_structures.rs (note: VerifierKey's
      prepared_h/prepared_beta_h are NOT serialized — recomputed on read,
      data_structures.rs:213-259)
  RangeProofPK / RangeProofVK / RangeProof   creds/src/rangeproof.rs:24-93
  DLogPoK / PedersenOpening                  creds/src/dlog.rs:16-29
  ClientState / ShowGroth16 / ShowRange      creds/src/groth16rand.rs:25-56
  DeviceProof                                creds/src/device.rs:82-94
  ProverParams / ShowParams / VerifierParams / ShowProof
      creds/src/lib.rs:59-139

Primitive rules (ark-serialize 0.4, Compress::No):
  * Fr/Fq: 32-byte LE canonical integer; Fq2/Fq6/Fq12: components in order.
  * G1 affine uncompressed: x || y, infinity flag (bit 6) on the last byte;
    G2 likewise over Fq2 (utils/serialize.py primitives).
  * Group (projective) values serialize as their affine form.
  * u64/usize: 8-byte LE; bool/u8: 1 byte; Vec<T>: u64 length + items;
    String: u64 length + UTF-8 bytes; Option<T>: u8 tag (0/1) + payload;
    fixed arrays [T; N]: N items, no length; tuples: fields in order;
    num_bigint::BigUint: Vec<u8> of to_bytes_le().

Layouts are held byte for byte against the JAX package's writer
(tests/test_torch_api.py); the G2Prepared construction is validated there by
re-running the pairing from the generated ell coefficients (see
`miller_loop_from_ell`) against core.pairing.
"""

from __future__ import annotations

from typing import Callable

from ..core.curves import AffinePoint, BN254G2, G2Point
from ..core.fields import BN254_FQ as P
from ..core.fields import Fq2, Fq6, Fq12
from .serialize import (
    deser_fr,
    ser_fq2,
    ser_fr,
    ser_g1_uncompressed,
    ser_g2_uncompressed,
    ser_u64,
)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("ark deserialize: unexpected EOF")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def boolean(self) -> bool:
        v = self.u8()
        if v > 1:
            raise ValueError("invalid bool")
        return bool(v)

    def fr(self) -> int:
        return deser_fr(self.take(32))

    def fq(self) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= P:
            raise ValueError("Fq out of range")
        return v

    def fq2(self) -> Fq2:
        c0 = self.fq()
        c1 = self.fq()
        return Fq2(c0, c1)

    def fq6(self) -> Fq6:
        return Fq6(self.fq2(), self.fq2(), self.fq2())

    def fq12(self) -> Fq12:
        return Fq12(self.fq6(), self.fq6())

    def g1(self) -> AffinePoint:
        """Unchecked read (the reference uses
        deserialize_uncompressed_unchecked, utils.rs:185 — no curve check)."""
        raw = bytearray(self.take(64))
        flags = raw[63] & 0xC0
        raw[63] &= 0x3F
        if flags & 0x40:
            return None
        return (
            int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:64], "little"),
        )

    def g2(self) -> G2Point:
        raw = bytearray(self.take(128))
        flags = raw[127] & 0xC0
        raw[127] &= 0x3F
        if flags & 0x40:
            return None
        x = Fq2(int.from_bytes(raw[0:32], "little"), int.from_bytes(raw[32:64], "little"))
        y = Fq2(int.from_bytes(raw[64:96], "little"), int.from_bytes(raw[96:128], "little"))
        return (x, y)

    def string(self) -> str:
        n = self.u64()
        return self.take(n).decode("utf-8")

    def byte_vec(self) -> bytes:
        return self.take(self.u64())

    def biguint(self) -> int:
        return int.from_bytes(self.byte_vec(), "little")

    def vec(self, item: Callable) -> list:
        n = self.u64()
        return [item() for _ in range(n)]

    def point_vec(self, g2: bool = False):
        """Bulk Vec<GAffine> (uncompressed, unchecked — same semantics as
        vec(g1|g2)) into an ArrayPointVec: one numpy reinterpretation
        instead of 2N int.from_bytes + N tuple allocations."""
        from .pointvec import ArrayPointVec

        n = self.u64()
        v, nread = ArrayPointVec.deser_uncompressed(
            self.buf[self.pos :], n, g2=g2
        )
        self.pos += nread
        return v

    def option(self, item: Callable):
        return item() if self.boolean() else None

    def done(self):
        if self.pos != len(self.buf):
            raise ValueError(
                f"ark deserialize: {len(self.buf) - self.pos} trailing bytes"
            )


# -- primitive writers -------------------------------------------------------

def ser_bool(v: bool) -> bytes:
    return bytes([1 if v else 0])


def ser_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return ser_u64(len(b)) + b


def ser_byte_vec(b: bytes) -> bytes:
    return ser_u64(len(b)) + bytes(b)


def ser_biguint(x: int) -> bytes:
    """num_bigint::BigUint via ark: Vec<u8> of to_bytes_le() ([0] for zero)."""
    n = max(1, (int(x).bit_length() + 7) // 8)
    return ser_byte_vec(int(x).to_bytes(n, "little"))


def ser_option(v, item: Callable) -> bytes:
    return b"\x00" if v is None else b"\x01" + item(v)


def ser_list(xs, item: Callable) -> bytes:
    from .pointvec import ArrayPointVec

    if isinstance(xs, ArrayPointVec) and item in (
        ser_g1_uncompressed,
        ser_g2_uncompressed,
    ):
        # vectorized path: byte-identical to mapping `item` over the items
        # (tests/test_ark_serialize.py), without 2N int.to_bytes calls
        assert xs.g2 == (item is ser_g2_uncompressed)
        return ser_u64(len(xs)) + xs.ser_items_uncompressed()
    return ser_u64(len(xs)) + b"".join(item(x) for x in xs)


def ser_fq6(x: Fq6) -> bytes:
    return ser_fq2(x.c0) + ser_fq2(x.c1) + ser_fq2(x.c2)


def ser_fq12(x: Fq12) -> bytes:
    return ser_fq6(x.c0) + ser_fq6(x.c1)


# ---------------------------------------------------------------------------
# G2Prepared — ark-ec 0.4 models/bn/g2.rs for ark-bn254 (TwistType::D)
# ---------------------------------------------------------------------------

# ark_bn254 Config::ATE_LOOP_COUNT (signed digits, LSB first; sums to 6u+2 —
# verified: sum(d<<i) == 29793968203157093288).
ATE_LOOP_COUNT_I8 = [
    0, 0, 0, 1, 0, 1, 0, -1, 0, 0, -1, 0, 0, 0, 1, 0, 0, -1, 0, -1, 0, 0, 0,
    1, 0, -1, 0, 0, 0, 0, -1, 0, 0, 1, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0,
    0, -1, 0, 1, 0, -1, 0, 0, 0, -1, 0, -1, 0, 0, 0, 1, 0, 1, 1,
]

_TWO_INV = pow(2, -1, P)

# G2 curve coefficient b' = 3/(9+u) (D-type twist).
from ..core.curves import G2_B  # noqa: E402

# Frobenius twist constants: (9+u)^((p-1)/3), (9+u)^((p-1)/2) over Fq2.
TWIST_MUL_BY_Q_X = Fq2(9, 1).pow((P - 1) // 3)
TWIST_MUL_BY_Q_Y = Fq2(9, 1).pow((P - 1) // 2)


def _mul_fp(a: Fq2, k: int) -> Fq2:
    return Fq2(a.c0 * k % P, a.c1 * k % P)


def _doubling_step(rx: Fq2, ry: Fq2, rz: Fq2):
    """ark models/bn/g2.rs doubling_step (homogeneous projective).
    Returns (ell_coeff (c0,c1,c2), new (x,y,z))."""
    a = _mul_fp(rx * ry, _TWO_INV)
    b = ry.square()
    c = rz.square()
    e = G2_B * (c + c + c)
    f = e + e + e
    g = _mul_fp(b + f, _TWO_INV)
    h = (ry + rz).square() - (b + c)
    i = e - b
    j = rx.square()
    e_sq = e.square()
    nx = a * (b - f)
    ny = g.square() - (e_sq + e_sq + e_sq)
    nz = b * h
    return (-h, j + j + j, i), (nx, ny, nz)


def _addition_step(rx: Fq2, ry: Fq2, rz: Fq2, qx: Fq2, qy: Fq2):
    """ark models/bn/g2.rs addition_step."""
    theta = ry - qy * rz
    lam = rx - qx * rz
    c = theta.square()
    d = lam.square()
    e = lam * d
    f = rz * c
    g = rx * d
    h = e + f - (g + g)
    nx = lam * h
    ny = theta * (g - h) - e * ry
    nz = rz * e
    j = theta * qx - lam * qy
    return (lam, -theta, j), (nx, ny, nz)


def _mul_by_char(q: G2Point) -> G2Point:
    x, y = q
    return (x.frobenius(1) * TWIST_MUL_BY_Q_X, y.frobenius(1) * TWIST_MUL_BY_Q_Y)


def g2_prepare(q: G2Point) -> tuple[list, bool]:
    """ell_coeffs exactly as ark-bn254's G2Prepared::from(q).

    Returns ([(c0, c1, c2) Fq2 triples], infinity)."""
    if q is None:
        return [], True
    qx, qy = q
    rx, ry, rz = qx, qy, Fq2(1, 0)
    neg_q = (qx, -qy)
    ell = []
    for bit in reversed(ATE_LOOP_COUNT_I8[:-1]):
        coeff, (rx, ry, rz) = _doubling_step(rx, ry, rz)
        ell.append(coeff)
        if bit == 1:
            coeff, (rx, ry, rz) = _addition_step(rx, ry, rz, qx, qy)
            ell.append(coeff)
        elif bit == -1:
            coeff, (rx, ry, rz) = _addition_step(rx, ry, rz, *neg_q)
            ell.append(coeff)
    # X_IS_NEGATIVE = false for bn254; final Frobenius correction steps
    q1 = _mul_by_char(q)
    q2x, q2y = _mul_by_char(q1)
    q2 = (q2x, -q2y)
    coeff, (rx, ry, rz) = _addition_step(rx, ry, rz, *q1)
    ell.append(coeff)
    coeff, (rx, ry, rz) = _addition_step(rx, ry, rz, *q2)
    ell.append(coeff)
    return ell, False


def miller_loop_from_ell(p: AffinePoint, ell: list) -> Fq12:
    """ark Bn::multi_miller_loop evaluation from prepared coefficients
    (validation: final exponentiation of this must equal core.pairing)."""
    px, py = p

    def ell_eval(f: Fq12, coeff) -> Fq12:
        c0, c1, c2 = coeff
        # TwistType::D: c0 *= p.y, c1 *= p.x, then mul_by_034:
        # sparse element c0 + c1*w^3 + c2*w^4 in the (c0.c0, c1.c0, c1.c1)
        # slots of Fq12 = Fq6[w]/(w^2 - v).
        c0 = _mul_fp(c0, py)
        c1 = _mul_fp(c1, px)
        sparse = Fq12(
            Fq6(c0, Fq2(0, 0), Fq2(0, 0)),
            Fq6(c1, c2, Fq2(0, 0)),
        )
        return f * sparse

    it = iter(ell)
    f = Fq12.one()
    n = len(ATE_LOOP_COUNT_I8)
    for i in range(n - 2, -1, -1):
        if i != n - 2:
            f = f.square()
        f = ell_eval(f, next(it))
        if ATE_LOOP_COUNT_I8[i] != 0:
            f = ell_eval(f, next(it))
    f = ell_eval(f, next(it))
    f = ell_eval(f, next(it))
    return f


def ser_ell_coeff(c) -> bytes:
    return ser_fq2(c[0]) + ser_fq2(c[1]) + ser_fq2(c[2])


def ser_g2_prepared(prep: tuple[list, bool]) -> bytes:
    ell, inf = prep
    return ser_list(ell, ser_ell_coeff) + ser_bool(inf)


def deser_g2_prepared(r: Reader) -> tuple[list, bool]:
    ell = r.vec(lambda: (r.fq2(), r.fq2(), r.fq2()))
    inf = r.boolean()
    return ell, inf


# ---------------------------------------------------------------------------
# Groth16 structures (forks/groth16/src/data_structures.rs)
# ---------------------------------------------------------------------------

def ser_proof(pf) -> bytes:
    return (
        ser_g1_uncompressed(pf.a)
        + ser_g2_uncompressed(pf.b)
        + ser_g1_uncompressed(pf.c)
    )


def deser_proof(r: Reader):
    from ..models.groth16 import Proof

    return Proof(a=r.g1(), b=r.g2(), c=r.g1())


def ser_vk(vk) -> bytes:
    return (
        ser_g1_uncompressed(vk.alpha_g1)
        + ser_g2_uncompressed(vk.beta_g2)
        + ser_g2_uncompressed(vk.gamma_g2)
        + ser_g1_uncompressed(vk.delta_g1)
        + ser_g2_uncompressed(vk.delta_g2)
        + ser_list(vk.gamma_abc_g1, ser_g1_uncompressed)
    )


def deser_vk(r: Reader):
    from ..models.groth16 import VerifyingKey

    return VerifyingKey(
        alpha_g1=r.g1(),
        beta_g2=r.g2(),
        gamma_g2=r.g2(),
        delta_g1=r.g1(),
        delta_g2=r.g2(),
        gamma_abc_g1=r.vec(r.g1),
    )


def ser_pvk(pvk) -> bytes:
    """PreparedVerifyingKey: vk, e(alpha,beta), -gamma_g2 and -delta_g2
    prepared (data_structures.rs:62-72)."""
    vk = pvk.vk
    gamma_neg = BN254G2.neg(vk.gamma_g2)
    delta_neg = BN254G2.neg(vk.delta_g2)
    return (
        ser_vk(vk)
        + ser_fq12(pvk.alpha_beta)
        + ser_g2_prepared(g2_prepare(gamma_neg))
        + ser_g2_prepared(g2_prepare(delta_neg))
    )


def deser_pvk(r: Reader):
    from ..models.groth16 import PreparedVerifyingKey

    vk = deser_vk(r)
    alpha_beta = r.fq12()
    deser_g2_prepared(r)  # gamma_g2_neg_pc (recomputable from vk)
    deser_g2_prepared(r)  # delta_g2_neg_pc
    return PreparedVerifyingKey(vk=vk, alpha_beta=alpha_beta)


def ser_proving_key(pk) -> bytes:
    return (
        ser_vk(pk.vk)
        + ser_g1_uncompressed(pk.beta_g1)
        + ser_g1_uncompressed(pk.delta_g1)
        + ser_list(pk.a_query, ser_g1_uncompressed)
        + ser_list(pk.b_g1_query, ser_g1_uncompressed)
        + ser_list(pk.b_g2_query, ser_g2_uncompressed)
        + ser_list(pk.h_query, ser_g1_uncompressed)
        + ser_list(pk.l_query, ser_g1_uncompressed)
    )


def deser_proving_key(r: Reader):
    from ..models.groth16 import ProvingKey

    return ProvingKey(
        vk=deser_vk(r),
        beta_g1=r.g1(),
        delta_g1=r.g1(),
        a_query=r.point_vec(),
        b_g1_query=r.point_vec(),
        b_g2_query=r.point_vec(g2=True),
        h_query=r.point_vec(),
        l_query=r.point_vec(),
    )


# ---------------------------------------------------------------------------
# KZG10 (forks/ark-poly-commit/src/kzg10/data_structures.rs)
# ---------------------------------------------------------------------------

def ser_kzg_powers(powers) -> bytes:
    return ser_list(powers.powers_of_g, ser_g1_uncompressed) + ser_list(
        powers.powers_of_gamma_g, ser_g1_uncompressed
    )


def deser_kzg_powers(r: Reader):
    from ..models.kzg import Powers

    return Powers(powers_of_g=r.vec(r.g1), powers_of_gamma_g=r.vec(r.g1))


def ser_kzg_vk(vk) -> bytes:
    """kzg10::VerifierKey serializes g, gamma_g, h, beta_h only; the prepared
    fields are recomputed on deserialize (data_structures.rs:213-259)."""
    return (
        ser_g1_uncompressed(vk.g)
        + ser_g1_uncompressed(vk.gamma_g)
        + ser_g2_uncompressed(vk.h)
        + ser_g2_uncompressed(vk.beta_h)
    )


def deser_kzg_vk(r: Reader):
    from ..models.kzg import VerifierKey

    return VerifierKey(g=r.g1(), gamma_g=r.g1(), h=r.g2(), beta_h=r.g2())


def ser_kzg_commitment(c) -> bytes:
    return ser_g1_uncompressed(c.c)


def deser_kzg_commitment(r: Reader):
    from ..models.kzg import Commitment

    return Commitment(c=r.g1())


def ser_kzg_proof(pf) -> bytes:
    return ser_g1_uncompressed(pf.w) + ser_option(pf.random_v, ser_fr)


def deser_kzg_proof(r: Reader):
    from ..models.kzg import Proof

    return Proof(w=r.g1(), random_v=r.option(r.fr))


# ---------------------------------------------------------------------------
# creds structures
# ---------------------------------------------------------------------------

def ser_dlogpok(d) -> bytes:
    return ser_fr(d.c) + ser_list(d.s, lambda row: ser_list(row, ser_fr))


def deser_dlogpok(r: Reader):
    from ..credentials.dlog import DLogPoK

    return DLogPoK(c=r.fr(), s=r.vec(lambda: r.vec(r.fr)))


def ser_pedersen_opening(o) -> bytes:
    return (
        ser_list(o.bases, ser_g1_uncompressed)
        + ser_fr(o.m)
        + ser_fr(o.r)
        + ser_g1_uncompressed(o.c)
    )


def deser_pedersen_opening(r: Reader):
    from ..credentials.dlog import PedersenOpening

    return PedersenOpening(bases=r.vec(r.g1), m=r.fr(), r=r.fr(), c=r.g1())


def ser_range_proof_pk(pk) -> bytes:
    return ser_kzg_powers(pk.powers)


def deser_range_proof_pk(r: Reader):
    from ..credentials.rangeproof import RangeProofPK

    return RangeProofPK(powers=deser_kzg_powers(r))


def ser_range_proof_vk(vk) -> bytes:
    assert len(vk.com_f_basis) == 4  # [E::G1; 4] fixed array: no length prefix
    return ser_kzg_vk(vk.kzg_vk) + b"".join(
        ser_g1_uncompressed(p) for p in vk.com_f_basis
    )


def deser_range_proof_vk(r: Reader):
    from ..credentials.rangeproof import RangeProofVK

    kzg_vk = deser_kzg_vk(r)
    basis = [r.g1() for _ in range(4)]
    return RangeProofVK(kzg_vk=kzg_vk, com_f_basis=basis)


def ser_range_proof(rp) -> bytes:
    return (
        ser_kzg_commitment(rp.com_f)
        + ser_kzg_commitment(rp.com_g)
        + ser_fr(rp.eval_g)
        + ser_kzg_proof(rp.proof_g)
        + ser_fr(rp.eval_gw)
        + ser_kzg_proof(rp.proof_gw)
        + ser_kzg_commitment(rp.com_q)
        + ser_fr(rp.eval_w_hat)
        + ser_kzg_proof(rp.proof_w_hat)
        + ser_dlogpok(rp.dleq_proof)
    )


def deser_range_proof(r: Reader):
    from ..credentials.rangeproof import RangeProof

    return RangeProof(
        com_f=deser_kzg_commitment(r),
        com_g=deser_kzg_commitment(r),
        eval_g=r.fr(),
        proof_g=deser_kzg_proof(r),
        eval_gw=r.fr(),
        proof_gw=deser_kzg_proof(r),
        com_q=deser_kzg_commitment(r),
        eval_w_hat=r.fr(),
        proof_w_hat=deser_kzg_proof(r),
        dleq_proof=deser_dlogpok(r),
    )


def ser_show_groth16(sg) -> bytes:
    return (
        ser_proof(sg.rand_proof)
        + ser_g1_uncompressed(sg.com_hidden_inputs)
        + ser_dlogpok(sg.pok_inputs)
        + ser_list(sg.committed_inputs, ser_g1_uncompressed)
    )


def deser_show_groth16(r: Reader):
    from ..credentials.groth16rand import ShowGroth16

    return ShowGroth16(
        rand_proof=deser_proof(r),
        com_hidden_inputs=r.g1(),
        pok_inputs=deser_dlogpok(r),
        committed_inputs=r.vec(r.g1),
    )


def ser_show_range(sr) -> bytes:
    return ser_range_proof(sr.range_proof)


def deser_show_range(r: Reader):
    from ..credentials.groth16rand import ShowRange

    return ShowRange(range_proof=deser_range_proof(r))


def ser_client_state(cs) -> bytes:
    """groth16rand.rs:26-37 field order (note input_com_randomness sits
    between pvk and committed_input_openings)."""
    return (
        ser_list(cs.inputs, ser_fr)
        + ser_option(cs.aux, ser_string)
        + ser_proof(cs.proof)
        + ser_vk(cs.vk)
        + ser_pvk(cs.pvk)
        + ser_option(cs.input_com_randomness, ser_fr)
        + ser_list(cs.committed_input_openings, ser_pedersen_opening)
        + ser_string(cs.credtype)
        + ser_string(cs.config_str)
    )


def deser_client_state(r: Reader):
    from ..credentials.groth16rand import ClientState

    inputs = r.vec(r.fr)
    aux = r.option(r.string)
    proof = deser_proof(r)
    vk = deser_vk(r)
    pvk = deser_pvk(r)
    icr = r.option(r.fr)
    coo = r.vec(lambda: deser_pedersen_opening(r))
    credtype = r.string()
    config_str = r.string()
    return ClientState(
        inputs=inputs,
        aux=aux,
        proof=proof,
        vk=vk,
        pvk=pvk,
        config_str=config_str,
        credtype=credtype,
        input_com_randomness=icr,
        committed_input_openings=coo,
    )


def ser_device_proof(dp) -> bytes:
    return (
        ser_biguint(dp.r_x)
        + ser_biguint(dp.r_y)
        + ser_byte_vec(dp.digest)
        + ser_g1_uncompressed(dp.com1)
        + ser_g1_uncompressed(dp.comz)
        + ser_byte_vec(dp.h_Q)
        + ser_fr(dp.m)
        + ser_dlogpok(dp.pi0)
        + ser_dlogpok(dp.pi1)
        + ser_byte_vec(dp.pi2)
    )


def deser_device_proof(r: Reader):
    from ..credentials.device import DeviceProof

    return DeviceProof(
        r_x=r.biguint(),
        r_y=r.biguint(),
        digest=r.byte_vec(),
        com1=r.g1(),
        comz=r.g1(),
        h_Q=r.byte_vec(),
        m=r.fr(),
        pi0=deser_dlogpok(r),
        pi1=deser_dlogpok(r),
        pi2=r.byte_vec(),
    )


# ---------------------------------------------------------------------------
# lib.rs bundles
# ---------------------------------------------------------------------------

def ser_prover_params(pp) -> bytes:
    return (
        ser_proving_key(pp.groth16_params)
        + ser_pvk(pp.groth16_pvk)
        + ser_string(pp.config_str)
    )


def deser_prover_params(r: Reader):
    from ..credentials.api import ProverParams

    return ProverParams(
        groth16_params=deser_proving_key(r),
        groth16_pvk=deser_pvk(r),
        config_str=r.string(),
    )


def ser_show_params(sp) -> bytes:
    return ser_range_proof_pk(sp.range_pk)


def deser_show_params(r: Reader):
    from ..credentials.api import ShowParams

    return ShowParams(range_pk=deser_range_proof_pk(r))


def ser_verifier_params(vp) -> bytes:
    return (
        ser_vk(vp.vk)
        + ser_pvk(vp.pvk)
        + ser_range_proof_vk(vp.range_vk)
        + ser_string(vp.io_locations_str)
        + ser_string(vp.issuer_pem)
        + ser_string(vp.config_str)
    )


def deser_verifier_params(r: Reader):
    from ..credentials.api import VerifierParams

    return VerifierParams(
        vk=deser_vk(r),
        pvk=deser_pvk(r),
        range_vk=deser_range_proof_vk(r),
        io_locations_str=r.string(),
        issuer_pem=r.string(),
        config_str=r.string(),
    )


def ser_show_proof(sp) -> bytes:
    return (
        ser_show_groth16(sp.show_groth16)
        + ser_show_range(sp.show_range_exp)
        + ser_list(sp.show_range_attr, ser_show_range)
        + ser_list(sp.revealed_inputs, ser_fr)
        + ser_option(sp.revealed_preimages, ser_string)
        + ser_u64(sp.inputs_len)
        + ser_u64(sp.cur_time)
        + ser_option(sp.device_proof, ser_device_proof)
    )


def deser_show_proof(r: Reader):
    from ..credentials.api import ShowProof

    return ShowProof(
        show_groth16=deser_show_groth16(r),
        show_range_exp=deser_show_range(r),
        show_range_attr=r.vec(lambda: deser_show_range(r)),
        revealed_inputs=r.vec(r.fr),
        revealed_preimages=r.option(r.string),
        inputs_len=r.u64(),
        cur_time=r.u64(),
        device_proof=r.option(lambda: deser_device_proof(r)),
    )


# ---------------------------------------------------------------------------
# Type registry (api.write_to_file/read_from_file dispatch)
# ---------------------------------------------------------------------------

def _registry():
    from ..credentials.api import ProverParams, ShowParams, ShowProof, VerifierParams
    from ..credentials.device import DeviceProof
    from ..credentials.dlog import DLogPoK, PedersenOpening
    from ..credentials.groth16rand import ClientState, ShowGroth16, ShowRange
    from ..credentials.rangeproof import RangeProof, RangeProofPK, RangeProofVK
    from ..models.groth16 import (
        PreparedVerifyingKey,
        Proof,
        ProvingKey,
        VerifyingKey,
    )

    return {
        Proof: (ser_proof, deser_proof),
        VerifyingKey: (ser_vk, deser_vk),
        PreparedVerifyingKey: (ser_pvk, deser_pvk),
        ProvingKey: (ser_proving_key, deser_proving_key),
        DLogPoK: (ser_dlogpok, deser_dlogpok),
        PedersenOpening: (ser_pedersen_opening, deser_pedersen_opening),
        RangeProofPK: (ser_range_proof_pk, deser_range_proof_pk),
        RangeProofVK: (ser_range_proof_vk, deser_range_proof_vk),
        RangeProof: (ser_range_proof, deser_range_proof),
        ClientState: (ser_client_state, deser_client_state),
        ShowGroth16: (ser_show_groth16, deser_show_groth16),
        ShowRange: (ser_show_range, deser_show_range),
        DeviceProof: (ser_device_proof, deser_device_proof),
        ProverParams: (ser_prover_params, deser_prover_params),
        ShowParams: (ser_show_params, deser_show_params),
        VerifierParams: (ser_verifier_params, deser_verifier_params),
        ShowProof: (ser_show_proof, deser_show_proof),
    }


def serialize(obj) -> bytes:
    reg = _registry()
    ser, _ = reg[type(obj)]
    return ser(obj)


def deserialize(buf: bytes, typ):
    reg = _registry()
    _, de = reg[typ]
    r = Reader(buf)
    out = de(r)
    r.done()
    return out
