"""ECDSA proof-of-possession (reference: ecdsa-pop/src/lib.rs).

A copy of ``crescent_tpu/credentials/ecdsa_pop.py`` (host only: the
Spartan NIZK's MSMs run on the native backend, models/spartan.py).

Statement (lib.rs:38-57): given public T = (1/r)R and U = (-h/r)G on P-256,
prove knowledge of (s, q0, q1, z) such that
    h_Q = Poseidon(q0, q1, z),
    m   = q0 + q1*e1 + z*e2  (mod BN254 Fr, emulated),
    Q.x = q0 + 2^128*q1,  and  (s*T + U).x = Q.x,
which ties a fresh ECDSA signature under the committed device key to the
BN254 commitments of the show proof.

Circuit design (ours, same statement as ECDSAProofCircuit::synthesize
lib.rs:360-420 but arithmetized with the native builder over T-256's scalar
field = P-256's base field):

  * public IO layout matches the reference verifier's input vector
    [T.x, T.y, 0, U.x, U.y, 0, hQ] (lib.rs:600-606);
  * m, e1, e2 are circuit CONSTANTS, exactly like the reference where the
    shape is re-synthesized per call with `allocate_field_element_unchecked`
    (lib.rs:372-380) — which makes the emulated BN254-Fr relation m = q0 +
    e1*q1 + e2*z LINEAR in the witness limbs.  Instead of porting the
    generic gnark-style emulated multiplier (ecdsa-pop/src/emulated/,
    3.1k LoC), we enforce the integer identity
        q0 + e1*q1 + e2*z - m - k*p_fr == 0
    with a witnessed quotient k and a 16-bit-limb signed carry chain —
    ~4x fewer constraints for this statement;
  * scalar multiplication uses the Nova-style split (ecc.rs:432-525):
    incomplete double-and-add for the low 254 bits assuming bit0 = 1,
    slack removal, then complete addition for the top 2 bits.

Hot loops (sumcheck rounds, mlpoly commitments) live in models/spartan.py.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

from ..core.curves import P256
from ..core.fields import BN254_FR, P256_FP, P256_FQ, T256_FQ
from ..core.poseidon import Poseidon, get_poseidon, io_pattern_value, safe_hash
from ..models import spartan as sp
from ..r1cs.builder import LC, ConstraintSystem, Var
from ..utils.merlin import Transcript

F = T256_FQ  # == P256_FP: circuit field = Spartan scalar field
assert F == P256_FP


@dataclass
class ECDSAParams:
    """ECDSAParams (lib.rs:78): P-256 signature curve, BN254 commitment field."""

    curve: str = "secp256r1"
    commitment_field: int = BN254_FR


def split_public_key_x(pubkey_x: int) -> tuple[int, int]:
    """Q.x = q0 + 2^128*q1 (ECDSAProof::split_public_key_x, lib.rs:441)."""
    mask = (1 << 128) - 1
    return pubkey_x & mask, pubkey_x >> 128


def compute_hQ(q0: int, q1: int, z: int) -> bytes:
    """h_Q = Poseidon(q0, q1, z) over P-256's base field via the neptune
    SAFE sponge with IOPattern [Absorb(3), Squeeze(1)] over a width-3 (U2)
    permutation (ecdsa-pop/src/lib.rs:308-320, src/poseidon.rs:71-100),
    serialized little-endian (32 bytes)."""
    pos = get_poseidon(P256_FP, 3)  # U2 arity: width 3, rate 2
    h = safe_hash(pos, [q0 % P256_FP, q1 % P256_FP, z % P256_FP])
    return int(h).to_bytes(32, "little")


def compute_RTU(sig_r: int, sig_s: int, digest: bytes, pubkey_x: int, pubkey_y: int):
    """Recover R and compute T = (1/r)R, U = (-h/r)G (lib.rs:180-240).

    Returns (R, T, U) as affine P-256 points; R chosen so that the statement
    s*T + U == Q holds for the given public key."""
    n = P256_FQ
    h = int.from_bytes(digest[:32], "big") % n
    # R candidates from r (x-coordinate); pick the one consistent with Q:
    # s*R == h*G + r*Q  (standard ECDSA relation)
    rhs = P256.add(P256.mul(h, P256.generator), P256.mul(sig_r, (pubkey_x, pubkey_y)))
    for parity in (0, 1):
        R = P256.lift_x(sig_r, parity)
        if P256.mul(sig_s, R) == rhs:
            r_inv = pow(sig_r, -1, n)
            T = P256.mul(r_inv, R)
            U = P256.mul((-h * r_inv) % n, P256.generator)
            # sanity: s*T + U == Q
            assert P256.add(P256.mul(sig_s, T), U) == (pubkey_x, pubkey_y)
            return R, T, U
    raise ValueError("signature r does not correspond to a valid point")


def compute_TU(R, digest: bytes):
    """Verifier-side T, U from R and the digest (lib.rs:compute_TU)."""
    n = P256_FQ
    h = int.from_bytes(digest[:32], "big") % n
    r = R[0] % n
    r_inv = pow(r, -1, n)
    T = P256.mul(r_inv, R)
    U = P256.mul((-h * r_inv) % n, P256.generator)
    return T, U


# ---------------------------------------------------------------------------
# In-circuit P-256 gadgets (design mirrors ecc.rs; field ops are native)
# ---------------------------------------------------------------------------


def _inv0(x: int) -> int:
    x %= F
    return pow(x, -1, F) if x else 0


class _Pt:
    """Non-infinity circuit point (x, y as Var/LC)."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x, self.y = x, y


class _PtInf:
    """Circuit point with infinity flag."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x, y, inf):
        self.x, self.y, self.inf = x, y, inf


def _alloc_div(cs: ConstraintSystem, num, den) -> Var:
    """lam = num/den enforced via lam*den = num; witness uses inv0 so shape
    synthesis with dummy inputs never crashes."""
    lam = cs.alloc(cs.value(num) * _inv0(cs.value(den)) % F)
    cs.enforce(LC.of(lam), LC.of(den), LC.of(num))
    return lam


def ec_add_incomplete(cs: ConstraintSystem, p1: _Pt, p2: _Pt) -> _Pt:
    """Chord addition, x1 != x2 assumed (ecc.rs:656-718). 3 constraints."""
    lam = _alloc_div(cs, LC.of(p2.y) - LC.of(p1.y), LC.of(p2.x) - LC.of(p1.x))
    vl = cs.value(lam)
    x3 = cs.alloc((vl * vl - cs.value(p1.x) - cs.value(p2.x)) % F)
    cs.enforce(LC.of(lam), LC.of(lam), LC.of(x3) + LC.of(p1.x) + LC.of(p2.x))
    y3 = cs.alloc((vl * (cs.value(p1.x) - cs.value(x3)) - cs.value(p1.y)) % F)
    cs.enforce(LC.of(lam), LC.of(p1.x) - LC.of(x3), LC.of(y3) + LC.of(p1.y))
    return _Pt(x3, y3)


def ec_double_incomplete(cs: ConstraintSystem, p: _Pt) -> _Pt:
    """Tangent doubling, y != 0 assumed (ecc.rs:720-776). 4 constraints."""
    a = P256.a % F
    xx = cs.mul(p.x, p.x)
    lam = _alloc_div(cs, LC.of(xx, 3) + LC.of(a), LC.of(p.y, 2))
    vl = cs.value(lam)
    x3 = cs.alloc((vl * vl - 2 * cs.value(p.x)) % F)
    cs.enforce(LC.of(lam), LC.of(lam), LC.of(x3) + LC.of(p.x, 2))
    y3 = cs.alloc((vl * (cs.value(p.x) - cs.value(x3)) - cs.value(p.y)) % F)
    cs.enforce(LC.of(lam), LC.of(p.x) - LC.of(x3), LC.of(y3) + LC.of(p.y))
    return _Pt(x3, y3)


def ec_select(cs: ConstraintSystem, cond: Var, a: _Pt, b: _Pt) -> _Pt:
    return _Pt(cs.select(cond, a.x, b.x), cs.select(cond, a.y, b.y))


def ec_add_complete(cs: ConstraintSystem, p1: _PtInf, p2: _PtInf) -> _PtInf:
    """Complete addition over points-with-infinity-flags (the case analysis
    of ecc.rs add_internal:166-330, reformulated with guarded inverses)."""
    x1, y1, i1 = p1.x, p1.y, p1.inf
    x2, y2, i2 = p2.x, p2.y, p2.inf
    # eq_x = (x1 == x2), eq_y = (y1 == y2)
    eq_x = cs.is_zero(LC.of(x1) - LC.of(x2))
    eq_y = cs.is_zero(LC.of(y1) - LC.of(y2))
    # chord slope (guarded: 0 when x1 == x2)
    dx_inv = cs.alloc(_inv0(cs.value(x2) - cs.value(x1)))
    # (x2-x1)*dx_inv = 1 - eq_x
    cs.enforce(LC.of(x2) - LC.of(x1), LC.of(dx_inv), LC.of(1) - LC.of(eq_x))
    lam_c = cs.mul(LC.of(y2) - LC.of(y1), dx_inv)
    # tangent slope (guarded: 0 when y1 == 0)
    a = P256.a % F
    xx = cs.mul(x1, x1)
    y2inv = cs.alloc(_inv0(2 * cs.value(y1)))
    y1_zero = cs.is_zero(y1)
    cs.enforce(LC.of(y1, 2), LC.of(y2inv), LC.of(1) - LC.of(y1_zero))
    lam_d = cs.mul(LC.of(xx, 3) + LC.of(a), y2inv)
    lam = cs.select(eq_x, lam_d, lam_c)
    # x3 = lam^2 - x1 - x2 ; y3 = lam(x1 - x3) - y1
    ll = cs.mul(lam, lam)
    x3 = cs.add_const_mul(LC.of(ll) - LC.of(x1) - LC.of(x2))
    t = cs.mul(lam, LC.of(x1) - LC.of(x3))
    y3 = cs.add_const_mul(LC.of(t) - LC.of(y1))
    # result infinity: both finite and x1==x2 and y1 != y2  (P2 == -P1)
    not_eq_y = cs.add_const_mul(LC.of(1) - LC.of(eq_y))
    res_inf = cs.and_(eq_x, not_eq_y)
    # select against input infinity flags: if i1 -> p2 ; elif i2 -> p1
    x_out = cs.select(i1, x2, cs.select(i2, x1, x3))
    y_out = cs.select(i1, y2, cs.select(i2, y1, y3))
    not_i1 = cs.add_const_mul(LC.of(1) - LC.of(i1))
    not_i2 = cs.add_const_mul(LC.of(1) - LC.of(i2))
    both_fin = cs.and_(not_i1, not_i2)
    inf_if_fin = cs.and_(both_fin, res_inf)
    # i1 -> i2 ; i2 -> i1 ; else inf_if_fin
    inf_out = cs.select(i1, i2, cs.select(i2, i1, inf_if_fin))
    return _PtInf(x_out, y_out, inf_out)


def ec_scalar_mul(cs: ConstraintSystem, T: _Pt, s: Var, num_bits: int = 256) -> _PtInf:
    """s*T via the Nova split (ecc.rs:432-525): bits 1..253 with incomplete
    formulas assuming bit0 = 1, slack removal, top 2 bits complete."""
    bits = cs.decompose_bits(s, num_bits)
    split = num_bits - 2
    zero = cs.alloc_bool(0)
    cs.assert_equal(zero, LC.of(0))
    acc = T
    p = ec_double_incomplete(cs, T)
    for i in range(1, split):
        temp = ec_add_incomplete(cs, acc, p)
        acc = ec_select(cs, bits[i], temp, acc)
        p = ec_double_incomplete(cs, p)
    # slack removal: acc -= T when bit0 == 0
    accI = _PtInf(acc.x, acc.y, zero)
    negT_y = cs.add_const_mul(LC.of(T.y, -1))
    acc_minus_T = ec_add_complete(cs, accI, _PtInf(T.x, negT_y, zero))
    x = cs.select(bits[0], accI.x, acc_minus_T.x)
    y = cs.select(bits[0], accI.y, acc_minus_T.y)
    inf = cs.select(bits[0], accI.inf, acc_minus_T.inf)
    accC = _PtInf(x, y, inf)
    pC = _PtInf(p.x, p.y, zero)
    for i in range(split, num_bits):
        temp = ec_add_complete(cs, accC, pC)
        x = cs.select(bits[i], temp.x, accC.x)
        y = cs.select(bits[i], temp.y, accC.y)
        inf = cs.select(bits[i], temp.inf, accC.inf)
        accC = _PtInf(x, y, inf)
        if i + 1 < num_bits:
            pd = ec_double_incomplete(cs, _Pt(pC.x, pC.y))
            pC = _PtInf(pd.x, pd.y, zero)
    return accC


# ---------------------------------------------------------------------------
# Poseidon circuit (same permutation as core/poseidon.py, x^5 S-box)
# ---------------------------------------------------------------------------


def poseidon_hash_gadget(cs: ConstraintSystem, inputs: list, pos: Poseidon) -> Var:
    """In-circuit SAFE-sponge Poseidon hash with IOPattern
    [Absorb(len(inputs)), Squeeze(1)] — matches core.poseidon.safe_hash and
    the reference's SpongeCircuit usage (ecdsa-pop/src/poseidon.rs:165-210).
    Each permutation consumes the full round-constant schedule from the
    start (neptune resets constants_offset per hash)."""
    rate = pos.t - 1

    def sbox(x_lc):
        x2 = cs.mul(x_lc, x_lc)
        x4 = cs.mul(x2, x2)
        return cs.mul(x4, x_lc)

    def mix(st):
        return [
            sum((LC.of(st[j], pos.mds[i][j]) for j in range(pos.t)), LC())
            for i in range(pos.t)
        ]

    def permute(st):
        rc = iter(pos.round_constants)
        half = pos.r_f // 2

        def full_round(st):
            st = [x + LC.of(next(rc)) for x in st]
            st = [LC.of(sbox(x)) for x in st]
            return mix(st)

        def partial_round(st):
            st = [x + LC.of(next(rc)) for x in st]
            st = [LC.of(sbox(st[0]))] + st[1:]
            return mix(st)

        for _ in range(half):
            st = full_round(st)
        for _ in range(pos.r_p):
            st = partial_round(st)
        for _ in range(half):
            st = full_round(st)
        return st

    tag = io_pattern_value([("absorb", len(inputs)), ("squeeze", 1)])
    state = [LC.of(tag % pos.p)] + [LC() for _ in range(rate)]
    apos = 0
    for x in inputs:
        if apos == rate:
            state = permute(state)
            apos = 0
        state[1 + apos] = state[1 + apos] + LC.of(x)
        apos += 1
    state = permute(state)  # absorb -> squeeze turn
    return cs.add_const_mul(state[1])


# ---------------------------------------------------------------------------
# Linear emulated BN254-Fr relation: m = q0 + e1*q1 + e2*z  (mod p_fr)
# ---------------------------------------------------------------------------

_LIMB = 16
_K_LIMBS = 18  # quotient bound: LHS < 2^512 -> k < 2^(512-253), pad to 18 limbs
_CARRY_BITS = 48


def _const_limbs(x: int, n: int) -> list[int]:
    return [(x >> (_LIMB * i)) & 0xFFFF for i in range(n)]


def _decompose_limbs(cs: ConstraintSystem, v: Var, n_limbs: int) -> list[Var]:
    bits = cs.decompose_bits(v, n_limbs * _LIMB)
    limbs = []
    for i in range(n_limbs):
        acc = LC()
        for j in range(_LIMB):
            acc = acc + LC.of(bits[i * _LIMB + j], 1 << j)
        limbs.append(cs.add_const_mul(acc))
    return limbs


def enforce_m_valid(cs: ConstraintSystem, q0: Var, q1: Var, z: Var, m: int, e1: int, e2: int):
    """Enforce q0 + e1*q1 + e2*z == m (mod BN254-Fr) over the integers with a
    witnessed quotient k and a signed 16-bit carry chain.  Replaces the
    reference's generic emulated mul (enforce_m_valid, lib.rs:330-358):
    since e1, e2, m are circuit constants the relation is linear in the
    witness limbs."""
    p_fr = BN254_FR
    q0l = _decompose_limbs(cs, q0, 16)
    q1l = _decompose_limbs(cs, q1, 16)
    zl = _decompose_limbs(cs, z, 16)
    # integer quotient witness — k can exceed the native field modulus
    # (k < 2^258 > F), so allocate it limb-wise and never as one element
    lhs_int = cs.value(q0) + e1 * cs.value(q1) + e2 * cs.value(z)
    k_int, rem = divmod(lhs_int - (m % p_fr), p_fr)
    if rem != 0 or k_int < 0:
        # dummy-witness synthesis: shape is all that matters, clamp k
        k_int = max(k_int, 0)
    kl = []
    for i in range(_K_LIMBS):
        limb = cs.alloc((k_int >> (_LIMB * i)) & 0xFFFF)
        cs.decompose_bits(limb, _LIMB)
        kl.append(limb)

    e1l = _const_limbs(e1, 16)
    e2l = _const_limbs(e2, 16)
    pl = _const_limbs(p_fr, 16)
    ml = _const_limbs(m % p_fr, 16)

    n_cols = _K_LIMBS + 16  # max column index of k*p_fr
    cols = [LC() for _ in range(n_cols)]
    for i, limb in enumerate(q0l):
        cols[i] = cols[i] + LC.of(limb)
    for i in range(16):
        for j in range(16):
            if e1l[j]:
                cols[i + j] = cols[i + j] + LC.of(q1l[i], e1l[j])
            if e2l[j]:
                cols[i + j] = cols[i + j] + LC.of(zl[i], e2l[j])
    for i in range(_K_LIMBS):
        for j in range(16):
            if pl[j]:
                cols[i + j] = cols[i + j] - LC.of(kl[i], pl[j])
    for i in range(16):
        cols[i] = cols[i] - LC.of(ml[i])

    # signed carry chain: cols[j] + carry_{j-1} == 2^16 * carry_j
    offset = 1 << (_CARRY_BITS - 1)
    carry_lc = LC()
    for j in range(n_cols):
        d = cols[j] + carry_lc
        dv = cs.value(d)
        # interpret as signed (canonical reps near F are negatives)
        sval = dv if dv < F // 2 else dv - F
        assert sval % (1 << _LIMB) == 0 or True  # holds for honest witness
        cval = sval >> _LIMB
        carry = cs.alloc(cval % F)
        # range check carry in [-2^47, 2^47): decompose carry + 2^47
        shifted = cs.add_const_mul(LC.of(carry) + LC.of(offset))
        cs.decompose_bits(shifted, _CARRY_BITS)
        cs.assert_equal(d, LC.of(carry, 1 << _LIMB))
        carry_lc = LC.of(carry)
    cs.assert_equal(carry_lc, LC.of(0))


# ---------------------------------------------------------------------------
# The ECDSA-PoP circuit + Spartan glue
# ---------------------------------------------------------------------------


def synthesize_ecdsa_circuit(
    T, U, hQ: int, m: int, e1: int, e2: int,
    s: int | None, q0: int | None, q1: int | None, z: int | None,
) -> ConstraintSystem:
    """Build shape + witness (prover) or shape with dummy witness (verifier,
    pass None prover inputs).  Mirrors ECDSAProofCircuit::synthesize
    (lib.rs:360-420); m/e1/e2 are baked in as constants exactly like the
    reference."""
    cs = ConstraintSystem(field=F)
    Tx = cs.alloc_public(T[0], "T_x")
    Ty = cs.alloc_public(T[1], "T_y")
    Tinf = cs.alloc_public(0)
    Ux = cs.alloc_public(U[0], "U_x")
    Uy = cs.alloc_public(U[1], "U_y")
    Uinf = cs.alloc_public(0)
    hQv = cs.alloc_public(hQ % F, "hQ")
    # dummy witness values for shape-only synthesis
    sv = 1 if s is None else s
    q0v = 1 if q0 is None else q0
    q1v = 1 if q1 is None else q1
    zv = 1 if z is None else z
    s_var = cs.alloc(sv % F)
    q0_var = cs.alloc(q0v % F)
    q1_var = cs.alloc(q1v % F)
    z_var = cs.alloc(zv % F)

    # 1. hQ == Poseidon(q0, q1, z)
    pos = get_poseidon(P256_FP, 3)
    hQ_prime = poseidon_hash_gadget(cs, [q0_var, q1_var, z_var], pos)
    cs.assert_equal(hQv, hQ_prime)

    # 2. m == q0 + e1*q1 + e2*z (mod BN254-Fr)
    enforce_m_valid(cs, q0_var, q1_var, z_var, m, e1, e2)

    # 3. Qx = q0 + 2^128*q1 ;  4. (s*T + U).x == Qx
    qx_lc = LC.of(q0_var) + LC.of(q1_var, 1 << 128)
    sT = ec_scalar_mul(cs, _Pt(Tx, Ty), s_var)
    zero = cs.alloc_bool(0)
    cs.assert_equal(zero, LC.of(0))
    lhs = ec_add_complete(cs, sT, _PtInf(Ux, Uy, zero))
    cs.assert_equal(lhs.x, qx_lc)
    # the sum must be a finite point (honest: Q)
    cs.assert_equal(lhs.inf, LC.of(0))
    _ = Tinf, Uinf
    return cs


def builder_to_spartan(cs: ConstraintSystem):
    """Convert builder layout [1, publics, privates] to Spartan layout
    [vars..., 1, inputs...] (Instance::new_from_shape semantics)."""
    n_pub = cs.num_instance - 1
    n_priv = len(cs.values) - cs.num_instance
    num_vars = n_priv

    def remap(col: int) -> int:
        if col == 0:
            return num_vars
        if col <= n_pub:
            return num_vars + col
        return col - 1 - n_pub

    A, B, C = [], [], []
    for row, (a, b, c) in enumerate(cs.constraints):
        for terms, out in ((a, A), (b, B), (c, C)):
            for col, coeff in terms:
                out.append((row, remap(col), coeff))
    inst = sp.SpartanR1CSInstance.from_unpadded(
        len(cs.constraints), num_vars, n_pub, A, B, C
    )
    vars_ = cs.values[cs.num_instance :]
    inputs = cs.values[1 : cs.num_instance]
    return inst, vars_, inputs


_ECDSA_TRANSCRIPT_LABEL = b"NIZK proof of ECDSA signature with committed public key"


class ECDSAProof:
    """Spartan NIZK for the ECDSA-PoP circuit (lib.rs:441-615)."""

    @staticmethod
    def prove(
        params: ECDSAParams,
        pubkey_x: int, pubkey_y: int,
        sig_r: int, sig_s: int, digest: bytes,
        h_q: bytes, m: int, e1: bytes, e2: bytes, z: int,
    ):
        """Returns (R.x, R.y, zlib-compressed proof bytes) like
        ECDSAProof::prove (lib.rs:476-551)."""
        R, T, U = compute_RTU(sig_r, sig_s, digest, pubkey_x, pubkey_y)
        q0, q1 = split_public_key_x(pubkey_x)
        e1i = int.from_bytes(e1, "little")
        e2i = int.from_bytes(e2, "little")
        hQi = int.from_bytes(h_q, "little")
        cs = synthesize_ecdsa_circuit(T, U, hQi, m, e1i, e2i, sig_s, q0, q1, z)
        assert cs.is_satisfied(), "ECDSA circuit unsatisfied"
        inst, vars_, inputs = builder_to_spartan(cs)
        gens = sp.NIZKGens(inst.num_cons, inst.num_vars, inst.num_inputs)
        ts = Transcript(_ECDSA_TRANSCRIPT_LABEL)
        nizk = sp.NIZK.prove(inst, vars_, inputs, gens, ts)
        # zlib + bincode-style bytes, the reference's proof wire format
        # (ecdsa-pop/src/lib.rs:541-545) — models/spartan_ser.py
        from ..models import spartan_ser

        blob = zlib.compress(spartan_ser.ecdsa_proof_to_bytes(nizk))
        return R[0], R[1], blob

    @staticmethod
    def verify(
        params: ECDSAParams,
        r_x: int, r_y: int, digest: bytes,
        h_q: bytes, m: int, e1: bytes, e2: bytes, proof_blob: bytes,
    ) -> bool:
        try:
            T, U = compute_TU((r_x, r_y), digest)
        except ValueError:
            return False
        e1i = int.from_bytes(e1, "little")
        e2i = int.from_bytes(e2, "little")
        hQi = int.from_bytes(h_q, "little")
        # re-synthesize the shape with dummy witness (lib.rs:566-574)
        cs = synthesize_ecdsa_circuit(T, U, hQi, m, e1i, e2i, None, None, None, None)
        inst, _dummy_vars, inputs = builder_to_spartan(cs)
        gens = sp.NIZKGens(inst.num_cons, inst.num_vars, inst.num_inputs)
        from ..models import spartan_ser

        try:
            nizk = spartan_ser.ecdsa_proof_from_bytes(zlib.decompress(proof_blob))
            ts = Transcript(_ECDSA_TRANSCRIPT_LABEL)
            nizk.verify(inst, inputs, ts, gens)
            return True
        except (sp.SpartanError, AssertionError, ValueError, zlib.error, EOFError):
            return False
