"""Non-native P-256 ECDSA verification gadgets (mdl1 statement, ES256).

A copy of ``crescent_tpu/r1cs/p256.py``: a re-design of the reference's
circom-ecdsa-p256 port
(circuit_setup/circuits-mdl/ecdsa-p256/{ecdsa,p256,bigint}.circom):
P-256 field elements are emulated over BN254-Fr as 6 x 43-bit limbs
(CIRCOM_P256_LIMB_BITS, circuit_setup/scripts/crescent_helper.py:17-19),
points are affine limb pairs, and scalar multiplication is 8-bit-stride
windowed with one-hot multiplexing (ecdsa.circom ECDSAPrivToPub:13-127).

Where the reference differs: our zksetup specializes the circuit to the
issuer key (the pubkey limbs stay public IOs, additionally constrained to
the issuer's constants), which makes BOTH scalar multiplications
fixed-base — table entries become R1CS *constants*, so the per-stride
point selection is a free linear combination instead of in-circuit table
construction (P256ScalarMult builds 256-entry multiple tables with
in-circuit adds).  This cuts the ECDSA statement roughly in half; a
parameter set is per-issuer, which the pipeline already assumes (zksetup
consumes the issuer PEM, as prepare_mdl_setup.py's config does).

The workhorse is `nn_enforce`: one carry-chain check of
    sum_i s_i*(a_i*b_i) + sum_j t_j*c_j == 0  (mod m)
over integer limb planes with a biased witness quotient — the same
integer-identity pattern as r1cs/bigint.mul_mod_gadget (and circom's
CheckCarryToZero), generalized to multi-term so each curve formula costs
one chain instead of three.
"""

from __future__ import annotations

import functools

from ..core.curves import P256
from .builder import LC, ConstraintSystem, Var

LIMB = 43     # CIRCOM_P256_LIMB_BITS
K = 6         # CIRCOM_P256_N_LIMBS
STRIDE = 8    # ecdsa.circom ECDSAPrivToPub stride
NBITS = LIMB * K          # 258
NSTRIDES = -(-NBITS // STRIDE)  # 33

P = P256.p
Q = P256.n


# ---------------------------------------------------------------------------
# limb helpers (operands may mix Var / LC / int constants)
# ---------------------------------------------------------------------------

def to_limbs(x: int, k: int = K) -> list[int]:
    mask = (1 << LIMB) - 1
    return [(x >> (LIMB * i)) & mask for i in range(k)]


def limbs_value(cs: ConstraintSystem, limbs: list) -> int:
    return sum(cs.value(l) << (LIMB * i) for i, l in enumerate(limbs))


def nn_alloc(cs: ConstraintSystem, value: int, k: int = K):
    """Allocate a k-limb emulated integer, range-checked; returns
    (limbs, bits) with bits the full little-endian decomposition."""
    limbs, bits = [], []
    for v in to_limbs(value, k):
        var = cs.alloc(v)
        bits.extend(cs.decompose_bits(var, LIMB))
        limbs.append(var)
    return limbs, bits


def nn_alloc_hinted(cs: ConstraintSystem, value: int, hint, k: int = K):
    """Like nn_alloc, but the limb VALUES come from a witness-replay hint:
    allocate limbs, record `hint(limb_indices)`, then range-check (the
    decompose hints execute after the value hint — builder hint order)."""
    limbs = [cs.alloc(v) for v in to_limbs(value, k)]
    hint([v.idx for v in limbs])
    bits = []
    for var in limbs:
        bits.extend(cs.decompose_bits(var, LIMB))
    return limbs, bits


def nn_enforce(cs: ConstraintSystem, muls: list, lins: list, m_int: int):
    """Enforce  sum s*(a*b) [muls: (s, a_limbs, b_limbs)]
              + sum t*c     [lins: (t, c_limbs)]  == 0 (mod m_int)
    as an exact integer identity via limb planes + biased carries.

    The witness quotient is biased (q' = q + 2^(KQ*LIMB-1)) so negative
    totals need no sign handling; q'*m is linear (m is constant).  With
    invalid placeholder inputs (setup-time shape build) the emitted
    constraints are simply unsatisfied — the shape is data-independent.
    """
    KQ = K + 1
    total = 0
    for s, a, b in muls:
        total += s * limbs_value(cs, a) * limbs_value(cs, b)
    for t, c in lins:
        total += t * limbs_value(cs, c)
    qv = total // m_int  # exact when total % m == 0; shape-only otherwise
    bias = 1 << (KQ * LIMB - 1)
    assert -bias < qv < bias, "nn_enforce quotient overflow"
    qb, _ = nn_alloc_hinted(
        cs, qv + bias,
        lambda idx: cs.hint_nn_quot(muls, lins, m_int, bias, idx, LIMB),
        KQ,
    )

    width = max(2 * K - 1, KQ + K)
    planes = [LC() for _ in range(width)]
    # product planes: one mul constraint per limb pair
    for s, a, b in muls:
        for i in range(K):
            for j in range(K):
                planes[i + j] = planes[i + j] + LC.of(cs.mul(a[i], b[j]), s)
    # linear planes: free
    for t, c in lins:
        for i, ci in enumerate(c):
            planes[i] = planes[i] + LC.of(ci, t)
    # -(q' - bias) * m, with m constant => linear; constant part folded in
    m_limbs = to_limbs(m_int, K)
    for i in range(KQ):
        for j in range(K):
            planes[i + j] = planes[i + j] - LC.of(qb[i], m_limbs[j])
    for i, c in enumerate(to_limbs(bias * m_int, width)):
        planes[i] = planes[i] + LC.of(c)

    # carry chain: planes[i] + carry_in == carry_out * 2^LIMB, carries biased
    # (plane magnitude < ~len(muls)*K*2^(2*LIMB) + ... << 2^(LIMB+13))
    carry_bits = LIMB + 13
    offset = 1 << (carry_bits - 1)
    shift = 1 << LIMB
    carry_lc = LC.of(0)
    for idx in range(width):
        diff_lc = planes[idx] + carry_lc
        nc = cs.alloc_sshr_bias(diff_lc, LIMB, offset)
        cs.decompose_bits(nc, carry_bits)
        cs.enforce(
            diff_lc - LC.of(nc, shift) + LC.of(offset * shift),
            LC.of(1),
            LC.of(0),
        )
        carry_lc = LC.of(nc) - LC.of(offset)
    cs.enforce(carry_lc, LC.of(1), LC.of(0))


def nn_mul(cs: ConstraintSystem, a: list, b: list, m_int: int):
    """r = a*b mod m_int; returns (limbs, bits) of r (canonical witness)."""
    rv = (limbs_value(cs, a) * limbs_value(cs, b)) % m_int
    r, bits = nn_alloc_hinted(
        cs, rv,
        lambda idx: cs.hint_nn_red([(1, a, b)], [], m_int, idx, LIMB),
    )
    nn_enforce(cs, [(1, a, b)], [(-1, r)], m_int)
    return r, bits


def _inv0(x: int, m: int) -> int:
    return pow(x, -1, m) if x % m else 0


# ---------------------------------------------------------------------------
# affine point gadget (limbs over P)
# ---------------------------------------------------------------------------

def point_const(pt) -> tuple[list[int], list[int]]:
    return to_limbs(pt[0]), to_limbs(pt[1])


def add_unequal(cs: ConstraintSystem, p1, p2):
    """(x3,y3) = p1 + p2, assuming x1 != x2 (p256.circom P256AddUnequal).
    lam*(x2-x1) = y2-y1; x3 = lam^2-x1-x2; y3 = lam*(x1-x3)-y1."""
    x1, y1 = p1
    x2, y2 = p2
    x1v, y1v = limbs_value(cs, x1), limbs_value(cs, y1)
    x2v, y2v = limbs_value(cs, x2), limbs_value(cs, y2)
    lamv = (y2v - y1v) * _inv0(x2v - x1v, P) % P
    x3v = (lamv * lamv - x1v - x2v) % P
    y3v = (lamv * (x1v - x3v) - y1v) % P
    lam, _ = nn_alloc_hinted(
        cs, lamv,
        lambda idx: cs.hint_nn_inv_mul(
            [(1, y2), (-1, y1)], [(1, x2), (-1, x1)], P, idx, LIMB
        ),
    )
    x3, _ = nn_alloc_hinted(
        cs, x3v,
        lambda idx: cs.hint_nn_red(
            [(1, lam, lam)], [(-1, x1), (-1, x2)], P, idx, LIMB
        ),
    )
    y3, _ = nn_alloc_hinted(
        cs, y3v,
        lambda idx: cs.hint_nn_red(
            [(1, lam, x1), (-1, lam, x3)], [(-1, y1)], P, idx, LIMB
        ),
    )
    nn_enforce(cs, [(1, lam, x2), (-1, lam, x1)], [(-1, y2), (1, y1)], P)
    nn_enforce(cs, [(1, lam, lam)], [(-1, x1), (-1, x2), (-1, x3)], P)
    nn_enforce(cs, [(1, lam, x1), (-1, lam, x3)], [(-1, y1), (-1, y3)], P)
    return x3, y3


# ---------------------------------------------------------------------------
# fixed-base windowed scalar multiplication
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stride_tables(base) -> list:
    """tables[i][j] = j * 2^(8i) * base (affine host ints), j in 0..255;
    entry 0 is the dummy stand-in 2^NBITS * base (never collides with a
    partial sum of honest strides — ecdsa.circom get_dummy_point)."""
    dummy = P256.msm([pow(2, NBITS, Q)], [base])
    tables = []
    cur = base
    for _ in range(NSTRIDES):
        row = [dummy]
        acc = None
        for _j in range(1, 1 << STRIDE):
            acc = cur if acc is None else P256.add(acc, cur)
            row.append(acc)
        tables.append(row)
        # advance cur to 2^STRIDE * cur
        for _ in range(STRIDE):
            cur = P256.double(cur)
    return tables


def _onehot256(cs: ConstraintSystem, bits8: list) -> list:
    """256-entry one-hot from 8 bit wires: pairwise products -> 4-entry
    LC one-hots, two 16-entry levels, one 256 outer product level."""
    def oh2(a, b):
        ab = cs.mul(a, b)
        return [
            LC.of(1) - LC.of(a) - LC.of(b) + LC.of(ab),
            LC.of(a) - LC.of(ab),
            LC.of(b) - LC.of(ab),
            LC.of(ab),
        ]

    lo2, hi2 = oh2(bits8[0], bits8[1]), oh2(bits8[2], bits8[3])
    lo16 = [cs.mul(lo2[i & 3], hi2[i >> 2]) for i in range(16)]
    lo2b, hi2b = oh2(bits8[4], bits8[5]), oh2(bits8[6], bits8[7])
    hi16 = [cs.mul(lo2b[i & 3], hi2b[i >> 2]) for i in range(16)]
    return [cs.mul(lo16[i & 15], hi16[i >> 4]) for i in range(256)]


def fixed_base_mul(cs: ConstraintSystem, scalar_bits: list, base):
    """scalar_bits: NBITS little-endian bit wires; base: host affine point.
    Returns (x, y) limb lists of scalar*base (dummy point if scalar == 0).
    Mirrors ECDSAPrivToPub's stride accumulation incl. the
    has_prev_nonzero / iszero partial multiplexing (ecdsa.circom:76-127)."""
    tables = _stride_tables(base)
    bits = list(scalar_bits) + [0] * (NSTRIDES * STRIDE - len(scalar_bits))

    def mux(onehot, row):
        out = []
        for coord in range(2):
            limbs = []
            for li in range(K):
                acc = LC()
                for j, oh in enumerate(onehot):
                    c = to_limbs(row[j][coord])[li]
                    if c:
                        acc = acc + LC.of(oh, c)
                limbs.append(cs.add_const_mul(acc))
            out.append(limbs)
        return out  # [x_limbs, y_limbs]

    def sel_pair(cond, a, b):
        """cond ? a : b, per coordinate limb (a, b = [x_limbs, y_limbs])."""
        return [
            [cs.select(cond, a[c][i], b[c][i]) for i in range(K)]
            for c in range(2)
        ]

    partial = None
    has_prev = None
    for i in range(NSTRIDES):
        b8 = bits[i * STRIDE : (i + 1) * STRIDE]
        # constant-0 padding bits materialize via add_const_mul (solvable
        # during witness replay, unlike a bare hint-less alloc_bool)
        onehot = _onehot256(
            cs,
            [bi if isinstance(bi, Var) else cs.add_const_mul(LC.of(0))
             for bi in b8],
        )
        iszero = onehot[0]
        sel = mux(onehot, tables[i])
        if partial is None:
            partial = sel
            has_prev = cs.add_const_mul(LC.of(1) - LC.of(iszero))
            continue
        added = add_unequal(cs, (partial[0], partial[1]), (sel[0], sel[1]))
        added = [list(added[0]), list(added[1])]
        # prev nonzero: keep partial if this stride is zero, else partial+sel
        with_prev = sel_pair(iszero, partial, added)
        # no prev nonzero: this stride's selection if nonzero, else zero
        zero = [[0] * K, [0] * K]
        without_prev = sel_pair(iszero, zero, sel)
        partial = sel_pair(has_prev, with_prev, without_prev)
        nz = cs.add_const_mul(LC.of(1) - LC.of(iszero))
        # has_prev = has_prev OR nz
        has_prev = cs.add_const_mul(
            LC.of(has_prev) + LC.of(nz) - LC.of(cs.mul(has_prev, nz))
        )
    return partial[0], partial[1]


# ---------------------------------------------------------------------------
# ECDSA verify
# ---------------------------------------------------------------------------

def ecdsa_verify_gadget(cs: ConstraintSystem, r, s, msghash, pubkey):
    """Constrain (r, s) to be a valid ECDSA-P256 signature on msghash under
    `pubkey` (host affine ints).  r/s/msghash: 6-limb range-checked wires.
    ecdsa.circom ECDSAVerifyNoPubkeyCheck:128-226, with both scalar
    multiplications fixed-base (issuer-key-specialized circuit)."""
    sv = limbs_value(cs, s)
    one = to_limbs(1)
    sinv, _ = nn_alloc_hinted(
        cs, _inv0(sv, Q),
        lambda idx: cs.hint_nn_inv_mul([(1, one)], [(1, s)], Q, idx, LIMB),
    )
    nn_enforce(cs, [(1, s, sinv)], [(-1, one)], Q)

    u1, u1_bits = nn_mul(cs, sinv, msghash, Q)
    u2, u2_bits = nn_mul(cs, sinv, r, Q)

    r1 = fixed_base_mul(cs, u1_bits, (P256.gx, P256.gy))
    r2 = fixed_base_mul(cs, u2_bits, pubkey)
    sx, _sy = add_unequal(cs, r1, r2)
    for i in range(K):
        cs.assert_equal(sx[i], r[i])
