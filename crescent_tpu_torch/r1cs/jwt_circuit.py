"""The real rs256 JWT statement circuit (native builder).

Reference: circuit_setup/circuits/main_header_rs256.circom.template (+ the
per-claim blocks emitted by prepare_setup.py:50-205), match_claim.circom,
indicator.circom, utils/{jwt,base64}.circom.  Statement:

    SHA-256(padded header.payload) --PKCS#1v1.5--> RSA-65537 verify
    base64url-decode(header || payload)  ->  jwt_bytes (JSON)
    nesting levels -> per-claim MatchClaimName at level 1
    per-claim reveal/reveal_domain_only/reveal_digest/validate

Public IO layout matches StubJWTFrontend (digests, modulus limbs, claim
values) so IOLocations and the show/verify paths are unchanged.

Sizing: all gadgets are parametric in max_msg_bytes/max_json_bytes (the
config's max_cred_len), like the circom templates.
"""

from __future__ import annotations


from ..core.fields import BN254_FR as R
from .bigint import LIMB as RSA_LIMB
from .bigint import int_to_limbs, pkcs1v15_sha256_encode
from .builder import LC, ConstraintSystem, Var
from .sha256 import sha256_var_gadget

MAX_FIELD_BYTE_LEN = 31  # crescent_helper.py:13


# ---------------------------------------------------------------------------
# comparator / indicator gadgets (circomlib comparators.circom,
# indicator.circom)
# ---------------------------------------------------------------------------


def less_than(cs: ConstraintSystem, a, b, nbits: int) -> Var:
    """1 if a < b else 0; assumes a, b < 2^nbits (circomlib LessThan)."""
    diff = LC.of(a) + LC.of(1 << nbits) - LC.of(b)
    d = cs.add_const_mul(diff)
    bits = cs.decompose_bits(d, nbits + 1)
    out = cs.add_const_mul(LC.of(1) - LC.of(bits[nbits]))
    return out


def is_equal(cs: ConstraintSystem, a, b) -> Var:
    return cs.is_zero(LC.of(a) - LC.of(b))


def point_indicator(cs: ConstraintSystem, l, n: int) -> list:
    """One-hot vector with 1 at position l (indicator.circom:7-27)."""
    ind = cs.one_hot(l, n)
    total = LC()
    for j, v in enumerate(ind):
        total = total + LC.of(v)
        # ind[j] * (j - l) == 0
        cs.enforce(LC.of(v), LC.of(j) - LC.of(l), LC.of(0))
    cs.assert_equal(total, LC.of(1))
    return ind


def interval_indicator(cs: ConstraintSystem, l, r, n: int):
    """(indicator, start_indicator, last_indicator) for [l, r)
    (indicator.circom:30-57)."""
    start = point_indicator(cs, l, n)
    last = point_indicator(cs, LC.of(r) - LC.of(1), n)
    ind = []
    prev = LC()
    for i in range(n):
        cur = prev + LC.of(start[i]) - (LC.of(last[i - 1]) if i > 0 else LC())
        v = cs.add_const_mul(cur)
        ind.append(v)
        prev = LC.of(v)
    return ind, start, last


# ---------------------------------------------------------------------------
# base64url decoding (utils/base64.circom) + JWT framing (utils/jwt.circom)
# ---------------------------------------------------------------------------


def base64_lookup(cs: ConstraintSystem, c) -> Var:
    """base64url char -> 6-bit value; unmapped chars (incl. '=', 0x80 SHA
    padding, 0x00) decode to 0 (base64.circom:6-78)."""
    le_Z = less_than(cs, c, 91, 8)
    ge_A = less_than(cs, 64, c, 8)
    range_AZ = cs.mul(ge_A, le_Z)
    sum_AZ = cs.mul(range_AZ, LC.of(c) - LC.of(65))
    le_z = less_than(cs, c, 123, 8)
    ge_a = less_than(cs, 96, c, 8)
    range_az = cs.mul(ge_a, le_z)
    t = cs.mul(range_az, LC.of(c) - LC.of(71))
    sum_az = LC.of(sum_AZ) + LC.of(t)
    le_9 = less_than(cs, c, 58, 8)
    ge_0 = less_than(cs, 47, c, 8)
    range_09 = cs.mul(ge_0, le_9)
    t2 = cs.mul(range_09, LC.of(c) + LC.of(4))
    sum_09 = sum_az + LC.of(t2)
    eq_minus = is_equal(cs, c, 45)
    sum_minus = sum_09 + LC.of(eq_minus, 62)
    eq_under = is_equal(cs, c, 95)
    out = cs.add_const_mul(sum_minus + LC.of(eq_under, 63))
    return out


def base64_decode(cs: ConstraintSystem, chars: list, n_out: int) -> list:
    """4 chars -> 3 bytes repacking (base64.circom:80-126). chars length
    must be 4*ceil(n_out/3); returns n_out byte wires."""
    m = 4 * ((n_out + 2) // 3)
    assert len(chars) >= m
    out = []
    for i in range(0, m, 4):
        six = []
        for j in range(4):
            v = base64_lookup(cs, chars[i + j])
            six.append(cs.decompose_bits(v, 6))
        # byte0 = six0<<2 | six1>>4 ; byte1 = (six1&15)<<4 | six2>>2 ;
        # byte2 = (six2&3)<<6 | six3
        def pack(bits_lc_pairs):
            acc = LC()
            for bit, w in bits_lc_pairs:
                acc = acc + LC.of(bit, w)
            return cs.add_const_mul(acc)

        b0 = pack([(six[0][k], 1 << (k + 2)) for k in range(6)]
                  + [(six[1][4], 1), (six[1][5], 2)])
        b1 = pack([(six[1][k], 1 << (k + 4)) for k in range(4)]
                  + [(six[2][k + 2], 1 << k) for k in range(4)])
        b2 = pack([(six[2][0], 64), (six[2][1], 128)]
                  + [(six[3][k], 1 << k) for k in range(6)])
        for b in (b0, b1, b2):
            if len(out) < n_out:
                out.append(b)
    return out


def remove_value(cs: ConstraintSystem, arr: list, p) -> list:
    """Drop the element at position p, shift left, zero-pad
    (jwt.circom RemoveValue)."""
    n = len(arr)
    cs.decompose_bits(cs.add_const_mul(LC.of(p)), 15)
    out = []
    for i in range(n - 1):
        ge = less_than(cs, p, i + 1, 15)  # i >= p  <=>  p < i+1
        out.append(cs.select(ge, arr[i + 1], arr[i]))
    out.append(cs.add_const_mul(LC.of(0)))
    return out


def conditional_insert(cs: ConstraintSystem, arr: list, p, c: int, cond) -> list:
    """Insert constant char c at position p when cond (jwt.circom
    ConditionalInsert); p > 0 assumed."""
    n = len(arr)
    # _p = cond ? p : 32767
    _p = cs.select(cond, p, 32767)
    out = [arr[0]]
    for i in range(1, n):
        lt = less_than(cs, i, _p, 15)
        gt = less_than(cs, _p, i, 15)
        eq = cs.mul(LC.of(1) - LC.of(lt), LC.of(1) - LC.of(gt))
        t1 = cs.mul(lt, arr[i])
        t2 = cs.mul(gt, arr[i - 1])
        out.append(cs.add_const_mul(LC.of(t1) + LC.of(t2) + LC.of(eq, c)))
    return out


def jwt_b64_decode(cs: ConstraintSystem, message: list, period_idx, n_json: int) -> list:
    """Period removal + header '=' padding + base64 decode
    (jwt.circom JWTB64Decode)."""
    # padding bytes = f(period_idx mod 4): 3 -> 1, else len%4
    pbits = cs.decompose_bits(cs.add_const_mul(LC.of(period_idx)), 15)
    len_mod4 = cs.add_const_mul(LC.of(pbits[0]) + LC.of(pbits[1], 2))
    eq3 = is_equal(cs, len_mod4, 3)
    pad = cs.add_const_mul(LC.of(eq3) + cs_mul_lc(cs, LC.of(1) - LC.of(eq3), len_mod4))
    no_period = remove_value(cs, message, period_idx)
    c1 = cs.is_zero(pad)
    step1 = conditional_insert(cs, no_period, period_idx, 61, cs.add_const_mul(LC.of(1) - LC.of(c1)))
    gt1 = less_than(cs, 1, pad, 15)
    step2 = conditional_insert(cs, step1, period_idx, 61, gt1)
    return base64_decode(cs, step2, n_json)


def cs_mul_lc(cs: ConstraintSystem, a, b) -> LC:
    return LC.of(cs.mul(a, b))


# ---------------------------------------------------------------------------
# claim matching (match_claim.circom)
# ---------------------------------------------------------------------------


def nesting_levels(cs: ConstraintSystem, json_bytes: list) -> list:
    """object_nested_level prefix sums (main template :40-51); returns
    len+1 wires."""
    levels = [cs.add_const_mul(LC.of(0))]
    acc = LC()
    for b in json_bytes:
        is_l = is_equal(cs, b, 123)  # {
        is_r = is_equal(cs, b, 125)  # }
        acc = acc + LC.of(is_l) - LC.of(is_r)
        levels.append(cs.add_const_mul(acc))
    return levels


def match_claim_name(
    cs: ConstraintSystem, json_bytes: list, name: bytes, l, r, levels: list
):
    """MatchClaimName (match_claim.circom:61-104): returns (value_l, value_r)."""
    n = len(json_bytes)
    start = point_indicator(cs, l, n)
    for i, ch in enumerate(name):
        for j in range(i, n):
            # start[j-i] * (name[i] - json[j]) == 0
            cs.enforce(LC.of(start[j - i]), LC.of(ch) - LC.of(json_bytes[j]), LC.of(0))
    cs.decompose_bits(cs.add_const_mul(LC.of(l)), 16)
    cs.decompose_bits(cs.add_const_mul(LC.of(r)), 16)
    cs.assert_equal(less_than(cs, l, r, 16), LC.of(1))
    cs.assert_equal(less_than(cs, r, n + 1, 16), LC.of(1))
    for i in range(n):
        cs.enforce(LC.of(start[i]), LC.of(levels[i + 1]) - LC.of(1), LC.of(0))
    value_l = cs.add_const_mul(LC.of(l) + LC.of(len(name)))
    value_r = r
    return value_l, value_r


def exclude_special(cs: ConstraintSystem, interval: list, msg: list, char: int):
    for ind, b in zip(interval, msg):
        iz = cs.is_zero(LC.of(b) - LC.of(char))
        cs.enforce(LC.of(ind), LC.of(iz), LC.of(0))


def assert_end_number(cs: ConstraintSystem, last_ind: list, msg: list):
    """Character after a number must be ',' or '}' (match_claim.circom:537)."""
    for j in range(1, len(msg)):
        t = cs.mul(last_ind[j - 1], LC.of(msg[j]) - LC.of(44))
        cs.enforce(LC.of(t), LC.of(msg[j]) - LC.of(125), LC.of(0))


def validate_claim_value(cs: ConstraintSystem, json_bytes: list, l, r, typ: int):
    """ValidateClaimValue (match_claim.circom:107-157)."""
    n = len(json_bytes)
    ind, start, last = interval_indicator(cs, l, r, n)
    if typ == 1:  # number
        for ch in (44, 93, 125):
            exclude_special(cs, ind, json_bytes, ch)
        assert_end_number(cs, last, json_bytes)
    elif typ == 0:  # string
        inside = [
            cs.add_const_mul(LC.of(ind[i]) - LC.of(start[i]) - LC.of(last[i]))
            for i in range(n)
        ]
        exclude_special(cs, inside, json_bytes, 34)
        for i in range(n):
            cs.enforce(LC.of(last[i]), LC.of(json_bytes[i]) - LC.of(34), LC.of(0))
    else:
        raise NotImplementedError("claim types bool/null/array/object")
    return ind, start, last


def match_substring(
    cs: ConstraintSystem, msg: list, substr: list, range_ind: list, l, r,
    field_byte_len: int = MAX_FIELD_BYTE_LEN,
):
    """MatchSubstring (match_claim.circom:470-521)."""
    n = len(msg)
    ns = len(substr)
    substr_field_len = (ns + field_byte_len - 1) // field_byte_len
    w_ind, w_start, _w_last = interval_indicator(
        cs, l, cs.add_const_mul(LC.of(l) + LC.of(field_byte_len)), n
    )
    pow_win = []
    # pow256_window[0] = start[0] ? 1 : 0
    pow_win.append(cs.select(w_start[0], 1, 0))
    for i in range(1, n):
        prev = cs.select(w_start[i], 1, LC.of(pow_win[i - 1]).scale(256))
        pow_win.append(cs.mul(prev, w_ind[i]))
    pow256 = [1]
    for _ in range(field_byte_len - 1):
        pow256.append(pow256[-1] * 256 % R)
    for i in range(substr_field_len):
        matched = LC()
        for j in range(i * field_byte_len, n):
            p1 = cs.mul(range_ind[j], msg[j])
            p2 = cs.mul(p1, pow_win[j - i * field_byte_len])
            matched = matched + LC.of(p2)
        expected = LC()
        for j in range(field_byte_len):
            if i * field_byte_len + j < ns:
                expected = expected + LC.of(substr[i * field_byte_len + j], pow256[j])
        cs.assert_equal(matched, expected)


def reveal_claim_value_bytes(
    cs: ConstraintSystem, json_bytes: list, l, r, claim_byte_len: int, is_number: bool
):
    """RevealClaimValueBytes (match_claim.circom:160-199): witness-hint the
    value bytes, then constrain via MatchSubstring."""
    n = len(json_bytes)
    ind, start, last = interval_indicator(cs, l, r, n)
    value_len = cs.add_const_mul(LC.of(r) - LC.of(l))
    if is_number:
        assert_end_number(cs, last, json_bytes)
    lv, rv = cs.value(l), cs.value(r)
    value = []
    for i in range(claim_byte_len):
        v = cs.value(json_bytes[lv + i]) if lv + i < min(rv, n) else 0
        value.append(cs.alloc(v))
    match_substring(cs, json_bytes, value, ind, l, r)
    return value, value_len


def ascii_digits_to_field(cs: ConstraintSystem, digits: list) -> Var:
    """AsciiDigitsToField (match_claim.circom:11-57)."""
    n = len(digits)
    rev = list(reversed(digits))
    iz0 = cs.is_zero(rev[0])
    mask = [cs.add_const_mul(LC.of(1) - LC.of(iz0))]
    for i in range(1, n):
        izi = cs.is_zero(rev[i])
        # mask[i] = mask[i-1] + (1-mask[i-1])*(1-izi)
        t = cs.mul(LC.of(1) - LC.of(mask[i - 1]), LC.of(1) - LC.of(izi))
        mask.append(cs.add_const_mul(LC.of(mask[i - 1]) + LC.of(t)))
    p = [cs.add_const_mul(LC.of(1))]
    pow10 = []
    for i in range(n):
        pow10.append(cs.mul(p[i], mask[i]))
        tmp = cs.mul(mask[i], LC.of(p[i], 10))
        p.append(cs.add_const_mul(LC.of(tmp) + LC.of(p[i]) - cs_mul_lc(cs, mask[i], p[i])))
    acc = LC()
    first = cs.mul(pow10[0], rev[0])
    acc = acc + LC.of(first)
    for i in range(1, n):
        t = cs.mul(pow10[i], LC.of(rev[i]) - LC.of(48))
        acc = acc + LC.of(t)
    return cs.add_const_mul(acc)


def reveal_claim_value(
    cs: ConstraintSystem, json_bytes: list, l, r, claim_byte_len: int, is_number: bool
) -> Var:
    """RevealClaimValue (match_claim.circom:202-233) -> packed field elem."""
    value, _vl = reveal_claim_value_bytes(cs, json_bytes, l, r, claim_byte_len, is_number)
    if is_number:
        return ascii_digits_to_field(cs, value)
    acc = LC.of(value[0])
    w = 256
    for i in range(1, claim_byte_len):
        acc = acc + LC.of(value[i], w)
        w = w * 256 % R
    return cs.add_const_mul(acc)


def reveal_domain_only(
    cs: ConstraintSystem, json_bytes: list, l, r, claim_byte_len: int
) -> Var:
    """RevealDomainOnly (match_claim.circom:246-300): pack bytes after '@'."""
    raw, _vl = reveal_claim_value_bytes(cs, json_bytes, l, r, claim_byte_len, False)
    # strip quotes
    value = []
    for b in raw:
        q = is_equal(cs, b, 34)
        value.append(cs.mul(LC.of(1) - LC.of(q), b))
    n = claim_byte_len
    indicator = [cs.add_const_mul(LC.of(0))]
    pow256 = [cs.add_const_mul(LC.of(0))]
    eq_prev = None
    eqs = [None] * n
    for i in range(1, n):
        eq = is_equal(cs, value[i], 64)
        eqs[i] = eq
        indicator.append(cs.add_const_mul(LC.of(eq) + LC.of(indicator[i - 1])))
        cs.enforce(LC.of(1) - LC.of(indicator[i]), LC.of(indicator[i]), LC.of(0))
        if i == 1:
            pow256.append(cs.add_const_mul(LC.of(0)))  # is_eq[0] is constant 0
        else:
            t = cs.mul(LC.of(1) - LC.of(eqs[i - 1]), LC.of(pow256[i - 1], 256))
            pow256.append(cs.add_const_mul(LC.of(eqs[i - 1]) + LC.of(t)))
    acc = LC()
    for i in range(1, n - 1):
        t = cs.mul(value[i], pow256[i])
        acc = acc + LC.of(t)
    return cs.add_const_mul(acc)


def hash_reveal_claim_value(
    cs: ConstraintSystem, json_bytes: list, l, r, max_claim_byte_len: int,
    is_number: bool,
) -> Var:
    """HashRevealClaimValue (match_claim.circom:362-467): variable-length
    SHA-256 of the claim value, truncated to 248 bits."""
    value, _vl = reveal_claim_value_bytes(
        cs, json_bytes, l, r, max_claim_byte_len, is_number
    )
    n_blocks = (max_claim_byte_len * 8 + 1 + 64) // 512 + 1
    max_bytes_padded = n_blocks * 64
    data_len = cs.add_const_mul(LC.of(r) - LC.of(l))
    # padding_zero_bytes witness + checks (CalculatePadding):
    # pzb = next-multiple-of-64(d+9) - (d+9)  ==  (-(d+9)) mod 64
    pzb = cs.alloc_negmod_pow2(LC.of(data_len) + LC.of(9), 6)
    cs.decompose_bits(pzb, 6)
    le55 = less_than(cs, pzb, 56, 6)
    cs.assert_equal(le55, LC.of(1))
    padded_len = cs.add_const_mul(LC.of(data_len) + LC.of(pzb) + LC.of(9))
    plbits = cs.decompose_bits(padded_len, 32)
    for i in range(6):
        cs.assert_equal(plbits[i], LC.of(0))  # mod 64 == 0
    pad_ind, pad_start, _pl = interval_indicator(cs, data_len, padded_len, max_bytes_padded)
    padded = []
    for i in range(max_bytes_padded):
        base = LC.of(value[i]) if i < max_claim_byte_len else LC()
        # zero outside [0, data_len): value bytes are already 0 past r-l
        b = base + LC.of(pad_start[i], 128) - LC.of(cs.mul(pad_start[i], base)) if i < max_claim_byte_len else LC.of(pad_start[i], 128)
        padded.append(cs.add_const_mul(b))
    # place the 8 big-endian length bytes at padded_len-8..padded_len
    len_bits = cs.decompose_bits(cs.add_const_mul(LC.of(data_len, 8)), 64)
    len_bytes = []
    for i in range(8):
        acc = LC()
        for j in range(8):
            acc = acc + LC.of(len_bits[8 * i + j], 1 << j)
        len_bytes.append(cs.add_const_mul(acc))
    cur = padded
    for i in range(8):
        pi = point_indicator(
            cs, cs.add_const_mul(LC.of(padded_len) - LC.of(8) + LC.of(i)), max_bytes_padded
        )
        nxt = []
        for j in range(max_bytes_padded):
            t = cs.mul(pi[j], len_bytes[7 - i])
            nxt.append(cs.add_const_mul(LC.of(t) + LC.of(cur[j])))
        cur = nxt
    nb = cs.alloc_shr(padded_len, 6)
    cs.assert_equal(LC.of(nb, 64), LC.of(padded_len))
    digest_bytes = sha256_var_gadget(cs, cur, nb)
    # truncate to 248 bits: circom packs sha.out[0..248) where out[0] is the
    # MSB of the digest; Bits2Num makes out[0] the LSB of the field element
    bits = []
    for byte_bits in digest_bytes:
        bits.extend(reversed(byte_bits))  # MSB-first stream
    acc = LC()
    for k in range(248):
        acc = acc + LC.of(bits[k], 1 << k)
    return cs.add_const_mul(acc)


# ---------------------------------------------------------------------------
# bits_to_num digest packing helper used by the top-level circuit
# ---------------------------------------------------------------------------


def digest_bytes_to_pkcs1_limbs(
    cs: ConstraintSystem, digest_bytes: list, key_bits: int,
    limb_bits: int = RSA_LIMB,
) -> list:
    """EM = PKCS#1 v1.5 padding || digest as limb LCs; only the low
    32 bytes vary (the digest), the rest is constant."""
    em_const = pkcs1v15_sha256_encode(b"\x00" * 32, key_bits)
    n_limbs = -(-key_bits // limb_bits)
    const_limbs = int_to_limbs(em_const, n_limbs, limb_bits)
    accs = [LC.of(const_limbs[li]) for li in range(n_limbs)]
    # digest byte i (big-endian) occupies bits [8*(31-i), 8*(31-i)+8); since
    # limb_bits need not divide 8 (121 doesn't), place each BIT in the limb
    # containing its global position
    for i, byte in enumerate(digest_bytes):
        assert isinstance(byte, list), "digest bytes must be bit wires"
        base = 8 * (31 - i)
        for k, bit in enumerate(byte):
            pos = base + k
            li = pos // limb_bits
            accs[li] = accs[li] + LC.of(bit, 1 << (pos % limb_bits))
    return [cs.add_const_mul(a) for a in accs]
