"""Big-integer R1CS gadgets: limbed modular multiplication and RSA-65537.

Native-frontend replacement for the reference's circom bigint/RSA stack
(circuit_setup/circuits/utils/{bigint,fp,rsa}.circom, 121-bit limbs).  Our
limbing is 120 bits (divides common key sizes evenly and leaves slack for
carry accumulation in the 254-bit field).

Core identity per modular multiply a*b = q*n + r:
  prod_k = sum_{i+j=k} a_i*b_j  and  rhs_k = sum_{i+j=k} q_i*n_j + r_k
  are equated limb-wise via a carry chain: t_k = prod_k - rhs_k + carry_k,
  with each carry range-checked; all inputs/outputs range-checked to 120
  bits.  RSA-65537 verify = 16 squarings + 1 multiply, with the final
  result constrained to the PKCS#1 v1.5 encoding of the SHA-256 digest.
"""

from __future__ import annotations

from ..core.fields import BN254_FR as R
from .builder import LC, ConstraintSystem

LIMB = 120


def int_to_limbs(x: int, n_limbs: int, limb_bits: int = LIMB) -> list[int]:
    mask = (1 << limb_bits) - 1
    return [(x >> (limb_bits * i)) & mask for i in range(n_limbs)]


def limbs_to_int_vals(cs: ConstraintSystem, limbs: list, limb_bits: int = LIMB) -> int:
    return sum(cs.value(l) << (limb_bits * i) for i, l in enumerate(limbs))


def alloc_bigint(
    cs: ConstraintSystem, value: int, n_limbs: int, range_check: bool = True,
    limb_bits: int = LIMB,
) -> list:
    out = []
    for v in int_to_limbs(value, n_limbs, limb_bits):
        var = cs.alloc(v)
        if range_check:
            cs.decompose_bits(var, limb_bits)
        out.append(var)
    assert value < (1 << (limb_bits * n_limbs))
    return out


def mul_mod_gadget(
    cs: ConstraintSystem, a: list, b: list, n: list, n_int: int,
    limb_bits: int = LIMB,
) -> list:
    """r = a*b mod n with witness quotient; all operands n_limbs long."""
    k = len(a)
    a_int = limbs_to_int_vals(cs, a, limb_bits)
    b_int = limbs_to_int_vals(cs, b, limb_bits)
    q_int, r_int = divmod(a_int * b_int, n_int)
    # q/r are genuine witness hints: allocate first, record the divmod hint
    # (so replay computes them before their range checks), then range-check
    q = alloc_bigint(cs, q_int, k, range_check=False, limb_bits=limb_bits)
    r = alloc_bigint(cs, r_int, k, range_check=False, limb_bits=limb_bits)
    cs.hint_divmod(a, b, n_int, [v.idx for v in q], [v.idx for v in r], limb_bits)
    for v in q:
        cs.decompose_bits(v, limb_bits)
    for v in r:
        cs.decompose_bits(v, limb_bits)

    # cross-product limbs (one mult constraint each)
    prod = [LC() for _ in range(2 * k - 1)]
    for i in range(k):
        for j in range(k):
            pij = cs.mul(a[i], b[j])
            prod[i + j] = prod[i + j] + LC.of(pij)
    rhs = [LC() for _ in range(2 * k - 1)]
    for i in range(k):
        for j in range(k):
            qn = cs.mul(q[i], n[j])
            rhs[i + j] = rhs[i + j] + LC.of(qn)
    for i in range(k):
        rhs[i] = rhs[i] + LC.of(r[i])

    # carry chain: (prod_k - rhs_k + carry_in) == carry_out * 2^120,
    # with carry_out range-limited.  Bound: |sum of k products of 120-bit
    # limbs| < k * 2^240; carries stay below ~2^(121 + log2(k)).
    carry_bits = limb_bits + 2 + (k - 1).bit_length()
    carry_lc = LC.of(0)
    carry_val = 0
    shift = 1 << limb_bits
    offset = 1 << (carry_bits - 1)  # carries can be negative; bias them
    for idx in range(2 * k - 1):
        diff_val = cs.value(prod[idx]) - cs.value(rhs[idx]) + carry_val
        # diff must be divisible by 2^120; next carry = diff / 2^120
        assert diff_val % shift == 0, "modmul witness inconsistency"
        next_carry = diff_val // shift
        diff_lc = prod[idx] - rhs[idx] + carry_lc
        nc = cs.alloc_sshr_bias(diff_lc, limb_bits, offset)
        assert cs.value(nc) == (next_carry + offset) % R
        cs.decompose_bits(nc, carry_bits)  # range check biased carry
        # constraint: prod - rhs + carry == (nc - offset) * 2^120
        cs.enforce(
            diff_lc - LC.of(nc, shift) + LC.of(offset * shift),
            LC.of(1),
            LC.of(0),
        )
        carry_lc = LC.of(nc) - LC.of(offset)
        carry_val = next_carry
    # final carry must be zero
    cs.enforce(carry_lc, LC.of(1), LC.of(0))
    return r


def rsa65537_verify_gadget(
    cs: ConstraintSystem, sig: list, modulus: list, expected: list, n_int: int,
    limb_bits: int = LIMB,
) -> None:
    """Constrain sig^65537 mod n == expected (limb vectors, default 120-bit;
    the JWT circuit passes 121 to match circom's CIRCOM_RS256_LIMB_BITS).

    16 modular squarings + 1 modular multiply (65537 = 2^16 + 1), then
    limb-wise equality with `expected` (the PKCS#1 v1.5 encoded digest)."""
    acc = sig
    for _ in range(16):
        acc = mul_mod_gadget(cs, acc, acc, modulus, n_int, limb_bits=limb_bits)
    acc = mul_mod_gadget(cs, acc, sig, modulus, n_int, limb_bits=limb_bits)
    for x, e in zip(acc, expected):
        cs.assert_equal(x, e)


def pkcs1v15_sha256_encode(digest: bytes, key_bits: int) -> int:
    """EMSA-PKCS1-v1_5 for SHA-256: 0x00 01 FF..FF 00 || DigestInfo || digest."""
    digest_info = bytes.fromhex("3031300d060960864801650304020105000420")
    em_len = key_bits // 8
    ps_len = em_len - 3 - len(digest_info) - len(digest)
    em = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + digest_info + digest
    return int.from_bytes(em, "big")
