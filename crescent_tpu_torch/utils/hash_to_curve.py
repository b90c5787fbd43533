"""Variable-time hash-to-curve (public inputs only) matching utils.rs:45.

The reference hunts-and-pecks: SHA-512("{input}||{counter}") interpreted via
ark `G1Affine::from_random_bytes` until a valid point appears.  We mirror
that: take the first 32 bytes, strip the two ark SWFlags bits from the top
byte, reject if >= p or flags invalid, otherwise lift x with the flagged y
sign.  Used to derive Pedersen commitment bases (dlog.rs:197).
"""

from __future__ import annotations

import hashlib

from ..core.curves import AffinePoint, BN254_G1, Curve
from .serialize import INFINITY_FLAG, NEGATIVE_FLAG


def _from_random_bytes(curve: Curve, digest: bytes) -> AffinePoint | None:
    raw = bytearray(digest[:32])
    flags = raw[31] & 0xC0
    raw[31] &= 0x3F
    x = int.from_bytes(raw, "little")
    if x >= curve.p:
        return None
    if flags == (INFINITY_FLAG | NEGATIVE_FLAG):
        return None
    if flags & INFINITY_FLAG:
        return None  # identity is useless as a base; reference also skips via x==0 check
    try:
        pt = curve.lift_x(x)
    except ValueError:
        return None
    # pick sign: flag bit7 set -> the "negative" root (y > p - y)
    y = pt[1]
    y_neg = y > curve.p - y
    want_neg = bool(flags & NEGATIVE_FLAG)
    if y_neg != want_neg:
        pt = (pt[0], curve.p - pt[1])
    return pt


def hash_to_curve_vartime(input_str: str, curve: Curve = BN254_G1) -> AffinePoint:
    counter = 0
    while True:
        digest = hashlib.sha512(f"{input_str}||{counter}".encode()).digest()
        pt = _from_random_bytes(curve, digest)
        if pt is not None:
            return pt
        counter += 1


def derive_pedersen_bases(curve: Curve = BN254_G1) -> list:
    """Pedersen bases g1, g2 (dlog.rs:197)."""
    return [
        hash_to_curve_vartime(f"Pedersen commitment base {i}", curve) for i in (1, 2)
    ]


# ---------------------------------------------------------------------------
# RFC 9380 expand_message_xmd + simplified-SWU hash-to-curve for T-256,
# byte-compatible with halo2curves (forks/halo2curves/src/hash_to_curve.rs
# and src/t256/curve.rs:76-96: suite T256_XMD:SHA-256_SSWU_RO_, L=48,
# SSWU_Z = a+2, identity isogeny).  Used by Spartan's MultiCommitGens
# (forks/Spartan-t256/src/commitments.rs:19-41).
# ---------------------------------------------------------------------------


def expand_message_xmd(
    msg: bytes, dst: bytes, out_len: int, hash_name: str = "sha256"
) -> bytes:
    """expand_message_xmd per RFC 9380 §5.3.1 (SHA-256: block 64, out 32)."""
    assert len(dst) < 256, "long DST not supported (matches halo2curves)"
    h = hashlib.new(hash_name)
    block_size = h.block_size
    output_size = h.digest_size
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.new(
        hash_name,
        bytes(block_size)
        + msg
        + bytes([(out_len >> 8) & 0xFF, out_len & 0xFF, 0])
        + dst_prime,
    ).digest()
    ell = (out_len + output_size - 1) // output_size
    b_i = hashlib.new(hash_name, b0 + bytes([1]) + dst_prime).digest()
    out = bytearray()
    for i in range(1, ell):
        out += b_i
        b_i = hashlib.new(
            hash_name,
            bytes(x ^ y for x, y in zip(b0, b_i)) + bytes([1 + i]) + dst_prime,
        ).digest()
    out += b_i
    return bytes(out[:out_len])


def _sswu_map_to_curve(u: int, curve: Curve, z: int) -> tuple:
    """Simplified SWU (RFC 9380 §6.6.2), constant-free host version.

    Returns an affine point on `curve` (a, b != 0 required — true for T-256).
    Mirrors halo2curves sswu_map_to_curve (hash_to_curve.rs:182-286)."""
    F = curve.field
    A, B = curve.a, curve.b
    tv1 = F.mul(z, F.mul(u, u))
    tv2 = (F.mul(tv1, tv1) + tv1) % curve.p
    tv3 = F.mul(B, (tv2 + 1) % curve.p)
    tv4 = F.mul(A, z if tv2 == 0 else F.neg(tv2))
    num = (F.mul(F.mul(tv3, tv3), tv3) + F.mul(F.mul(A, F.mul(tv4, tv4)), tv3)
           + F.mul(B, F.mul(F.mul(tv4, tv4), tv4))) % curve.p
    div = F.mul(F.mul(tv4, tv4), tv4)
    x = F.mul(tv1, tv3)
    # sqrt_ratio(num, div): num/div square -> (True, sqrt(num/div)),
    # else (False, sqrt(z*num/div))
    a_ratio = F.mul(num, F.inv(div) if div != 0 else 0)
    sqrt_a = F.sqrt(a_ratio)
    if sqrt_a is not None:
        is_gx1_square = num == 0 or div != 0
        y1 = sqrt_a
    else:
        is_gx1_square = False
        y1 = F.sqrt(F.mul(a_ratio, z))
        assert y1 is not None
    y = F.mul(F.mul(tv1, u), y1)
    if is_gx1_square:
        x, y = tv3, y1
    # select y sign: sgn0(u) == sgn0(y)
    if (u & 1) != (y & 1):
        y = F.neg(y)
    # homogeneous (x : y*tv4 : tv4) -> affine (x/tv4, y)
    return (F.mul(x, F.inv(tv4)), y)


T256_H2C_SUITE = b"T256_XMD:SHA-256_SSWU_RO_"


def t256_hash_to_curve(msg: bytes, domain_prefix: bytes = b"domain_prefix") -> AffinePoint:
    """halo2curves `T256::hash_to_curve(domain_prefix)(msg)`.

    DST = domain_prefix || suite name; two 48-byte uniform field elements
    (big-endian after halo2curves' reverse + from_uniform_bytes dance);
    point = map(u0) + map(u1)."""
    from ..core.curves import T256

    z = (T256.a + 2) % T256.p  # t256/curve.rs:82-87 SSWU_Z
    out = expand_message_xmd(msg, domain_prefix + T256_H2C_SUITE, 96)
    u0 = int.from_bytes(out[:48], "big") % T256.p
    u1 = int.from_bytes(out[48:], "big") % T256.p
    return T256.add(_sswu_map_to_curve(u0, T256, z), _sswu_map_to_curve(u1, T256, z))
