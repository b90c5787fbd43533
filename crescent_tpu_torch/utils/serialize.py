"""ark-serialize-compatible canonical encodings (host).

The reference stores/ships every artifact with arkworks CanonicalSerialize
(creds/src/utils.rs:140-197: file + b64url wrappers), and hashes the
*compressed* forms into merlin transcripts (utils.rs:29).  Byte layouts
implemented here (ark-serialize / ark-ec 0.4 semantics):

  * Fr/Fq: 32-byte little-endian canonical integer.
  * Fq2: c0 || c1.
  * G1/G2 affine compressed: x with flag bits in the top byte —
      bit7 = y is "negative" (y > -y), bit6 = point at infinity.
  * G1/G2 affine uncompressed: x || y, infinity flag on y's top byte.
  * Projective points serialize as affine (ark normalizes first).
  * usize/u64: 8-byte LE;  Vec<T>: u64 length then elements.

NOTE: validated structurally + round-trip here; cross-validation against the
Rust CLI requires a cargo toolchain (absent in this image) and is tracked as
a parity TODO (SURVEY.md §7 hard part (a)).
"""

from __future__ import annotations

import base64

from ..core.curves import AffinePoint, BN254_G1, G2Point
from ..core.fields import BN254_FQ, BN254_FR, Fq2

INFINITY_FLAG = 1 << 6
NEGATIVE_FLAG = 1 << 7


def ser_fr(x: int) -> bytes:
    return int(x % BN254_FR).to_bytes(32, "little")


def deser_fr(b: bytes) -> int:
    v = int.from_bytes(b[:32], "little")
    assert v < BN254_FR
    return v


def ser_fq(x: int) -> bytes:
    return int(x % BN254_FQ).to_bytes(32, "little")


def ser_fq2(x: Fq2) -> bytes:
    return ser_fq(x.c0) + ser_fq(x.c1)


def _fq_is_negative(y: int) -> bool:
    """ark SWFlags convention: negative iff y > -y (i.e. y > (p-1)/2)."""
    return y > BN254_FQ - y


def _fq2_is_negative(y: Fq2) -> bool:
    """ark QuadExtField ordering: compare c1 first, then c0."""
    ny = -y
    if y.c1 != ny.c1:
        return y.c1 > ny.c1
    return y.c0 > ny.c0


def ser_g1_compressed(p: AffinePoint) -> bytes:
    if p is None:
        out = bytearray(32)
        out[31] |= INFINITY_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(ser_fq(x))
    if _fq_is_negative(y):
        out[31] |= NEGATIVE_FLAG
    return bytes(out)


def deser_g1_compressed(b: bytes) -> AffinePoint:
    raw = bytearray(b[:32])
    flags = raw[31] & 0xC0
    raw[31] &= 0x3F
    if flags & INFINITY_FLAG:
        return None
    x = int.from_bytes(raw, "little")
    pt = BN254_G1.lift_x(x, 0)
    neg = _fq_is_negative(pt[1])
    want_neg = bool(flags & NEGATIVE_FLAG)
    if neg != want_neg:
        pt = (pt[0], BN254_FQ - pt[1])
    return pt


def ser_g1_uncompressed(p: AffinePoint) -> bytes:
    if p is None:
        out = bytearray(64)
        out[63] |= INFINITY_FLAG
        return bytes(out)
    return ser_fq(p[0]) + ser_fq(p[1])


def deser_g1_uncompressed(b: bytes) -> AffinePoint:
    raw = bytearray(b[:64])
    flags = raw[63] & 0xC0
    raw[63] &= 0x3F
    if flags & INFINITY_FLAG:
        return None
    x = int.from_bytes(raw[:32], "little")
    y = int.from_bytes(raw[32:64], "little")
    assert BN254_G1.is_on_curve((x, y)), "point not on curve"
    return (x, y)


def ser_g2_compressed(p: G2Point) -> bytes:
    if p is None:
        out = bytearray(64)
        out[63] |= INFINITY_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(ser_fq2(x))
    if _fq2_is_negative(y):
        out[63] |= NEGATIVE_FLAG
    return bytes(out)


def ser_g2_uncompressed(p: G2Point) -> bytes:
    if p is None:
        out = bytearray(128)
        out[127] |= INFINITY_FLAG
        return bytes(out)
    return ser_fq2(p[0]) + ser_fq2(p[1])


def deser_g2_uncompressed(b: bytes) -> G2Point:
    from ..core.curves import BN254G2

    raw = bytearray(b[:128])
    flags = raw[127] & 0xC0
    raw[127] &= 0x3F
    if flags & INFINITY_FLAG:
        return None
    x = Fq2(int.from_bytes(raw[0:32], "little"), int.from_bytes(raw[32:64], "little"))
    y = Fq2(int.from_bytes(raw[64:96], "little"), int.from_bytes(raw[96:128], "little"))
    pt = (x, y)
    assert BN254G2.is_on_curve(pt), "G2 point not on curve"
    return pt


# ---------------------------------------------------------------------------
# halo2curves T-256 compressed points (33 bytes, CompressedFlagConfig::Extra:
# byte 0 = flag byte with bit7 = sign (y odd), bit6 = identity; bytes 1..33 =
# x little-endian).  Spartan's CompressedGroup (forks/Spartan-t256/src/
# group.rs:17) and every transcript append_point use this layout.
# ---------------------------------------------------------------------------

_T256_SIGN_FLAG = 0x80
_T256_IDENT_FLAG = 0x40


def ser_t256_compressed(p: AffinePoint) -> bytes:
    if p is None:
        return bytes([_T256_IDENT_FLAG]) + bytes(32)
    flag = _T256_SIGN_FLAG if (p[1] & 1) else 0
    return bytes([flag]) + int(p[0]).to_bytes(32, "little")


def deser_t256_compressed(b: bytes) -> AffinePoint:
    from ..core.curves import T256

    assert len(b) == 33
    flag, xb = b[0], b[1:]
    if flag & _T256_IDENT_FLAG:
        if any(xb) or (flag & ~(_T256_IDENT_FLAG | _T256_SIGN_FLAG)):
            raise ValueError("invalid identity encoding")
        return None
    x = int.from_bytes(xb, "little")
    if x >= T256.p:
        raise ValueError("x out of range")
    pt = T256.lift_x(x)
    want_odd = bool(flag & _T256_SIGN_FLAG)
    if bool(pt[1] & 1) != want_odd:
        pt = (pt[0], T256.p - pt[1])
    return pt


def ser_u64(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def ser_vec(items, ser_item) -> bytes:
    out = ser_u64(len(items))
    for it in items:
        out += ser_item(it)
    return out


# -- b64url wrapping for HTTP transport (utils.rs:154-177) ------------------

def to_b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode("ascii")


def from_b64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)
