"""Minimal CBOR encoder (RFC 8949 subset) for mDL MSO construction.

A copy of ``crescent_tpu/utils/cbor.py``.

Covers what the issuance path needs (credentials/mdl.py): unsigned/negative
ints, byte/text strings, arrays, maps (insertion order preserved — the mDL
circuits match on exact byte positions, so deterministic order matters),
tags, and bool/None.  Mirrors what isomdl's cbor emits for the structures
mdl-gen.rs builds (circuit_setup/mdl-tools/src/bin/mdl-gen.rs).
"""

from __future__ import annotations


class Tag:
    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value):
        self.tag = tag
        self.value = value


def _head(major: int, arg: int) -> bytes:
    mt = major << 5
    if arg < 24:
        return bytes([mt | arg])
    if arg < 0x100:
        return bytes([mt | 24, arg])
    if arg < 0x10000:
        return bytes([mt | 25]) + arg.to_bytes(2, "big")
    if arg < 0x100000000:
        return bytes([mt | 26]) + arg.to_bytes(4, "big")
    return bytes([mt | 27]) + arg.to_bytes(8, "big")


def bstr_head(n: int) -> bytes:
    """Explicit-length byte-string head (always 2-byte form 0x58 for n<256 —
    legal CBOR; used to keep IssuerSignedItem preimages a fixed length)."""
    assert n < 0x100
    return bytes([0x58, n])


def encode(obj) -> bytes:
    if isinstance(obj, bool):
        return b"\xf5" if obj else b"\xf4"
    if obj is None:
        return b"\xf6"
    if isinstance(obj, int):
        return _head(0, obj) if obj >= 0 else _head(1, -1 - obj)
    if isinstance(obj, bytes):
        return _head(2, len(obj)) + obj
    if isinstance(obj, str):
        b = obj.encode()
        return _head(3, len(b)) + b
    if isinstance(obj, (list, tuple)):
        return _head(4, len(obj)) + b"".join(encode(x) for x in obj)
    if isinstance(obj, dict):
        return _head(5, len(obj)) + b"".join(
            encode(k) + encode(v) for k, v in obj.items()
        )
    if isinstance(obj, Tag):
        return _head(6, obj.tag) + encode(obj.value)
    raise TypeError(f"cbor: unsupported type {type(obj)}")
