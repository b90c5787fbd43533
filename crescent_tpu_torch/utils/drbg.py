"""Deterministic random generator shared with the in-browser JS prover.

A copy of ``crescent_tpu/utils/drbg.py``.

The reference's wasm show prover uses the platform RNG; for cross-language
golden vectors (sample/client/crypto/*.js vs client.py) both sides need the
SAME deterministic stream.  Spec (mirrored in sample/client/crypto/drbg.js):

    block(i)    = SHA-256(seed || u32_le(i))
    stream      = block(0) || block(1) || ...
    randrange(n)= next ceil(bits(n)/8) + 8 bytes, big-endian int, mod n

The +8 bytes make the modulo bias < 2^-64 — fine for test vectors AND for
the blinding factors the show protocol needs (uniformity, not secrecy,
derives from the seed; production callers pass no seed and get the system
RNG instead).
"""

from __future__ import annotations

import hashlib


class HashDRBG:
    """random.Random-compatible subset: randrange(stop) / randrange(a, b)."""

    def __init__(self, seed: bytes | str):
        if isinstance(seed, str):
            seed = seed.encode()
        self.seed = bytes(seed)
        self.ctr = 0
        self.buf = b""

    def _take(self, n: int) -> bytes:
        while len(self.buf) < n:
            self.buf += hashlib.sha256(
                self.seed + self.ctr.to_bytes(4, "little")
            ).digest()
            self.ctr += 1
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def randrange(self, a: int, b: int | None = None) -> int:
        if b is None:
            lo, hi = 0, a
        else:
            lo, hi = a, b
        span = hi - lo
        if span <= 0:
            raise ValueError("empty range")
        nbytes = (span.bit_length() + 7) // 8 + 8
        return lo + int.from_bytes(self._take(nbytes), "big") % span

    def getrandbits(self, k: int) -> int:
        return int.from_bytes(self._take((k + 7) // 8), "big") >> (
            (8 - k % 8) % 8
        )

    def random(self) -> float:
        return self.getrandbits(53) / (1 << 53)
