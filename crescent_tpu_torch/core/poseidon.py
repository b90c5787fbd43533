"""Poseidon permutation + SAFE sponge over a prime field, neptune-parity.

A copy of ``crescent_tpu/core/poseidon.py`` (host only).

The device-binding proof hashes the split device public key
h_Q = Poseidon(q0, q1, z) over T-256's scalar field (= P-256's base field),
one hash per proof — host-side is the right place (SURVEY.md §2b).

Byte-parity targets (the reference's neptune fork,
ecdsa-pop/neptune):

* round constants from the Grain LFSR with init bits FIELD=1, SBOX=1,
  field_size = modulus bit length, self-shrinking output filter, big-endian
  bit packing, resample-if->=p (src/round_constants.rs:29-118; KAT'd in
  tests/test_poseidon.py against the checked-in neptune parameter file for
  (1,1,255,9,8,57));
* round numbers per width from neptune's calc_round_numbers port — values
  pinned from its parameters/round_numbers-*-128-1-1.txt files;
* MDS = symmetric Cauchy matrix 1/(x_i + y_j), x_i = i, y_j = t + j
  (src/mds.rs:138-170);
* permutation = the 'Correct' evaluation order (src/poseidon_alt.rs:14-86):
  full round = (x + rc)^5 each, then MDS; partial round = rc added to ALL
  elements, S-box on element 0 only, then MDS.  neptune's optimized-static
  path is algebraically identical (asserted by its own tests);
* sponge = the SAFE sponge API (src/sponge/api.rs): capacity element
  initialized to the 128-bit IO-pattern tag, absorb ADDS into rate
  elements (positions 1..t-1), permute when the rate fills and once more
  on the absorb->squeeze turn, squeeze reads element 1.  This is what
  ecdsa-pop's compute_hQ drives with IOPattern [Absorb(3), Squeeze(1)]
  (ecdsa-pop/src/lib.rs:308-320, src/poseidon.rs:71-100).
"""

from __future__ import annotations

import functools

# (R_F, R_P) per width t at 128-bit security over ~256-bit prime fields —
# neptune parameters/round_numbers-{256*t}-{t}-128-1-1.txt outputs.
ROUND_NUMBERS = {2: (8, 55), 3: (8, 55), 4: (8, 56), 5: (8, 56),
                 6: (8, 56), 7: (8, 56), 8: (8, 57), 9: (8, 57)}


class GrainLFSR:
    """Poseidon Grain-LFSR in self-shrinking mode (round_constants.rs)."""

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int):
        state = []

        def add_bits(value, n):
            for i in range(n - 1, -1, -1):
                state.append((value >> i) & 1)

        add_bits(1, 2)            # field = GF(p)
        add_bits(1, 4)            # sbox = x^5 (neptune lib.rs:173 SBOX=1)
        add_bits(field_bits, 12)  # field size in bits
        add_bits(t, 12)
        add_bits(r_f, 10)
        add_bits(r_p, 10)
        add_bits((1 << 30) - 1, 30)
        self.state = state
        assert len(state) == 80
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_filtered_bit(self) -> int:
        # evaluate bits in pairs: first bit 1 -> output second, else discard
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def next_field_element(self, p: int, field_bits: int) -> int:
        """Big-endian packing of field_bits filtered bits; resample if >= p.

        Matches neptune get_next_bytes + repr.reverse(): the first
        (field_bits % 8) bits land in the most-significant partial byte."""
        while True:
            v = 0
            for _ in range(field_bits):
                v = (v << 1) | self.next_filtered_bit()
            if v < p:
                return v


def round_numbers(t: int) -> tuple[int, int]:
    return ROUND_NUMBERS[t]


class Poseidon:
    """Poseidon permutation for width t with neptune-parity constants."""

    def __init__(self, p: int, t: int, r_f: int | None = None, r_p: int | None = None):
        self.p = p
        self.t = t
        self.field_bits = p.bit_length()
        rf, rp = round_numbers(t)
        self.r_f = r_f or rf
        self.r_p = r_p or rp
        # NOTE: x^5 is only a bijection when gcd(5, p-1) == 1; over P-256's
        # base field gcd == 5, yet the reference's neptune fork applies the
        # quintic S-box there regardless (ecdsa-pop/src/lib.rs:36).  We match
        # that behavior — the sponge stays computable either way.

        g = GrainLFSR(self.field_bits, t, self.r_f, self.r_p)
        n_consts = t * (self.r_f + self.r_p)
        self.round_constants = [
            g.next_field_element(p, self.field_bits) for _ in range(n_consts)
        ]
        # MDS: symmetric Cauchy matrix M[i][j] = 1/(x_i + y_j), x_i=i, y_j=t+j
        self.mds = [
            [pow((i + (t + j)) % p, -1, p) for j in range(t)] for i in range(t)
        ]

    def _sbox(self, x: int) -> int:
        return pow(x, 5, self.p)

    def permutation(self, state: list[int]) -> list[int]:
        p, t = self.p, self.t
        assert len(state) == t
        state = [x % p for x in state]
        rc = iter(self.round_constants)
        half = self.r_f // 2

        def full_round(state):
            state = [self._sbox((x + next(rc)) % p) for x in state]
            return self._mix(state)

        def partial_round(state):
            state = [(x + next(rc)) % p for x in state]
            state = [self._sbox(state[0])] + state[1:]
            return self._mix(state)

        for _ in range(half):
            state = full_round(state)
        for _ in range(self.r_p):
            state = partial_round(state)
        for _ in range(half):
            state = full_round(state)
        return state

    def _mix(self, state: list[int]) -> list[int]:
        p = self.p
        return [
            sum(self.mds[i][j] * state[j] for j in range(self.t)) % p
            for i in range(self.t)
        ]


# ---------------------------------------------------------------------------
# SAFE sponge API (neptune sponge/api.rs)
# ---------------------------------------------------------------------------

_U128 = (1 << 128) - 1
_HASHER_BASE = (0 - 159) & _U128


def io_pattern_value(ops: list[tuple[str, int]], domain_separator: int = 0) -> int:
    """128-bit IO-pattern tag: ops are ('absorb'|'squeeze', count); runs of
    the same op coalesce; absorb encodes as count + 2^31, squeeze as count;
    tag = sum_i x^i * v_i mod 2^128 with x = 2^128 - 159."""
    combined: list[tuple[str, int]] = []
    for kind, cnt in ops:
        if combined and combined[-1][0] == kind:
            combined[-1] = (kind, combined[-1][1] + cnt)
        else:
            combined.append((kind, cnt))
    x_i = 1
    state = 0

    def update(a):
        nonlocal x_i, state
        x_i = (x_i * _HASHER_BASE) & _U128
        state = (state + x_i * a) & _U128

    for kind, cnt in combined:
        if cnt == 0:
            continue
        update(cnt + (1 << 31) if kind == "absorb" else cnt)
    update(domain_separator)
    return state


def safe_hash(pos: Poseidon, inputs: list[int]) -> int:
    """SAFE-sponge hash with IOPattern [Absorb(len(inputs)), Squeeze(1)]
    (ecdsa-pop Poseidon::squeeze_field_element semantics)."""
    p, t = pos.p, pos.t
    rate = t - 1
    tag = io_pattern_value([("absorb", len(inputs)), ("squeeze", 1)])
    state = [tag % p] + [0] * rate
    apos = 0
    for e in inputs:
        if apos == rate:
            state = pos.permutation(state)
            apos = 0
        state[1 + apos] = (state[1 + apos] + e) % p
        apos += 1
    # absorb sets squeeze_pos = rate -> first squeeze permutes (Sponge
    # hash-type padding is a no-op)
    state = pos.permutation(state)
    return state[1]


@functools.lru_cache(maxsize=None)
def get_poseidon(p: int, t: int) -> Poseidon:
    return Poseidon(p, t)
