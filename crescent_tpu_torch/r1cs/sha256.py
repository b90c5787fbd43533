"""SHA-256 compression as R1CS gadgets (native statement frontend).

Replaces circomlib's sha256 templates (used by the JWT circuit
circuit_setup/circuits/utils/sha256general.circom) in our builder.  Words
are lists of 32 bit-wires (LSB first); rotations/shifts are free reindexing,
Ch/Maj cost 1-2 constraints per bit, and every modular addition is one
35-bit decomposition.  ~27k constraints per 512-bit block, matching the
standard R1CS costing.

Bit-exactness is tested against hashlib over multi-block messages
(tests/test_sha256_gadget.py).
"""

from __future__ import annotations

from .builder import LC, ConstraintSystem, Var

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

# A "word" is a list of 32 entries, LSB first; each entry is a Var or the
# int constant 0/1.


def word_const(cs: ConstraintSystem, value: int) -> list:
    return [(value >> i) & 1 for i in range(32)]


def word_value(cs: ConstraintSystem, w: list) -> int:
    return sum((cs.value(b) if isinstance(b, Var) else b) << i for i, b in enumerate(w))


def word_lc(w: list) -> LC:
    acc = LC()
    for i, b in enumerate(w):
        acc = acc + LC.of(b, 1 << i)
    return acc


def rotr(w: list, n: int) -> list:
    return [w[(i + n) % 32] for i in range(32)]


def shr(w: list, n: int) -> list:
    return [w[i + n] if i + n < 32 else 0 for i in range(32)]


def _bit_value(cs, b) -> int:
    return cs.value(b) if isinstance(b, Var) else b


def xor_bits(cs: ConstraintSystem, a, b):
    """XOR of bit wires/constants, folding constants."""
    if not isinstance(a, Var) and not isinstance(b, Var):
        return (a ^ b) & 1
    if not isinstance(a, Var):
        a, b = b, a
    if not isinstance(b, Var):
        if b == 0:
            return a
        # 1 - a: materialize (rare; SHA-256 never hits it)
        out = cs.alloc(1 - cs.value(a))
        cs.enforce(LC.of(1) - LC.of(a), LC.of(1), LC.of(out))
        return out
    return cs.xor(a, b)


def xor_word(cs: ConstraintSystem, *words) -> list:
    out = words[0]
    for w in words[1:]:
        out = [xor_bits(cs, x, y) for x, y in zip(out, w)]
    return out


def ch_word(cs: ConstraintSystem, e: list, f: list, g: list) -> list:
    """ch = g + e*(f - g), one constraint per bit."""
    out = []
    for eb, fb, gb in zip(e, f, g):
        ve, vf, vg = _bit_value(cs, eb), _bit_value(cs, fb), _bit_value(cs, gb)
        o = cs.alloc(vf if ve else vg)
        cs.enforce(LC.of(eb), LC.of(fb) - LC.of(gb), LC.of(o) - LC.of(gb))
        out.append(o)
    return out


def maj_word(cs: ConstraintSystem, a: list, b: list, c: list) -> list:
    """maj = t + a*(b + c - 2t), t = b*c; two constraints per bit."""
    out = []
    for ab, bb, cb in zip(a, b, c):
        va, vb, vc = _bit_value(cs, ab), _bit_value(cs, bb), _bit_value(cs, cb)
        t = cs.alloc(vb & vc)
        cs.enforce(LC.of(bb), LC.of(cb), LC.of(t))
        o = cs.alloc((va & vb) ^ (va & vc) ^ (vb & vc))
        cs.enforce(LC.of(ab), LC.of(bb) + LC.of(cb) - LC.of(t, 2), LC.of(o) - LC.of(t))
        out.append(o)
    return out


def add_words(cs: ConstraintSystem, words: list, consts: int = 0) -> list:
    """Sum of words (+ constant) mod 2^32 via one wide bit decomposition."""
    total = sum(word_value(cs, w) for w in words) + consts
    nbits = 32 + max(1, (len(words) + 1).bit_length())
    acc = LC.of(consts)
    for w in words:
        acc = acc + word_lc(w)
    out_bits = [cs.alloc_bool((total >> i) & 1) for i in range(nbits)]
    recomp = LC()
    for i, b in enumerate(out_bits):
        recomp = recomp + LC.of(b, 1 << i)
    cs.assert_equal(recomp, acc)
    return out_bits[:32]


def sha256_compress(cs: ConstraintSystem, state: list, block_words: list) -> list:
    """One compression round: state (8 words) x block (16 words) -> 8 words."""
    w = list(block_words)
    for i in range(16, 64):
        s0 = xor_word(cs, rotr(w[i - 15], 7), rotr(w[i - 15], 18), shr(w[i - 15], 3))
        s1 = xor_word(cs, rotr(w[i - 2], 17), rotr(w[i - 2], 19), shr(w[i - 2], 10))
        w.append(add_words(cs, [w[i - 16], s0, w[i - 7], s1]))

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = xor_word(cs, rotr(e, 6), rotr(e, 11), rotr(e, 25))
        ch = ch_word(cs, e, f, g)
        S0 = xor_word(cs, rotr(a, 2), rotr(a, 13), rotr(a, 22))
        mj = maj_word(cs, a, b, c)
        new_e = add_words(cs, [d, h, S1, ch, w[i]], consts=K[i])
        new_a = add_words(cs, [h, S1, ch, w[i], S0, mj], consts=K[i])
        a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g

    return [
        add_words(cs, [state[i], x])
        for i, x in enumerate([a, b, c, d, e, f, g, h])
    ]


def bytes_to_block_words(cs: ConstraintSystem, byte_bits: list) -> list:
    """64 bytes (each 8 bit-wires, LSB first) -> 16 big-endian 32-bit words."""
    words = []
    for i in range(16):
        bits = [0] * 32
        for j in range(4):  # byte j is the (3-j)-th significant
            bb = byte_bits[4 * i + j]
            for k in range(8):
                bits[8 * (3 - j) + k] = bb[k]
        words.append(bits)
    return words


def sha256_gadget(cs: ConstraintSystem, message_bytes: list) -> list:
    """Hash a pre-padded message (list of byte Vars, len % 64 == 0).
    Returns 32 digest bytes as lists of 8 bit-wires each."""
    assert len(message_bytes) % 64 == 0
    byte_bits = [cs.decompose_bits(b, 8) for b in message_bytes]
    state = [word_const(cs, h) for h in H_INIT]
    for blk in range(len(message_bytes) // 64):
        words = bytes_to_block_words(cs, byte_bits[64 * blk : 64 * (blk + 1)])
        state = sha256_compress(cs, state, words)
    digest = []
    for wrd in state:
        for j in range(4):  # big-endian bytes
            digest.append([wrd[8 * (3 - j) + k] for k in range(8)])
    return digest


def sha256_var_gadget(cs: ConstraintSystem, message_bytes: list, num_blocks) -> list:
    """Variable-length SHA-256 (circom sha256general semantics): the message
    buffer is max-length with SHA padding already embedded at position
    `message_padded_bytes`; all blocks are compressed, and the digest is the
    state after block `num_blocks` (= message_padded_bytes/64), selected with
    a one-hot indicator so the circuit is independent of the actual length.

    num_blocks: Var holding the 1-based count of real blocks.
    Returns 32 digest bytes as lists of 8 bit-wires."""
    assert len(message_bytes) % 64 == 0
    total_blocks = len(message_bytes) // 64
    byte_bits = [cs.decompose_bits(b, 8) for b in message_bytes]

    states = []
    state = [word_const(cs, h) for h in H_INIT]
    for blk in range(total_blocks):
        words = bytes_to_block_words(cs, byte_bits[64 * blk : 64 * (blk + 1)])
        state = sha256_compress(cs, state, words)
        states.append(state)

    # one-hot indicator over blocks: sum ind = 1, sum ind_b*(b+1) = num_blocks
    ind = cs.one_hot(LC.of(num_blocks) - LC.of(1), total_blocks)
    for b in ind:
        cs.assert_bool(b)
    sum_ind = LC()
    sum_idx = LC()
    for b, iv in enumerate(ind):
        sum_ind = sum_ind + LC.of(iv)
        sum_idx = sum_idx + LC.of(iv, b + 1)
    cs.assert_equal(sum_ind, LC.of(1))
    cs.assert_equal(sum_idx, LC.of(num_blocks))

    # digest word bits: bit = sum_b ind_b * state_b_bit  (one mult each)
    out_words = []
    for w in range(8):
        bits = []
        for k in range(32):
            acc_val = 0
            acc_lc = LC()
            for b in range(total_blocks):
                sb = states[b][w][k]
                prod = cs.mul(ind[b], sb)
                acc_lc = acc_lc + LC.of(prod)
                acc_val += cs.value(prod)
            bit = cs.alloc(acc_val)  # one-hot ind => acc_val is 0/1
            cs.assert_equal(LC.of(bit), acc_lc)
            bits.append(bit)
        out_words.append(bits)

    digest = []
    for wrd in out_words:
        for j in range(4):
            digest.append([wrd[8 * (3 - j) + k] for k in range(8)])
    return digest


def digest_bytes_value(cs: ConstraintSystem, digest: list) -> bytes:
    out = []
    for byte_bits in digest:
        out.append(sum(_bit_value(cs, b) << i for i, b in enumerate(byte_bits)))
    return bytes(out)
