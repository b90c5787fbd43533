"""The `inv` kernels' divstep schedule (crescent_tpu_torch/csrc/field.cuh
`fe_inv_divsteps`), modelled in Python ints and held against Fermat's
x^(p-2) for BN254 Fq and Fr, and the Fq2 `inv` (the same divsteps on the
norm) against the JAX package's host Fq2 inverse and the port's plain
version.  Exact comparisons (tolerance 0); no card needed.

The model repeats the kernel step for step: nine signed 30-bit limbs,
batches of 30 constant-time divsteps on the low words of f and g, each
batch's 2x2 matrix applied to (f, g) and, modulo p with p^-1 mod 2^30, to
(d, e); the same batch count, the same final normalisation and the same
Montgomery product by R^3 mod p.  The limb width, batch length and batch
count are read from field.cuh itself, so the model runs the kernel's
schedule.  uint32/int32 wrap-around is modelled with masks, and every 64-bit
accumulator is checked to fit in an int64.
"""

import os
import re

import numpy as np
import pytest
import torch

from crescent_tpu_torch.core import fields
from crescent_tpu_torch.ops.cuda_ec import _curve26, divstep_r3

FIELD_CUH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "crescent_tpu_torch", "csrc", "field.cuh")


def _schedule() -> tuple[int, int, int]:
    """(limb bits, divsteps a batch, batches) as field.cuh declares them."""
    with open(FIELD_CUH) as f:
        src = f.read()

    def const(name: str) -> str:
        m = re.search(rf"constexpr int {name} = (\w+);", src)
        assert m, f"field.cuh declares no {name}"
        return m.group(1)

    bits = int(const("kS30Bits"))
    batch = const("kDivstepBatch")
    return bits, bits if batch == "kS30Bits" else int(batch), int(const("kDivstepBatches"))


LIMB_BITS, BATCH, BATCHES = _schedule()
FIELDS = {"Fq": fields.BN254_FQ, "Fr": fields.BN254_FR}
R = 1 << 256
NLIMB = 9
M30 = (1 << LIMB_BITS) - 1
U32 = (1 << 32) - 1


def _i32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def _i64(x: int) -> int:
    assert -(1 << 63) <= x < 1 << 63, "a 64-bit accumulator overflows"
    return x


def _to_s30(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & M30 for i in range(NLIMB)]


def _value(v: list[int]) -> int:
    return sum(l << (LIMB_BITS * i) for i, l in enumerate(v))


def _pinv30(p: int) -> int:
    """p^-1 mod 2^30 as fe_inv_divsteps computes it: (0 - M.inv) & kM30,
    M.inv = -p^-1 mod 2^32 from the curve's constants."""
    return (-_curve26(p, R % p, 0)[8]) & M30


def _divsteps_30(eta: int, f0: int, g0: int):
    """30 divsteps on the low words (uint32 arithmetic); returns the new eta
    (= -delta) and the matrix (u, v, q, r) as int32."""
    u, v, q, r, f, g = 1, 0, 0, 1, f0, g0
    for _ in range(BATCH):
        c1 = U32 if eta < 0 else 0          # delta > 0
        c2 = U32 if g & 1 else 0            # g odd
        x = ((f ^ c1) - c1) & U32
        y = ((u ^ c1) - c1) & U32
        z = ((v ^ c1) - c1) & U32
        g = (g + (x & c2)) & U32
        q = (q + (y & c2)) & U32
        r = (r + (z & c2)) & U32
        c1 &= c2                            # the swap: (1 - delta, g, (g - f) / 2)
        eta = (-eta if c1 else eta) - 1
        f = (f + (g & c1)) & U32
        u = (u + (q & c1)) & U32
        v = (v + (r & c1)) & U32
        g >>= 1
        u = (u << 1) & U32
        v = (v << 1) & U32
    return eta, tuple(_i32(t) for t in (u, v, q, r))


def _update_fg(f, g, t):
    u, v, q, r = t
    cf = _i64(u * f[0] + v * g[0])
    cg = _i64(q * f[0] + r * g[0])
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= LIMB_BITS
    cg >>= LIMB_BITS
    nf, ng = [0] * NLIMB, [0] * NLIMB
    for i in range(1, NLIMB):
        cf = _i64(cf + u * f[i] + v * g[i])
        cg = _i64(cg + q * f[i] + r * g[i])
        nf[i - 1], ng[i - 1] = cf & M30, cg & M30
        cf >>= LIMB_BITS
        cg >>= LIMB_BITS
    nf[8], ng[8] = _i32(cf), _i32(cg)
    return nf, ng


def _update_de(d, e, t, p30, pinv30):
    u, v, q, r = t
    sd = -1 if d[8] < 0 else 0
    se = -1 if e[8] < 0 else 0
    md = _i32((u & sd) + (v & se))
    me = _i32((q & sd) + (r & se))
    cd = _i64(u * d[0] + v * e[0])
    ce = _i64(q * d[0] + r * e[0])
    md = _i32(md - ((pinv30 * (cd & U32) + md) & M30))
    me = _i32(me - ((pinv30 * (ce & U32) + me) & M30))
    cd = _i64(cd + p30[0] * md)
    ce = _i64(ce + p30[0] * me)
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= LIMB_BITS
    ce >>= LIMB_BITS
    nd, ne = [0] * NLIMB, [0] * NLIMB
    for i in range(1, NLIMB):
        cd = _i64(cd + u * d[i] + v * e[i] + p30[i] * md)
        ce = _i64(ce + q * d[i] + r * e[i] + p30[i] * me)
        nd[i - 1], ne[i - 1] = cd & M30, ce & M30
        cd >>= LIMB_BITS
        ce >>= LIMB_BITS
    nd[8], ne[8] = _i32(cd), _i32(ce)
    return nd, ne


def _normalize(d, sign, p30):
    """d in (-2p, p) -> sign(f) * d in [0, p): add p if negative, negate
    if f < 0, carry; add p again if still negative, carry."""
    d = list(d)
    if d[8] < 0:
        d = [a + b for a, b in zip(d, p30)]
    if sign < 0:
        d = [-a for a in d]
    for i in range(8):
        d[i + 1] += d[i] >> LIMB_BITS
        d[i] &= M30
    if d[8] < 0:
        d = [a + b for a, b in zip(d, p30)]
    for i in range(8):
        d[i + 1] += d[i] >> LIMB_BITS
        d[i] &= M30
    return d


def inv_model(xm: int, p: int):
    """The kernel on one Montgomery row xm = xR: returns (x^-1 R, f, g)
    after the schedule, f and g as integers."""
    r3, pinv30 = divstep_r3(p), _pinv30(p)
    p30 = _to_s30(p)
    f, g = _to_s30(p), _to_s30(xm)
    d, e = [0] * NLIMB, [1] + [0] * 8
    eta = -1                                # delta = 1
    for _ in range(BATCHES):
        eta, t = _divsteps_30(eta, f[0], g[0])
        d, e = _update_de(d, e, t, p30, pinv30)
        f, g = _update_fg(f, g, t)
        assert all(0 <= l <= M30 for l in f[:8] + g[:8] + d[:8] + e[:8])
        assert -2 * p < _value(d) < p and -2 * p < _value(e) < p
    d = _normalize(d, f[8], p30)
    assert all(0 <= l <= M30 for l in d)
    dv = _value(d)
    assert 0 <= dv < p
    return dv * r3 * pow(R, -1, p) % p, _value(f), _value(g)  # fe_mont_mul(d, R^3)


def _inputs(p: int) -> list[int]:
    """0, 1, p - 1, R mod p, 2^k, and 300 seeded values below p."""
    rng = np.random.default_rng(p % 1000003)
    words = rng.integers(0, 1 << 32, size=(300, 8), dtype=np.uint64)
    seeded = [int("".join(f"{int(w):08x}" for w in row[::-1]), 16) % p for row in words]
    return ([0, 1, p - 1, R % p, p - 2, (p + 1) // 2]
            + [1 << k for k in (1, 2, 29, 30, 31, 32, 63, 64, 128, 200, 253)] + seeded)


def test_divstep_schedule_covers_the_bound():
    """field.cuh's schedule: 25 batches of 30 = 750 divsteps cover Bernstein
    and Yang's floor((49 * 256 + 57) / 17) = 741, and nine limbs hold a
    signed 256-bit value."""
    assert BATCH == LIMB_BITS <= 30  # the model's matrix entries fit in an int32
    assert BATCH * BATCHES >= (49 * 256 + 57) // 17 == 741
    assert LIMB_BITS * NLIMB >= 256 + 1


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_divstep_constants(name):
    """The host's R^3 mod p, and p^-1 mod 2^30 as the kernel reads it off
    the curve's -p^-1 mod 2^32 (word 8 of its constants)."""
    p = FIELDS[name]
    assert divstep_r3(p) == R ** 3 % p
    assert p * _pinv30(p) % (1 << LIMB_BITS) == 1


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_divstep_model_matches_fermat(name):
    """x^-1 R for every Montgomery row xR, 0 -> 0, bit-equal to the Fermat
    chain's x^(p-2); g is 0 after the schedule and f is +-1 (0 where x = 0:
    f stays p)."""
    p = FIELDS[name]
    for xm in _inputs(p):
        got, f, g = inv_model(xm, p)
        x = xm * pow(R, -1, p) % p
        want = pow(x, p - 2, p) * R % p      # the Fermat chain in Montgomery form
        assert got == want, hex(xm)
        assert g == 0, hex(xm)
        assert abs(f) == (1 if xm else p), hex(xm)


def _mont_mul(a: int, b: int, p: int) -> int:
    return a * b * pow(R, -1, p) % p


def fq2_inv_model(x0m: int, x1m: int, p: int) -> tuple[int, int]:
    """The Fq2 `inv` kernel (field.cuh `fe_inv` over Fe2) on one Montgomery
    row (x0 R, x1 R): the norm x0^2 + x1^2 by two products and a sum, its
    inverse by the divstep model, then x0 ninv and (-x1) ninv."""
    nrm = (_mont_mul(x0m, x0m, p) + _mont_mul(x1m, x1m, p)) % p
    ninv = inv_model(nrm, p)[0]
    return _mont_mul(x0m, ninv, p), _mont_mul((p - x1m) % p, ninv, p)


def _fq2_inputs(p: int) -> list[tuple[int, int]]:
    """The norm's edges ((0, 0), (1, 0), (0, 1), (p - 1, 0), (0, p - 1),
    (a, a), (a, p - a), 2^k in c0 and in c1) and 12 seeded pairs."""
    a = 0x1234567890ABCDEF
    ks = (1, 31, 32, 64, 128, 253)
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, size=(24, 8), dtype=np.uint64)
    seeded = [int("".join(f"{int(w):08x}" for w in row[::-1]), 16) % p for row in words]
    return ([(0, 0), (1, 0), (0, 1), (p - 1, 0), (0, p - 1), (a, a), (a, p - a)]
            + [(1 << k, 0) for k in ks] + [(0, 1 << k) for k in ks]
            + list(zip(seeded[::2], seeded[1::2])))


def test_fq2_divstep_model_matches_reference_and_plain():
    """The Fq2 `inv` model equals the JAX package's host Fq2 inverse and the
    port's plain QuadCtx.inv_mod (the norm's Fermat chain), bit for bit;
    (0, 0) -> (0, 0)."""
    from crescent_tpu.core.fields import Fq2 as RefFq2
    from crescent_tpu_torch.ops.quadratic import get_fq2_ctx

    p = fields.BN254_FQ
    xs = _fq2_inputs(p)
    mont = [(x0 * R % p, x1 * R % p) for x0, x1 in xs]
    got = [fq2_inv_model(x0m, x1m, p) for x0m, x1m in mont]
    ref = []
    for x0, x1 in xs:
        y = RefFq2(x0, x1).inv() if (x0, x1) != (0, 0) else RefFq2(0, 0)
        ref.append((y.c0 * R % p, y.c1 * R % p))
    assert got == ref
    q = get_fq2_ctx()
    plain = q.inv_mod(q.words([fields.Fq2(*m) for m in mont]))
    assert torch.equal(plain, q.words([fields.Fq2(*g) for g in got]))
