"""T-256 in the port: the field layer and the `jadd` and `jdbl` kernels over
a modulus at or above 2^255, and Spartan's T-256 MSMs under
CRESCENT_NATIVE=0 (crescent_tpu_torch/models/spartan.py), on the CPU.

T-256's base field p = 0xFFFFFFFF00000001...B117 lies above 2^255, as
P-256's does: a sum of two elements, and a Montgomery product's value
before its last subtraction (below 2p), can carry out of 256 bits.

* The plain field ops of ``ModCtx`` (``mont_mul``, ``add_mod``,
  ``sub_mod``, ``_cond_sub``) over BN254's Fr and Fq, P-256's and T-256's
  base fields against Python ints, with p - 1, p - 2, 2^255 and sums and
  products across 2^256 planted (the reference's tests/test_limb_ops.py
  runs its kernels over the same four moduli).
* The CUDA arithmetic that the T-256 `jadd` and `jdbl` run, replayed word
  by word in Python ints: field.cuh's ``fe_add`` / ``fe_reduce_once`` and
  ``fe_mont_mul`` (CIOS), warp.cuh's ``fe_add_cc`` and ``group_mont_mul``
  (the 8-thread group product, its carries and borrows resolved from warp
  votes) with kWide set, against Python ints over P-256's and T-256's p;
  and with kWide clear, which drops the carry, shown wrong there (so the
  replay sees the carry) and right over BN254's.
* ``jadd_plain`` and ``double_plain`` over T-256 (a = p - 3) against the
  JAX package's host group law (``crescent_tpu.core.curves.T256``): the
  identity on either side and both, P + P (and through another Jacobian
  representative, the tangent with a != 0), P + (-P), and Z coordinates
  whose Montgomery words are p - 1, p - 2, 2^255 and 2^256 - 1 mod p.
* Which entry ``CudaEC`` takes over T-256: ``mul`` as it is, the wide
  ``jadd`` and ``jdbl``; every other kernel refuses, naming its ROADMAP
  item (the library stubbed: no card needed).
* Spartan's device routes with the native backend off, on device="cpu"
  (the kernels' plain versions): ``commit_vector`` over 20 bases,
  ``_t256_msm`` over 33 points and ``poly_commit`` at ell = 9 (16 rows of
  32, one ``run_device_many``) against the reference's host oracle
  ``crescent_tpu.core.curves.T256.msm``; the native MSM is never reached,
  and without a card the default device raises.

Comparisons are exact (tolerance 0).
"""

import itertools
import random
import types

import pytest
import torch

from crescent_tpu.core.curves import T256 as RefT256
from crescent_tpu_torch.core.curves import T256
from crescent_tpu_torch.core.fields import BN254_FQ, BN254_FR, P256_FP, T256_FP, T256_FQ
from crescent_tpu_torch.models import spartan as psp
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import _build, limb
from crescent_tpu_torch.ops.cuda_ec import KERNELS, WIDE_KERNELS, CudaEC, get_cuda_ec
from crescent_tpu_torch.ops.ec import get_curve_ctx

MODULI = {"BN254_FR": BN254_FR, "BN254_FQ": BN254_FQ, "P256_FP": P256_FP,
          "T256_FP": T256_FP}
WIDE = {"P256_FP": P256_FP, "T256_FP": T256_FP}
R = 1 << 256
M32 = (1 << 32) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions on one torch thread (the suite runs workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planted(p: int) -> list[int]:
    """p - 1, p - 2, 2^255 and its neighbours, R mod p, (R - 1) mod p,
    (p +- 1) / 2, 0 and 1: canonical values whose sums and products cross
    2^256 where p >= 2^255."""
    return [0, 1, 2, p - 1, p - 2, (1 << 255) % p, ((1 << 255) - 1) % p,
            ((1 << 255) + 1) % p, R % p, (R - 1) % p, p // 2, p // 2 + 1]


def _operands(p: int, seed: int) -> tuple[list[int], list[int]]:
    """Every pair of the planted values, then seeded pairs."""
    rng = random.Random(seed)
    pairs = list(itertools.product(_planted(p), repeat=2))
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(400)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def _ints(w: torch.Tensor) -> list[int]:
    return limb.limbs_to_ints(limb.words_to_limbs(w))


# -- the plain field layer ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODULI))
def test_plain_field_ops_match_python_ints(name):
    p = MODULI[name]
    ctx = limb.ModCtx(p)
    assert ctx.wide == (name in WIDE)
    xs, ys = _operands(p, 1)
    x, y = ctx.words(xs), ctx.words(ys)
    rinv = pow(R, -1, p)
    assert _ints(ctx.mont_mul(x, y)) == [a * b * rinv % p for a, b in zip(xs, ys)]
    assert _ints(ctx.add_mod(x, y)) == [(a + b) % p for a, b in zip(xs, ys)]
    assert _ints(ctx.sub_mod(x, y)) == [(a - b) % p for a, b in zip(xs, ys)]
    assert _ints(ctx.to_mont(x)) == [a * R % p for a in xs]
    assert _ints(ctx.from_mont(x)) == [a * rinv % p for a in xs]
    if name in WIDE:  # the planted sums do cross 2^256
        assert any(a + b >= R for a, b in zip(xs, ys))


@pytest.mark.parametrize("name", sorted(MODULI))
def test_plain_cond_sub_takes_the_top_bit(name):
    """``_cond_sub`` of X = x + top 2^256 < 2p on 32-bit words."""
    p = MODULI[name]
    ctx = limb.ModCtx(p)
    rng = random.Random(2)
    vals = [0, p - 1, p, p + 1, 2 * p - 1, R - 1, R, R + 1] + [rng.randrange(2 * p)
                                                                for _ in range(200)]
    vals = [v for v in vals if v < 2 * p]
    x = limb._wide(ctx.words([v % R for v in vals]))
    top = torch.tensor([v >> 256 for v in vals], dtype=torch.int64)
    got = ctx._cond_sub(x, limb.WORD_BITS, top).to(torch.int32)
    assert _ints(got) == [v % p for v in vals]
    if name not in WIDE:  # 2p < 2^256: the bit is always 0
        assert not top.any()


# -- the CUDA arithmetic of the wide instances, word by word ------------------

def _words(x: int) -> list[int]:
    return [(x >> (32 * j)) & M32 for j in range(8)]


def _value(w) -> int:
    return sum(v << (32 * j) for j, v in enumerate(w))


def fe_reduce_once(t: int, top: int, p: int) -> int:
    """field.cuh: t (eight words) with carry word top, value < 2p -> t mod
    p: t - p kept unless it borrows past the carry word."""
    assert top in (0, 1) and t + (top << 256) < 2 * p
    borrow = int(t < p)
    return t if borrow > top else (t - p) % R


def fe_add(a: int, b: int, p: int) -> int:
    """field.cuh fe_add: the eight-word sum, its carry into fe_reduce_once."""
    s = a + b
    return fe_reduce_once(s % R, s >> 256, p)


def fe_mont_mul(a: int, b: int, p: int) -> int:
    """field.cuh fe_mont_mul word by word: CIOS over ten accumulator words,
    asserting the bounds its comment states."""
    A, B, Pw = _words(a), _words(b), _words(p)
    minv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    t = [0] * 10
    for i in range(8):
        assert _value(t[:9]) < 2 * p
        c = 0
        for j in range(8):
            s = t[j] + A[j] * B[i] + c
            t[j], c = s & M32, s >> 32
        s = t[8] + c
        t[8], t[9] = s & M32, s >> 32
        assert _value(t) < 1 << 289
        m = (t[0] * minv) & M32
        s = t[0] + m * Pw[0]
        assert s & M32 == 0
        c = s >> 32
        for j in range(1, 8):
            s = t[j] + m * Pw[j] + c
            t[j - 1], c = s & M32, s >> 32
        s = t[8] + c
        t[7] = s & M32
        t[8] = t[9] + (s >> 32)
    return fe_reduce_once(_value(t[:8]), t[8], p)


def fe_add_cc(a: int, b: int, p: int, wide: bool) -> int:
    """warp.cuh fe_add_cc: the add chain (its carry kept where wide), the
    sub chain's borrow, the select."""
    s = a + b
    t, carry = s % R, s >> 256
    borrow = int(t < p)
    keep_t = borrow != 0 and (carry == 0 or not wide)
    return t if keep_t else (t - p) % R


def _carries(G: int, P: int) -> int:
    """warp.cuh: bit k is the carry (or borrow) into word k from the votes
    of the generate and propagate bits."""
    return ((G << 1) + P) ^ P


def group_mont_mul(a: int, b: int, p: int, wide: bool) -> int:
    """warp.cuh group_mont_mul: thread k of a group holds word k of a and
    of p and all of b; per step a product word and two carry words owed to
    the thread's next position, position 0's word broadcast for m, T's
    words shifted down one thread; at the end the carries out of each word
    passed up, resolved with the chain of T - p by warp votes."""
    A, B, Pw = _words(a), _words(b), _words(p)
    minv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    t, c1, c2 = [0] * 8, [0] * 8, [0] * 8
    for i in range(8):
        v = [A[k] * B[i] + t[k] + c1[k] for k in range(8)]
        assert max(v) < 1 << 64
        lo = [x & M32 for x in v]
        m = (((lo[0] + c2[0]) & M32) * minv) & M32  # __shfl_sync from position 0
        w = [m * Pw[k] + lo[k] + c2[k] for k in range(8)]
        assert w[0] & M32 == 0 and max(w) < 1 << 64
        c1 = [x >> 32 for x in v]
        c2 = [x >> 32 for x in w]
        t = [w[k + 1] & M32 for k in range(7)] + [0]  # __shfl_down_sync, thread 7 0
    s = [t[k] + c1[k] + c2[k] for k in range(8)]
    assert _value(s) < 2 * p  # T < 2p: what the shifts leave
    e = [0] + [s[k - 1] >> 32 for k in range(1, 8)]  # __shfl_up_sync
    s2 = [(s[k] & M32) + e[k] for k in range(8)]
    r = [x & M32 for x in s2]
    carry = _carries(sum((x >> 32) << k for k, x in enumerate(s2)),
                     sum(int(x == M32) << k for k, x in enumerate(r)))
    r = [(r[k] + (carry >> k & 1)) & M32 for k in range(8)]
    top = (s[7] >> 32) + (carry >> 8 & 1) if wide else 0
    assert _value(r) + (top << 256) == _value(s) or not wide
    borrow = _carries(sum(int(r[k] < Pw[k]) << k for k in range(8)),
                      sum(int(r[k] == Pw[k]) << k for k in range(8)))
    d = [(r[k] - Pw[k] - (borrow >> k & 1)) & M32 for k in range(8)]
    return _value(r) if (borrow >> 8 & 1) > top else _value(d)


@pytest.mark.parametrize("name", sorted(MODULI))
def test_cuda_field_arithmetic_replayed(name):
    """The wide instances' arithmetic equals Python ints over every modulus;
    the narrow instances' equals them below 2^255 and not above."""
    p = MODULI[name]
    xs, ys = _operands(p, 3)
    rinv = pow(R, -1, p)
    narrow_wrong = 0
    for a, b in zip(xs, ys):
        prod, total = a * b * rinv % p, (a + b) % p
        assert fe_add(a, b, p) == total
        assert fe_mont_mul(a, b, p) == prod
        assert fe_add_cc(a, b, p, wide=True) == total
        assert group_mont_mul(a, b, p, wide=True) == prod
        narrow = (fe_add_cc(a, b, p, wide=False), group_mont_mul(a, b, p, wide=False))
        narrow_wrong += narrow != (total, prod)
    assert bool(narrow_wrong) == (name in WIDE)


# -- jadd and jdbl's plain versions over T-256 ----------------------------------

def _jacobian(ctx, pts, zs):
    """Affine points (None: the identity) with Jacobian Z = zs[i] (standard
    form) -> Montgomery (x, y, z) planes."""
    f = ctx.fctx
    p = f.modulus
    rows = []
    for pt, z in zip(pts, zs):
        if pt is None:
            rows.append((0, 1, 0))
        else:
            rows.append((pt[0] * z * z % p, pt[1] * z * z * z % p, z))
    return tuple(f.words([v * R % p for v in col]) for col in zip(*rows))


def _affine(ctx, X, Y, Z) -> list:
    f = ctx.fctx
    p = f.modulus
    out = []
    for x, y, z in zip(*(f.from_mont_host(limb.words_to_limbs(c)) for c in (X, Y, Z))):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi * zi % p, y * zi * zi * zi % p))
    return out


def test_jadd_and_jdbl_plain_match_reference_group_law():
    ctx = get_curve_ctx(T256)
    p = T256_FP
    ec = ctx.ec
    assert ec.wide and not ec.a_is_zero and ec.a_host == p - 3
    rng = random.Random(4)
    pts = [RefT256.random_point(rng) for _ in range(10)]
    pts = [(int(x), int(y)) for x, y in pts]
    neg = [(x, (-y) % p) for x, y in pts]
    # Montgomery words of Z: p - 1, p - 2, 2^255, 2^256 - 1 mod p
    zs_mont = [p - 1, p - 2, 1 << 255, (R - 1) % p]
    zs = [z * pow(R, -1, p) % p for z in zs_mont] + [rng.randrange(1, p) for _ in range(8)]
    # lanes: P + P (one Z), P + P (two Z's), P + (-P), the identity on the
    # left, on the right, on both, four chords, P + P at Z words 2^255 and
    # 2^256 - 1 mod p
    P = [pts[0], pts[1], pts[2], None, pts[3], None, pts[4], pts[5], pts[6], pts[7], pts[8]]
    Q = [pts[0], pts[1], neg[2], pts[8], None, None, pts[9], pts[4], pts[0], pts[6], pts[8]]
    z1 = [zs[0], zs[1], zs[2], zs[3], zs[4], zs[5], zs[6], zs[7], zs[0], zs[1], zs[2]]
    z2 = [zs[0], zs[2], zs[3], zs[4], zs[5], zs[6], zs[7], zs[8], zs[9], zs[10], zs[3]]
    X1, Y1, Z1 = _jacobian(ctx, P, z1)
    X2, Y2, Z2 = _jacobian(ctx, Q, z2)
    assert _ints(Z1)[:3] == zs_mont[:3]

    got = _affine(ctx, *ec.jadd(X1, Y1, Z1, X2, Y2, Z2))
    want = [RefT256.add(a, b) for a, b in zip(P, Q)]
    assert got == [None if w is None else (int(w[0]), int(w[1])) for w in want]
    assert got[2] is None and got[0] is not None and got[5] is None

    got = _affine(ctx, *ec.jdbl(X1, Y1, Z1))
    want = [None if a is None else RefT256.double(a) for a in P]
    assert got == [None if w is None else (int(w[0]), int(w[1])) for w in want]


# -- which kernels hold the wide modulus -----------------------------------------

def test_cuda_ec_picks_wide_entries_and_refuses_the_rest(monkeypatch):
    """Over T-256 ``CudaEC`` resolves ``mul`` as it is and ``jadd`` /
    ``jdbl`` to their wide entries; every other kernel, and a wide modulus
    with a = 0, refuses naming ROADMAP Queue 2 item 1.  BN254 keeps its
    entries."""
    names = []
    monkeypatch.setattr(_build, "library", lambda lib: types.SimpleNamespace(
        **{n: (lambda *a, _n=n: names.append(_n)) for n in _build.SIGNATURES[lib]}))
    t256, bn = CudaEC(T256_FP, T256.a), get_cuda_ec(BN254_FQ)
    assert set(WIDE_KERNELS) <= set(KERNELS)
    for k in KERNELS:
        lib = "ntt" if k in ("mul", "butterfly") else "ec"
        assert bn._entry(k, lib) is not None
        if k in WIDE_KERNELS:
            t256._entry(k, lib)()
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 1"):
                t256._entry(k, lib)
    assert names == ["crescent_mul", "crescent_jadd_wide", "crescent_jdbl_wide"]
    with pytest.raises(NotImplementedError, match="a = 0"):
        CudaEC(T256_FP, 0)._entry("jadd")


# -- Spartan's T-256 MSMs with the native backend off ----------------------------

@pytest.fixture
def native_off(monkeypatch):
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setattr(nb, "msm", lambda *a: pytest.fail("the native MSM was reached"))


def _ref(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def test_commit_vector_device_route_matches_reference(native_off):
    """Above 16 bases: ``get_msm(T256).run_host``; at or below, the host
    oracle, as in the reference."""
    rng = random.Random(5)
    gens = psp.pedersen_gens(20)
    vals = [rng.randrange(T256_FQ) for _ in range(20)]
    got = psp.commit_vector(gens, vals, 7, device="cpu")
    assert got == _ref(RefT256.msm(vals + [7], gens.g + [gens.h]))
    small = psp.PedersenGens(gens.g[:3], gens.h)
    assert psp.commit_vector(small, vals[:3], 7) == _ref(RefT256.msm(vals[:3] + [7],
                                                                     small.g + [small.h]))
    if not torch.cuda.is_available():  # the card by default: none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psp.commit_vector(gens, vals, 7)


def test_t256_msm_device_route_matches_reference(native_off):
    """Above 32 points (after dropping zero scalars and identities)."""
    rng = random.Random(6)
    pts = psp.derive_generators(34, b"t")
    sc = [rng.randrange(T256_FQ) for _ in range(33)] + [0]
    got = psp._t256_msm(sc, pts, device="cpu")
    assert got == _ref(RefT256.msm(sc[:33], pts[:33]))
    assert psp._t256_msm(sc[:4], pts[:4]) == _ref(RefT256.msm(sc[:4], pts[:4]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psp._t256_msm(sc, pts)


def test_poly_commit_device_route_matches_reference(native_off):
    """ell = 9: 16 rows of 32 coefficients, each row's commitment with its
    blind one problem of one ``run_device_many``."""
    rng = random.Random(7)
    ell = 9
    poly = psp.DenseMlPoly([rng.randrange(T256_FQ) for _ in range(1 << ell)])
    gens = psp.PolyCommitmentGens(ell, b"g")
    tape = psp.RandomTape.__new__(psp.RandomTape)
    tape.tape = psp.Transcript(b"proof")
    psp.ts_append_scalar(tape.tape, b"init_randomness", 11)
    comm, blinds = psp.poly_commit(poly, gens, tape, device="cpu")
    L, Rn = (1 << k for k in psp.factored_lens(ell))
    assert (L, Rn, len(comm.C), len(blinds)) == (16, 32, 16, 16)
    gn = gens.gens.gens_n
    for i in range(L):
        row = poly.evals[Rn * i: Rn * (i + 1)] + [blinds[i]]
        assert comm.C[i] == psp._comp(_ref(RefT256.msm(row, gn.G[:Rn] + [gn.h])))
