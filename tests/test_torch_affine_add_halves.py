"""The Fq2 `affine_add` kernel's split of a lane over two threads
(crescent_tpu_torch/csrc/affine_add.cuh), modelled in Python ints: thread h
of a pair holds half h (c0 or c1) of every element, the pair's zero tests
and the partner's operand halves cross by shuffle, each Fq2 product is
schoolbook with each half one sum of two base products under one
Montgomery reduction (field.cuh `fe_mont_mul_sum`, replayed word by word
with its bounds), each square one base product a thread, and the tangent's
3 x^2 is computed only on a warp (16 lanes) that holds a tangent lane.  The
values that cross, in order, are read out of the source.

The model is held exactly (tolerance 0) against `affine_add_plain` over
`QuadCtx` (the plain version the kernel is held to on the card) and, in
affine ints, against the JAX package's host G2 addition
(`crescent_tpu/core/curves.py` `BN254G2.add`), on lanes with L == R,
L == -R, either side invalid, both invalid, L == R on an invalid side and
generic chords planted at every position of a warp, and on warps with no
tangent lane.  No card needed.
"""

import os
import re

import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254G2 as RefG2
from crescent_tpu.core.fields import Fq2 as RefFq2
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.ops.cuda_ec import get_cuda_quad_ec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AADD_CUH = os.path.join(ROOT, "crescent_tpu_torch", "csrc", "affine_add.cuh")
R = 1 << 256
RINV = pow(R, -1, P)
M32 = (1 << 32) - 1
MINV = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32
WARP_LANES = 16  # 32 threads, two a lane


def _words(x: int) -> list[int]:
    return [(x >> (32 * j)) & M32 for j in range(8)]


def mont_mul_sum(a0: int, b0: int, a1: int, b1: int) -> int:
    """field.cuh `fe_mont_mul_sum` word by word: ten accumulator words,
    both products added a word of b at a time, then one reduction step;
    asserts the bounds its comment states."""
    A0, B0, A1, B1, Pw = (_words(v) for v in (a0, b0, a1, b1, P))
    t = [0] * 10
    for i in range(8):
        assert sum(w << (32 * j) for j, w in enumerate(t)) < 4 * P
        for a, b in ((A0, B0), (A1, B1)):
            c = 0
            for j in range(8):
                s = t[j] + a[j] * b[i] + c
                t[j], c = s & M32, s >> 32
            s = t[8] + c
            t[8] = s & M32
            t[9] = (t[9] + (s >> 32)) if a is A1 else s >> 32
        assert t[9] == 0  # below 2^288 within the step
        m = (t[0] * MINV) & M32
        s = t[0] + m * Pw[0]
        c = s >> 32
        for j in range(1, 8):
            s = t[j] + m * Pw[j] + c
            t[j - 1], c = s & M32, s >> 32
        s = t[8] + c
        t[7] = s & M32
        t[8] = t[9] + (s >> 32)
    T = sum(w << (32 * j) for j, w in enumerate(t[:8])) + (t[8] << 256)
    assert T < 3 * P // 2 and t[8] == 0
    r = T - P if T >= P else T  # fe_reduce_once
    assert r == (a0 * b0 + a1 * b1) * RINV % P
    return r


class Pair:
    """The two threads of a lane: values are [half 0, half 1] lists of
    canonical ints in Montgomery form; counts each thread's base products
    and records the values that cross by shuffle."""

    def __init__(self):
        self.products = [0, 0]
        self.crossed: list[str] = []

    def partner(self, name: str, v):
        self.crossed.append(name)
        return [v[1], v[0]]

    def half_mul(self, u, uo, v, vo):
        """Thread 0 u0 v0 + (p - u1) v1, thread 1 u1 v0 + u0 v1."""
        out = []
        for h in (0, 1):
            self.products[h] += 2
            if h == 0:
                out.append(mont_mul_sum(u[h], v[h], (-uo[h]) % P, vo[h]))
            else:
                out.append(mont_mul_sum(u[h], vo[h], uo[h], v[h]))
        return out

    def half_sqr(self, u, uo):
        """Thread 0 (u0 + u1)(u0 - u1), thread 1 2 u1 u0."""
        out = []
        for h in (0, 1):
            self.products[h] += 1
            if h == 0:
                out.append((u[h] + uo[h]) * (u[h] - uo[h]) * RINV % P)
            else:
                out.append(2 * u[h] * uo[h] * RINV % P)
        return out


def lane_halves(lane, tangent_warp: bool):
    """One lane as `affine_add_half` runs it; lane = (Lx, Ly, Rx,
    Ry, inv, lv, rv), each coordinate a [c0, c1] pair.  Returns ((x3, y3,
    valid3), the Pair)."""
    Lx, Ly, Rx, Ry, iv, lv, rv = lane
    t = Pair()
    l, r = lv != 0, rv != 0
    both = l and r
    dy = [(Ry[h] - Ly[h]) % P for h in (0, 1)]
    zx = [Rx[h] == Lx[h] for h in (0, 1)]
    zy = [dy[h] == 0 for h in (0, 1)]
    zxo, zyo = t.partner("zx", zx), t.partner("zy", zy)
    same_x, same_y = zx[0] and zxo[0], zy[0] and zyo[0]
    dbl_case, inf_case = same_x and same_y, same_x and not same_y
    num = dy
    if tangent_warp:  # __any_sync over the warp's lanes
        xx = t.half_sqr(Lx, t.partner("Lx", Lx))
        num = [3 * v % P for v in xx] if dbl_case else dy
    lam = t.half_mul(num, t.partner("num", num), iv, t.partner("iv", iv))
    lo = t.partner("lam", lam)
    x3 = [(s - Lx[h] - Rx[h]) % P for h, s in enumerate(t.half_sqr(lam, lo))]
    d = [(Lx[h] - x3[h]) % P for h in (0, 1)]
    y3 = [(s - Ly[h]) % P for h, s in enumerate(t.half_mul(lam, lo, d, t.partner("d", d)))]
    x = x3 if both else (Lx if l else Rx)
    y = y3 if both else (Ly if l else Ry)
    return (x, y, int((l or r) and not (both and inf_case))), t


def kernel_model(lanes):
    """Every lane, warp by warp: a warp computes 3 x^2 where one of its 16
    lanes has L == R (whatever the lanes' validity)."""
    out, pairs = [], []
    for w in range(0, len(lanes), WARP_LANES):
        warp = lanes[w:w + WARP_LANES]
        tangent = any(ln[0] == ln[2] and ln[1] == ln[3] for ln in warp)
        for ln in warp:
            res, t = lane_halves(ln, tangent)
            out.append(res)
            pairs.append((t, tangent))
    return out, pairs


# -- inputs ---------------------------------------------------------------------

def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % P


CASES = ("tangent", "opposite", "left_only", "right_only", "neither", "tangent_invalid")


def _lanes(n_warps: int, seed: int):
    """Seeded lanes (Montgomery-form halves and flags, inv = 1/denominator
    as affine_denom gives it): warp w < 16 plants every case of CASES from
    position w on, so that each case sits at every position of some warp;
    warps 16..19 plant L == -R alone (no tangent lane), warps 20..23 one
    tangent lane alone; the rest are generic chords with seeded
    validity."""
    rng = np.random.default_rng(seed)
    n = n_warps * WARP_LANES
    el = lambda: [_rand(rng), _rand(rng)]
    Lx, Ly, Rx, Ry = ([el() for _ in range(n)] for _ in range(4))
    lv = list(rng.integers(0, 2, size=n))
    rv = list(rng.integers(0, 2, size=n))
    for w in range(n_warps):
        plant = (CASES if w < 16 else ("opposite",) if w < 20 else ("tangent",) if w < 24
                 else ())
        for k, case in enumerate(plant):
            i = w * WARP_LANES + (w + k) % WARP_LANES
            if case in ("tangent", "tangent_invalid", "opposite"):
                Rx[i] = list(Lx[i])
                Ry[i] = list(Ly[i]) if case != "opposite" else [(-c) % P for c in Ly[i]]
            lv[i], rv[i] = {"left_only": (1, 0), "right_only": (0, 1), "neither": (0, 0),
                            "tangent_invalid": (0, 1)}.get(case, (1, 1))
    inv = []
    for i in range(n):
        std = lambda v: Fq2(v[0] * RINV, v[1] * RINV)
        if not (lv[i] and rv[i]):
            d = Fq2(1, 0)
        elif Lx[i] == Rx[i]:
            d = Fq2(1, 0) if Ly[i] != Ry[i] else std(Ly[i]) * 2
        else:
            d = std(Rx[i]) - std(Lx[i])
        di = d.inv()
        inv.append([di.c0 * R % P, di.c1 * R % P])
    return [(Lx[i], Ly[i], Rx[i], Ry[i], inv[i], int(lv[i]), int(rv[i])) for i in range(n)]


N_WARPS = 28


@pytest.fixture(scope="module")
def model():
    lanes = _lanes(N_WARPS, 7)
    return lanes, *kernel_model(lanes)


def _kernel_body() -> str:
    with open(AADD_CUH) as f:
        src = f.read()
    body = src[src.index("void affine_add_half(const Mod& M"):]
    return body[: body.index("\n}\n")]


def test_mont_mul_sum_bounds_at_the_edges():
    """fe_mont_mul_sum's accumulator bounds hold at p - 1 and 0 operands
    and on seeded ones."""
    rng = np.random.default_rng(3)
    vals = [0, 1, P - 1, P - 2, R % P] + [_rand(rng) for _ in range(12)]
    for a0, b0, a1, b1 in [(P - 1,) * 4, (P - 1, P - 1, 0, 0), (0, 0, P - 1, P - 1)] + [
            tuple(vals[int(k)] for k in rng.integers(0, len(vals), size=4)) for _ in range(40)]:
        mont_mul_sum(a0, b0, a1, b1)


def test_split_crosses_what_the_source_shuffles(model):
    """The values that cross by shuffle, in order, are the source's: the
    zero tests, Lx (tangent warps only), num, inv, lam and Lx - x3; each
    thread runs 5 base products, 6 on a tangent warp (10 and 12 a lane)."""
    body = _kernel_body()
    src = re.findall(r"__shfl_xor_sync\(live, \(int\)(\w+), 1\)|fe_partner\((\w+), live\)", body)
    names = [a or b for a, b in src]
    assert names == ["zx", "zy", "Lx", "num", "iv", "lam", "d"]
    assert "fe_mont_mul_sum" in open(AADD_CUH).read().split("half_mul(")[1]
    _, _, pairs = model
    seen = set()
    for t, tangent in pairs:
        want = names if tangent else [v for v in names if v != "Lx"]
        assert t.crossed == want
        assert t.products == ([6, 6] if tangent else [5, 5])
        seen.add(tangent)
    assert seen == {True, False}


def test_split_matches_plain_affine_add(model):
    """The model's (x3, y3, valid3) equal affine_add_plain over QuadCtx
    bit for bit, every lane."""
    lanes, got, _ = model
    ec = get_cuda_quad_ec(P)
    plane = lambda k: ec.ctx.words([Fq2(*ln[k]) for ln in lanes])
    flags = lambda k: torch.tensor([ln[k] for ln in lanes], dtype=torch.int32)
    want = ec.affine_add_plain(plane(0), plane(1), flags(5), plane(2), plane(3), flags(6),
                               plane(4))
    assert torch.equal(want[0], ec.ctx.words([Fq2(*g[0]) for g in got]))
    assert torch.equal(want[1], ec.ctx.words([Fq2(*g[1]) for g in got]))
    assert want[2].tolist() == [g[2] for g in got]


def test_split_matches_reference_g2_addition(model):
    """In affine ints the model adds as the JAX package's host G2 law:
    L == -R gives the identity, one valid side passes through."""
    lanes, got, _ = model
    back = lambda v: RefFq2(v[0] * RINV % P, v[1] * RINV % P)
    planted = set()
    for ln, (x, y, valid) in zip(lanes, got):
        L = (back(ln[0]), back(ln[1])) if ln[5] else None
        Rp = (back(ln[2]), back(ln[3])) if ln[6] else None
        want = RefG2.add(L, Rp)
        if want is None:
            assert valid == 0
        else:
            assert valid == 1 and (back(x), back(y)) == want
        if ln[5] and ln[6] and ln[0] == ln[2]:
            planted.add("tangent" if ln[1] == ln[3] else "opposite")
    assert planted == {"tangent", "opposite"}
