"""The Fq `affine_add` kernel (crescent_tpu_torch/csrc/affine_add.cuh
`affine_add_lane_kernel`, one thread a lane), modelled in Python ints: the
lane's formula (three Montgomery products on a chord, the carry-chain sums
as canonical sums, the same-x and same-y tests as equal words) with the
tangent's 3 x^2 + a computed only on a warp (32 lanes) where a lane has
both sides valid and L == R, the vote and the products read out of the
source.

The model is held exactly (tolerance 0) against `affine_add_plain` over
`ModCtx` (the plain version the kernel is held to on the card), for a = 0
and a != 0, and, in affine ints, against the JAX package's host G1
addition (`crescent_tpu/core/curves.py` `Curve.add`, BN254 G1 and the
same curve with a != 0), on lanes with L == R, L == -R, either side
invalid, both invalid and L == R on an invalid side planted at every
position of a warp, and on warps with no tangent lane.  No card needed.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254_G1 as RefG1
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AADD_CUH = os.path.join(ROOT, "crescent_tpu_torch", "csrc", "affine_add.cuh")
R = 1 << 256
RINV = pow(R, -1, P)
WARP_LANES = 32  # one thread a lane
A_NONZERO = 0x1234567


def _kernel_body() -> str:
    with open(AADD_CUH) as f:
        src = f.read()
    body = src[src.index("affine_add_lane_kernel(Curve C"):]
    return body[: body.index("\n}\n")]


def mont_mul(a: int, b: int) -> int:
    """field.cuh `fe_mont_mul`: a b 2^-256 mod p, canonical."""
    return a * b * RINV % P


# -- the lane ---------------------------------------------------------------------

def lane_model(lane, tangent_warp: bool, a_mont: int):
    """One lane as affine_add_lane_kernel runs it; lane = (Lx, Ly, Rx, Ry,
    inv, lv, rv) in Montgomery form.  Returns ((x3, y3, valid3), products)."""
    Lx, Ly, Rx, Ry, iv, lv, rv = lane
    l, r = lv != 0, rv != 0
    both = l and r
    same_x, same_y = Rx == Lx, Ry == Ly  # canonical: equal words
    dbl_case, inf_case = same_x and same_y, same_x and not same_y
    num = (Ry - Ly) % P
    products = 3
    if tangent_warp:
        xx = mont_mul(Lx, Lx)
        products += 1
        t = (3 * xx + a_mont) % P
        num = t if dbl_case else num
    lam = mont_mul(num, iv)
    x3 = (mont_mul(lam, lam) - Lx - Rx) % P
    y3 = (mont_mul(lam, (Lx - x3) % P) - Ly) % P
    x = x3 if both else (Lx if l else Rx)
    y = y3 if both else (Ly if l else Ry)
    return (x, y, int((l or r) and not (both and inf_case))), products


def kernel_model(lanes, a_mont: int):
    """Every lane, warp by warp: a warp computes 3 x^2 + a where one of its
    32 lanes has both sides valid and L == R."""
    out, tangent_warps, products = [], [], []
    for w in range(0, len(lanes), WARP_LANES):
        warp = lanes[w:w + WARP_LANES]
        tangent = any(ln[5] and ln[6] and ln[0] == ln[2] and ln[1] == ln[3] for ln in warp)
        tangent_warps.append(tangent)
        for ln in warp:
            res, k = lane_model(ln, tangent, a_mont)
            out.append(res)
            products.append(k)
    return out, tangent_warps, products


# -- inputs ---------------------------------------------------------------------

def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % P


CASES = ("tangent", "opposite", "left_only", "right_only", "neither", "tangent_invalid")


def _lanes(n_warps: int, seed: int):
    """Seeded lanes (Montgomery form, inv = 1/denominator as affine_denom
    gives it): warp w < 32 plants every case of CASES from position w on,
    so that each case sits at every position of some warp; warps 32 and 33
    plant L == -R alone and L == R on an invalid side alone (no tangent
    vote), warps 34 and 35 one tangent lane alone; the rest are generic
    chords with seeded validity."""
    rng = np.random.default_rng(seed)
    n = n_warps * WARP_LANES
    Lx, Ly, Rx, Ry = ([_rand(rng) for _ in range(n)] for _ in range(4))
    lv = [int(v) for v in rng.integers(0, 2, size=n)]
    rv = [int(v) for v in rng.integers(0, 2, size=n)]
    for w in range(n_warps):
        plant = (CASES if w < 32 else ("opposite",) if w == 32 else ("tangent_invalid",)
                 if w == 33 else ("tangent",) if w < 36 else ())
        if plant and len(plant) == 1:  # alone in its warp: the others chords
            for i in range(w * WARP_LANES, (w + 1) * WARP_LANES):
                lv[i] = rv[i] = 1
        for k, case in enumerate(plant):
            i = w * WARP_LANES + (w + 5 * k) % WARP_LANES
            if case in ("tangent", "tangent_invalid", "opposite"):
                Rx[i] = Lx[i]
                Ry[i] = Ly[i] if case != "opposite" else (-Ly[i]) % P
            lv[i], rv[i] = {"left_only": (1, 0), "right_only": (0, 1), "neither": (0, 0),
                            "tangent_invalid": (0, 1)}.get(case, (1, 1))
    rinv = RINV
    inv = []
    for i in range(n):
        if not (lv[i] and rv[i]):
            d = 1
        elif Lx[i] == Rx[i]:
            d = 1 if Ly[i] != Ry[i] else 2 * Ly[i] * rinv
        else:
            d = (Rx[i] - Lx[i]) * rinv
        inv.append(pow(d % P, -1, P) * R % P)
    return [(Lx[i], Ly[i], Rx[i], Ry[i], inv[i], lv[i], rv[i]) for i in range(n)]


@pytest.fixture(scope="module", params=[0, A_NONZERO], ids=["a0", "a_nonzero"])
def model(request):
    a = request.param
    lanes = _lanes(40 if a == 0 else 36, 11 + a % 7)
    return a, lanes, *kernel_model(lanes, a * R % P)


def test_tangent_only_on_a_warp_with_a_valid_tangent(model):
    """3 x^2 + a is computed on a warp where a lane has both sides valid
    and L == R, and nowhere else: four products a lane there, three on
    every other warp (the source's vote)."""
    body = _kernel_body()
    assert "__any_sync(live, both && dbl_case)" in body
    assert body.count("fe_mont_mul(") == 4
    _, lanes, _, tangent_warps, products = model
    assert tangent_warps[:32] == [True] * 32
    assert tangent_warps[32:36] == [False, False, True, True]
    for w, tangent in enumerate(tangent_warps):
        assert set(products[w * WARP_LANES:(w + 1) * WARP_LANES]) == {4 if tangent else 3}


def test_lane_model_matches_plain_affine_add(model):
    """The model's (x3, y3, valid3) equal affine_add_plain over ModCtx bit
    for bit, every lane, for a = 0 and a != 0."""
    a, lanes, got, _, _ = model
    ec = get_cuda_ec(P, a)
    plane = lambda k: ec.ctx.words([ln[k] for ln in lanes], "cpu")
    flags = lambda k: torch.tensor([ln[k] for ln in lanes], dtype=torch.int32)
    want = ec.affine_add_plain(plane(0), plane(1), flags(5), plane(2), plane(3), flags(6),
                               plane(4))
    assert torch.equal(want[0], ec.ctx.words([g[0] for g in got], "cpu"))
    assert torch.equal(want[1], ec.ctx.words([g[1] for g in got], "cpu"))
    assert want[2].tolist() == [g[2] for g in got]


def test_lane_model_matches_reference_g1_addition(model):
    """In affine ints the model adds as the JAX package's host curve law
    (BN254 G1, and the same curve with a != 0): L == -R gives the
    identity, one valid side passes through, L == R doubles."""
    a, lanes, got, _, _ = model
    curve = dataclasses.replace(RefG1, a=a)
    back = lambda v: v * RINV % P
    planted = set()
    for ln, (x, y, valid) in zip(lanes, got):
        L = (back(ln[0]), back(ln[1])) if ln[5] else None
        Rp = (back(ln[2]), back(ln[3])) if ln[6] else None
        want = curve.add(L, Rp)
        if want is None:
            assert valid == 0
        else:
            assert valid == 1 and (back(x), back(y)) == want
        if ln[5] and ln[6] and ln[0] == ln[2]:
            planted.add("tangent" if ln[1] == ln[3] else "opposite")
    assert planted == {"tangent", "opposite"}
