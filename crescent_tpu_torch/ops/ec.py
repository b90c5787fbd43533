"""Batches of short-Weierstrass points on a device (Jacobian coordinates).

Counterpart of ``crescent_tpu/ops/ec.py`` for prime-field curves.  A batch is
a ``JPoints(x, y, z)`` of (..., 8) int32 word tensors in Montgomery form
(``ops/limb.py``); the identity is Z == 0.  ``CurveCtx`` carries the curve's
field context, its kernels (``ops/cuda_ec.py``) and the conversions between
host points and device batches.

The group law itself (``double``, ``add``, ``add_mixed``, ``scalar_mul``) is
not here yet: the MSM path calls the point kernels directly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.curves import Curve
from ..utils.pointvec import ArrayPointVec
from . import limb
from .cuda_ec import get_cuda_ec


class JPoints(NamedTuple):
    """Batch of Jacobian points; each field (..., 8) Montgomery words."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def points_valid(pts) -> np.ndarray:
    """(n,) int32: 0 for the identity, 1 otherwise."""
    if isinstance(pts, ArrayPointVec):
        return (~pts.inf).astype(np.int32)
    return np.asarray([0 if p is None else 1 for p in pts], dtype=np.int32)


class CurveCtx:
    """One curve y^2 = x^3 + a*x + b over a prime field p < 2^255."""

    def __init__(self, modulus: int, a_host: int, order: int, name: str):
        self.fctx = limb.get_ctx(modulus)
        self.ec = get_cuda_ec(modulus, a_host)
        self.name = name
        self.n = order
        self.a_host = a_host
        self.a_is_zero = a_host % modulus == 0

    # -- host conversion ----------------------------------------------------
    def points_to_device(self, pts, device) -> JPoints:
        """Affine host points ([(x, y) | None, ...] or an ``ArrayPointVec``)
        -> a Jacobian batch on `device`: standard-form limbs go up, the
        conversion to Montgomery form is a ``mul`` by R^2 there, and Z is
        Montgomery 1 or 0 by the validity mask."""
        f = self.fctx
        if isinstance(pts, ArrayPointVec):
            xs, ys = pts.xs, pts.ys
        else:
            xs = limb.ints_to_limbs([0 if p is None else p[0] for p in pts])
            ys = limb.ints_to_limbs([1 if p is None else p[1] for p in pts])
        r2 = f.const_words(f.r2, device)
        dx = limb.limbs_to_words(xs, device)
        dy = limb.limbs_to_words(ys, device)
        if len(pts):
            self.ec.mul(dx, r2, out=dx)
            self.ec.mul(dy, r2, out=dy)
        v = torch.from_numpy(points_valid(pts)).to(device)
        dz = torch.where(v[:, None] != 0, f.one_mont(device),
                         torch.zeros((), dtype=torch.int32, device=device))
        return JPoints(dx, dy, dz)

    def points_to_host(self, P: JPoints) -> list:
        """A Jacobian batch -> affine host points (None for the identity).
        Waits for the device."""
        f = self.fctx
        p = f.modulus
        xs, ys, zs = (
            f.from_mont_host(limb.words_to_limbs(c.reshape(-1, limb.NWORD)))
            for c in P
        )
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, p)
                zi2 = zi * zi % p
                out.append((x * zi2 % p, y * zi2 * zi % p))
        return out

    def identity(self, shape=(), device="cpu") -> JPoints:
        """(0, 1, 0) in Montgomery form, broadcast to shape + (8,)."""
        f = self.fctx
        full = tuple(shape) + (limb.NWORD,)
        one = f.one_mont(device).reshape(limb.NWORD).expand(full).contiguous()
        zero = torch.zeros(full, dtype=torch.int32, device=device)
        return JPoints(zero, one, zero.clone())


@functools.lru_cache(maxsize=None)
def get_curve_ctx(curve: Curve) -> CurveCtx:
    ctx = CurveCtx(curve.p, curve.a, curve.n, curve.name)
    ctx.curve = curve
    return ctx
