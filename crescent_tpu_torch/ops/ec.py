"""Batches of short-Weierstrass points on a device (Jacobian coordinates).

Counterpart of ``crescent_tpu/ops/ec.py``.  A batch is a ``JPoints(x, y, z)``
of (..., W) int32 word tensors in Montgomery form, W = 8 over a prime field
(``ops/limb.py``) and 16 over Fq2 (``ops/quadratic.py``); the identity is
Z == 0.  ``CurveCtx`` carries the curve's field context, its kernels
(``ops/cuda_ec.py``: ``CudaEC`` or ``CudaQuadEC``) and the conversions
between host points and device batches.

The group law (``double``, ``add``, ``add_mixed``, ``scalar_mul``) runs on
the point kernels (``jdbl``, ``jadd``, ``madd``) over batches of any shape;
the MSM and fixed-base paths call the kernels directly.  (The reference's
``reduce_sum`` has no caller and is not here.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.curves import BN254G2, Curve
from ..core.fields import BN254_FQ, BN254_FR
from ..utils.pointvec import ArrayPointVec
from . import limb
from .cuda_ec import get_cuda_ec, get_cuda_quad_ec
from .quadratic import get_fq2_ctx


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
    """One curve y^2 = x^3 + a*x + b over a prime field p < 2^256 or its
    quadratic extension: `fctx` is the field's ``ModCtx`` or ``QuadCtx``,
    `ec` its kernels, `a_host` the coefficient a (an int; 0 over Fq2)."""

    def __init__(self, fctx, ec, a_host: int, order: int, name: str):
        self.fctx = fctx
        self.ec = ec
        self.name = name
        self.n = order
        self.a_host = a_host
        self.a_is_zero = a_host % fctx.modulus == 0
        self.quad = fctx.nword != limb.NWORD
        base = getattr(fctx, "base", fctx)
        # the base field's mul converts every component to Montgomery form
        self.base_ec = get_cuda_ec(base.modulus)

    # -- host conversion ----------------------------------------------------
    def points_to_device(self, pts, device) -> JPoints:
        """Affine host points ([(x, y) | None, ...] or an ``ArrayPointVec``)
        -> a Jacobian batch on `device`: standard-form limbs go up, the
        conversion to Montgomery form is a base-field ``mul`` by R^2 per
        component there, and Z is Montgomery 1 or 0 by the validity mask."""
        f = self.fctx
        base = self.base_ec.ctx
        w = f.nword
        if isinstance(pts, ArrayPointVec):
            xs, ys = pts.xs, pts.ys
        elif self.quad:
            xs = limb.ints_to_limbs([c for p in pts for c in
                                     ((0, 0) if p is None else (p[0].c0, p[0].c1))])
            ys = limb.ints_to_limbs([c for p in pts for c in
                                     ((1, 0) if p is None else (p[1].c0, p[1].c1))])
        else:
            xs = limb.ints_to_limbs([0 if p is None else p[0] for p in pts])
            ys = limb.ints_to_limbs([1 if p is None else p[1] for p in pts])
        n = len(pts)
        r2 = base.const_words(base.r2, device)
        # (n, 16 * w / 8) limbs -> one base element per row, then (n, w)
        dx = limb.limbs_to_words(np.asarray(xs).reshape(-1, limb.NLIMB), device)
        dy = limb.limbs_to_words(np.asarray(ys).reshape(-1, limb.NLIMB), device)
        if n:
            self.base_ec.mul(dx, r2, out=dx)
            self.base_ec.mul(dy, r2, out=dy)
        v = torch.from_numpy(points_valid(pts)).to(device)
        dz = torch.where(v[:, None] != 0, f.one_mont(device),
                         torch.zeros((), dtype=torch.int32, device=device))
        return JPoints(dx.reshape(n, w), dy.reshape(n, w), dz)

    def points_to_host(self, P: JPoints) -> list:
        """A Jacobian batch -> affine host points (None for the identity).
        Waits for the device."""
        f = self.fctx
        w = f.nword
        xs, ys, zs = (
            f.from_mont_host(limb.words_to_limbs(c.reshape(-1, limb.NWORD)))
            for c in P
        )
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == f.host_zero:
                out.append(None)
            else:
                zi = f.host_inv(z)
                zi2 = f.host_mul(zi, zi)
                out.append((f.host_mul(x, zi2), f.host_mul(f.host_mul(y, zi2), zi)))
        assert len(out) == P.x.numel() // w
        return out

    def identity(self, shape=(), device="cpu") -> JPoints:
        """(0, 1, 0) in Montgomery form, broadcast to shape + (W,)."""
        f = self.fctx
        full = tuple(shape) + (f.nword,)
        one = f.one_mont(device).reshape(f.nword).expand(full).contiguous()
        zero = torch.zeros(full, dtype=torch.int32, device=device)
        return JPoints(zero, one, zero.clone())

    # -- group law ----------------------------------------------------------
    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """A (..., W) batch as the packed (N, W) plane the kernels take."""
        return t.reshape(-1, self.fctx.nword).contiguous()

    def _batch(self, outs, shape) -> JPoints:
        return JPoints(*(o.reshape(shape) for o in outs))

    def double(self, P: JPoints) -> JPoints:
        """2P (dbl-2007-bl, ``jdbl``); the identity stays the identity."""
        return self._batch(self.ec.jdbl(*map(self._rows, P)), P.x.shape)

    def add(self, P: JPoints, Q: JPoints) -> JPoints:
        """Complete addition (``jadd``): the identity, P == Q and P == -Q
        included."""
        return self._batch(self.ec.jadd(*map(self._rows, P), *map(self._rows, Q)),
                           P.x.shape)

    def add_mixed(self, P: JPoints, qx: torch.Tensor, qy: torch.Tensor,
                  q_valid: torch.Tensor) -> JPoints:
        """P (Jacobian) + Q (affine, Montgomery) by ``madd`` with no sign;
        lanes with q_valid == 0 return P unchanged."""
        valid = q_valid.reshape(-1).to(torch.int32).contiguous()
        sign = torch.zeros_like(valid)
        outs = self.ec.madd(*map(self._rows, P), self._rows(qx), self._rows(qy),
                            valid, sign)
        return self._batch(outs, P.x.shape)

    def scalar_mul(self, k_words: torch.Tensor, P: JPoints) -> JPoints:
        """Batched double-and-add, least significant bit first: k (..., 8)
        standard-form words (Fr words whatever the curve's field), P a batch
        of the same shape.  Each of the 256 steps adds the running base to
        the sum, keeps the sum where the scalar's bit is 0 (``torch.where``
        per lane) and doubles the base."""
        batch = k_words.shape[:-1]
        u = k_words.to(torch.int64) & 0xFFFFFFFF
        i = torch.arange(limb.NWORD * 32, device=k_words.device)
        bits = ((u[..., i // 32] >> (i % 32)) & 1).bool()  # (..., 256)
        acc = self.identity(batch, P.x.device)
        base = P
        for b in range(bits.shape[-1]):
            added = self.add(acc, base)
            bit = bits[..., b, None]
            acc = JPoints(*(torch.where(bit, n, o) for n, o in zip(added, acc)))
            base = self.double(base)
        return acc


@functools.lru_cache(maxsize=None)
def get_curve_ctx(curve: Curve) -> CurveCtx:
    ctx = CurveCtx(limb.get_ctx(curve.p), get_cuda_ec(curve.p, curve.a), curve.a,
                   curve.n, curve.name)
    ctx.curve = curve
    return ctx


@functools.lru_cache(maxsize=None)
def get_g2_ctx() -> CurveCtx:
    """BN254 G2 over Fq2 (a = 0, order = the Fr modulus)."""
    ctx = CurveCtx(get_fq2_ctx(), get_cuda_quad_ec(BN254_FQ), 0, BN254_FR,
                   "bn254_g2")
    ctx.curve = BN254G2
    return ctx
