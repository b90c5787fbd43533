"""Multi-scalar multiplication on one device.

Counterpart of ``crescent_tpu/ops/msm.py`` for the paths Groth16 ``prove``
and ``verify`` take: MSMs over G1 (``get_msm``) or over G2, whose field is
Fq2 (``get_g2_msm``), one problem at a time (``run_device``) or several
QAP-scale problems as one fold over fixed-shape chunks
(``run_device_fold``).  Problems of at most ``small_cutoff`` points take
the direct path (``_small_msm``: a batched double-and-add, then a tree of
``jadd``), larger ones the sorted-segment batched-affine accumulator
(``ops/msm_affine.py``).

Not here yet: ``run_device_many`` and the scan-based Pippenger.

Scalars on the device are (N, 8) int32 word planes in standard form, the
bytes of the reference's (N, 16) 16-bit limbs, whatever the curve's field.
"""

from __future__ import annotations

import functools
import os

import torch

from ..core.curves import Curve
from . import limb
from .ec import CurveCtx, JPoints, get_curve_ctx, get_g2_ctx, points_valid
from .msm_affine import AffineMSM, pad_rows

I64 = torch.int64
NBITS = 256


def scalar_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(N, 8) standard-form words -> (N, W) int64 unsigned c-bit window
    digits, W = ceil(256 / c); c <= 32."""
    assert 1 <= c <= 32
    W = (NBITS + c - 1) // c
    u = scalars.to(I64) & 0xFFFFFFFF
    # two zero words on top: the last window may reach past bit 255
    u = torch.cat([u, torch.zeros((u.shape[0], 2), dtype=I64, device=u.device)], dim=1)
    start = torch.arange(W, dtype=I64, device=u.device) * c
    lo = start >> 5
    off = start & 31
    pair = u[:, lo] | (u[:, lo + 1] << 32)  # bit 63 may wrap; the mask drops it
    return (pair >> off) & ((1 << c) - 1)


def scalar_digits_signed(scalars: torch.Tensor, c: int):
    """(N, 8) words -> signed-digit recoding (|digit| (N, W+1), sign
    (N, W+1)), both int64.

    Windows are remapped to the balanced range [-(2^(c-1)-1), 2^(c-1)] by a
    carry chain, so 2^(c-1)+1 buckets suffice and a negative digit adds the
    negated point.  One extra window takes the last carry.  sign is 0/1
    (1: subtract)."""
    half = 1 << (c - 1)
    full = 1 << c
    d = scalar_digits(scalars, c)
    digs, signs = [], []
    carry = torch.zeros(d.shape[0], dtype=I64, device=d.device)
    for w in range(d.shape[1]):
        e = d[:, w] + carry
        neg = (e > half).to(I64)
        digs.append(torch.where(neg != 0, full - e, e))
        signs.append(neg)
        carry = neg
    digs.append(carry)
    signs.append(torch.zeros_like(carry))
    return torch.stack(digs, dim=-1), torch.stack(signs, dim=-1)


def _jadd_tree(jadd, acc) -> JPoints:
    """Sum of a batch of Jacobian points (three (n, W) planes) by a tree of
    ``jadd`` levels: the first half plus the second, an odd last row carried
    to the next level."""
    acc = list(acc)
    while acc[0].shape[0] > 1:
        h = acc[0].shape[0] // 2
        lo = jadd(*(a[:h] for a in acc), *(a[h : 2 * h] for a in acc))
        acc = [torch.cat([l, a[2 * h :]]) for l, a in zip(lo, acc)]
    return JPoints(acc[0][0], acc[1][0], acc[2][0])


def _small_msm(ctx: CurveCtx, px, py, pvalid, scalars) -> JPoints:
    """The direct path for small N (the reference's ``_small_msm_impl``,
    msm.py:300-314): every product k_i * P_i by ``ctx.scalar_mul``, then
    their sum.  The reference folds the products with N sequential adds;
    here a ``jadd`` tree adds them (the same affine point, another Jacobian
    representative)."""
    one = ctx.fctx.one_mont(px.device)
    z = torch.where(pvalid[:, None] != 0, one,
                    torch.zeros((), dtype=torch.int32, device=px.device))
    prods = ctx.scalar_mul(scalars, JPoints(px, py, z))
    return _jadd_tree(ctx.ec.jadd, prods)


class MSM:
    """MSM executor for one curve context, over a prime field (G1) or Fq2
    (G2): the context's kernel set and row width carry the difference.

    Problems of at most `small_cutoff` points (after padding) take the
    direct path (``_small_msm``); larger ones go to the sorted-segment
    batched-affine accumulator with window width `affine_c`; problems above
    `max_chunk` points run as chunks of that size, whose Jacobian results
    are added up.  ``CRESCENT_MSM_CHUNK`` overrides `max_chunk`.  (The
    reference's `c` and `lanes` belong to its scan-based Pippenger and come
    with that.)"""

    def __init__(self, curve, small_cutoff: int = 1024, affine_c: int = 11,
                 max_chunk: int = 1 << 17):
        self.ctx = curve if isinstance(curve, CurveCtx) else get_curve_ctx(curve)
        self.small_cutoff = small_cutoff
        self.affine_c = affine_c
        self.max_chunk = int(os.environ.get("CRESCENT_MSM_CHUNK", str(max_chunk)))
        self._affine = None

    def _affine_msm(self) -> AffineMSM:
        if self._affine is None:
            self._affine = AffineMSM(self.ctx, self.ctx.ec, c=self.affine_c)
        return self._affine

    @staticmethod
    def _pad_to(npad, px, py, pvalid, scalars):
        return tuple(pad_rows(a, npad) for a in (px, py, pvalid, scalars))

    # -- device API ---------------------------------------------------------
    def run_device(self, px, py, pvalid, scalars) -> JPoints:
        """px, py: (N, W) Montgomery affine (W = the field's words); pvalid:
        (N,) int32 0/1; scalars: (N, 8) standard-form Fr words.  Returns one
        Jacobian point.  N is padded with invalid lanes to a power of two,
        or above `max_chunk` to whole chunks (the reference pads to a power
        of two there too, to share compiled programs; chunks of padding
        alone add nothing to the sum).  At most `small_cutoff` padded
        points take the direct path, as in the reference."""
        n = px.shape[0]
        npad = 1 << (n - 1).bit_length() if n > 1 else 1
        if npad > self.max_chunk:
            npad = -(-n // self.max_chunk) * self.max_chunk
        px, py, pvalid, scalars = self._pad_to(npad, px, py, pvalid, scalars)
        if npad <= self.small_cutoff:
            return _small_msm(self.ctx, px, py, pvalid, scalars)
        am = self._affine_msm()
        if npad <= self.max_chunk:
            return am.run(px, py, pvalid, scalars)
        ck = self.max_chunk
        parts = [
            am.run(px[i : i + ck], py[i : i + ck], pvalid[i : i + ck],
                   scalars[i : i + ck])
            for i in range(0, npad, ck)
        ]
        return _jadd_tree(self.ctx.ec.jadd,
                          [torch.stack([p[k] for p in parts]) for k in range(3)])

    def run_device_fold(self, problems) -> list[JPoints]:
        """Several QAP-scale MSMs as one fold over chunks of `max_chunk`
        points: every problem is padded to whole chunks, each chunk is one
        ``AffineMSM.run`` of the same shape, and its result is added to its
        problem's accumulator with one ``jadd``.  Nothing here waits for the
        device.

        problems: list of (px, py, pvalid, scalars) device tensors; returns
        one Jacobian JPoints per problem."""
        am = self._affine_msm()
        ck = self.max_chunk
        jadd = self.ctx.ec.jadd
        out = []
        for px, py, pvalid, sc in problems:
            n = px.shape[0]
            acc = tuple(a[None] for a in self.ctx.identity((), px.device))
            for i in range(0, max(n, 1), ck):
                chunk = self._pad_to(ck, px[i : i + ck], py[i : i + ck],
                                     pvalid[i : i + ck], sc[i : i + ck])
                res = am.run(*chunk)
                acc = jadd(*acc, *(a[None] for a in res))
            out.append(JPoints(*(a[0] for a in acc)))
        return out

    # -- host convenience ---------------------------------------------------
    def run_host(self, scalars: list[int], points, device="cuda"):
        """Host scalars and affine points -> the host affine result."""
        P = self.ctx.points_to_device(points, device)
        valid = torch.from_numpy(points_valid(points)).to(device)
        # Fr words whatever the curve's field (the reference's
        # limb.ints_to_limbs, msm.py:539)
        sc = limb.limbs_to_words(limb.ints_to_limbs([s % self.ctx.n for s in scalars]),
                                 device)
        res = self.run_device(P.x, P.y, valid, sc)
        return self.ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]


@functools.lru_cache(maxsize=None)
def get_msm(curve: Curve) -> MSM:
    return MSM(curve)


@functools.lru_cache(maxsize=None)
def get_g2_msm() -> MSM:
    """The G2 MSM over Fq2 (reference msm.py:551-555, whose `c` and `lanes`
    belong to the scan Pippenger, not ported yet)."""
    return MSM(get_g2_ctx())
