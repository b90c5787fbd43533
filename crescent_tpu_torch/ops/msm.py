"""Multi-scalar multiplication on one device.

Counterpart of ``crescent_tpu/ops/msm.py``: MSMs over G1 (``get_msm``) or
over G2, whose field is Fq2 (``get_g2_msm``), one problem at a time
(``run_device``), a batch of problems (``run_device_many``), or several
QAP-scale problems as one fold over fixed-shape chunks
(``run_device_fold``).  Problems of at most ``small_cutoff`` points take
the direct path (``_small_msm``: a batched double-and-add, then a tree of
``jadd``), larger ones the sorted-segment batched-affine accumulator
(``ops/msm_affine.py``) or, with it off, the scan Pippenger below.

The scan Pippenger (the reference's ``_msm_impl``), window width ``c``:

  * phase 1: L lanes of local buckets, (L, W, B) points with W = ceil(256 /
    c) + 1 signed windows and B = 2^(c-1) + 1 buckets; each of ceil(N / L)
    steps gathers the buckets its points' digits name, adds the points in
    one ``madd`` launch over L * W lanes (a negative digit by ``madd``'s
    sign flag) and scatters the sums back.  Within a step the (lane,
    window, bucket) triples are distinct, so no two sums meet in a bucket;
  * phase 2: the L lanes folded, one ``jadd`` launch over W * B lanes a
    lane;
  * phase 3: per-window suffix sums, B - 1 steps of two ``jadd`` launches
    over W lanes;
  * phase 4: Horner over the windows, top first: c doublings (one
    ``jdbl_n`` launch) and one ``jadd`` a window.

The gathers and scatters are plain PyTorch indexing, as they are XLA
outside the kernel in the reference.  A batch of P problems runs as one:
its lanes are P * L, so every ``madd`` launch of phase 1 serves all P.

Switches, read as the reference reads them (any other value is the
default): ``CRESCENT_MSM_AFFINE=0`` turns the affine accumulator off;
``CRESCENT_MSM_PALLAS=0`` turns it off too and makes phases 1-2 take the
reference's XLA form (``_accumulate_buckets``: the sign applied by a
negation and a select, ``CurveCtx.add_mixed`` and ``add``) instead of the
kernel form (``_accumulate_buckets_kernel``); both run the same kernels
and give the same buckets.

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
    """Sum over the first axis of a batch of Jacobian points (three (n, ...,
    W) planes) by a tree of ``jadd`` levels: the first half plus the
    second, an odd last row carried to the next level.  Returns (..., W)
    planes."""
    acc = list(acc)
    w = acc[0].shape[-1]
    while acc[0].shape[0] > 1:
        h = acc[0].shape[0] // 2
        lo = jadd(*(a[:h].reshape(-1, w) for a in acc),
                  *(a[h : 2 * h].reshape(-1, w) for a in acc))
        acc = [torch.cat([l.reshape(a[:h].shape), a[2 * h :]]) for l, a in zip(lo, acc)]
    return JPoints(acc[0][0], acc[1][0], acc[2][0])


def _small_msm(ctx: CurveCtx, px, py, pvalid, scalars) -> JPoints:
    """The direct path for small N (the reference's ``_small_msm_impl``,
    msm.py:300-314): every product k_i * P_i by ``ctx.scalar_mul``, then
    their sum.  px, py: (..., N, W), a batch of problems along the leading
    axes.  The reference folds the products with N sequential adds; here a
    ``jadd`` tree adds them (the same affine point, another Jacobian
    representative)."""
    one = ctx.fctx.one_mont(px.device)
    z = torch.where(pvalid[..., None] != 0, one,
                    torch.zeros((), dtype=torch.int32, device=px.device))
    prods = ctx.scalar_mul(scalars, JPoints(px, py, z))
    return _jadd_tree(ctx.ec.jadd, (p.movedim(-2, 0) for p in prods))


def _kernel_accumulate() -> bool:
    """Whether phases 1-2 take the kernel form, by CRESCENT_MSM_PALLAS (the
    reference's switch, msm.py:52): "0" the reference's XLA form."""
    return os.environ.get("CRESCENT_MSM_PALLAS", "1") != "0"


def _bucket_scan(ctx: CurveCtx, px, py, pvalid, digits, signs, c: int, lanes: int,
                 step_add):
    """Phase 1 over P problems: px, py (P, N, W) Montgomery affine, pvalid
    (P, N), digits and signs (P, N, Wd) from ``scalar_digits_signed``.
    Points are padded with invalid rows to steps * L; point j of a problem
    goes to lane j % L at step j // L.  Each step gathers the P * L * Wd
    buckets its digits name from the flat bucket planes and stores
    step_add(cur, sx, sy, valid, sign) there: cur the gathered Jacobian
    planes, sx, sy the step's (P, L, W) points, valid and sign the flat
    int32 flags of its (problem, lane, window) rows (digit 0 and invalid
    points: valid 0).  The rows, flags and points of every step are made
    before the loop.  Returns the bucket planes as (P, L, Wd * B, W), B =
    2^(c-1) + 1, and Wd, B."""
    P, N, w = px.shape
    Wd = digits.shape[2]
    B = (1 << (c - 1)) + 1
    L = min(lanes, N)
    steps = -(-N // L)
    dev = px.device

    def by_step(a):
        """(P, N, ...) -> (steps, P, L, ...), padded with zero rows."""
        a = torch.cat([a, torch.zeros((P, steps * L - N) + a.shape[2:], dtype=a.dtype,
                                      device=dev)], dim=1) if steps * L != N else a
        return a.reshape((P, steps, L) + a.shape[2:]).transpose(0, 1).contiguous()

    px, py, pvalid, digits, signs = map(by_step, (px, py, pvalid, digits, signs))
    # the flat row of bucket 0 of every (problem, lane, window)
    first = torch.arange(P * L * Wd, dtype=I64, device=dev).reshape(P, L, Wd) * B
    rows = (first + digits).reshape(steps, -1)
    valid = ((digits != 0) & (pvalid[..., None] != 0)).to(torch.int32).reshape(steps, -1)
    signs = signs.to(torch.int32).reshape(steps, -1)
    planes = list(ctx.identity((P * L * Wd * B,), dev))
    for s in range(steps):
        new = step_add([t[rows[s]] for t in planes], px[s], py[s], valid[s], signs[s])
        for t, v in zip(planes, new):
            t[rows[s]] = v
    return [t.reshape(P, L, Wd * B, w) for t in planes], Wd, B


def _windows(a: torch.Tensor, Wd: int) -> torch.Tensor:
    """(P, L, W) point rows -> the (P * L * Wd, W) rows of every window."""
    P, L, w = a.shape
    return a[:, :, None, :].expand(P, L, Wd, w).reshape(-1, w)


def _accumulate_buckets(ctx: CurveCtx, px, py, pvalid, digits, signs, c: int,
                        lanes: int) -> JPoints:
    """Pippenger phases 1-2 in the reference's XLA form (msm.py:121-190):
    each point negated once, the sign applied by a select, the buckets
    updated by ``ctx.add_mixed`` and the lanes folded by ``ctx.add``.
    Arguments as ``_bucket_scan``'s; returns a (P, Wd, B) bucket set whose
    bucket b holds the sum of the points with |digit| == b."""
    f = ctx.fctx
    Wd = digits.shape[2]

    def step_add(cur, sx, sy, valid, sign):
        qy = f.select(sign, _windows(f.neg_mod(sy), Wd), _windows(sy, Wd))
        return ctx.add_mixed(JPoints(*cur), _windows(sx, Wd), qy, valid)

    planes, Wd, B = _bucket_scan(ctx, px, py, pvalid, digits, signs, c, lanes, step_add)
    P, L = planes[0].shape[:2]
    wb = ctx.identity((P, Wd * B), px.device)
    for lane in range(L):
        wb = ctx.add(wb, JPoints(*(t[:, lane] for t in planes)))
    return JPoints(*(t.reshape(P, Wd, B, -1) for t in wb))


def _accumulate_buckets_kernel(ctx: CurveCtx, px, py, pvalid, digits, signs, c: int,
                               lanes: int) -> JPoints:
    """Pippenger phases 1-2 in the kernel form (the reference's
    ``_accumulate_buckets_pallas``, msm.py:225-284): one ``madd`` launch a
    step over P * L * Wd lanes with the digits' sign flags, then the lanes
    folded by one ``jadd`` launch each over P * Wd * B lanes.  The same
    buckets as ``_accumulate_buckets``."""
    ec = ctx.ec
    Wd = digits.shape[2]

    def step_add(cur, sx, sy, valid, sign):
        return ec.madd(*cur, _windows(sx, Wd), _windows(sy, Wd), valid, sign)

    planes, Wd, B = _bucket_scan(ctx, px, py, pvalid, digits, signs, c, lanes, step_add)
    P, L, _, w = planes[0].shape
    acc = [t.reshape(-1, w) for t in ctx.identity((P * Wd * B,), px.device)]
    for lane in range(L):
        acc = ec.jadd(*acc, *(t[:, lane].reshape(-1, w) for t in planes))
    return JPoints(*(t.reshape(P, Wd, B, w) for t in acc))


def _aggregate_buckets(ctx: CurveCtx, wb: JPoints, c: int) -> JPoints:
    """Pippenger phases 3-4 (msm.py:193-222): per-window suffix sums, then
    Horner over the windows.  wb: (P, Wd, B) bucket set -> (P,) Jacobian
    points."""
    P, Wd, B, w = wb.x.shape
    dev = wb.x.device
    # running_d = sum_{b >= d} bucket_b; acc = sum_{d >= 1} running_d
    running = acc = ctx.identity((P, Wd), dev)
    for d in range(B - 1):
        running = ctx.add(running, JPoints(*(t[:, :, B - 1 - d] for t in wb)))
        acc = ctx.add(acc, running)
    # res = 2^c res + acc[w], the top window first (doubling the identity
    # is the identity, so the first needs no special case)
    res = ctx.identity((P,), dev)
    for i in range(Wd - 1, -1, -1):
        res = JPoints(*ctx.ec.jdbl_n(*(t.contiguous() for t in res), c))
        res = ctx.add(res, JPoints(*(t[:, i] for t in acc)))
    return res


def _msm_impl(ctx: CurveCtx, px, py, pvalid, digits, signs, c: int, lanes: int) -> JPoints:
    """The scan Pippenger over P problems given their signed digits
    (msm.py:287-297); returns (P,) Jacobian points.  Over Fq2 too: the Fq2
    ``madd`` and ``jadd`` serve G2 as the Fq ones serve G1."""
    acc = _accumulate_buckets_kernel if _kernel_accumulate() else _accumulate_buckets
    return _aggregate_buckets(ctx, acc(ctx, px, py, pvalid, digits, signs, c, lanes), c)


class MSM:
    """MSM executor for one curve context, over a prime field (G1) or Fq2
    (G2): the context's kernel set and row width carry the difference.

    Problems of at most `small_cutoff` points (after padding) take the
    direct path (``_small_msm``); larger ones go to the sorted-segment
    batched-affine accumulator with window width `affine_c`, whose problems
    above `max_chunk` points run as chunks of that size, their Jacobian
    results added up (``CRESCENT_MSM_CHUNK`` overrides `max_chunk`); with
    the accumulator off (``CRESCENT_MSM_AFFINE=0`` or
    ``CRESCENT_MSM_PALLAS=0``), to the scan Pippenger of window width `c`
    on at most `lanes` lanes."""

    def __init__(self, curve, c: int = 8, lanes: int = 256, small_cutoff: int = 1024,
                 affine_c: int = 11, max_chunk: int = 1 << 17):
        self.ctx = curve if isinstance(curve, CurveCtx) else get_curve_ctx(curve)
        self.c = c
        self.lanes = lanes
        self.small_cutoff = small_cutoff
        self.affine_c = affine_c
        self.max_chunk = int(os.environ.get("CRESCENT_MSM_CHUNK", str(max_chunk)))
        self._affine = None

    def _affine_msm(self) -> AffineMSM | None:
        """The affine accumulator, or None where CRESCENT_MSM_AFFINE or
        CRESCENT_MSM_PALLAS is "0" (msm.py:351-363: the reference's
        accumulator needs its kernels, which the second switch turns
        off)."""
        if os.environ.get("CRESCENT_MSM_AFFINE", "1") == "0" or not _kernel_accumulate():
            return None
        if self._affine is None:
            self._affine = AffineMSM(self.ctx, self.ctx.ec, c=self.affine_c)
        return self._affine

    def _lanes_for(self, n: int) -> int:
        """Phase 1's lanes: at most `lanes`, and at most n / 2^c, so that the
        lane fold (L * Wd * B additions) stays below the accumulation's
        (n * Wd)."""
        return max(1, min(self.lanes, n >> self.c))

    def _get_impl(self, lanes: int, many: bool):
        """The scan Pippenger on `lanes` lanes over a batch of problems, or,
        with many False, over one (no problem axis)."""
        impl = functools.partial(_msm_impl, self.ctx, c=self.c, lanes=lanes)
        if many:
            return impl

        def one(px, py, pvalid, digits, signs):
            res = impl(*(a[None] for a in (px, py, pvalid, digits, signs)))
            return JPoints(*(t[0] for t in res))

        return one

    def _digits(self, scalars):
        """Signed digits of (..., N, 8) scalar words, (..., N, Wd) each."""
        d, s = scalar_digits_signed(scalars.reshape(-1, scalars.shape[-1]), self.c)
        return d.reshape(scalars.shape[:-1] + (-1,)), s.reshape(scalars.shape[:-1] + (-1,))

    @staticmethod
    def _pad_to(npad, px, py, pvalid, scalars):
        return tuple(pad_rows(a, npad) for a in (px, py, pvalid, scalars))

    # -- device API ---------------------------------------------------------
    def run_device(self, px, py, pvalid, scalars) -> JPoints:
        """px, py: (N, W) Montgomery affine (W = the field's words); pvalid:
        (N,) int32 0/1; scalars: (N, 8) standard-form Fr words.  Returns one
        Jacobian point.  N is padded with invalid lanes to a power of two,
        or on the affine route above `max_chunk` to whole chunks (the
        reference pads to a power of two there too, to share compiled
        programs; chunks of padding alone add nothing to the sum).  At most
        `small_cutoff` padded points take the direct path, as in the
        reference."""
        n = px.shape[0]
        npad = 1 << (n - 1).bit_length() if n > 1 else 1
        if npad <= self.small_cutoff:
            return _small_msm(self.ctx, *self._pad_to(npad, px, py, pvalid, scalars))
        am = self._affine_msm()
        if am is None:
            px, py, pvalid, scalars = self._pad_to(npad, px, py, pvalid, scalars)
            return self._get_impl(self._lanes_for(npad), many=False)(
                px, py, pvalid, *self._digits(scalars))
        if npad > self.max_chunk:
            npad = -(-n // self.max_chunk) * self.max_chunk
        px, py, pvalid, scalars = self._pad_to(npad, px, py, pvalid, scalars)
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

    def run_device_many(self, problems) -> JPoints:
        """A batch of independent MSMs (msm.py:433-453): problems is a list
        of (px, py, pvalid, scalars) as ``run_device`` takes them, each
        padded to one power of two, the largest's.  Returns JPoints with a
        leading axis of len(problems).  Small problems run as one batched
        direct path; on the affine route the problems run one after
        another, as the reference's do; on the scan route as one batch
        along the lane axis, every ``madd`` launch serving all of them
        (what the reference's vmap compiles to)."""
        nmax = max(p[0].shape[0] for p in problems)
        npad = 1 << (nmax - 1).bit_length() if nmax > 1 else 1
        padded = [self._pad_to(npad, *p) for p in problems]
        if npad <= self.small_cutoff:
            return _small_msm(self.ctx, *(torch.stack(a) for a in zip(*padded)))
        if self._affine_msm() is not None:
            outs = [self.run_device(*p) for p in padded]
            return JPoints(*(torch.stack(a) for a in zip(*outs)))
        pxs, pys, vals, scs = (torch.stack(a) for a in zip(*padded))
        return self._get_impl(self._lanes_for(npad), many=True)(
            pxs, pys, vals, *self._digits(scs))

    def run_device_fold(self, problems) -> list[JPoints] | None:
        """Several QAP-scale MSMs as one fold over chunks of `max_chunk`
        points: every problem is padded to whole chunks, each chunk is one
        ``AffineMSM.run`` of the same shape, and its result is added to its
        problem's accumulator with one ``jadd``.  Nothing here waits for the
        device.  None where the affine route is off (the caller falls back,
        msm.py:502-504).

        problems: list of (px, py, pvalid, scalars) device tensors; returns
        one Jacobian JPoints per problem."""
        am = self._affine_msm()
        if am is None:
            return None
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
def get_msm(curve: Curve, c: int = 8, lanes: int = 128) -> MSM:
    return MSM(curve, c, lanes)


@functools.lru_cache(maxsize=None)
def get_g2_msm(c: int = 8, lanes: int = 64) -> MSM:
    """The G2 MSM over Fq2 (msm.py:551-555)."""
    return MSM(get_g2_ctx(), c, lanes)
