"""Sorted-segment batched-affine Pippenger MSM on one device.

Counterpart of ``crescent_tpu/ops/msm_affine.py``: the same pipeline, the
same operations in the same order, so a chunk's Jacobian result equals the
reference's (x, y, z) bit for bit.

  1. signed window digits -> one flat entry per (point, window), keyed by
     (window, bucket) with the entry's validity in the key's low bit; the
     payload is ``point_index << 1 | sign``;
  2. one stable sort by key groups the entries of a bucket into a
     contiguous segment;
  3. ceil(log4(M)) rounds of 4-ary segmented reduction: a round finds the
     rank-quads of every segment, runs two levels of batched affine pair
     addition (``affine_denom`` -> one product-tree inversion shared by the
     level, ``batch_inv``, one launch -> ``affine_add``), and compacts
     the survivors by gather.  Array sizes follow a static worst-case
     schedule (``_round_schedule``), so no shape depends on the data;
  4. the survivors scatter into a dense (W, B) bucket table; per-window
     suffix sums are shift-add rounds of ``jadd``, the bucket weighting a
     halving tree (both one ``bucket_reduce`` launch under
     ``CRESCENT_MSM_FUSED_AGG=1``), and the windows combine by a doubling
     tree whose chains are single ``jdbl_n`` launches.

Everything outside the point kernels and ``batch_inv`` is plain PyTorch, as
it is plain XLA in the reference.  Where the reference compiles the whole MSM
into one program, PyTorch enqueues it launch by launch; the property kept is
that nothing between the inputs and the result waits for the device: no
``.item()``, no ``nonzero``, no boolean-mask indexing.

Layout: coordinates are packed (N, W) word planes, W = 8 over a prime
field and 16 over Fq2 (the context's ``fctx.nword``; the reference's
``rows`` planes of 16 or 32 limbs), so a lane range is a row range and
slicing lanes copies nothing.  Keys, payloads and positions are
int64 (they index tensors); they stay far below 2^31.
"""

from __future__ import annotations

import os

import torch

from .cuda_ec import bucket_levels
from .ec import CurveCtx, JPoints

I64 = torch.int64


def batch_inv(pec, d: torch.Tensor, inv_floor: int = 512) -> torch.Tensor:
    """Montgomery product-tree inversion of an (n, W) plane of nonzero
    values (W = 8 with a ``CudaEC``, 16 over Fq2 with a ``CudaQuadEC``):
    the reference's tree of ``mul`` with ``inv`` on its root level, one
    ``batch_inv`` launch on a card (a block a root), the tree itself on the
    CPU.  n must halve evenly down to inv_floor (callers pad; a power of two
    always works)."""
    return pec.batch_inv(d, inv_floor)


def quantize(n: int, floor: int = 512) -> int:
    """Round up into the quarter-power-of-two family {2^k * (4+i)/4}.
    Halving a family member stays in the family, so the product-tree levels
    of every round halve evenly."""
    n = max(int(n), 1)
    if n <= floor:
        return floor
    q = 1 << max(int(n - 1).bit_length() - 2, 0)
    return -(-n // q) * q


def pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """a with zero rows appended up to n rows."""
    if a.shape[0] == n:
        return a
    z = torch.zeros((n - a.shape[0],) + a.shape[1:], dtype=a.dtype, device=a.device)
    return torch.cat([a, z])


def _rank_in_segment(seg: torch.Tensor) -> torch.Tensor:
    """Position of every entry within its run of equal `seg` values.  `seg`
    is non-decreasing (the sort's order, which every round's compaction
    keeps, with the sentinel, the largest key, behind the last head), so a
    run starts at the first index holding its value: a binary search where
    the reference takes a running maximum over the run starts."""
    i = torch.arange(seg.shape[0], dtype=I64, device=seg.device)
    return i - torch.searchsorted(seg, seg)


def _head_positions(rank: torch.Tensor, mn: int) -> torch.Tensor:
    """Positions of the quad heads (rank % 4 == 0) in order, then the other
    positions in order, cut to mn."""
    not_head = ((rank & 3) != 0).to(torch.uint8)
    return torch.sort(not_head, stable=True).indices[:mn]


class AffineMSM:
    """Segmented-affine MSM executor for one curve context: `pec` is its
    kernel set (``CudaEC``, or ``CudaQuadEC`` over Fq2)."""

    def __init__(self, ctx: CurveCtx, pec, c: int = 11,
                 min_bucket: int = 512, inv_floor: int = 512):
        self.ctx = ctx
        self.pec = pec
        self.nword = ctx.fctx.nword  # int32 words per coordinate
        self.c = c
        self.min_bucket = min_bucket
        self.inv_floor = inv_floor
        self.B = (1 << (c - 1)) + 1          # signed digits: |d| <= 2^(c-1)
        self.W = (256 + c - 1) // c + 1      # +1 carry window
        self.sentinel = self.W * self.B

    def _batch_inv(self, d):
        return batch_inv(self.pec, d, self.inv_floor)

    # -- one 4-ary reduction round --------------------------------------------
    def _pair_levels(self, parts, mn: int):
        """Two levels of batched affine pair addition over the four quad
        parts [(x, y, valid)] * 4.  Returns the survivors (x, y, valid)."""
        pec = self.pec
        lx = torch.cat([parts[0][0], parts[2][0]])
        ly = torch.cat([parts[0][1], parts[2][1]])
        lv = torch.cat([parts[0][2], parts[2][2]])
        rx = torch.cat([parts[1][0], parts[3][0]])
        ry = torch.cat([parts[1][1], parts[3][1]])
        rv = torch.cat([parts[1][2], parts[3][2]])
        d = pec.affine_denom(lx, ly, lv, rx, ry, rv)
        sx, sy, sv = pec.affine_add(lx, ly, lv, rx, ry, rv, self._batch_inv(d))
        ax, bx = sx[:mn], sx[mn:]
        ay, by = sy[:mn], sy[mn:]
        av, bv = sv[:mn], sv[mn:]
        d2 = pec.affine_denom(ax, ay, av, bx, by, bv)
        return pec.affine_add(ax, ay, av, bx, by, bv, self._batch_inv(d2))

    def _next_keys(self, in_r, kseg, nv):
        return torch.where(in_r, kseg * 2 + nv.to(I64),
                           torch.full_like(kseg, 2 * self.sentinel))

    def _round(self, pk, ex, ey, mn: int):
        """One 4-ary reduction round on survivor arrays (rounds >= 2).
        pk: (m,) packed keys (key << 1 | valid); ex, ey: (m, nword)."""
        m = pk.shape[0]
        seg = pk >> 1
        rank = _rank_in_segment(seg)
        hp = _head_positions(rank, mn)
        kaug = seg << 3 | (rank & 3) << 1 | (pk & 1)
        g0 = None
        parts = []
        for t in range(4):
            pos = torch.clamp(hp + t, max=m - 1)
            g = kaug[pos]
            if t == 0:
                g0 = g
            ok = (hp + t < m) & (((g >> 1) & 3) == t)
            parts.append((ex[pos], ey[pos], (ok & ((g & 1) != 0)).to(torch.int32)))
        # the segment id rides in the key word's high bits
        kseg = g0 >> 3
        in_r = ((g0 >> 1) & 3) == 0
        nx, ny, nv = self._pair_levels(parts, mn)
        return self._next_keys(in_r, kseg, nv), nx, ny

    def _round1(self, spk, spay, tx, ty, mn: int, n: int):
        """First reduction round: coordinates come straight from the point
        table through the sorted payload.  tx, ty: (2n, nword), row j the point
        (x, y) and row n + j its negative (x, -y).

        The rank in the segment mod 4 decides quad membership (position
        hp + t belongs to the quad of head hp iff its rank is t mod 4: a new
        segment inside the quad resets the rank below t), so payload, rank
        bits and validity pack into one word per entry,
            paug = point_index << 4 | sign << 3 | (rank & 3) << 1 | valid,
        and a quad slot costs one gather of that word and one of each
        coordinate."""
        m = spk.shape[0]
        assert 2 * (self.sentinel + 1) < 1 << 31 and n < 1 << 27 and m < 1 << 31
        seg = spk >> 1
        rank = _rank_in_segment(seg)
        hp = _head_positions(rank, mn)
        paug = (spay >> 1) << 4 | (spay & 1) << 3 | (rank & 3) << 1 | (spk & 1)
        kseg = seg[hp]
        g0 = None
        parts = []
        for t in range(4):
            pos = torch.clamp(hp + t, max=m - 1)
            g = paug[pos]
            if t == 0:
                g0 = g
            ok = (hp + t < m) & (((g >> 1) & 3) == t)
            idx = (g >> 4) + ((g >> 3) & 1) * n
            parts.append((tx[idx], ty[idx], (ok & ((g & 1) != 0)).to(torch.int32)))
        in_r = ((g0 >> 1) & 3) == 0  # hp points at a real quad head
        nx, ny, nv = self._pair_levels(parts, mn)
        return self._next_keys(in_r, kseg, nv), nx, ny

    # -- bucket aggregation -----------------------------------------------------
    def _scatter_dense(self, pk, ex, ey, fused: bool = False):
        """Survivors -> dense Jacobian bucket tables, three (W*B, nword)
        planes; for the fused aggregate, windows ``pec.bucket_stride(B)``
        rows apart (the rows past B of a window stay the identity).  A
        survivor that is not valid writes to one spare row, which is cut
        off."""
        W, B = self.W, self.B
        dev = pk.device
        ev = pk & 1
        keys = pk >> 1
        if fused:
            Bp = self.pec.bucket_stride(B)
            kw = keys // B
            tgt = kw * Bp + (keys - kw * B)
        else:
            Bp, tgt = B, keys
        WB = W * Bp
        idx = torch.where(ev != 0, tgt, torch.full_like(pk, WB))
        dx = torch.zeros((WB + 1, self.nword), dtype=torch.int32, device=dev)
        dy = torch.zeros((WB + 1, self.nword), dtype=torch.int32, device=dev)
        dv = torch.zeros(WB + 1, dtype=I64, device=dev)
        dx[idx] = ex
        dy[idx] = ey
        dv[idx] = ev
        one = self.ctx.fctx.one_mont(dev)
        dz = torch.where(dv[:WB, None] != 0, one,
                         torch.zeros((), dtype=torch.int32, device=dev))
        return dx[:WB], dy[:WB], dz

    def _aggregate(self, pk, ex, ey):
        """Dense (W, B) table -> suffix sums -> bucket weighting -> window
        combine.  Returns one Jacobian point as three (nword,) rows.  Under
        CRESCENT_MSM_FUSED_AGG=1 the suffix sums and the weighting are one
        ``bucket_reduce`` launch, else one ``jadd`` launch a level."""
        fused = os.environ.get("CRESCENT_MSM_FUSED_AGG", "0") == "1"
        return self._aggregate_dense(*self._scatter_dense(pk, ex, ey, fused), fused)

    def _aggregate_dense(self, dx, dy, dz, fused: bool = False):
        W, c = self.W, self.c
        pec = self.pec
        nw = self.nword
        if fused:
            acc = pec.bucket_reduce(dx, dy, dz, W, self.B)
        else:
            acc = bucket_levels(pec.jadd, dx, dy, dz, W, self.B)

        # window combine: sum_w acc_w * 2^(c*w) by a doubling tree: level j
        # pairs (2t, 2t+1) with the odd half doubled c*2^j times (padded
        # with the identity up to a power of two)
        Wp = 1 << (W - 1).bit_length()
        pad = torch.zeros((Wp - W, nw), dtype=torch.int32, device=dx.device)
        acc = [torch.cat([a, pad]) for a in acc]
        shift_bits = c
        while Wp > 1:
            odd = pec.jdbl_n(*(a[1::2].contiguous() for a in acc), count=shift_bits)
            acc = list(pec.jadd(*(a[0::2].contiguous() for a in acc), *odd))
            shift_bits *= 2
            Wp //= 2
        return acc[0][0], acc[1][0], acc[2][0]

    # -- full program -----------------------------------------------------------
    def _round_schedule(self, n: int) -> list[int]:
        """Static survivor-count schedule for an n-point problem."""
        W, B = self.W, self.B
        m0 = n * W
        # survivors <= m/4 + 3/4 * (#segments + 1)
        slack = (3 * (W * B + 2)) // 4 + 64
        rounds = []
        m = m0
        max_seg = m0
        while max_seg > 1:
            # clamp: the compaction cuts the head positions to mn, so a
            # round may not grow (worst-case schedules of tiny problems)
            m = min(quantize(m // 4 + slack, self.min_bucket), m)
            rounds.append(m)
            max_seg = -(-max_seg // 4)
        return rounds

    def _survivors(self, px, py, pvalid, scalars, n: int):
        """Recode, sort, 4-ary reduction rounds.  Returns the survivor
        arrays (pk, ex, ey) for `_aggregate`."""
        from .msm import scalar_digits_signed

        W, B, sentinel = self.W, self.B, self.sentinel
        dev = px.device
        digits, signs = scalar_digits_signed(scalars, self.c)
        neg_py = self.ctx.fctx.neg_mod(py)
        tx = torch.cat([px, px])
        ty = torch.cat([py, neg_py])  # row j: (x, y); row n + j: (x, -y)
        valid = (digits != 0) & (pvalid[:, None] != 0)
        keys = torch.where(
            valid,
            torch.arange(W, dtype=I64, device=dev)[None, :] * B + digits,
            torch.full_like(digits, sentinel),
        )
        pk = keys * 2 + valid.to(I64)
        pay = (torch.arange(n, dtype=I64, device=dev)[:, None] << 1) | signs
        spk, order = torch.sort(pk.reshape(-1), stable=True)
        spay = pay.reshape(-1)[order]
        ex = ey = None
        for i, mn in enumerate(self._round_schedule(n)):
            if i == 0:
                spk, ex, ey = self._round1(spk, spay, tx, ty, mn, n)
            else:
                spk, ex, ey = self._round(spk, ex, ey, mn)
        return spk, ex, ey

    def run(self, px, py, pvalid, scalars) -> JPoints:
        """px, py: (N, nword) Montgomery affine coordinates; pvalid: (N,)
        0/1; scalars: (N, 8) standard-form Fr words.  Returns one Jacobian
        point with (nword,) coordinates.  Nothing here waits for the
        device."""
        nq = quantize(px.shape[0], self.min_bucket)
        px, py, pvalid, scalars = (pad_rows(a, nq) for a in (px, py, pvalid, scalars))
        return JPoints(*self._aggregate(*self._survivors(px, py, pvalid, scalars, nq)))
