"""Windowed fixed-base scalar multiplication on a device: the SRS
generator's loop of Groth16 ``setup``.

Counterpart of ``crescent_tpu/ops/fixed_base.py``, the same computation in
the same order, so its affine results equal the reference's bit for bit.

* One table of 32 x 256 affine points d * 2^(8w) * G (w-major; a dummy
  nonzero multiple for d = 0 keeps the table free of the identity), built
  on the host by the native backend and uploaded as Montgomery rows
  [x | y] (16 words a row over Fq, 32 over Fq2).
* Every scalar gives 32 byte digits (a byte view of its standard-form
  words).  Per chunk of `chunk` scalars and per window, one row gather from
  the table (``index_select``, as the reference gathers outside its kernel)
  and one ``madd`` launch with valid = digit != 0 and sign = 0 accumulate
  into a Jacobian (x, y, z) that starts as the identity.
* Jacobian -> affine for the whole batch at once: the identity mask, padding
  to a power of two with Montgomery 1, one ``batch_inv`` (the product tree,
  one launch on a card), x z^-2 and y z^-3, then a ``mul`` by standard-form 1
  (de-Montgomery) and zeroed identity rows.  Results leave the device as
  standard-form limb planes, an ``ArrayPointVec``.

The same code serves G1 (``CudaEC``) and G2 (``CudaQuadEC``): the kernel set
is the curve context's (``pec_for``), and a row is ``ctx.fctx.nword`` words.
``dispatch`` enqueues and returns at once; ``fetch`` waits and downloads, so
a caller can queue both groups before it fetches either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.pointvec import ArrayPointVec
from .ec import CurveCtx
from .limb import NLIMB, NWORD
from .msm_affine import batch_inv

WBITS = 8
NWIN = NLIMB * 16 // WBITS  # 32 byte windows cover a 256-bit scalar
TSIZE = 1 << WBITS


def pec_for(ctx: CurveCtx):
    """The kernel set of a curve context: ``CudaEC`` over a prime field,
    ``CudaQuadEC`` over Fq2 (whose curve must have a = 0)."""
    if ctx.quad and not ctx.a_is_zero:
        raise ValueError("the Fq2 kernels serve curves with a = 0 only")
    return ctx.ec


class FixedBaseMSM:
    """[k_i * G] for one fixed base G, batched on a device."""

    def __init__(self, ctx: CurveCtx, chunk: int = 1 << 16):
        self.ctx = ctx
        self.pec = pec_for(ctx)
        self.width = ctx.fctx.nword
        self.chunk = chunk

    # -- table --------------------------------------------------------------
    def table_scalars(self) -> list[int]:
        """Scalars whose base multiples form the window table, w-major:
        entry w*256 + d holds max(d, 1) << 8w mod n (d == 0 lanes are
        masked when accumulating)."""
        n = self.ctx.n
        return [(max(d, 1) << (WBITS * w)) % n for w in range(NWIN) for d in range(TSIZE)]

    def table_planes(self, table_pts, device) -> torch.Tensor:
        """8192 affine host points (w-major, from ``table_scalars``) -> one
        (8192, 2W) plane of Montgomery rows [x | y] on `device`."""
        if len(table_pts) != NWIN * TSIZE:
            raise ValueError(f"the table holds {NWIN * TSIZE} points, got {len(table_pts)}")
        P = self.ctx.points_to_device(table_pts, device)
        return torch.cat([P.x, P.y], dim=1)

    # -- accumulation and conversion ----------------------------------------
    def _accumulate(self, table: torch.Tensor, sc: torch.Tensor):
        """One chunk: (ck, 8) standard-form scalar words -> Jacobian
        (x, y, z) planes of (ck, W)."""
        W = self.width
        ck = sc.shape[0]
        dev = sc.device
        digits = sc.view(torch.uint8).to(torch.int64).T  # (32, ck): byte w of each scalar
        rows = (digits + torch.arange(NWIN, dtype=torch.int64, device=dev)[:, None]
                * TSIZE).contiguous()
        valid = (digits != 0).to(torch.int32).contiguous()
        sign = torch.zeros(ck, dtype=torch.int32, device=dev)
        zero = torch.zeros((ck, W), dtype=torch.int32, device=dev)
        acc = (zero, zero, zero)  # the identity: Z == 0
        for w in range(NWIN):
            g = table.index_select(0, rows[w])
            acc = self.pec.madd(*acc, g[:, :W], g[:, W:], valid[w], sign)
        return acc

    def _to_affine(self, AX, AY, AZ):
        """Jacobian (npad, W) planes -> standard-form affine x, y (identity
        rows zeroed) and the (npad,) identity mask."""
        pec, f = self.pec, self.ctx.fctx
        npad = AX.shape[0]
        dev = AX.device
        p2 = 1 << (npad - 1).bit_length()
        inf = f.is_zero(AZ)
        one_m = f.one_mont(dev)
        zm = torch.where(inf[:, None], one_m, AZ)
        if p2 != npad:  # the product tree halves down to its floor
            zm = torch.cat([zm, one_m.expand(p2 - npad, -1)])
        zi = batch_inv(pec, zm, min(512, p2))[:npad]
        zi2 = pec.mul(zi, zi)
        xa = pec.mul(AX, zi2)
        ya = pec.mul(AY, pec.mul(zi2, zi))
        # de-Montgomery: a product by standard-form 1 (1 + 0u over Fq2)
        one_s = torch.zeros((1, self.width), dtype=torch.int32, device=dev)
        one_s[0, 0] = 1
        pec.mul(xa, one_s, out=xa)
        pec.mul(ya, one_s, out=ya)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (torch.where(inf[:, None], zero, xa),
                torch.where(inf[:, None], zero, ya), inf)

    # -- entry --------------------------------------------------------------
    def dispatch(self, table_pts, scalar_limbs: np.ndarray, device="cuda"):
        """Upload the table and the scalars and enqueue the whole batch;
        returns a handle at once (nothing here waits for the device).
        scalar_limbs: (N, 16) standard-form 16-bit limbs (u16 or u32),
        reduced mod the group order."""
        device = torch.device(device)
        n = int(scalar_limbs.shape[0])
        if n == 0:
            raise ValueError("no scalars")
        ck = min(self.chunk, 1 << (n - 1).bit_length() if n > 1 else 1)
        nchunks = -(-n // ck)
        npad = nchunks * ck
        sc16 = np.zeros((npad, NLIMB), dtype="<u2")
        sc16[:n] = scalar_limbs
        sc = torch.from_numpy(sc16.view("<i4").reshape(npad, NWORD)).to(device)
        table = self.table_planes(table_pts, device)
        W = self.width
        AX, AY, AZ = (torch.empty((npad, W), dtype=torch.int32, device=device)
                      for _ in range(3))
        for c in range(nchunks):
            s = slice(c * ck, (c + 1) * ck)
            for dst, src in zip((AX, AY, AZ), self._accumulate(table, sc[s])):
                dst[s] = src
        xa, ya, inf = self._to_affine(AX, AY, AZ)
        return xa, ya, inf, n

    def fetch(self, handle) -> ArrayPointVec:
        """Wait for a ``dispatch`` handle and download it as an
        ``ArrayPointVec`` (standard-form u16 limb planes)."""
        xa, ya, inf, n = handle
        xs, ys = (np.ascontiguousarray(a[:n].cpu().numpy()).view("<u2") for a in (xa, ya))
        return ArrayPointVec(xs, ys, inf[:n].cpu().numpy(), g2=self.ctx.quad)

    def run(self, table_pts, scalar_limbs: np.ndarray, device="cuda") -> ArrayPointVec:
        """The affine results k_i * G (the identity for k_i == 0)."""
        return self.fetch(self.dispatch(table_pts, scalar_limbs, device))
