"""Windowed fixed-base scalar multiplication on a device: the SRS
generator's loop of Groth16 ``setup``.

Counterpart of ``crescent_tpu/ops/fixed_base.py``, the same computation in
the same order, so its affine results equal the reference's bit for bit.

* One table of 32 x 256 affine points d * 2^(8w) * G (w-major; a dummy
  nonzero multiple for d = 0 keeps the table free of the identity), built
  on the host by the native backend and uploaded as Montgomery rows
  [x | y] (16 words a row over Fq, 32 over Fq2).
* Every scalar gives 32 byte digits (a byte view of its standard-form
  words).  One ``fixed_base`` launch for the whole batch: each lane
  takes its 32 windows in turn, reads the table row of each nonzero digit
  itself and adds it by ``madd``'s lane body into a Jacobian (x, y, z)
  that starts as the identity (``csrc/madd.cuh``); the reference runs the
  same additions as a scan of row gathers and ``madd`` over chunks of
  scalars, which is ``fixed_base_plain``, the CPU's path.  A lane's result
  depends on its scalar only, so the batch is the scalars as given, with
  no padding lanes.
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
from .cuda_ec import NWIN, TSIZE, WBITS
from .ec import CurveCtx
from .limb import NLIMB, NWORD
from .msm_affine import batch_inv


def pec_for(ctx: CurveCtx):
    """The kernel set of a curve context: ``CudaEC`` over a prime field,
    ``CudaQuadEC`` over Fq2 (whose curve must have a = 0)."""
    if ctx.quad and not ctx.a_is_zero:
        raise ValueError("the Fq2 kernels serve curves with a = 0 only")
    return ctx.ec


class FixedBaseMSM:
    """[k_i * G] for one fixed base G, batched on a device."""

    def __init__(self, ctx: CurveCtx):
        self.ctx = ctx
        self.pec = pec_for(ctx)
        self.width = ctx.fctx.nword

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

    # -- conversion -----------------------------------------------------------
    def _to_affine(self, AX, AY, AZ):
        """Jacobian (n, W) planes -> standard-form affine x, y (identity
        rows zeroed) and the (n,) identity mask."""
        pec, f = self.pec, self.ctx.fctx
        n = AX.shape[0]
        dev = AX.device
        p2 = 1 << (n - 1).bit_length()
        inf = f.is_zero(AZ)
        one_m = f.one_mont(dev)
        zm = torch.where(inf[:, None], one_m, AZ)
        if p2 != n:  # the product tree halves down to its floor
            zm = torch.cat([zm, one_m.expand(p2 - n, -1)])
        zi = batch_inv(pec, zm, min(512, p2))[:n]
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
        sc16 = np.ascontiguousarray(scalar_limbs, dtype="<u2").reshape(n, NLIMB)
        sc = torch.from_numpy(sc16.view("<i4").reshape(n, NWORD)).to(device)
        table = self.table_planes(table_pts, device)
        return self._to_affine(*self.pec.fixed_base(table, sc))

    def fetch(self, handle) -> ArrayPointVec:
        """Wait for a ``dispatch`` handle and download it as an
        ``ArrayPointVec`` (standard-form u16 limb planes)."""
        xa, ya, inf = handle
        xs, ys = (a.cpu().numpy().view("<u2") for a in (xa, ya))
        return ArrayPointVec(xs, ys, inf.cpu().numpy(), g2=self.ctx.quad)

    def run(self, table_pts, scalar_limbs: np.ndarray, device="cuda") -> ArrayPointVec:
        """The affine results k_i * G (the identity for k_i == 0)."""
        return self.fetch(self.dispatch(table_pts, scalar_limbs, device))
