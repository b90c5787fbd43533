"""Fq2 = Fq[u]/(u^2 + 1) on PyTorch tensors: the port's counterpart of
``crescent_tpu/ops/quadratic.py`` (whose module imports jax).

Layout.  An element is one row of sixteen int32 words: words 0-7 hold the
real part c0 and words 8-15 the imaginary part c1, both in Montgomery form
over the base ``ModCtx`` (``ops/limb.py``).  Those are the same 64 bytes as
the reference's (n, 2, 16) 16-bit limbs and as an ``ArrayPointVec(g2=True)``
row, so a batch is an (N, 16) int32 tensor and every boundary is a view.
The nonresidue is -1 (BN254's Fq2): a product is Karatsuba with three base
products, a square two.

The plain ops carry the same arithmetic as the kernels of ``csrc/field.cuh``
(``Fe2``) and the reference's ``_F2``; the base products of one Fq2 op run as
one batched base ``mont_mul``, since on the CPU the time is per-op overhead.
Canonical in, canonical out, so results equal the reference's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.fields import BN254_FQ, Fq2
from . import limb
from .limb import NLIMB, NWORD, ModCtx

QWORD = 2 * NWORD  # int32 words per Fq2 element


class QuadCtx:
    """Fq2 over a base ``ModCtx``, with ``ModCtx``'s op names, on
    (..., 16) int32 word tensors (any device, leading dimensions
    broadcast)."""

    nword = QWORD

    def __init__(self, base: ModCtx, name: str = "fq2"):
        self.base = base
        self.name = name
        self.modulus = base.modulus  # the characteristic
        self._consts: dict = {}

    @staticmethod
    def _split(x: torch.Tensor):
        return x[..., :NWORD], x[..., NWORD:]

    @staticmethod
    def _cat(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
        return torch.cat([c0, c1], dim=-1)

    # -- host conversion: values are core.fields.Fq2 --------------------------
    def to_mont_host(self, xs) -> np.ndarray:
        """Fq2 values -> Montgomery-form (n, 2, 16) uint32 limbs."""
        re = self.base.to_mont_host([x.c0 for x in xs])
        im = self.base.to_mont_host([x.c1 for x in xs])
        return np.stack([re, im], axis=1)

    def from_mont_host(self, a) -> list[Fq2]:
        """(n, 2, 16) or (n, 32) Montgomery limbs -> Fq2 values."""
        a = np.asarray(a).reshape(-1, 2, NLIMB)
        re = self.base.from_mont_host(a[:, 0])
        im = self.base.from_mont_host(a[:, 1])
        return [Fq2(r, i) for r, i in zip(re, im)]

    def words(self, xs, device="cpu") -> torch.Tensor:
        """Fq2 values (standard form, as given) -> (n, 16) int32 words."""
        ints = [v for x in xs for v in (x.c0, x.c1)]
        return self.base.words(ints, device).reshape(len(xs), QWORD)

    host_zero = Fq2(0, 0)
    host_one = Fq2(1, 0)

    @staticmethod
    def host_mul(a: Fq2, b: Fq2) -> Fq2:
        return a * b

    @staticmethod
    def host_inv(a: Fq2) -> Fq2:
        return a.inv()

    # -- plain device ops -----------------------------------------------------
    def mont_mul(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Karatsuba: c0 = x0 y0 - x1 y1, c1 = (x0 + x1)(y0 + y1) - x0 y0 -
        x1 y1 (the sums reduced before the product, as ``_F2`` does)."""
        b = self.base
        x0, x1 = self._split(x)
        y0, y1 = self._split(y)
        x0, x1, y0, y1 = torch.broadcast_tensors(x0, x1, y0, y1)
        t0, t1, t2 = b.mont_mul(torch.stack([x0, x1, b.add_mod(x0, x1)]),
                                torch.stack([y0, y1, b.add_mod(y0, y1)]))
        return self._cat(b.sub_mod(t0, t1), b.sub_mod(b.sub_mod(t2, t0), t1))

    def mont_sqr(self, x: torch.Tensor) -> torch.Tensor:
        """(x0 + x1)(x0 - x1) + 2 x0 x1 u: two base products."""
        b = self.base
        x0, x1 = self._split(x)
        c0, t = b.mont_mul(torch.stack([b.add_mod(x0, x1), x0]),
                           torch.stack([b.sub_mod(x0, x1), x1]))
        return self._cat(c0, b.add_mod(t, t))

    def add_mod(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Componentwise: the base op on 16 words is the base op on each
        8-word half."""
        x, y = torch.broadcast_tensors(x, y)
        shape = x.shape
        return self.base.add_mod(x.reshape(shape[:-1] + (2, NWORD)),
                                 y.reshape(shape[:-1] + (2, NWORD))).reshape(shape)

    def sub_mod(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = torch.broadcast_tensors(x, y)
        shape = x.shape
        return self.base.sub_mod(x.reshape(shape[:-1] + (2, NWORD)),
                                 y.reshape(shape[:-1] + (2, NWORD))).reshape(shape)

    def neg_mod(self, x: torch.Tensor) -> torch.Tensor:
        """0 - x (0 stays 0)."""
        return self.sub_mod(torch.zeros_like(x), x)

    @staticmethod
    def is_zero(x: torch.Tensor) -> torch.Tensor:
        """(..., 16) -> (...) bool."""
        return (x == 0).all(dim=-1)

    @staticmethod
    def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per element: mask (...) nonzero ? a : b."""
        return torch.where(mask.to(torch.bool)[..., None], a, b)

    def const_words(self, value: Fq2, device) -> torch.Tensor:
        """The (1, 16) word row of `value` (as given) on `device`, cached."""
        key = (value.c0, value.c1, str(device))
        if key not in self._consts:
            self._consts[key] = self.words([value], device)
        return self._consts[key]

    def one_mont(self, device) -> torch.Tensor:
        """Montgomery 1 (R mod p + 0u) as a (1, 16) row."""
        return self.const_words(Fq2(self.base.r_mod_n, 0), device)

    def inv_mod(self, x: torch.Tensor) -> torch.Tensor:
        """1/(x0 + x1 u) = (x0 - x1 u) / (x0^2 + x1^2): the norm, one base
        Fermat chain, two products (``QuadPallasEC._inv_core``); 0 -> 0."""
        b = self.base
        x0, x1 = self._split(x)
        s0, s1 = b.mont_sqr(torch.stack([x0, x1]))
        ninv = b.inv_mod(b.add_mod(s0, s1))
        c0, c1 = b.mont_mul(torch.stack([x0, b.neg_mod(x1)]), ninv)
        return self._cat(c0, c1)


@functools.lru_cache(maxsize=None)
def get_quad_ctx(modulus: int) -> QuadCtx:
    return QuadCtx(limb.get_ctx(modulus), "fq2")


def get_fq2_ctx() -> QuadCtx:
    """BN254's Fq2."""
    return get_quad_ctx(BN254_FQ)
