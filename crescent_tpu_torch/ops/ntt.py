"""Radix-2 number-theoretic transform on (n, 8) word planes.

Counterpart of ``crescent_tpu/ops/ntt.py``, with the same evaluation-domain
semantics (arkworks ``Radix2EvaluationDomain``): natural order in and out,
``intt = (1/n) * ntt with w^-1``, coset ops scale coefficient i by g^i.  All
values are Montgomery form (R = 2^256) on the device.

A transform is one bit-reversal gather and log2(n) in-place butterfly stages
(``CudaEC.butterfly_stage_``), then, for the inverse, one ``mul`` by 1/n.
Where the JAX stage loop tiles each stage's twiddles into an n/2-wide plane
(ntt.py:72), a stage here reads only its ``half`` twiddles: the tables are
one (n-1, 8) plane per direction, stage s at rows [2^s - 1, 2^(s+1) - 1).

Twiddles and coset powers are native geometric series (``nb.powers``, as in
the reference's ntt.py:119-153) converted to Montgomery form on the device
through ``mul`` by R^2 mod p.  Device tables are built on first use per
device and cached on the domain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import fields
from ..native import backend as nb
from . import limb
from .cuda_ec import CudaEC, get_cuda_ec


def _device_key(device) -> str:
    """'cuda' and 'cuda:<current>' name one device: one cache entry."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def elemwise_mont_mul(ec: CudaEC, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of (n, 8) planes, y (n, 8) or (1, 8):
    the ``mul`` kernel on a CUDA tensor, its plain version on the CPU."""
    return ec.mul(x, y)


def stage_twiddles(tws: torch.Tensor, s: int) -> torch.Tensor:
    """Stage s's 2^s twiddles from an (n-1, 8) table."""
    return tws[(1 << s) - 1 : (2 << s) - 1]


def transform_limb_major(ec: CudaEC, x: torch.Tensor, perm: torch.Tensor,
                         tws: torch.Tensor, n_inv_mont) -> torch.Tensor:
    """Radix-2 NTT of the (n, 8) Montgomery plane x with explicit tables
    (the counterpart of the reference function of this name; the port keeps
    elements as word rows, not limb-major planes).  n_inv_mont is None for
    the forward transform, the (1, 8) Montgomery 1/n for the inverse.
    Returns a new plane; x is left as it was."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    if n != 1 << logn or tws.shape[0] != n - 1 or perm.shape[0] != n:
        raise ValueError(f"tables do not fit a length-{n} transform")
    y = x.index_select(0, perm)
    for s in range(logn):
        ec.butterfly_stage_(y, stage_twiddles(tws, s), 1 << s)
    if n_inv_mont is not None:
        ec.mul(y, n_inv_mont, out=y)
    return y


class NTTDomain:
    """Radix-2 evaluation domain of size n = 2^k over the field of `modulus`."""

    def __init__(self, modulus: int, n: int):
        assert n & (n - 1) == 0, "domain size must be a power of two"
        assert (modulus - 1) % n == 0, "field lacks required 2-adicity"
        self.modulus = modulus
        self.n = n
        self.logn = n.bit_length() - 1
        self.ec = get_cuda_ec(modulus)
        self.ctx = self.ec.ctx
        f = fields.PrimeField(modulus)
        self.w = f.root_of_unity(n) if n > 1 else 1
        self.w_inv = pow(self.w, -1, modulus) if n > 1 else 1
        self.n_inv = pow(n, -1, modulus)
        self._tables: dict = {}
        self._coset: dict = {}

    # -- device tables ------------------------------------------------------
    def _to_mont(self, std_u64: np.ndarray, device) -> torch.Tensor:
        """(m, 4) u64 standard form -> (m, 8) Montgomery words on device,
        through `mul` by R^2."""
        x = limb.u64_to_words(std_u64, device)
        r2 = self.ctx.words([self.ctx.r2], device)
        return self.ec.mul(x, r2, out=x)

    def _stage_series(self, root: int) -> np.ndarray:
        """Stage twiddles w^(j * n / 2^(s+1)), j < 2^s, for every stage,
        concatenated: (n-1, 4) u64 standard form."""
        p, n = self.modulus, self.n
        if n == 1:
            return np.zeros((0, 4), dtype="<u8")
        return np.concatenate(
            [nb.powers(p, pow(root, n >> (s + 1), p), 1, 1 << s)
             for s in range(self.logn)],
            axis=0,
        )

    def tables(self, device) -> dict:
        """{'perm', 'tw_fwd', 'tw_inv', 'n_inv_mont'} on `device`."""
        key = _device_key(device)
        if key not in self._tables:
            if not nb.available():
                raise RuntimeError("the native host backend is required")
            self._tables[key] = {
                "perm": torch.from_numpy(bit_reverse_perm(self.n)).to(device),
                "tw_fwd": self._to_mont(self._stage_series(self.w), device),
                "tw_inv": self._to_mont(self._stage_series(self.w_inv), device),
                "n_inv_mont": limb.limbs_to_words(
                    self.ctx.to_mont_host([self.n_inv]), device),
            }
        return self._tables[key]

    def coset_powers(self, g: int, device) -> torch.Tensor:
        """Montgomery [g^0 .. g^(n-1)] on `device`, cached per (g, device)."""
        key = (g, _device_key(device))
        if key not in self._coset:
            if not nb.available():
                raise RuntimeError("the native host backend is required")
            self._coset[key] = self._to_mont(
                nb.powers(self.modulus, g % self.modulus, 1, self.n), device)
        return self._coset[key]

    # -- transforms ---------------------------------------------------------
    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """coefficients -> evaluations (both Montgomery form)."""
        t = self.tables(x.device)
        return transform_limb_major(self.ec, x, t["perm"], t["tw_fwd"], None)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """evaluations -> coefficients."""
        t = self.tables(x.device)
        return transform_limb_major(self.ec, x, t["perm"], t["tw_inv"],
                                    t["n_inv_mont"])

    def coset_scale(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """Multiply coefficient i by g^i (host-known g)."""
        return elemwise_mont_mul(self.ec, x, self.coset_powers(g, x.device))

    def coset_ntt(self, x: torch.Tensor, g: int) -> torch.Tensor:
        return self.ntt(self.coset_scale(x, g))

    def coset_intt(self, x: torch.Tensor, g: int) -> torch.Tensor:
        return self.coset_scale(self.intt(x), pow(g, -1, self.modulus))

    # -- host oracle --------------------------------------------------------
    def ntt_host(self, coeffs: list[int]) -> list[int]:
        p, n = self.modulus, self.n
        return [
            sum(coeffs[j] * pow(self.w, j * k, p) for j in range(n)) % p
            for k in range(n)
        ]

    def intt_host(self, evals: list[int]) -> list[int]:
        p, n = self.modulus, self.n
        return [
            self.n_inv * sum(evals[j] * pow(self.w_inv, j * k, p) for j in range(n)) % p
            for k in range(n)
        ]

    def vanishing_on_coset(self, g: int) -> int:
        """Z_H(g*w^i) = g^n - 1, constant on the coset."""
        return (pow(g, self.n, self.modulus) - 1) % self.modulus


@functools.lru_cache(maxsize=None)
def get_domain(modulus: int, n: int) -> NTTDomain:
    return NTTDomain(modulus, n)
