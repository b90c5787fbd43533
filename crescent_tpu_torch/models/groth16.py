"""Groth16 setup, prove and verify with h(x) and the MSMs on a device.

Counterpart of ``crescent_tpu/models/groth16.py``.  ``prove`` runs the QAP
witness map h(x) on the device (``device="cuda"`` launches the kernels; a CPU
device runs their plain PyTorch versions) and then, by the reference's
switches ``CRESCENT_PROVE_MSM`` and ``CRESCENT_NATIVE``:

* ``device``: the four G1 MSMs as one chunk fold of sorted-segment affine
  MSMs on the device (``ops/msm.py``), with h staying there, while the G2
  MSM runs on the native C++ host backend on a worker thread
  (groth16.py:876-931); under ``CRESCENT_NATIVE=0`` the G2 MSM runs on the
  device too, enqueued behind the fold (groth16.py:943-958);
* ``native``: all five MSMs on the native host backend (groth16.py:868-875);
* ``auto`` (the default) and any other value: ``device`` on a CUDA device,
  ``native`` on the CPU.

``CRESCENT_NATIVE=0`` (default 1) turns the native host backend off where
the reference does: in ``prove`` the witness matvec Az/Bz/Cz runs in pure
Python (``_matvec_evals``) and h(x) on the device from its lists
(``_compute_h``), and the MSMs take the device route on any device (the
CPU runs the kernels' plain versions), whatever ``CRESCENT_PROVE_MSM``
says; so does verify's public-input MSM.  ``R1CS.is_satisfied`` runs its
Python loop then, as it does for small lists.  ``CRESCENT_MSM_FUSED_AGG=1``
(the reference's switch) aggregates each chunk of the device MSMs by one
``bucket_reduce`` launch; the proof is the same.  ``CRESCENT_PROVE_FUSED``
other than 1 (the reference's switch) turns the fused data path off: h(x)
from the Python lists of ``_compute_h`` (the native matvec while the
backend is on), and the four G1 MSMs as one ``MSM.run_device_many`` batch
in place of the fold (the affine route one problem after another; with
``CRESCENT_MSM_AFFINE=0`` the scan Pippenger over all four at once), the
G2 MSM as above.  The fold falls back to that batch by itself where the
affine route is off.

``setup`` draws the same randomness in the same order as the reference
(gamma == 1) and then, by the reference's switches ``CRESCENT_SETUP_TPU``
and ``CRESCENT_NATIVE``, builds the SRS in one of its two branches
(groth16.py:576-642):

* the device branch (only with the native backend on): both fixed-base
  batches (G1 and G2) on the device (``ops/fixed_base.py``: byte-window
  ``madd`` accumulation and an affine conversion through ``batch_inv``),
  scalar prep with the Fr ``mul`` kernel; the tables come back as
  ``ArrayPointVec``s, which ``prove`` uploads without Python ints;
* the host branch: QAP evaluations and scalar prep on the native backend,
  or in pure Python with it off, then both batches through
  ``fixed_base_mul``: the native fixed base, or with the backend off
  batched double-and-add on the device (``jadd`` and ``jdbl``); tables are
  lists of host affine points.

Both give the reference's key, table for table.

The native backend's library is required: every entry point raises without
it, whatever ``CRESCENT_NATIVE`` says (the reference would take its pure
routes then).
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core import curves, fields
from ..core import pairing as pr
from ..native import backend as nb
from ..utils import trace
from ..ops import limb, ntt
from ..ops.cuda_ec import get_cuda_ec
from ..ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid
from ..ops.fixed_base import FixedBaseMSM
from ..ops.msm import MSM, get_g2_msm, get_msm

G1 = curves.BN254_G1
G2 = curves.BN254G2
R = fields.BN254_FR
Fr = fields.Fr


def _require_native() -> None:
    if not nb.available():
        raise RuntimeError("the native host backend (crescent_tpu_torch/native) "
                           "is required and did not build")


def _setup_device_enabled(device: torch.device) -> bool:
    """Whether `setup` builds the SRS on `device` (else on the native host
    backend), by CRESCENT_SETUP_TPU (the reference's switch): 0 never, force
    on any device (the CPU tests run the plain versions of the kernels this
    way), any other value (auto, 1, ...) on a CUDA device."""
    env = os.environ.get("CRESCENT_SETUP_TPU", "auto")
    if env == "0":
        return False
    if env == "force":
        return True
    return device.type == "cuda"


def _native_ok() -> bool:
    """Whether `prove` may use the native host backend for its MSMs, by
    CRESCENT_NATIVE (default 1; the reference's switch, groth16.py:49).
    The backend itself is required either way (see the module's
    docstring)."""
    return os.environ.get("CRESCENT_NATIVE", "1") == "1"


def _device_msm_prove(device: torch.device) -> bool:
    """Whether `prove` runs the G1 MSMs on `device` (else on the native
    host backend), by CRESCENT_PROVE_MSM: native never, device always, any
    other value (auto, ...) on a CUDA device; with the native backend off
    (CRESCENT_NATIVE=0), always (the reference's `_native_msm_prove`,
    groth16.py:102-110)."""
    env = os.environ.get("CRESCENT_PROVE_MSM", "auto")
    if not _native_ok():
        return True
    if env == "native":
        return False
    if env == "device":
        return True
    return device.type == "cuda"


@contextmanager
def _phase(label: str, timings: Optional[dict], key: str):
    """trace.timed(label), and the wall seconds into timings[key]."""
    t0 = time.perf_counter()
    with trace.timed(label):
        yield
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# R1CS container
# ---------------------------------------------------------------------------

@dataclass
class R1CS:
    """Rank-1 constraint system over BN254 Fr (reference groth16.R1CS).

    Variables are indexed [1, instance..., witness...]; `num_instance`
    counts the constant.  Each constraint is (A_row, B_row, C_row): lists
    of (var_idx, coeff)."""

    num_instance: int
    num_witness: int
    constraints: list
    field: int = R

    @property
    def num_vars(self) -> int:
        return self.num_instance + self.num_witness

    def is_satisfied(self, z) -> bool:
        """z: list of ints or an (nv, 4) u64 standard-form array.  Three
        native COO matvecs and one elementwise a*b - c check with the native
        backend on, for more than 512 constraints or an array; else the
        Python loop (reference groth16.py:136-162)."""
        F = self.field
        nc = len(self.constraints)
        if isinstance(z, np.ndarray) and not _native_ok():
            z = [int.from_bytes(row.tobytes(), "little") for row in
                 np.ascontiguousarray(z, dtype="<u8")]
        if _native_ok() and (nc > 512 or isinstance(z, np.ndarray)):
            _require_native()
            zu = z if isinstance(z, np.ndarray) else nb.ints_to_u64([x % F for x in z])
            evs = [
                nb.coo_matvec(F, rows, cols, coeffs, zu, nc)
                for rows, cols, coeffs in _r1cs_coo(self)
            ]
            ab = nb.vec_op(F, "mul", evs[0], evs[1])
            return not nb.vec_op(F, "sub", ab, evs[2]).any()
        for a_row, b_row, c_row in self.constraints:
            a = sum(c * z[i] for i, c in a_row) % F
            b = sum(c * z[i] for i, c in b_row) % F
            c = sum(co * z[i] for i, co in c_row) % F
            if a * b % F != c:
                return False
        return True


def dummy_circuit(log_size: int, rng: random.Random, num_public: int = 1):
    """a*b multiplication chain (reference groth16.dummy_circuit, after
    creds/benches/proof_benchmark.rs:24): 2^log_size - 2 constraints, the
    first `num_public` products public.  Returns (r1cs, z)."""
    n_cons = (1 << log_size) - 2
    a = rng.randrange(R)
    b = rng.randrange(R)
    products = []
    cur = a
    for _ in range(n_cons):
        cur = cur * b % R
        products.append(cur)
    # variable indexing: [1, pubs..., a, b, rest...]
    var_a, var_b = 1 + num_public, 2 + num_public
    out_idx = [1 + j if j < num_public else 3 + j for j in range(n_cons)]
    cons = []
    prev = var_a
    for j in range(n_cons):
        cons.append(([(prev, 1)], [(var_b, 1)], [(out_idx[j], 1)]))
        prev = out_idx[j]
    r1cs = R1CS(1 + num_public, 2 + (n_cons - num_public), cons)
    z = [1] + products[:num_public] + [a, b] + products[num_public:]
    assert r1cs.is_satisfied(z)
    return r1cs, z


# ---------------------------------------------------------------------------
# Keys and proofs
# ---------------------------------------------------------------------------

@dataclass
class VerifyingKey:
    """Fields as the reference's (forks/groth16/src/data_structures.rs:31-44)."""

    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # length num_instance

    def prepare(self) -> "PreparedVerifyingKey":
        return PreparedVerifyingKey(
            vk=self, alpha_beta=pr.pairing(self.alpha_g1, self.beta_g2)
        )


@dataclass
class PreparedVerifyingKey:
    vk: VerifyingKey
    alpha_beta: object  # Fq12


@dataclass
class ProvingKey:
    """SRS tables are lists of affine points or ArrayPointVec."""

    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: list        # A_i(tau)*G1, len num_vars
    b_g1_query: list     # B_i(tau)*G1, len num_vars
    b_g2_query: list     # B_i(tau)*G2, len num_vars
    h_query: list        # tau^i Z(tau)/delta * G1, len domain_size-1
    l_query: list        # (beta A_i + alpha B_i + C_i)/delta * G1 (witness)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def device_table(self, name: str, msm_obj: MSM, device):
        """The Montgomery-form device planes (x, y, valid) of an SRS table,
        cached per table and device."""
        key = (name, ntt._device_key(device))
        if key not in self._dev:
            pts = getattr(self, name)
            P = msm_obj.ctx.points_to_device(pts, device)
            valid = torch.from_numpy(points_valid(pts)).to(device)
            self._dev[key] = (P.x, P.y, valid)
        return self._dev[key]

    def native_g2_table(self) -> np.ndarray:
        """The (n, 16) u64 layout of b_g2_query for the native G2 MSM,
        cached."""
        key = "b_g2_query:u64"
        if key not in self._dev:
            self._dev[key] = nb.g2_to_u64(self.b_g2_query)
        return self._dev[key]


@dataclass
class Proof:
    a: tuple
    b: tuple
    c: tuple


# ---------------------------------------------------------------------------
# QAP helpers (host, exact)
# ---------------------------------------------------------------------------

def _domain_for(r1cs: R1CS) -> ntt.NTTDomain:
    need = len(r1cs.constraints) + r1cs.num_instance
    n = 1
    while n < need:
        n *= 2
    return ntt.get_domain(R, n)


def _r1cs_coo(r1cs: R1CS):
    """COO triples (rows, cols, coeffs_u64) per matrix A/B/C, cached on the
    instance (reference groth16._r1cs_coo)."""
    coo = getattr(r1cs, "_coo_cache", None)
    if coo is None:
        from array import array

        F = r1cs.field
        cbytes: dict[int, bytes] = {}  # coefficients repeat heavily
        coo = []
        for k in range(3):
            rows = array("I")
            cols = array("I")
            buf = bytearray()
            for j, cons in enumerate(r1cs.constraints):
                row = cons[k]
                if not row:
                    continue
                rows.extend([j] * len(row))
                for i, co in row:
                    cols.append(i)
                    b = cbytes.get(co)
                    if b is None:
                        b = (co % F).to_bytes(32, "little")
                        cbytes[co] = b
                    buf += b
            coo.append(
                (
                    np.frombuffer(rows, dtype=np.uint32),
                    np.frombuffer(cols, dtype=np.uint32),
                    np.frombuffer(bytes(buf), dtype="<u8").reshape(-1, 4),
                )
            )
        r1cs._coo_cache = coo
    return coo


def _lagrange_coeffs_at(dom: ntt.NTTDomain, t: int) -> list[int]:
    """L_j(t) for all j: (Z(t)/N) * w^j / (t - w^j)."""
    n, w = dom.n, dom.w
    zt = (pow(t, n, R) - 1) % R
    factor = zt * pow(n, -1, R) % R
    wj = 1
    nums, dens = [], []
    for j in range(n):
        nums.append(factor * wj % R)
        dens.append((t - wj) % R)
        wj = wj * w % R
    inv = _batch_inv_host(dens)
    return [nums[j] * inv[j] % R for j in range(n)]


def _batch_inv_host(xs: list[int]) -> list[int]:
    """Montgomery's batch inversion over Fr in Python ints."""
    prefix = [1]
    for x in xs:
        prefix.append(prefix[-1] * x % R)
    total = pow(prefix[-1], -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = total * prefix[i] % R
        total = total * xs[i] % R
    return out


def _qap_evals_at_t(r1cs: R1CS, dom: ntt.NTTDomain, t: int):
    """A_i(t), B_i(t), C_i(t) per variable, with identity rows for the
    instance variables (reference groth16.py:358-389): on the native
    backend, or in pure Python with it off."""
    nv = r1cs.num_vars
    nc = len(r1cs.constraints)
    if _native_ok():
        zt = (pow(t, dom.n, R) - 1) % R
        factor = zt * pow(dom.n, -1, R) % R
        L = nb.lagrange_at(R, dom.w, t, factor, dom.n)
        A, B, C = (
            nb.u64_to_ints(nb.coo_matvec(R, cols, rows, coeffs, L, nv))
            for rows, cols, coeffs in _r1cs_coo(r1cs)
        )
        L_tail = nb.u64_to_ints(L[nc : nc + r1cs.num_instance])
        for i in range(r1cs.num_instance):
            A[i] = (A[i] + L_tail[i]) % R
        return A, B, C
    L = _lagrange_coeffs_at(dom, t)
    A = [0] * nv
    B = [0] * nv
    C = [0] * nv
    for j, (ar, br, cr) in enumerate(r1cs.constraints):
        lj = L[j]
        for i, co in ar:
            A[i] = (A[i] + co * lj) % R
        for i, co in br:
            B[i] = (B[i] + co * lj) % R
        for i, co in cr:
            C[i] = (C[i] + co * lj) % R
    for i in range(r1cs.num_instance):
        A[i] = (A[i] + L[nc + i]) % R
    return A, B, C


def _matvec_evals(r1cs: R1CS, z: list[int], dom: ntt.NTTDomain):
    """Domain evaluations a = Az, b = Bz, c = Cz (+ identity rows) as lists
    of ints (reference groth16.py:392-414): on the native backend, or in
    pure Python with it off."""
    n = dom.n
    nc = len(r1cs.constraints)
    if _native_ok():
        zu = nb.ints_to_u64([x % R for x in z])
        a, b, c = (nb.u64_to_ints(nb.coo_matvec(R, rows, cols, coeffs, zu, n))
                   for rows, cols, coeffs in _r1cs_coo(r1cs))
        for i in range(r1cs.num_instance):
            a[nc + i] = z[i] % R
        return a, b, c
    a = [0] * n
    b = [0] * n
    c = [0] * n
    for j, (ar, br, cr) in enumerate(r1cs.constraints):
        a[j] = sum(co * z[i] for i, co in ar) % R
        b[j] = sum(co * z[i] for i, co in br) % R
        c[j] = sum(co * z[i] for i, co in cr) % R
    for i in range(r1cs.num_instance):
        a[nc + i] = z[i]
    return a, b, c


# ---------------------------------------------------------------------------
# Fixed-base batched scalar muls
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    """`device` as a ``torch.device``; raises if it names a CUDA device and
    there is none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, and no CUDA device is "
                           "available; pass device='cpu' for the plain versions")
    return device


def fixed_base_mul(base, scalars: list[int], g2: bool = False, *, device="cuda") -> list:
    """[k*base for k in scalars] (reference groth16.py:421-444).  The native
    windowed fixed base with the native backend on; with it off
    (CRESCENT_NATIVE=0), the base broadcast to a power-of-two batch and
    ``CurveCtx.scalar_mul`` on `device` (256 ``jadd`` and ``jdbl`` launches,
    over Fq2 for G2), then the points read back.  `device` must exist
    whichever route runs; "cpu" runs the kernels' plain versions."""
    device = _device(device)
    if not scalars:
        return []
    if _native_ok():
        _require_native()
        ks = [s % G2.n for s in scalars] if g2 else [s % G1.n for s in scalars]
        if g2:
            return nb.fixed_base_g2(base, ks)
        return nb.fixed_base("bn254_g1", base, ks)
    ctx = get_g2_ctx() if g2 else get_curve_ctx(G1)
    P1 = ctx.points_to_device([base], device)
    n = len(scalars)
    npad = 1 << (n - 1).bit_length() if n > 1 else 1
    P = JPoints(*(c.expand(npad, -1) for c in P1))
    padded = [s % ctx.n for s in scalars] + [0] * (npad - n)
    kw = limb.limbs_to_words(limb.ints_to_limbs(padded), device)
    return ctx.points_to_host(ctx.scalar_mul(kw, P))[:n]


# ---------------------------------------------------------------------------
# Setup / Prove / Verify
# ---------------------------------------------------------------------------

def _qap_evals_at_t_u64(r1cs: R1CS, dom: ntt.NTTDomain, t: int):
    """`_qap_evals_at_t` as (nv, 4) u64 standard-form arrays, for the device
    branch (reference groth16.py:459-478)."""
    nv = r1cs.num_vars
    nc = len(r1cs.constraints)
    zt = (pow(t, dom.n, R) - 1) % R
    factor = zt * pow(dom.n, -1, R) % R
    L = nb.lagrange_at(R, dom.w, t, factor, dom.n)
    A, B, C = (nb.coo_matvec(R, cols, rows, coeffs, L, nv)
               for rows, cols, coeffs in _r1cs_coo(r1cs))
    ninst = r1cs.num_instance
    Ai = nb.u64_to_ints(A[:ninst])
    Lt = nb.u64_to_ints(L[nc : nc + ninst])
    A[:ninst] = nb.ints_to_u64([(a + l) % R for a, l in zip(Ai, Lt)])
    return A, B, C


def _setup_scalar_planes(A, B, C, ninst: int, alpha: int, beta: int, d_inv: int,
                         device) -> tuple[np.ndarray, np.ndarray]:
    """beta*A + alpha*B + C over all variables on `device` (Fr ``mul``
    kernel for the products by Montgomery constants, which leave standard
    form; ``ModCtx.add_mod`` for the sums), and its delta^-1-scaled witness
    tail (reference groth16.py:481-509).  Returns (gamma_abc (ninst, 16),
    l (nv - ninst, 16)) standard-form u16 limbs."""
    fr = get_cuda_ec(R)
    ctx = fr.ctx
    Au, Bu, Cu = (limb.u64_to_words(v, device) for v in (A, B, C))
    cb, ca, cd = (ctx.const_words(x * ctx.R % R, device) for x in (beta, alpha, d_inv))
    lc = ctx.add_mod(ctx.add_mod(fr.mul(Au, cb), fr.mul(Bu, ca)), Cu)
    lw = fr.mul(lc[ninst:], cd)
    return (limb.u64_to_limbs(limb.words_to_u64(lc[:ninst])),
            limb.u64_to_limbs(limb.words_to_u64(lw)))


def _setup_fixed_base_device(r1cs: R1CS, dom: ntt.NTTDomain, alpha: int, beta: int,
                             delta: int, t: int, device, timings: Optional[dict]):
    """Both SRS fixed-base batches on `device` (reference groth16.py:512-557).
    Returns (g1_all, g2_all) ``ArrayPointVec``s in the order of the native
    branch's concatenated scalar lists."""
    ninst = r1cs.num_instance
    nv = r1cs.num_vars
    zt = (pow(t, dom.n, R) - 1) % R
    d_inv = pow(delta, -1, R)
    with _phase("Groth16::setup qap_evals_at_t (native, arrays)", timings, "qap_evals"):
        A, B, C = _qap_evals_at_t_u64(r1cs, dom, t)
    with _phase(f"Groth16::setup scalar prep ({device})", timings, "scalar_prep"):
        abc16, l16 = _setup_scalar_planes(A, B, C, ninst, alpha, beta, d_inv, device)
        h16 = limb.u64_to_limbs(nb.powers(R, t, zt * d_inv % R, dom.n - 1))
        A16, B16 = limb.u64_to_limbs(A), limb.u64_to_limbs(B)
        tail = limb.ints_to_limbs([alpha, beta, delta]).astype(np.uint16)
        sc_g1 = np.concatenate([A16, B16, h16, l16, abc16, tail], axis=0)
        sc_g2 = np.concatenate(
            [B16, limb.ints_to_limbs([beta, 1, delta]).astype(np.uint16)], axis=0)
    fb1 = FixedBaseMSM(get_curve_ctx(G1))
    fb2 = FixedBaseMSM(get_g2_ctx())
    # both groups are enqueued before either is fetched: G2's table build
    # and upload overlap G1's device work, G1's download G2's
    with _phase(f"Groth16::setup fixed-base G1 dispatch ({sc_g1.shape[0]} pts)",
                timings, "g1_dispatch"):
        t1 = nb.fixed_base("bn254_g1", G1.generator, fb1.table_scalars())
        h1 = fb1.dispatch(t1, sc_g1, device)
    with _phase(f"Groth16::setup fixed-base G2 dispatch ({sc_g2.shape[0]} pts)",
                timings, "g2_dispatch"):
        t2 = nb.fixed_base_g2(G2.generator(), fb2.table_scalars())
        h2 = fb2.dispatch(t2, sc_g2, device)
    with _phase("Groth16::setup fixed-base G1 fetch", timings, "g1_fetch"):
        g1_all = fb1.fetch(h1)
    with _phase("Groth16::setup fixed-base G2 fetch", timings, "g2_fetch"):
        g2_all = fb2.fetch(h2)
    assert len(g1_all) == 3 * nv + (dom.n - 1) + 3 and len(g2_all) == nv + 3
    return g1_all, g2_all


def setup(r1cs: R1CS, rng: random.Random, *, device="cuda",
          timings: Optional[dict] = None) -> ProvingKey:
    """Per-circuit SRS (forks/groth16/src/generator.rs).

    The device branch runs where CRESCENT_SETUP_TPU selects it for `device`
    (see ``_setup_device_enabled``; the default is the card), the native
    backend is on (CRESCENT_NATIVE) and the circuit holds at least
    CRESCENT_SETUP_TPU_MIN (default 2^14) G1 points, 3 * num_vars + domain
    size.  Otherwise the host branch runs, its fixed-base batches on
    `device` with the backend off (``fixed_base_mul``): that gate is the
    reference's own routing (groth16.py:576-581), not a fallback; no
    failure of either branch is caught.
    timings: if given, filled with wall seconds per phase: of the device
    branch "qap_evals", "scalar_prep", "g1_dispatch", "g2_dispatch",
    "g1_fetch", "g2_fetch", "assemble" (dispatches only enqueue, so the
    device work shows in the fetches); of the host branch "qap_evals",
    "scalar_prep", "g1_fixed_base", "g2_fixed_base"."""
    _require_native()
    device = _device(device)
    # gamma = 1 exactly as the reference generator (generator.rs:28): the
    # show protocol's committed-input algebra relies on it
    alpha, beta, delta, t = (rng.randrange(1, R) for _ in range(4))
    gamma = 1
    with trace.timed("Groth16::setup domain"):
        dom = _domain_for(r1cs)
    ninst = r1cs.num_instance
    nv = r1cs.num_vars
    if (_setup_device_enabled(device)
            and _native_ok()
            and 3 * nv + dom.n >= int(os.environ.get("CRESCENT_SETUP_TPU_MIN", str(1 << 14)))):
        g1_all, g2_all = _setup_fixed_base_device(r1cs, dom, alpha, beta, delta, t,
                                                  device, timings)
        with _phase("Groth16::setup key assembly", timings, "assemble"):
            nh = dom.n - 1
            a_query = g1_all[:nv]
            b_g1_query = g1_all[nv : 2 * nv]
            h_query = g1_all[2 * nv : 2 * nv + nh]
            l_query = g1_all[2 * nv + nh : 2 * nv + nh + (nv - ninst)]
            gamma_abc_g1 = g1_all[2 * nv + nh + (nv - ninst) : -3].to_list()
            alpha_g1, beta_g1, delta_g1 = (g1_all[i] for i in range(-3, 0))
            b_g2_query = g2_all[:nv]
            beta_g2, gamma_g2, delta_g2 = (g2_all[i] for i in range(-3, 0))
            vk = VerifyingKey(alpha_g1, beta_g2, gamma_g2, delta_g1, delta_g2,
                              gamma_abc_g1)
        return ProvingKey(vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query,
                          h_query, l_query)

    with _phase("Groth16::setup qap_evals_at_t", timings, "qap_evals"):
        A, B, C = _qap_evals_at_t(r1cs, dom, t)
    zt = (pow(t, dom.n, R) - 1) % R
    g_inv = pow(gamma, -1, R)
    d_inv = pow(delta, -1, R)
    with _phase("Groth16::setup scalar prep", timings, "scalar_prep"):
        gamma_abc = [(beta * A[i] + alpha * B[i] + C[i]) * g_inv % R
                     for i in range(ninst)]
        l_scalars = [(beta * A[i] + alpha * B[i] + C[i]) * d_inv % R
                     for i in range(ninst, nv)]
        if _native_ok():
            h_scalars = nb.u64_to_ints(nb.powers(R, t, zt * d_inv % R, dom.n - 1))
        else:
            h_scalars = [pow(t, i, R) * zt * d_inv % R for i in range(dom.n - 1)]

    with _phase(f"Groth16::setup fixed-base G1 ({3 * nv + dom.n} pts)", timings,
                "g1_fixed_base"):
        g1_all = fixed_base_mul(
            G1.generator, A + B + h_scalars + l_scalars + gamma_abc + [alpha, beta, delta],
            device=device)
    a_query, rest = g1_all[:nv], g1_all[nv:]
    b_g1_query, rest = rest[:nv], rest[nv:]
    h_query, rest = rest[: len(h_scalars)], rest[len(h_scalars):]
    l_query, rest = rest[: len(l_scalars)], rest[len(l_scalars):]
    gamma_abc_g1, rest = rest[:ninst], rest[ninst:]
    alpha_g1, beta_g1, delta_g1 = rest
    with _phase(f"Groth16::setup fixed-base G2 ({nv} pts)", timings, "g2_fixed_base"):
        g2_all = fixed_base_mul(G2.generator(), B + [beta, gamma, delta], g2=True,
                                device=device)
    b_g2_query = g2_all[:nv]
    beta_g2, gamma_g2, delta_g2 = g2_all[nv:]

    vk = VerifyingKey(alpha_g1, beta_g2, gamma_g2, delta_g1, delta_g2, gamma_abc_g1)
    return ProvingKey(vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query,
                      h_query, l_query)


def _h_pipeline(dom: ntt.NTTDomain, device):
    """The h(x) pipeline on `device` (reference groth16._h_pipeline): to
    Montgomery, 3x (iNTT -> coset scale -> NTT), pointwise (ab - c)/Z on the
    coset, coset iNTT, and back to standard form.  Returns run(a, b, c) on
    (n, 8) standard-form word planes -> (n, 8) standard-form h."""
    ec = dom.ec
    ctx = dom.ctx
    g = Fr.multiplicative_generator
    g_inv = pow(g, -1, R)
    zinv = pow(dom.vanishing_on_coset(g), -1, R)
    tabs = dom.tables(device)
    pows = dom.coset_powers(g, device)
    ipows = dom.coset_powers(g_inv, device)
    r2 = ctx.words([ctx.r2], device)
    zinv_m = limb.limbs_to_words(ctx.to_mont_host([zinv]), device)
    one_std = ctx.words([1], device)

    def fwd(x):
        return ntt.transform_limb_major(ec, x, tabs["perm"], tabs["tw_fwd"], None)

    def inv(x):
        return ntt.transform_limb_major(ec, x, tabs["perm"], tabs["tw_inv"],
                                        tabs["n_inv_mont"])

    def mul(x, y):
        return ntt.elemwise_mont_mul(ec, x, y)

    def coset_fwd(x):
        return fwd(mul(inv(x), pows))

    def run(a, b, c):
        am, bm, cm = (mul(v, r2) for v in (a, b, c))
        # (the reference's sub here is an XLA op, not a Pallas kernel; so
        # is the plain PyTorch sub_mod)
        prod = ctx.sub_mod(mul(coset_fwd(am), coset_fwd(bm)), coset_fwd(cm))
        hc = mul(prod, zinv_m)
        hm = mul(inv(hc), ipows)
        return mul(hm, one_std)  # de-Montgomery

    return run


def _matvec_evals_u64(r1cs: R1CS, zu: np.ndarray, dom: ntt.NTTDomain):
    """Native Az/Bz/Cz as (dom.n, 4) u64 arrays, identity rows included."""
    nc = len(r1cs.constraints)
    outs = [
        nb.coo_matvec(R, rows, cols, coeffs, zu, dom.n)
        for rows, cols, coeffs in _r1cs_coo(r1cs)
    ]
    outs[0][nc : nc + r1cs.num_instance] = zu[: r1cs.num_instance]
    return outs


def _h_device_words(r1cs: R1CS, zu: np.ndarray, dom: ntt.NTTDomain, device,
                    timings: Optional[dict] = None) -> torch.Tensor:
    """Native u64 matvec -> h(x) pipeline on `device`.  Returns the
    full-length (dom.n, 8) standard-form word plane of h, still on the
    device; its last row must be zero (the degree bound), which is checked
    here and is the one wait for the device."""
    with _phase("prove::matvec Az/Bz/Cz", timings, "matvec"):
        a, b, c = _matvec_evals_u64(r1cs, zu, dom)
    with _phase(f"prove::NTT h(x) (domain 2^{dom.logn}, {device})", timings, "h"):
        run = _h_pipeline(dom, device)
        h = run(*(limb.u64_to_words(v, device) for v in (a, b, c)))
        assert not h[-1].cpu().any(), "h degree bound violated (unsatisfied R1CS?)"
    return h


def _compute_h(r1cs: R1CS, z: list[int], dom: ntt.NTTDomain, device,
               timings: Optional[dict] = None) -> torch.Tensor:
    """h(x) = (A(x)B(x) - C(x)) / Z(x) with the native backend off
    (reference groth16.py:741-774): the Python matvec, then the h(x)
    pipeline on `device` from the three lists' planes.  Returns, as
    ``_h_device_words`` does, the full-length (dom.n, 8) standard-form word
    plane of h on the device (the reference returns h's first dom.n - 1
    coefficients as ints); the degree bound is checked here."""
    with _phase("prove::matvec Az/Bz/Cz", timings, "matvec"):
        a, b, c = _matvec_evals(r1cs, z, dom)
    with _phase(f"prove::NTT h(x) (domain 2^{dom.logn}, {device})", timings, "h"):
        run = _h_pipeline(dom, device)
        h = run(*(limb.limbs_to_words(limb.ints_to_limbs([x % R for x in v]), device)
                  for v in (a, b, c)))
        assert not h[-1].cpu().any(), "h degree bound violated (unsatisfied R1CS?)"
    return h


def _compute_h_device(r1cs: R1CS, zu: np.ndarray, dom: ntt.NTTDomain,
                      device="cuda", timings: Optional[dict] = None) -> np.ndarray:
    """`_h_device_words`, downloaded: the full-length (dom.n, 16) uint16
    standard-form h (callers slice [: dom.n - 1]), as the reference's
    function of this name returns it."""
    h = _h_device_words(r1cs, zu, dom, torch.device(device), timings)
    return limb.u64_to_limbs(limb.words_to_u64(h))


def _msm_problem(pk: ProvingKey, name: str, sc: torch.Tensor, msm_obj: MSM, device):
    """(px, py, valid, scalars) of one MSM of `prove`: the first len(sc)
    points of an SRS table's device planes and the (n, 8) scalar words `sc`
    (reference groth16.py:777-781, which uploads the scalars from ints)."""
    px, py, valid = pk.device_table(name, msm_obj, device)
    n = sc.shape[0]
    return (px[:n], py[:n], valid[:n], sc)


def _prove_fused() -> bool:
    """CRESCENT_PROVE_FUSED (the reference's switch, groth16.py:834, :880;
    default 1): with "1", h(x) comes from the native u64 matvec and the G1
    MSMs run as one chunk fold; any other value takes the Python-list h(x)
    route (``_compute_h``) and the four G1 MSMs as one ``run_device_many``
    batch."""
    return os.environ.get("CRESCENT_PROVE_FUSED", "1") == "1"


def prove(
    pk: ProvingKey,
    r1cs: R1CS,
    z,
    rng: random.Random,
    r: Optional[int] = None,
    s: Optional[int] = None,
    *,
    device="cuda",
    timings: Optional[dict] = None,
) -> Proof:
    """Groth16 prove (forks/groth16/src/prover.rs): h(x) on `device` (from
    the native matvec, or under CRESCENT_NATIVE=0 from the Python one), the
    four G1 MSMs there or on the native backend (CRESCENT_PROVE_MSM), the
    G2 MSM on the native backend or, under CRESCENT_NATIVE=0, on `device`
    (see the module's docstring), the proof assembled on the host.

    z: full assignment, a list of ints or an (nv, 4) u64 standard-form
    array.  device: where the device work runs; the default is the card,
    and without one the call raises.  timings: if given, filled with wall
    seconds per phase ("matvec", "h", "msm", "msm_g1", "msm_g2",
    "assemble"; "msm" spans both MSM phases, which overlap on a device; with
    G2 on the device, "msm_g2" is the host's time to enqueue it and read its
    result, and its device time falls in the one wait, inside "msm_g1")."""
    _require_native()
    device = _device(device)
    r = rng.randrange(R) if r is None else r
    s = rng.randrange(R) if s is None else s
    if isinstance(z, np.ndarray):
        zu = np.ascontiguousarray(z, dtype="<u8")
    else:
        zu = nb.ints_to_u64([x % R for x in z])
    dom = _domain_for(r1cs)
    if _native_ok() and _prove_fused():
        hw = _h_device_words(r1cs, zu, dom, device, timings)
    else:
        zl = nb.u64_to_ints(zu) if isinstance(z, np.ndarray) else z
        hw = _compute_h(r1cs, zl, dom, device, timings)
    ni = r1cs.num_instance

    if _device_msm_prove(device):
        msm_g1 = get_msm(G1)
        g2_on_device = not _native_ok()
        with _phase(f"prove::MSMs G1 {device} ({r1cs.num_vars} vars)", timings, "msm"):
            g2_out: dict = {}
            worker = None
            if not g2_on_device:
                def g2_worker():
                    t0 = time.perf_counter()
                    try:
                        g2_out["bz2"] = nb.msm_g2_raw(zu, pk.native_g2_table())
                    except BaseException as e:  # re-raised on the main thread
                        g2_out["error"] = e
                    g2_out["seconds"] = time.perf_counter() - t0

                # the G2 MSM runs on the host beside the fold: the ctypes
                # call releases the GIL while this thread enqueues the
                # launches
                worker = threading.Thread(target=g2_worker, name="prove-msm-g2")
                worker.start()
            try:
                t0 = time.perf_counter()
                # one z plane, shared by a, b1, (sliced) l and G2's b; h
                # stays on the device
                zsc = limb.u64_to_words(zu, device)
                nh = dom.n - 1
                problems = [
                    _msm_problem(pk, name, sc, msm_g1, device)
                    for name, sc in (("a_query", zsc), ("b_g1_query", zsc),
                                     ("h_query", hw[:nh]), ("l_query", zsc[ni:]))]
                # the fold, or with it off (CRESCENT_PROVE_FUSED, or the
                # affine route off) the four as one batch
                fold = msm_g1.run_device_fold(problems) if _prove_fused() else None
                if fold is None:
                    g1 = msm_g1.run_device_many(problems)
                else:
                    g1 = JPoints(*(torch.stack(c) for c in zip(*fold)))
                if g2_on_device:
                    # enqueued behind the fold before anything is read
                    # back, so the one wait below covers both
                    t1 = time.perf_counter()
                    msm_g2 = get_g2_msm()
                    nv = r1cs.num_vars
                    res2 = msm_g2.run_device(*_msm_problem(pk, "b_g2_query", zsc[:nv], msm_g2,
                                                           device))
                    g2_enqueue = time.perf_counter() - t1
                az, bz1, hq, lw = msm_g1.ctx.points_to_host(g1)
                g1_seconds = time.perf_counter() - t0
                if g2_on_device:
                    t1 = time.perf_counter()
                    g2_out["bz2"] = msm_g2.ctx.points_to_host(
                        JPoints(*(a[None] for a in res2)))[0]
                    g2_out["seconds"] = g2_enqueue + time.perf_counter() - t1
                    g1_seconds -= g2_enqueue
            finally:
                if worker is not None:
                    worker.join()
            if "error" in g2_out:
                raise g2_out["error"]
            bz2 = g2_out["bz2"]
            if timings is not None:
                timings["msm_g1"] = timings.get("msm_g1", 0.0) + g1_seconds
                timings["msm_g2"] = timings.get("msm_g2", 0.0) + g2_out["seconds"]
    else:
        with _phase(f"prove::MSMs native ({r1cs.num_vars} vars)", timings, "msm"):
            t0 = time.perf_counter()
            zr = nb.u64_to_ints(zu)
            h = nb.u64_to_ints(limb.words_to_u64(hw[: dom.n - 1]))
            az = nb.msm("bn254_g1", zr, pk.a_query)
            bz1 = nb.msm("bn254_g1", zr, pk.b_g1_query)
            hq = nb.msm("bn254_g1", h, pk.h_query)
            lw = nb.msm("bn254_g1", zr[ni:], pk.l_query)
            t1 = time.perf_counter()
            bz2 = nb.msm_g2(zr, pk.b_g2_query)
            if timings is not None:
                timings["msm_g1"] = timings.get("msm_g1", 0.0) + t1 - t0
                timings["msm_g2"] = timings.get("msm_g2", 0.0) + time.perf_counter() - t1

    with _phase("prove::assemble", timings, "assemble"):
        vk = pk.vk
        # A = alpha + sum z_i A_i(t) + r*delta
        A = G1.add(G1.add(vk.alpha_g1, az), G1.mul(r, pk.delta_g1))
        # B(G2) = beta + sum z_i B_i(t) + s*delta ; B(G1) likewise
        B2 = G2.add(G2.add(vk.beta_g2, bz2), G2.mul(s, vk.delta_g2))
        B1 = G1.add(G1.add(pk.beta_g1, bz1), G1.mul(s, pk.delta_g1))
        # C = l + h + sA + rB1 - rs*delta
        C = G1.add(lw, hq)
        C = G1.add(C, G1.mul(s, A))
        C = G1.add(C, G1.mul(r, B1))
        C = G1.add(C, G1.neg(G1.mul(r * s % R, pk.delta_g1)))
    return Proof(A, B2, C)


def prepare_inputs(vk: VerifyingKey, public_inputs: list[int], device="cuda"):
    """gamma_abc[0] + sum_i pub_i * gamma_abc[i+1]  (verifier.rs:25): the
    MSM on the native host backend, or with it off (CRESCENT_NATIVE=0) by
    ``get_msm(G1, lanes=8).run_host`` on `device`, as the reference does."""
    assert len(public_inputs) == len(vk.gamma_abc_g1) - 1
    acc = vk.gamma_abc_g1[0]
    if public_inputs:
        if _native_ok():
            _require_native()
            acc = G1.add(acc, nb.msm("bn254_g1", [x % R for x in public_inputs],
                                     vk.gamma_abc_g1[1:]))
        else:
            acc = G1.add(acc, get_msm(G1, lanes=8).run_host(public_inputs,
                                                            vk.gamma_abc_g1[1:], device))
    return acc


def verify_with_prepared_inputs(pvk: PreparedVerifyingKey, proof: Proof,
                                prepared) -> bool:
    """e(A,B) == e(alpha,beta) * e(prepared, gamma) * e(C, delta)."""
    vk = pvk.vk
    f = pr.multi_pairing(
        [
            (proof.a, proof.b),
            (G1.neg(prepared), vk.gamma_g2),
            (G1.neg(proof.c), vk.delta_g2),
        ]
    )
    return f == pvk.alpha_beta


def verify(pvk: PreparedVerifyingKey, proof: Proof, public_inputs: list[int],
           device="cuda") -> bool:
    """The pairing check; `device` is where `prepare_inputs` runs its MSM
    when the native backend is off."""
    return verify_with_prepared_inputs(
        pvk, proof, prepare_inputs(pvk.vk, public_inputs, device))


def rerandomize_proof(vk: VerifyingKey, proof: Proof, rng: random.Random,
                      r1: Optional[int] = None, r2: Optional[int] = None) -> Proof:
    """Unlinkable rerandomization (BKSV20 fig.1; forks/groth16/src/prover.rs:227):
    A' = r1*A,  B' = (1/r1)*B + r2*delta_g2,  C' = C + r1*r2*A.  Host group
    operations; r1 is drawn before r2, as in the reference."""
    r1 = rng.randrange(1, R) if r1 is None else r1
    r2 = rng.randrange(R) if r2 is None else r2
    A2 = G1.mul(r1, proof.a)
    B2 = G2.add(G2.mul(pow(r1, -1, R), proof.b), G2.mul(r2, vk.delta_g2))
    C2 = G1.add(proof.c, G1.mul(r1 * r2 % R, proof.a))
    return Proof(A2, B2, C2)
