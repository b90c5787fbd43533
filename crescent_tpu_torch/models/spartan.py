"""Spartan proof-system primitives over T-256's scalar field.

Counterpart of ``crescent_tpu/models/spartan.py`` and equivalent of
forks/Spartan-t256 (the NIZK behind the ECDSA device-binding proof,
SURVEY.md §2c): dense multilinear polynomials, the sumcheck protocol
(quadratic/cubic rounds), Pedersen vector commitments over T-256, and the
R1CS-satisfiability sumcheck instance.

Its MSMs over T-256 and its field loops run on the native host backend, as
the reference's defaults do.  With the backend off (``CRESCENT_NATIVE=0``)
they take the reference's device routes: ``commit_vector``'s and
``_t256_msm``'s ``get_msm(T256).run_host`` and ``poly_commit``'s row
commits as one ``run_device_many``, each the small-MSM path (at most 1,024
points: ``CurveCtx.scalar_mul`` on the ``jadd`` and ``jdbl`` kernels over
T-256's base field, above 2^255, then a ``jadd`` tree).  Those three take a
keyword-only ``device``, the card by default; without a card they raise the
port's "no CUDA device" error unless given the CPU, where the kernels' plain
versions run.  Everything else is the reference's code.

Second half of this module: the full zero-knowledge NIZK assembly —
halo2curves-compatible SSWU generator derivation (commitments.rs:19-41),
the sigma-protocol zoo (Knowledge/Equality/Product/DotProduct proofs,
nizk/mod.rs), the Bulletproofs reduction (nizk/bullet.rs), zk-sumcheck
with committed round polynomials (sumcheck.rs:429-778), the sqrt-split
polynomial commitment + evaluation proof (dense_mlpoly.rs:181-404), the
two-phase R1CS satisfiability argument (r1csproof.rs:78-492) and the
public NIZK::prove/verify API (lib.rs:624-709).  Transcript framing
(labels, 33-byte compressed points, 64-byte wide scalar challenges)
follows the reference byte-for-byte.

Field: T-256 scalar = P-256 base prime, so commitments here can carry P-256
coordinates natively (the whole point of the Tom-256 curve).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..core.curves import T256, AffinePoint
from ..core.fields import T256_FQ as Q  # scalar field of T-256
from ..native import backend as nb
from ..utils.merlin import Transcript

# ---------------------------------------------------------------------------
# Dense multilinear polynomials (dense_mlpoly.rs)
# ---------------------------------------------------------------------------


def _nb_ok() -> bool:
    """Native host backend for the prover's O(n)-per-round field loops
    (sumcheck round evals, variable binds, eq tables) — the reference runs
    these multithreaded in Rust (sumcheck.rs:430-778); pure-Python bigints
    were the dominant prove cost."""
    import os

    return os.environ.get("CRESCENT_NATIVE", "1") == "1" and nb.available()


def _t256_device_msm(scalars, points, device):
    """The reference's device route for one T-256 MSM:
    ``get_msm(T256).run_host`` on `device`, which must exist."""
    from ..ops.msm import get_msm
    from .groth16 import _device

    return get_msm(T256).run_host(scalars, points, device=_device(device))


class DenseMlPoly:
    """Multilinear polynomial in evaluation form over {0,1}^m.

    evals[i] is the value at the bit-vector of i (little-endian: bit 0 of i
    is variable x_0... matching Spartan's ordering where `bound_poly_var_top`
    fixes the MOST significant variable).

    Backed by EITHER a Python int list or a (n, 4) u64 numpy array (native
    standard-form limbs); each materializes lazily from the other so the
    native sumcheck path never round-trips through bigints."""

    def __init__(self, evals: list[int] | None, u64=None):
        if u64 is not None:
            self._u64 = u64
            self._evals = None
            self._n = u64.shape[0]
        else:
            n = len(evals)
            self._evals = [e % Q for e in evals]
            self._u64 = None
            self._n = n
        assert self._n & (self._n - 1) == 0

    @property
    def evals(self) -> list[int]:
        if self._evals is None:
            self._evals = nb.u64_to_ints(self._u64)
        return self._evals

    def u64(self):
        if self._u64 is None:
            self._u64 = nb.ints_to_u64(self._evals)
        return self._u64

    @property
    def num_vars(self) -> int:
        return self._n.bit_length() - 1

    def bound_poly_var_top(self, r: int) -> "DenseMlPoly":
        """Fix the top variable to r: new[i] = (1-r)*lo[i] + r*hi[i]."""
        if _nb_ok():
            return DenseMlPoly(None, u64=nb.bind_top(Q, self.u64(), r))
        half = len(self.evals) // 2
        lo, hi = self.evals[:half], self.evals[half:]
        return DenseMlPoly([(l + r * (h - l)) % Q for l, h in zip(lo, hi)])

    def evaluate(self, rs: list[int]) -> int:
        """Evaluate at a point (top variable first, Spartan convention)."""
        p = self
        for r in rs:
            p = p.bound_poly_var_top(r)
        assert p._n == 1
        return p.evals[0]


def eq_evals(rs: list[int]) -> list[int]:
    """Evaluations of eq(x, r) over x in {0,1}^m (EqPolynomial::evals)."""
    if rs and _nb_ok():
        return nb.u64_to_ints(nb.eq_evals(Q, rs))
    evals = [1]
    for r in rs:
        out = []
        for e in evals:
            out.append(e * (1 - r) % Q)
        for e in evals:
            out.append(e * r % Q)
        evals = out
    return evals


def _quad_round_evals(a: DenseMlPoly, b: DenseMlPoly) -> tuple[int, int]:
    """(g(0), g(2)) for g(t) = sum_i A_t(i)*B_t(i) over the bound tables."""
    if _nb_ok():
        return nb.sumcheck_quad(Q, a.u64(), b.u64())
    half = len(a.evals) // 2
    e0 = sum(a.evals[i] * b.evals[i] for i in range(half)) % Q
    e2 = 0
    for i in range(half):
        a2 = 2 * a.evals[half + i] - a.evals[i]
        b2 = 2 * b.evals[half + i] - b.evals[i]
        e2 += a2 * b2
    return e0, e2 % Q


_ZEROS_U64 = {}


def _cubic_round_evals(
    a: DenseMlPoly, b: DenseMlPoly, c: DenseMlPoly, d: DenseMlPoly | None
) -> tuple[int, int, int]:
    """(g(0), g(2), g(3)) for g(t) = sum_i A*(B*C - D); d=None means D=0."""
    if _nb_ok():
        if d is None:
            n = a._n
            if n not in _ZEROS_U64:
                import numpy as _np

                _ZEROS_U64[n] = _np.zeros((n, 4), dtype="<u8")
            du = _ZEROS_U64[n]
        else:
            du = d.u64()
        return nb.sumcheck_cubic(Q, a.u64(), b.u64(), c.u64(), du)
    half = len(a.evals) // 2
    e0 = e2 = e3 = 0
    for i in range(half):
        al, bl, cl = a.evals[i], b.evals[i], c.evals[i]
        ah, bh, ch = a.evals[half + i], b.evals[half + i], c.evals[half + i]
        dl = 0 if d is None else d.evals[i]
        dh = 0 if d is None else d.evals[half + i]
        e0 += al * ((bl * cl - dl) % Q)
        a2, b2, c2, d2 = 2 * ah - al, 2 * bh - bl, 2 * ch - cl, 2 * dh - dl
        e2 += a2 * ((b2 * c2 - d2) % Q)
        a3, b3, c3, d3 = a2 + ah - al, b2 + bh - bl, c2 + ch - cl, d2 + dh - dl
        e3 += a3 * ((b3 * c3 - d3) % Q)
    return e0 % Q, e2 % Q, e3 % Q


# ---------------------------------------------------------------------------
# Sumcheck (sumcheck.rs prove_quad / prove_cubic, non-ZK core)
# ---------------------------------------------------------------------------


def _challenge_scalar(ts: Transcript, label: bytes) -> int:
    return int.from_bytes(ts.challenge_bytes(label, 31), "little") % Q


def _append_poly(ts: Transcript, label: bytes, coeffs: list[int]):
    ts.append_message(label, b"".join(int(c % Q).to_bytes(32, "little") for c in coeffs))


@dataclass
class SumcheckProof:
    round_polys: list  # per round: coefficient list of the univariate poly


def sumcheck_prove_quad(
    poly_a: DenseMlPoly, poly_b: DenseMlPoly, claim: int, ts: Transcript
) -> tuple[SumcheckProof, list[int], tuple[int, int]]:
    """Prove sum_x A(x)*B(x) == claim.  Returns (proof, challenge point,
    final evaluations (A(r), B(r)))."""
    a, b = poly_a, poly_b
    num_rounds = a.num_vars
    e = claim % Q
    r_point = []
    round_polys = []
    for _ in range(num_rounds):
        # univariate g(t) = sum_i (a_lo + t(a_hi-a_lo)) * (b_lo + t(b_hi-b_lo))
        eval0, eval2 = _quad_round_evals(a, b)
        eval0 %= Q
        eval2 %= Q
        eval1 = (e - eval0) % Q  # g(0) + g(1) = e
        # interpolate degree-2 poly from g(0), g(1), g(2)
        c0 = eval0
        c2 = ((eval2 - 2 * eval1 + eval0) * pow(2, -1, Q)) % Q
        c1 = (eval1 - c0 - c2) % Q
        coeffs = [c0, c1, c2]
        _append_poly(ts, b"poly", coeffs)
        r = _challenge_scalar(ts, b"challenge_nextround")
        r_point.append(r)
        e = (c0 + c1 * r + c2 * r * r) % Q
        a = a.bound_poly_var_top(r)
        b = b.bound_poly_var_top(r)
        round_polys.append(coeffs)
    return SumcheckProof(round_polys), r_point, (a.evals[0], b.evals[0])


def sumcheck_prove_cubic(
    poly_a: DenseMlPoly, poly_b: DenseMlPoly, poly_c: DenseMlPoly, claim: int, ts: Transcript
) -> tuple[SumcheckProof, list[int], tuple[int, int, int]]:
    """Prove sum_x A(x)*B(x)*C(x) == claim (Spartan phase-1 shape with C=eq)."""
    a, b, c = poly_a, poly_b, poly_c
    num_rounds = a.num_vars
    e = claim % Q
    r_point = []
    round_polys = []
    for _ in range(num_rounds):
        g0, g2, g3 = _cubic_round_evals(a, b, c, None)
        g1 = (e - g0) % Q
        # interpolate cubic from g(0..3)
        c0 = g0
        # solve Vandermonde for c1, c2, c3
        #   g1 = c0 + c1 + c2 + c3
        #   g2 = c0 + 2c1 + 4c2 + 8c3
        #   g3 = c0 + 3c1 + 9c2 + 27c3
        d1 = (g1 - c0) % Q
        d2 = (g2 - c0) % Q
        d3 = (g3 - c0) % Q
        inv2, inv6 = pow(2, -1, Q), pow(6, -1, Q)
        c3 = ((d3 - 3 * d2 + 3 * d1) * inv6) % Q
        c2 = ((d2 - 2 * d1) * inv2 - 3 * c3) % Q
        c1 = (d1 - c2 - c3) % Q
        coeffs = [c0, c1, c2, c3]
        _append_poly(ts, b"poly", coeffs)
        r = _challenge_scalar(ts, b"challenge_nextround")
        r_point.append(r)
        e = (c0 + r * (c1 + r * (c2 + r * c3))) % Q
        a = a.bound_poly_var_top(r)
        b = b.bound_poly_var_top(r)
        c = c.bound_poly_var_top(r)
        round_polys.append(coeffs)
    return SumcheckProof(round_polys), r_point, (a.evals[0], b.evals[0], c.evals[0])


def sumcheck_verify(
    proof: SumcheckProof, claim: int, num_rounds: int, degree: int, ts: Transcript
) -> tuple[int, list[int]]:
    """Returns (final expected evaluation, challenge point); the caller must
    check it against the claimed polynomial opening."""
    e = claim % Q
    r_point = []
    for coeffs in proof.round_polys:
        assert len(coeffs) == degree + 1
        # g(0) + g(1) == e
        g0 = coeffs[0]
        g1 = sum(coeffs) % Q
        assert (g0 + g1) % Q == e, "sumcheck round check failed"
        _append_poly(ts, b"poly", coeffs)
        r = _challenge_scalar(ts, b"challenge_nextround")
        r_point.append(r)
        e = 0
        for c in reversed(coeffs):
            e = (e * r + c) % Q
    assert len(r_point) == num_rounds
    return e, r_point


# ---------------------------------------------------------------------------
# Pedersen vector commitments over T-256 (commitments.rs / NIZKGens)
# ---------------------------------------------------------------------------


def derive_generators(n: int, label: bytes) -> list[AffinePoint]:
    """n independent T-256 generators via hash-to-curve (size-derived, like
    NIZKGens lib.rs:591-609)."""
    out = []
    counter = 0
    while len(out) < n:
        digest = hashlib.sha512(label + counter.to_bytes(8, "little")).digest()
        x = int.from_bytes(digest[:32], "little") % T256.p
        try:
            out.append(T256.lift_x(x, digest[32] & 1))
        except ValueError:
            pass
        counter += 1
    return out


@dataclass
class PedersenGens:
    g: list[AffinePoint]  # vector bases
    h: AffinePoint        # blinding base


def pedersen_gens(n: int, label: bytes = b"crescent-tpu spartan gens") -> PedersenGens:
    pts = derive_generators(n + 1, label)
    return PedersenGens(pts[:n], pts[n])


def commit_vector(gens: PedersenGens, values: list[int], blind: int, *,
                  device="cuda") -> AffinePoint:
    bases = gens.g[: len(values)] + [gens.h]
    scalars = [v % Q for v in values] + [blind % Q]
    if len(bases) <= 16:
        return T256.msm(scalars, bases)
    if _nb_ok():
        return nb.msm("t256", scalars, bases)
    return _t256_device_msm(scalars, bases, device)


# ---------------------------------------------------------------------------
# R1CS-satisfiability phase-1 sumcheck (the algebra of r1csproof.rs:24-38):
# prove sum_x eq(tau, x) * (Az(x)*Bz(x) - Cz(x)) == 0.
# ---------------------------------------------------------------------------


def r1cs_phase1_prove(
    az: list[int], bz: list[int], cz: list[int], tau: list[int], ts: Transcript
) -> tuple[SumcheckProof, list[int], tuple[int, int, int, int]]:
    """Cubic sumcheck over G(x) = eq(x)*(A(x)*B(x) - C(x)), claim 0.
    Returns (proof, r, (eq(r), A(r), B(r), C(r)))."""
    eq = DenseMlPoly(eq_evals(tau))
    A, B, C = DenseMlPoly(az), DenseMlPoly(bz), DenseMlPoly(cz)
    e = 0
    r_point = []
    round_polys = []
    for _ in range(A.num_vars):
        g0, g2, g3 = _cubic_round_evals(eq, A, B, C)
        g1 = (e - g0) % Q
        c0 = g0
        d1, d2, d3 = (g1 - c0) % Q, (g2 - c0) % Q, (g3 - c0) % Q
        inv2, inv6 = pow(2, -1, Q), pow(6, -1, Q)
        c3 = ((d3 - 3 * d2 + 3 * d1) * inv6) % Q
        c2 = ((d2 - 2 * d1) * inv2 - 3 * c3) % Q
        c1 = (d1 - c2 - c3) % Q
        coeffs = [c0, c1, c2, c3]
        _append_poly(ts, b"poly", coeffs)
        r = _challenge_scalar(ts, b"challenge_nextround")
        r_point.append(r)
        e = (c0 + r * (c1 + r * (c2 + r * c3))) % Q
        eq = eq.bound_poly_var_top(r)
        A = A.bound_poly_var_top(r)
        B = B.bound_poly_var_top(r)
        C = C.bound_poly_var_top(r)
        round_polys.append(coeffs)
    return (
        SumcheckProof(round_polys),
        r_point,
        (eq.evals[0], A.evals[0], B.evals[0], C.evals[0]),
    )


# ===========================================================================
# Full Spartan NIZK (zero-knowledge variant)
# ===========================================================================

import os as _os

from ..utils.hash_to_curve import t256_hash_to_curve
from ..utils.serialize import deser_t256_compressed, ser_t256_compressed


def _scalar_bytes(x: int) -> bytes:
    return int(x % Q).to_bytes(32, "little")


# --- transcript framing (transcript.rs) ------------------------------------


def ts_append_protocol_name(ts: Transcript, name: bytes):
    ts.append_message(b"protocol-name", name)


def ts_append_scalar(ts: Transcript, label: bytes, x: int):
    ts.append_message(label, _scalar_bytes(x))


def ts_append_point(ts: Transcript, label: bytes, comp: bytes):
    ts.append_message(label, comp)


def ts_challenge_scalar(ts: Transcript, label: bytes) -> int:
    # 64 uniform bytes -> from_uniform_bytes (little-endian wide reduction)
    return int.from_bytes(ts.challenge_bytes(label, 64), "little") % Q


def ts_challenge_vector(ts: Transcript, label: bytes, n: int) -> list[int]:
    return [ts_challenge_scalar(ts, label) for _ in range(n)]


def ts_append_scalars(ts: Transcript, label: bytes, xs) -> None:
    """[Scalar]::append_to_transcript framing (transcript.rs:51-59)."""
    ts.append_message(label, b"begin_append_vector")
    for x in xs:
        ts_append_scalar(ts, label, x)
    ts.append_message(label, b"end_append_vector")


class RandomTape:
    """Prover randomness from a transcript seeded with OS entropy
    (random.rs)."""

    def __init__(self, name: bytes = b"proof"):
        self.tape = Transcript(name)
        ts_append_scalar(
            self.tape, b"init_randomness", int.from_bytes(_os.urandom(48), "little") % Q
        )

    def scalar(self, label: bytes) -> int:
        return ts_challenge_scalar(self.tape, label)

    def vector(self, label: bytes, n: int) -> list[int]:
        return ts_challenge_vector(self.tape, label, n)


# --- generators + Pedersen commitments (commitments.rs) --------------------


def _t256_msm(scalars, points, *, device="cuda"):
    pts, scs = [], []
    for s, p in zip(scalars, points):
        if p is None or s % Q == 0:
            continue
        scs.append(s % Q)
        pts.append(p)
    if not pts:
        return None
    if len(pts) <= 32:
        return T256.msm(scs, pts)
    if _nb_ok():
        return nb.msm("t256", scs, pts)
    return _t256_device_msm(scs, pts, device)


_GENS_CACHE: dict = {}


class MultiCommitGens:
    """n vector bases + blinding base h, derived with Shake256 XOF over
    (label || compressed basepoint) and SSWU hash-to-curve per 64-byte block
    (commitments.rs:19-41)."""

    __slots__ = ("n", "G", "h")

    def __init__(self, n: int, G: list, h):
        self.n, self.G, self.h = n, G, h

    @staticmethod
    def new(n: int, label: bytes) -> "MultiCommitGens":
        key = (n, label)
        if key in _GENS_CACHE:
            return _GENS_CACHE[key]
        basepoint = ser_t256_compressed(T256.generator)
        xof = hashlib.shake_256(label + basepoint).digest(64 * (n + 1))
        pts = [
            t256_hash_to_curve(xof[64 * i : 64 * (i + 1)]) for i in range(n + 1)
        ]
        out = MultiCommitGens(n, pts[:n], pts[n])
        _GENS_CACHE[key] = out
        return out

    def scale(self, s: int) -> "MultiCommitGens":
        return MultiCommitGens(self.n, [T256.mul(s % Q, g) for g in self.G], self.h)

    def split_at(self, mid: int):
        return (
            MultiCommitGens(mid, self.G[:mid], self.h),
            MultiCommitGens(self.n - mid, self.G[mid:], self.h),
        )


def commit1(x: int, blind: int, gens: MultiCommitGens):
    assert gens.n == 1
    return _t256_msm([x, blind], [gens.G[0], gens.h])


def commitv(xs, blind: int, gens: MultiCommitGens):
    assert gens.n == len(xs)
    return _t256_msm(list(xs) + [blind], gens.G + [gens.h])


def _comp(pt) -> bytes:
    return ser_t256_compressed(pt)


def _decomp(b: bytes):
    return deser_t256_compressed(b)


class SpartanError(Exception):
    pass


def _require(cond: bool, what: str):
    if not cond:
        raise SpartanError(what)


# --- univariate round polynomials (unipoly.rs) ------------------------------


class UniPoly:
    """Degree-2/3 univariate in coefficient form, built from evaluations at
    0..deg (unipoly.rs:24-55)."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: list[int]):
        self.coeffs = [c % Q for c in coeffs]

    @staticmethod
    def from_evals(evals: list[int]) -> "UniPoly":
        assert len(evals) in (3, 4)
        inv2 = pow(2, -1, Q)
        if len(evals) == 3:
            c = evals[0]
            a = inv2 * (evals[2] - 2 * evals[1] + c) % Q
            b = (evals[1] - c - a) % Q
            return UniPoly([c, b, a])
        inv6 = pow(6, -1, Q)
        d = evals[0]
        a = inv6 * (evals[3] - 3 * evals[2] + 3 * evals[1] - evals[0]) % Q
        b = inv2 * (2 * evals[0] - 5 * evals[1] + 4 * evals[2] - evals[3]) % Q
        c = (evals[1] - d - a - b) % Q
        return UniPoly([d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, r: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % Q
        return acc

    def commit(self, gens: MultiCommitGens, blind: int):
        return commitv(self.coeffs, blind, gens)


# --- sigma protocols (nizk/mod.rs) ------------------------------------------


@dataclass
class KnowledgeProof:
    """PoK of (x, r) in C = x*G + r*H (nizk/mod.rs:18-77)."""

    alpha: bytes
    z1: int
    z2: int

    @staticmethod
    def prove(gens1: MultiCommitGens, ts: Transcript, tape: RandomTape, x: int, r: int):
        ts_append_protocol_name(ts, b"knowledge proof")
        t1, t2 = tape.scalar(b"t1"), tape.scalar(b"t2")
        C = _comp(commit1(x, r, gens1))
        ts_append_point(ts, b"C", C)
        alpha = _comp(commit1(t1, t2, gens1))
        ts_append_point(ts, b"alpha", alpha)
        c = ts_challenge_scalar(ts, b"c")
        return KnowledgeProof(alpha, (x * c + t1) % Q, (r * c + t2) % Q), C

    def verify(self, gens1: MultiCommitGens, ts: Transcript, C: bytes):
        ts_append_protocol_name(ts, b"knowledge proof")
        ts_append_point(ts, b"C", C)
        ts_append_point(ts, b"alpha", self.alpha)
        c = ts_challenge_scalar(ts, b"c")
        lhs = commit1(self.z1, self.z2, gens1)
        rhs = T256.add(T256.mul(c, _decomp(C)), _decomp(self.alpha))
        _require(lhs == rhs, "knowledge proof")


@dataclass
class EqualityProof:
    """C1, C2 commit the same value (nizk/mod.rs:80-146)."""

    alpha: bytes
    z: int

    @staticmethod
    def prove(
        gens1: MultiCommitGens, ts: Transcript, tape: RandomTape,
        v1: int, s1: int, v2: int, s2: int,
    ):
        ts_append_protocol_name(ts, b"equality proof")
        r = tape.scalar(b"r")
        C1 = _comp(commit1(v1, s1, gens1))
        ts_append_point(ts, b"C1", C1)
        C2 = _comp(commit1(v2, s2, gens1))
        ts_append_point(ts, b"C2", C2)
        alpha = _comp(T256.mul(r, gens1.h))
        ts_append_point(ts, b"alpha", alpha)
        c = ts_challenge_scalar(ts, b"c")
        return EqualityProof(alpha, (c * (s1 - s2) + r) % Q), C1, C2

    def verify(self, gens1: MultiCommitGens, ts: Transcript, C1: bytes, C2: bytes):
        ts_append_protocol_name(ts, b"equality proof")
        ts_append_point(ts, b"C1", C1)
        ts_append_point(ts, b"C2", C2)
        ts_append_point(ts, b"alpha", self.alpha)
        c = ts_challenge_scalar(ts, b"c")
        Cdiff = T256.add(_decomp(C1), T256.neg(_decomp(C2)))
        rhs = T256.add(T256.mul(c, Cdiff), _decomp(self.alpha))
        _require(T256.mul(self.z, gens1.h) == rhs, "equality proof")


@dataclass
class ProductProof:
    """Z commits x*y given X, Y commitments (nizk/mod.rs:149-293)."""

    alpha: bytes
    beta: bytes
    delta: bytes
    z: list[int]  # z1..z5

    @staticmethod
    def prove(
        gens1: MultiCommitGens, ts: Transcript, tape: RandomTape,
        x: int, rX: int, y: int, rY: int, zval: int, rZ: int,
    ):
        ts_append_protocol_name(ts, b"product proof")
        b1, b2, b3, b4, b5 = (tape.scalar(lb) for lb in (b"b1", b"b2", b"b3", b"b4", b"b5"))
        X = _comp(commit1(x, rX, gens1))
        ts_append_point(ts, b"X", X)
        Y = _comp(commit1(y, rY, gens1))
        ts_append_point(ts, b"Y", Y)
        Z = _comp(commit1(zval, rZ, gens1))
        ts_append_point(ts, b"Z", Z)
        alpha = _comp(commit1(b1, b2, gens1))
        ts_append_point(ts, b"alpha", alpha)
        beta = _comp(commit1(b3, b4, gens1))
        ts_append_point(ts, b"beta", beta)
        gens_X = MultiCommitGens(1, [_decomp(X)], gens1.h)
        delta = _comp(commit1(b3, b5, gens_X))
        ts_append_point(ts, b"delta", delta)
        c = ts_challenge_scalar(ts, b"c")
        zs = [
            (b1 + c * x) % Q,
            (b2 + c * rX) % Q,
            (b3 + c * y) % Q,
            (b4 + c * rY) % Q,
            (b5 + c * (rZ - rX * y)) % Q,
        ]
        return ProductProof(alpha, beta, delta, zs), X, Y, Z

    def verify(self, gens1: MultiCommitGens, ts: Transcript, X: bytes, Y: bytes, Z: bytes):
        ts_append_protocol_name(ts, b"product proof")
        for lb, P in ((b"X", X), (b"Y", Y), (b"Z", Z),
                      (b"alpha", self.alpha), (b"beta", self.beta), (b"delta", self.delta)):
            ts_append_point(ts, lb, P)
        c = ts_challenge_scalar(ts, b"c")
        z1, z2, z3, z4, z5 = self.z

        def check(P: bytes, Xc: bytes, g: MultiCommitGens, za: int, zb: int) -> bool:
            lhs = T256.add(_decomp(P), T256.mul(c, _decomp(Xc)))
            return lhs == commit1(za, zb, g)

        gens_X = MultiCommitGens(1, [_decomp(X)], gens1.h)
        _require(
            check(self.alpha, X, gens1, z1, z2)
            and check(self.beta, Y, gens1, z3, z4)
            and check(self.delta, Z, gens_X, z3, z5),
            "product proof",
        )


@dataclass
class DotProductProof:
    """<x_vec, a_vec> = y under commitments, linear size (nizk/mod.rs:296-408)."""

    delta: bytes
    beta: bytes
    z: list[int]
    z_delta: int
    z_beta: int

    @staticmethod
    def prove(
        gens1: MultiCommitGens, gensn: MultiCommitGens, ts: Transcript, tape: RandomTape,
        x_vec, blind_x: int, a_vec, y: int, blind_y: int,
    ):
        ts_append_protocol_name(ts, b"dot product proof")
        n = len(x_vec)
        assert n == len(a_vec) == gensn.n and gens1.n == 1
        d_vec = tape.vector(b"d_vec", n)
        r_delta, r_beta = tape.scalar(b"r_delta"), tape.scalar(b"r_beta")
        Cx = _comp(commitv(x_vec, blind_x, gensn))
        ts_append_point(ts, b"Cx", Cx)
        Cy = _comp(commit1(y, blind_y, gens1))
        ts_append_point(ts, b"Cy", Cy)
        ts_append_scalars(ts, b"a", a_vec)
        delta = _comp(commitv(d_vec, r_delta, gensn))
        ts_append_point(ts, b"delta", delta)
        dot_ad = sum(a * d for a, d in zip(a_vec, d_vec)) % Q
        beta = _comp(commit1(dot_ad, r_beta, gens1))
        ts_append_point(ts, b"beta", beta)
        c = ts_challenge_scalar(ts, b"c")
        z = [(c * x + d) % Q for x, d in zip(x_vec, d_vec)]
        return (
            DotProductProof(delta, beta, z, (c * blind_x + r_delta) % Q, (c * blind_y + r_beta) % Q),
            Cx,
            Cy,
        )

    def verify(
        self, gens1: MultiCommitGens, gensn: MultiCommitGens, ts: Transcript,
        a_vec, Cx: bytes, Cy: bytes,
    ):
        assert gensn.n == len(a_vec) and gens1.n == 1
        ts_append_protocol_name(ts, b"dot product proof")
        ts_append_point(ts, b"Cx", Cx)
        ts_append_point(ts, b"Cy", Cy)
        ts_append_scalars(ts, b"a", a_vec)
        ts_append_point(ts, b"delta", self.delta)
        ts_append_point(ts, b"beta", self.beta)
        c = ts_challenge_scalar(ts, b"c")
        lhs1 = T256.add(T256.mul(c, _decomp(Cx)), _decomp(self.delta))
        _require(lhs1 == commitv(self.z, self.z_delta, gensn), "dot product (1)")
        dot_za = sum(zi * ai for zi, ai in zip(self.z, a_vec)) % Q
        lhs2 = T256.add(T256.mul(c, _decomp(Cy)), _decomp(self.beta))
        _require(lhs2 == commit1(dot_za, self.z_beta, gens1), "dot product (2)")


class DotProductProofGens:
    """(gens_n, gens_1) split of an (n+1)-element family (nizk/mod.rs:411-422)."""

    def __init__(self, n: int, label: bytes):
        self.n = n
        self.gens_n, self.gens_1 = MultiCommitGens.new(n + 1, label).split_at(n)


@dataclass
class BulletReductionProof:
    """Bulletproofs inner-product reduction (nizk/bullet.rs:21-242)."""

    L_vec: list[bytes]
    R_vec: list[bytes]

    @staticmethod
    def prove(ts: Transcript, Qp, G_vec: list, H, a_vec, b_vec, blind: int, blinds_vec):
        G = list(G_vec)
        a = [x % Q for x in a_vec]
        b = [x % Q for x in b_vec]
        n = len(G)
        assert n & (n - 1) == 0 and len(a) == len(b) == n
        lg_n = n.bit_length() - 1
        assert len(blinds_vec) == 2 * lg_n
        L_vec, R_vec = [], []
        blind_fin = blind % Q
        bi = iter(blinds_vec)
        while n != 1:
            n //= 2
            aL, aR = a[:n], a[n:]
            bL, bR = b[:n], b[n:]
            GL, GR = G[:n], G[n:]
            cL = sum(x * y for x, y in zip(aL, bR)) % Q
            cR = sum(x * y for x, y in zip(aR, bL)) % Q
            blind_L, blind_R = next(bi)
            L = _t256_msm(aL + [cL, blind_L], GR + [Qp, H])
            R = _t256_msm(aR + [cR, blind_R], GL + [Qp, H])
            ts_append_point(ts, b"L", _comp(L))
            ts_append_point(ts, b"R", _comp(R))
            u = ts_challenge_scalar(ts, b"u")
            u_inv = pow(u, -1, Q)
            a = [(x * u + u_inv * y) % Q for x, y in zip(aL, aR)]
            b = [(x * u_inv + u * y) % Q for x, y in zip(bL, bR)]
            G = [_t256_msm([u_inv, u], [gl, gr]) for gl, gr in zip(GL, GR)]
            blind_fin = (blind_fin + blind_L * u * u + blind_R * u_inv * u_inv) % Q
            L_vec.append(_comp(L))
            R_vec.append(_comp(R))
        G0 = G[0]
        Gamma_hat = _t256_msm([a[0], a[0] * b[0] % Q, blind_fin], [G0, Qp, H])
        return BulletReductionProof(L_vec, R_vec), Gamma_hat, a[0], b[0], G0, blind_fin

    def _verification_scalars(self, n: int, ts: Transcript):
        lg_n = len(self.L_vec)
        _require(lg_n < 32 and n == (1 << lg_n), "bullet size")
        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            ts_append_point(ts, b"L", L)
            ts_append_point(ts, b"R", R)
            challenges.append(ts_challenge_scalar(ts, b"u"))
        challenges_inv = [pow(u, -1, Q) for u in challenges]
        allinv = 1
        for ui in challenges_inv:
            allinv = allinv * ui % Q
        u_sq = [u * u % Q for u in challenges]
        u_inv_sq = [u * u % Q for u in challenges_inv]
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * u_sq[(lg_n - 1) - lg_i] % Q)
        return u_sq, u_inv_sq, s

    def verify(self, n: int, a_vec, ts: Transcript, Gamma, G_vec: list):
        u_sq, u_inv_sq, s = self._verification_scalars(n, ts)
        Ls = [_decomp(L) for L in self.L_vec]
        Rs = [_decomp(R) for R in self.R_vec]
        G_hat = _t256_msm(s, G_vec)
        a_hat = sum(x * y for x, y in zip(a_vec, s)) % Q
        Gamma_hat = _t256_msm(u_sq + u_inv_sq + [1], Ls + Rs + [Gamma])
        return G_hat, Gamma_hat, a_hat


@dataclass
class DotProductProofLog:
    """log-size dot-product argument via bullet reduction
    (nizk/mod.rs:425-580)."""

    bullet: BulletReductionProof
    delta: bytes
    beta: bytes
    z1: int
    z2: int

    @staticmethod
    def prove(
        gens: DotProductProofGens, ts: Transcript, tape: RandomTape,
        x_vec, blind_x: int, a_vec, y: int, blind_y: int,
    ):
        ts_append_protocol_name(ts, b"dot product proof (log)")
        n = len(x_vec)
        assert n == len(a_vec) == gens.n
        lg_n = n.bit_length() - 1
        d = tape.scalar(b"d")
        r_delta = tape.scalar(b"r_delta")
        r_beta = tape.scalar(b"r_delta")
        v1 = tape.vector(b"blinds_vec_1", 2 * lg_n)
        v2 = tape.vector(b"blinds_vec_2", 2 * lg_n)
        blinds_vec = list(zip(v1, v2))
        Cx = _comp(commitv(x_vec, blind_x, gens.gens_n))
        ts_append_point(ts, b"Cx", Cx)
        Cy = _comp(commit1(y, blind_y, gens.gens_1))
        ts_append_point(ts, b"Cy", Cy)
        ts_append_scalars(ts, b"a", a_vec)
        r = ts_challenge_scalar(ts, b"r")
        gens_1_scaled = gens.gens_1.scale(r)
        blind_Gamma = (blind_x + r * blind_y) % Q
        bullet, _Gamma_hat, x_hat, a_hat, g_hat, rhat_Gamma = BulletReductionProof.prove(
            ts, gens_1_scaled.G[0], gens.gens_n.G, gens.gens_n.h,
            x_vec, a_vec, blind_Gamma, blinds_vec,
        )
        y_hat = x_hat * a_hat % Q
        gens_hat = MultiCommitGens(1, [g_hat], gens.gens_1.h)
        delta = _comp(commit1(d, r_delta, gens_hat))
        ts_append_point(ts, b"delta", delta)
        beta = _comp(commit1(d, r_beta, gens_1_scaled))
        ts_append_point(ts, b"beta", beta)
        c = ts_challenge_scalar(ts, b"c")
        z1 = (d + c * y_hat) % Q
        z2 = (a_hat * (c * rhat_Gamma + r_beta) + r_delta) % Q
        return DotProductProofLog(bullet, delta, beta, z1, z2), Cx, Cy

    def verify(
        self, n: int, gens: DotProductProofGens, ts: Transcript,
        a_vec, Cx: bytes, Cy: bytes,
    ):
        assert gens.n == n and len(a_vec) == n
        ts_append_protocol_name(ts, b"dot product proof (log)")
        ts_append_point(ts, b"Cx", Cx)
        ts_append_point(ts, b"Cy", Cy)
        ts_append_scalars(ts, b"a", a_vec)
        r = ts_challenge_scalar(ts, b"r")
        gens_1_scaled = gens.gens_1.scale(r)
        Gamma = T256.add(_decomp(Cx), T256.mul(r, _decomp(Cy)))
        g_hat, Gamma_hat, a_hat = self.bullet.verify(n, a_vec, ts, Gamma, gens.gens_n.G)
        ts_append_point(ts, b"delta", self.delta)
        ts_append_point(ts, b"beta", self.beta)
        c = ts_challenge_scalar(ts, b"c")
        lhs = T256.add(
            T256.mul(a_hat, T256.add(T256.mul(c, Gamma_hat), _decomp(self.beta))),
            _decomp(self.delta),
        )
        rhs = T256.add(
            T256.mul(self.z1, T256.add(g_hat, T256.mul(a_hat, gens_1_scaled.G[0]))),
            T256.mul(self.z2, gens_1_scaled.h),
        )
        _require(lhs == rhs, "dot product (log)")


# --- zero-knowledge sumcheck (sumcheck.rs:429-778) ---------------------------


@dataclass
class ZKSumcheckInstanceProof:
    comm_polys: list[bytes]
    comm_evals: list[bytes]
    proofs: list[DotProductProof]

    def verify(
        self, comm_claim: bytes, num_rounds: int, degree_bound: int,
        gens_1: MultiCommitGens, gens_n: MultiCommitGens, ts: Transcript,
    ) -> tuple[bytes, list[int]]:
        assert gens_n.n == degree_bound + 1
        _require(len(self.comm_polys) == num_rounds, "zk-sumcheck rounds")
        _require(len(self.comm_evals) == num_rounds, "zk-sumcheck evals")
        r: list[int] = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            ts_append_point(ts, b"comm_poly", comm_poly)
            r_i = ts_challenge_scalar(ts, b"challenge_nextround")
            comm_claim_per_round = comm_claim if i == 0 else self.comm_evals[i - 1]
            comm_eval = self.comm_evals[i]
            ts_append_point(ts, b"comm_claim_per_round", comm_claim_per_round)
            ts_append_point(ts, b"comm_eval", comm_eval)
            w = ts_challenge_vector(ts, b"combine_two_claims_to_one", 2)
            comm_target = _comp(
                _t256_msm(w, [_decomp(comm_claim_per_round), _decomp(comm_eval)])
            )
            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1]
            for _ in range(degree_bound):
                a_eval.append(a_eval[-1] * r_i % Q)
            a = [(w[0] * x + w[1] * y) % Q for x, y in zip(a_sc, a_eval)]
            self.proofs[i].verify(gens_1, gens_n, ts, a, comm_poly, comm_target)
            r.append(r_i)
        return self.comm_evals[-1], r


def _zk_sumcheck_round_tail(
    poly: UniPoly, r_j: int, j: int, claim_per_round: int, comm_claim_per_round: bytes,
    blind_claim: int, blinds_poly, blinds_evals, gens_1, gens_n, ts, tape,
):
    """Shared post-challenge logic of prove_quad / prove_cubic_with_additive_term
    (sumcheck.rs:491-571): commit the round eval and emit the batched dot-product
    proof that ties (sum==claim, poly(r)==eval) to the committed coefficients."""
    eval_ = poly.evaluate(r_j)
    comm_eval = _comp(commit1(eval_, blinds_evals[j], gens_1))
    ts_append_point(ts, b"comm_claim_per_round", comm_claim_per_round)
    ts_append_point(ts, b"comm_eval", comm_eval)
    w = ts_challenge_vector(ts, b"combine_two_claims_to_one", 2)
    target = (w[0] * claim_per_round + w[1] * eval_) % Q
    blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
    blind = (w[0] * blind_sc + w[1] * blinds_evals[j]) % Q
    a_sc = [1] * (poly.degree() + 1)
    a_sc[0] = 2
    a_eval = [1]
    for _ in range(poly.degree()):
        a_eval.append(a_eval[-1] * r_j % Q)
    a = [(w[0] * x + w[1] * y) % Q for x, y in zip(a_sc, a_eval)]
    proof, _cp, _ce = DotProductProof.prove(
        gens_1, gens_n, ts, tape, poly.coeffs, blinds_poly[j], a, target, blind
    )
    return proof, eval_, comm_eval


def zk_sumcheck_prove_quad(
    claim: int, blind_claim: int, num_rounds: int,
    poly_A: DenseMlPoly, poly_B: DenseMlPoly,
    gens_1: MultiCommitGens, gens_n: MultiCommitGens,
    ts: Transcript, tape: RandomTape,
):
    """ZKSumcheckInstanceProof::prove_quad (sumcheck.rs:430-588) for
    sum_x A(x)*B(x).  Returns (proof, r, [A(r), B(r)], blind of final eval)."""
    blinds_poly = tape.vector(b"blinds_poly", num_rounds)
    blinds_evals = tape.vector(b"blinds_evals", num_rounds)
    claim_per_round = claim % Q
    comm_claim_per_round = _comp(commit1(claim_per_round, blind_claim, gens_1))
    r: list[int] = []
    comm_polys: list[bytes] = []
    comm_evals: list[bytes] = []
    proofs: list[DotProductProof] = []
    A, B = poly_A, poly_B
    for j in range(num_rounds):
        e0, e2 = _quad_round_evals(A, B)
        poly = UniPoly.from_evals([e0 % Q, (claim_per_round - e0) % Q, e2 % Q])
        comm_poly = _comp(poly.commit(gens_n, blinds_poly[j]))
        ts_append_point(ts, b"comm_poly", comm_poly)
        comm_polys.append(comm_poly)
        r_j = ts_challenge_scalar(ts, b"challenge_nextround")
        A = A.bound_poly_var_top(r_j)
        B = B.bound_poly_var_top(r_j)
        proof, claim_per_round, comm_claim_per_round = _zk_sumcheck_round_tail(
            poly, r_j, j, claim_per_round, comm_claim_per_round, blind_claim,
            blinds_poly, blinds_evals, gens_1, gens_n, ts, tape,
        )
        proofs.append(proof)
        r.append(r_j)
        comm_evals.append(comm_claim_per_round)
    return (
        ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs),
        r,
        [A.evals[0], B.evals[0]],
        blinds_evals[num_rounds - 1],
    )


def zk_sumcheck_prove_cubic_with_additive_term(
    claim: int, blind_claim: int, num_rounds: int,
    poly_A: DenseMlPoly, poly_B: DenseMlPoly, poly_C: DenseMlPoly, poly_D: DenseMlPoly,
    gens_1: MultiCommitGens, gens_n: MultiCommitGens,
    ts: Transcript, tape: RandomTape,
):
    """ZKSumcheckInstanceProof::prove_cubic_with_additive_term
    (sumcheck.rs:590-778) for sum_x A(x)*(B(x)*C(x) - D(x)) — Spartan
    phase 1 with A = eq(tau, x)."""
    blinds_poly = tape.vector(b"blinds_poly", num_rounds)
    blinds_evals = tape.vector(b"blinds_evals", num_rounds)
    claim_per_round = claim % Q
    comm_claim_per_round = _comp(commit1(claim_per_round, blind_claim, gens_1))
    r: list[int] = []
    comm_polys: list[bytes] = []
    comm_evals: list[bytes] = []
    proofs: list[DotProductProof] = []
    A, B, C, D = poly_A, poly_B, poly_C, poly_D
    for j in range(num_rounds):
        e0, e2, e3 = _cubic_round_evals(A, B, C, D)
        poly = UniPoly.from_evals(
            [e0 % Q, (claim_per_round - e0) % Q, e2 % Q, e3 % Q]
        )
        comm_poly = _comp(poly.commit(gens_n, blinds_poly[j]))
        ts_append_point(ts, b"comm_poly", comm_poly)
        comm_polys.append(comm_poly)
        r_j = ts_challenge_scalar(ts, b"challenge_nextround")
        A = A.bound_poly_var_top(r_j)
        B = B.bound_poly_var_top(r_j)
        C = C.bound_poly_var_top(r_j)
        D = D.bound_poly_var_top(r_j)
        proof, claim_per_round, comm_claim_per_round = _zk_sumcheck_round_tail(
            poly, r_j, j, claim_per_round, comm_claim_per_round, blind_claim,
            blinds_poly, blinds_evals, gens_1, gens_n, ts, tape,
        )
        proofs.append(proof)
        r.append(r_j)
        comm_evals.append(comm_claim_per_round)
    return (
        ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs),
        r,
        [A.evals[0], B.evals[0], C.evals[0], D.evals[0]],
        blinds_evals[num_rounds - 1],
    )


# --- polynomial commitment (dense_mlpoly.rs:181-404) ------------------------


def factored_lens(ell: int) -> tuple[int, int]:
    return ell // 2, ell - ell // 2


class PolyCommitmentGens:
    """sqrt-split commitment gens: DotProductProofGens over rows of size
    2^(ell - ell/2) (dense_mlpoly.rs:31-38)."""

    def __init__(self, num_vars: int, label: bytes):
        _left, right = factored_lens(num_vars)
        self.gens = DotProductProofGens(1 << right, label)


@dataclass
class PolyCommitment:
    C: list[bytes]  # one commitment per L-row

    def append_to_transcript(self, label: bytes, ts: Transcript):
        ts.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            ts_append_point(ts, b"poly_commitment_share", c)
        ts.append_message(label, b"poly_commitment_end")


def poly_commit(
    poly: DenseMlPoly, gens: PolyCommitmentGens, tape: RandomTape | None, *,
    device="cuda"
) -> tuple[PolyCommitment, list[int]]:
    """DensePolynomial::commit: matrix rows committed separately
    (dense_mlpoly.rs:181-206).

    Hot path of NIZK::prove: the rows on the native backend; without it,
    at L_size >= 8 rows of R_size >= 32, all rows as one batch of device
    MSMs (``run_device_many`` on `device`, the reference's one batched
    device program)."""
    ell = poly.num_vars
    left, right = factored_lens(ell)
    L_size, R_size = 1 << left, 1 << right
    blinds = tape.vector(b"poly_blinds", L_size) if tape is not None else [0] * L_size
    gn = gens.gens.gens_n
    if _nb_ok() and R_size > 16:
        # native host MSM per row: the reference's row commits are CPU rayon
        # (dense_mlpoly.rs:181-206)
        bases = gn.G[:R_size] + [gn.h]
        C = [
            _comp(
                nb.msm(
                    "t256",
                    [v % Q for v in poly.evals[R_size * i : R_size * (i + 1)]]
                    + [blinds[i] % Q],
                    bases,
                )
            )
            for i in range(L_size)
        ]
        return PolyCommitment(C), blinds
    if L_size >= 8 and R_size >= 32:
        import torch

        from ..ops import limb
        from ..ops.ec import get_curve_ctx
        from ..ops.msm import get_msm
        from .groth16 import _device

        device = _device(device)
        m = get_msm(T256)
        ctx = get_curve_ctx(T256)
        P = ctx.points_to_device(gn.G[:R_size] + [gn.h], device)
        valid = torch.ones(R_size + 1, dtype=torch.int32, device=device)
        problems = []
        for i in range(L_size):
            sc = limb.limbs_to_words(limb.ints_to_limbs(
                [v % Q for v in poly.evals[R_size * i : R_size * (i + 1)]]
                + [blinds[i] % Q]
            ), device)
            problems.append((P.x, P.y, valid, sc))
        res = m.run_device_many(problems)
        pts = ctx.points_to_host(res)
        return PolyCommitment([_comp(p) for p in pts]), blinds
    C = [
        _comp(commitv(poly.evals[R_size * i : R_size * (i + 1)], blinds[i], gn))
        for i in range(L_size)
    ]
    return PolyCommitment(C), blinds


def poly_bound_L(poly: DenseMlPoly, L: list[int]) -> list[int]:
    """L^T * Z viewed as an (L_size x R_size) matrix (dense_mlpoly.rs:208-215)."""
    left, right = factored_lens(poly.num_vars)
    L_size, R_size = 1 << left, 1 << right
    if _nb_ok():
        import numpy as np

        n = L_size * R_size
        out_idx = np.arange(n, dtype=np.uint32) % R_size
        in_idx = np.arange(n, dtype=np.uint32) // R_size
        lu = nb.ints_to_u64([x % Q for x in L])
        return nb.u64_to_ints(
            nb.coo_matvec(Q, out_idx, in_idx, poly.u64(), lu, R_size)
        )
    return [
        sum(L[j] * poly.evals[j * R_size + i] for j in range(L_size)) % Q
        for i in range(R_size)
    ]


@dataclass
class PolyEvalProof:
    """Z(r) opening against the row commitments (dense_mlpoly.rs:302-404)."""

    proof: DotProductProofLog

    @staticmethod
    def prove(
        poly: DenseMlPoly, blinds: list[int] | None, r: list[int], Zr: int,
        blind_Zr: int, gens: PolyCommitmentGens, ts: Transcript, tape: RandomTape,
    ):
        ts_append_protocol_name(ts, b"polynomial evaluation proof")
        assert poly.num_vars == len(r)
        left, right = factored_lens(len(r))
        L_size = 1 << left
        if blinds is None:
            blinds = [0] * L_size
        L = eq_evals(list(reversed(r[:left])))
        R = eq_evals(list(reversed(r[left:])))
        LZ = poly_bound_L(poly, L)
        LZ_blind = sum(blinds[i] * L[i] for i in range(L_size)) % Q
        proof, _C_LR, C_Zr_prime = DotProductProofLog.prove(
            gens.gens, ts, tape, LZ, LZ_blind, R, Zr, blind_Zr
        )
        return PolyEvalProof(proof), C_Zr_prime

    def verify(
        self, gens: PolyCommitmentGens, ts: Transcript, r: list[int],
        C_Zr: bytes, comm: PolyCommitment,
    ):
        ts_append_protocol_name(ts, b"polynomial evaluation proof")
        left, _right = factored_lens(len(r))
        L = eq_evals(list(reversed(r[:left])))
        R = eq_evals(list(reversed(r[left:])))
        C_LZ = _comp(_t256_msm(L, [_decomp(c) for c in comm.C]))
        self.proof.verify(len(R), gens.gens, ts, R, C_LZ, C_Zr)


# --- R1CS instance (r1csinstance.rs, sparse eval of lib.rs NIZK) -------------


def eq_evals_msb(rs: list[int]) -> list[int]:
    """EqPolynomial::evals ordering: rs[0] binds the MOST significant index
    bit (dense_mlpoly.rs:70-86) — our eq_evals builds LSB-first, so reverse."""
    return eq_evals(list(reversed(rs)))


def eq_evaluate(a: list[int], b: list[int]) -> int:
    assert len(a) == len(b)
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % Q) % Q
    return acc


class SpartanR1CSInstance:
    """R1CSInstance (r1csinstance.rs:20-320): three sparse matrices over
    Z = [vars, 1, inputs, 0-pad], power-of-two num_cons / num_vars."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int, A, B, C):
        assert num_cons & (num_cons - 1) == 0
        assert num_vars & (num_vars - 1) == 0
        assert num_inputs < num_vars
        self.num_cons, self.num_vars, self.num_inputs = num_cons, num_vars, num_inputs
        self.A = [(r, c, v % Q) for r, c, v in A]
        self.B = [(r, c, v % Q) for r, c, v in B]
        self.C = [(r, c, v % Q) for r, c, v in C]

    @staticmethod
    def from_unpadded(num_cons: int, num_vars: int, num_inputs: int, A, B, C):
        """Instance::new padding rules (lib.rs:126-241): pad vars to a power
        of two >= num_inputs+1, shift input/constant columns, pad cons."""
        num_vars_padded = max(num_vars, num_inputs + 1)
        if num_vars_padded & (num_vars_padded - 1):
            num_vars_padded = 1 << num_vars_padded.bit_length()
        num_cons_padded = max(num_cons, 2)
        if num_cons_padded & (num_cons_padded - 1):
            num_cons_padded = 1 << num_cons_padded.bit_length()

        def shift(mat):
            out = []
            for row, col, val in mat:
                assert row < num_cons and col < num_vars + 1 + num_inputs
                if col >= num_vars:
                    out.append((row, col + num_vars_padded - num_vars, val % Q))
                else:
                    out.append((row, col, val % Q))
            return out

        return SpartanR1CSInstance(
            num_cons_padded, num_vars_padded, num_inputs, shift(A), shift(B), shift(C)
        )

    def digest(self) -> bytes:
        """Canonical instance digest.  The reference hashes the bincode
        encoding with SHA3-256 (r1csinstance.rs:150-156); we hash an
        equivalent canonical byte layout (parity of the exact bincode bytes
        is tracked in PARITY.md)."""
        h = hashlib.sha3_256()
        for x in (self.num_cons, self.num_vars, self.num_inputs):
            h.update(x.to_bytes(8, "little"))
        for mat in (self.A, self.B, self.C):
            h.update(len(mat).to_bytes(8, "little"))
            for r, c, v in mat:
                h.update(r.to_bytes(8, "little"))
                h.update(c.to_bytes(8, "little"))
                h.update(_scalar_bytes(v))
        return h.digest()

    def _z(self, vars_: list[int], inputs: list[int]) -> list[int]:
        z = list(vars_) + [1] + list(inputs)
        z += [0] * (2 * self.num_vars - len(z))
        return z

    def is_sat(self, vars_: list[int], inputs: list[int]) -> bool:
        z = list(vars_) + [1] + list(inputs)
        az = self.multiply_vec_single(self.A, z)
        bz = self.multiply_vec_single(self.B, z)
        cz = self.multiply_vec_single(self.C, z)
        return all(a * b % Q == c for a, b, c in zip(az, bz, cz))

    def _coo(self, which: str):
        """Cached (rows, cols, coeff_u64) numpy triples for native matvecs."""
        cache = getattr(self, "_coo_cache", None)
        if cache is None:
            cache = {}
            self._coo_cache = cache
        if which not in cache:
            import numpy as np

            mat = getattr(self, which)
            rows = np.asarray([r for r, _, _ in mat], dtype=np.uint32)
            cols = np.asarray([c for _, c, _ in mat], dtype=np.uint32)
            coef = nb.ints_to_u64([v % Q for _, _, v in mat])
            cache[which] = (rows, cols, coef)
        return cache[which]

    def multiply_vec_single(self, mat, z: list[int]) -> list[int]:
        out = [0] * self.num_cons
        for r, c, v in mat:
            if c < len(z):
                out[r] = (out[r] + v * z[c]) % Q
        return out

    def multiply_vec(self, z: list[int]):
        if _nb_ok():
            zu = nb.ints_to_u64([x % Q for x in z])
            outs = []
            for which in ("A", "B", "C"):
                rows, cols, coef = self._coo(which)
                # guard: reference semantics drop out-of-range columns
                keep = cols < len(z)
                if not keep.all():
                    rows, cols, coef = rows[keep], cols[keep], coef[keep]
                outs.append(
                    DenseMlPoly(
                        None,
                        u64=nb.coo_matvec(Q, rows, cols, coef, zu, self.num_cons),
                    )
                )
            return tuple(outs)
        return (
            DenseMlPoly(self.multiply_vec_single(self.A, z)),
            DenseMlPoly(self.multiply_vec_single(self.B, z)),
            DenseMlPoly(self.multiply_vec_single(self.C, z)),
        )

    def compute_eval_table_sparse(self, rx_evals: list[int], num_cols: int):
        """A^T rx etc. (sparse_mlpoly.rs:472-487)."""
        if _nb_ok():
            ru = nb.ints_to_u64([x % Q for x in rx_evals])
            outs = []
            for which in ("A", "B", "C"):
                rows, cols, coef = self._coo(which)
                outs.append(
                    nb.u64_to_ints(nb.coo_matvec(Q, cols, rows, coef, ru, num_cols))
                )
            return outs
        outs = []
        for mat in (self.A, self.B, self.C):
            e = [0] * num_cols
            for r, c, v in mat:
                e[c] = (e[c] + rx_evals[r] * v) % Q
            outs.append(e)
        return outs

    def evaluate(self, rx: list[int], ry: list[int]) -> tuple[int, int, int]:
        """A~(rx, ry), B~, C~ via eq tables (sparse_mlpoly.rs:429-454)."""
        tx = eq_evals_msb(rx)
        ty = eq_evals_msb(ry)
        out = []
        for mat in (self.A, self.B, self.C):
            out.append(sum(tx[r] * ty[c] % Q * v for r, c, v in mat) % Q)
        return tuple(out)


def sparse_input_poly_evaluate(inputs: list[int], num_vars_log: int, r: list[int]) -> int:
    """SparsePolynomial::evaluate of [1, inputs...] (r1csproof.rs:459-469,
    sparse_mlpoly.rs:1572-1605): MSB-first index bits against r."""
    total = 0
    for idx, val in [(0, 1)] + [(i + 1, v) for i, v in enumerate(inputs)]:
        chi = 1
        for j in range(len(r)):
            bit = (idx >> (len(r) - 1 - j)) & 1
            chi = chi * ((r[j] if bit else (1 - r[j])) % Q) % Q
        total = (total + chi * val) % Q
    return total


# --- two-phase R1CS satisfiability argument (r1csproof.rs) -------------------


class R1CSGens:
    def __init__(self, label: bytes, num_cons: int, num_vars: int):
        num_poly_vars = num_vars.bit_length() - 1
        self.gens_pc = PolyCommitmentGens(num_poly_vars, label)
        # R1CSSumcheckGens: gens_1 shared with the PC gens (r1csproof.rs:49-61)
        self.gens_sc_1 = self.gens_pc.gens.gens_1
        self.gens_sc_3 = MultiCommitGens.new(3, label)
        self.gens_sc_4 = MultiCommitGens.new(4, label)


@dataclass
class R1CSProof:
    comm_vars: PolyCommitment
    sc_proof_phase1: ZKSumcheckInstanceProof
    claims_phase2: tuple  # (comm_Az, comm_Bz, comm_Cz, comm_prod) compressed
    pok_claims_phase2: tuple  # (KnowledgeProof, ProductProof)
    proof_eq_sc_phase1: EqualityProof
    sc_proof_phase2: ZKSumcheckInstanceProof
    comm_vars_at_ry: bytes
    proof_eval_vars_at_ry: PolyEvalProof
    proof_eq_sc_phase2: EqualityProof

    @staticmethod
    def prove(
        inst: SpartanR1CSInstance, vars_: list[int], inputs: list[int],
        gens: R1CSGens, ts: Transcript, tape: RandomTape,
    ) -> tuple["R1CSProof", list[int], list[int]]:
        ts_append_protocol_name(ts, b"R1CS proof")
        assert len(inputs) < len(vars_)
        ts_append_scalars(ts, b"input", inputs)

        poly_vars = DenseMlPoly(list(vars_))
        comm_vars, blinds_vars = poly_commit(poly_vars, gens.gens_pc, tape)
        comm_vars.append_to_transcript(b"poly_commitment", ts)

        z = inst._z(vars_, inputs)
        num_rounds_x = inst.num_cons.bit_length() - 1
        num_rounds_y = len(z).bit_length() - 1
        tau = ts_challenge_vector(ts, b"challenge_tau", num_rounds_x)
        poly_tau = DenseMlPoly(eq_evals_msb(tau))
        poly_Az, poly_Bz, poly_Cz = inst.multiply_vec(z)

        sc1, rx, claims1, blind_claim_postsc1 = zk_sumcheck_prove_cubic_with_additive_term(
            0, 0, num_rounds_x, poly_tau, poly_Az, poly_Bz, poly_Cz,
            MultiCommitGens(1, [gens.gens_sc_1.G[0]], gens.gens_sc_1.h),
            gens.gens_sc_4, ts, tape,
        )
        tau_claim, Az_claim, Bz_claim, Cz_claim = claims1
        Az_blind, Bz_blind, Cz_blind, prod_Az_Bz_blind = (
            tape.scalar(b"Az_blind"), tape.scalar(b"Bz_blind"),
            tape.scalar(b"Cz_blind"), tape.scalar(b"prod_Az_Bz_blind"),
        )
        gens_1 = gens.gens_sc_1
        pok_Cz_claim, comm_Cz_claim = KnowledgeProof.prove(gens_1, ts, tape, Cz_claim, Cz_blind)
        prod = Az_claim * Bz_claim % Q
        proof_prod, comm_Az_claim, comm_Bz_claim, comm_prod = ProductProof.prove(
            gens_1, ts, tape, Az_claim, Az_blind, Bz_claim, Bz_blind, prod, prod_Az_Bz_blind
        )
        ts_append_point(ts, b"comm_Az_claim", comm_Az_claim)
        ts_append_point(ts, b"comm_Bz_claim", comm_Bz_claim)
        ts_append_point(ts, b"comm_Cz_claim", comm_Cz_claim)
        ts_append_point(ts, b"comm_prod_Az_Bz_claims", comm_prod)

        blind_expected1 = tau_claim * (prod_Az_Bz_blind - Cz_blind) % Q
        claim_post1 = (Az_claim * Bz_claim - Cz_claim) * tau_claim % Q
        proof_eq1, _c1, _c2 = EqualityProof.prove(
            gens_1, ts, tape, claim_post1, blind_expected1, claim_post1, blind_claim_postsc1
        )

        r_A = ts_challenge_scalar(ts, b"challenege_Az")
        r_B = ts_challenge_scalar(ts, b"challenege_Bz")
        r_C = ts_challenge_scalar(ts, b"challenege_Cz")
        claim_phase2 = (r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim) % Q
        blind_claim_phase2 = (r_A * Az_blind + r_B * Bz_blind + r_C * Cz_blind) % Q

        evals_rx = eq_evals_msb(rx)
        eA, eB, eC = inst.compute_eval_table_sparse(evals_rx, len(z))
        evals_ABC = [(r_A * a + r_B * b + r_C * c) % Q for a, b, c in zip(eA, eB, eC)]

        sc2, ry, claims2, blind_claim_postsc2 = zk_sumcheck_prove_quad(
            claim_phase2, blind_claim_phase2, num_rounds_y,
            DenseMlPoly(z), DenseMlPoly(evals_ABC),
            MultiCommitGens(1, [gens.gens_sc_1.G[0]], gens.gens_sc_1.h),
            gens.gens_sc_3, ts, tape,
        )

        eval_vars_at_ry = poly_vars.evaluate(ry[1:])
        blind_eval = tape.scalar(b"blind_eval")
        proof_eval, comm_vars_at_ry = PolyEvalProof.prove(
            poly_vars, blinds_vars, ry[1:], eval_vars_at_ry, blind_eval,
            gens.gens_pc, ts, tape,
        )

        blind_eval_Z_at_ry = (1 - ry[0]) * blind_eval % Q
        blind_expected2 = claims2[1] * blind_eval_Z_at_ry % Q
        claim_post2 = claims2[0] * claims2[1] % Q
        proof_eq2, _c1, _c2 = EqualityProof.prove(
            gens.gens_pc.gens.gens_1, ts, tape,
            claim_post2, blind_expected2, claim_post2, blind_claim_postsc2,
        )

        return (
            R1CSProof(
                comm_vars, sc1,
                (comm_Az_claim, comm_Bz_claim, comm_Cz_claim, comm_prod),
                (pok_Cz_claim, proof_prod), proof_eq1, sc2,
                comm_vars_at_ry, proof_eval, proof_eq2,
            ),
            rx, ry,
        )

    def verify(
        self, num_vars: int, num_cons: int, inputs: list[int],
        evals: tuple[int, int, int], ts: Transcript, gens: R1CSGens,
    ) -> tuple[list[int], list[int]]:
        ts_append_protocol_name(ts, b"R1CS proof")
        ts_append_scalars(ts, b"input", inputs)
        self.comm_vars.append_to_transcript(b"poly_commitment", ts)

        num_rounds_x = num_cons.bit_length() - 1
        num_rounds_y = (2 * num_vars).bit_length() - 1
        tau = ts_challenge_vector(ts, b"challenge_tau", num_rounds_x)

        gens_1 = gens.gens_sc_1
        claim_phase1 = _comp(commit1(0, 0, gens_1))
        comm_claim_post1, rx = self.sc_proof_phase1.verify(
            claim_phase1, num_rounds_x, 3,
            MultiCommitGens(1, [gens_1.G[0]], gens_1.h), gens.gens_sc_4, ts,
        )
        comm_Az, comm_Bz, comm_Cz, comm_prod = self.claims_phase2
        pok_Cz, proof_prod = self.pok_claims_phase2
        pok_Cz.verify(gens_1, ts, comm_Cz)
        proof_prod.verify(gens_1, ts, comm_Az, comm_Bz, comm_prod)
        ts_append_point(ts, b"comm_Az_claim", comm_Az)
        ts_append_point(ts, b"comm_Bz_claim", comm_Bz)
        ts_append_point(ts, b"comm_Cz_claim", comm_Cz)
        ts_append_point(ts, b"comm_prod_Az_Bz_claims", comm_prod)

        taus_bound_rx = eq_evaluate(rx, tau)
        expected_post1 = _comp(
            T256.mul(taus_bound_rx, T256.add(_decomp(comm_prod), T256.neg(_decomp(comm_Cz))))
        )
        self.proof_eq_sc_phase1.verify(gens_1, ts, expected_post1, comm_claim_post1)

        r_A = ts_challenge_scalar(ts, b"challenege_Az")
        r_B = ts_challenge_scalar(ts, b"challenege_Bz")
        r_C = ts_challenge_scalar(ts, b"challenege_Cz")
        comm_claim_phase2 = _comp(
            _t256_msm([r_A, r_B, r_C], [_decomp(comm_Az), _decomp(comm_Bz), _decomp(comm_Cz)])
        )
        comm_claim_post2, ry = self.sc_proof_phase2.verify(
            comm_claim_phase2, num_rounds_y, 2,
            MultiCommitGens(1, [gens_1.G[0]], gens_1.h), gens.gens_sc_3, ts,
        )

        self.proof_eval_vars_at_ry.verify(
            gens.gens_pc, ts, ry[1:], self.comm_vars_at_ry, self.comm_vars
        )

        poly_input_eval = sparse_input_poly_evaluate(
            inputs, num_vars.bit_length() - 1, ry[1:]
        )
        comm_eval_Z_at_ry = _t256_msm(
            [(1 - ry[0]) % Q, ry[0]],
            [
                _decomp(self.comm_vars_at_ry),
                commit1(poly_input_eval, 0, gens.gens_pc.gens.gens_1),
            ],
        )
        eval_A_r, eval_B_r, eval_C_r = evals
        expected_post2 = _comp(
            T256.mul(
                (r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r) % Q, comm_eval_Z_at_ry
            )
        )
        self.proof_eq_sc_phase2.verify(gens_1, ts, expected_post2, comm_claim_post2)
        return rx, ry


# --- public NIZK API (lib.rs:589-709) ----------------------------------------


class NIZKGens:
    def __init__(self, num_cons: int, num_vars: int, num_inputs: int):
        num_vars_padded = max(num_vars, num_inputs + 1)
        if num_vars_padded & (num_vars_padded - 1):
            num_vars_padded = 1 << num_vars_padded.bit_length()
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons, num_vars_padded)


@dataclass
class NIZK:
    r1cs_sat_proof: R1CSProof
    rx: list[int]
    ry: list[int]

    @staticmethod
    def prove(
        inst: SpartanR1CSInstance, vars_: list[int], inputs: list[int],
        gens: NIZKGens, ts: Transcript,
    ) -> "NIZK":
        tape = RandomTape(b"proof")
        ts_append_protocol_name(ts, b"Spartan NIZK proof")
        ts.append_message(b"R1CSInstanceDigest", inst.digest())
        padded = list(vars_) + [0] * (inst.num_vars - len(vars_))
        proof, rx, ry = R1CSProof.prove(inst, padded, inputs, gens.gens_r1cs_sat, ts, tape)
        return NIZK(proof, rx, ry)

    def verify(self, inst: SpartanR1CSInstance, inputs: list[int], ts: Transcript, gens: NIZKGens):
        ts_append_protocol_name(ts, b"Spartan NIZK proof")
        ts.append_message(b"R1CSInstanceDigest", inst.digest())
        inst_evals = inst.evaluate(self.rx, self.ry)
        _require(len(inputs) == inst.num_inputs, "input length")
        rx, ry = self.r1cs_sat_proof.verify(
            inst.num_vars, inst.num_cons, inputs, inst_evals, ts, gens.gens_r1cs_sat
        )
        _require(rx == self.rx and ry == self.ry, "claimed (rx, ry)")
