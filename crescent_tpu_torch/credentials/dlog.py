"""Generalized Schnorr proof of knowledge (DLogPoK) + Pedersen commitments.

Counterpart of ``crescent_tpu/credentials/dlog.py`` and equivalent of
creds/src/dlog.rs: proves knowledge of
representations y_i = sum_j scalars[i][j] * bases[i][j] across multiple
statements, with optional cross-statement equality positions (DLEQ): for
(i, j) in eq_pos, scalars[0][i] == scalars[1][j] is enforced by sharing the
blinding r and checking response equality (dlog.rs:39-175).

Transcript framing matches the reference byte-for-byte: merlin transcript
labelled [0x00], context under "context string", per statement "num_bases"
(u64 LE), each base compressed, "k", "y"; 31-byte challenge under label
[0x00] (see tests for the DLEQ negative cases mirroring dlog.rs:224-338).

MSMs here are small (a handful of bases); `msm_select` takes them to the
host oracle or the native backend, as the reference does, and to the
device MSM only without the native library.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..core.curves import AffinePoint, BN254_G1
from ..core.fields import BN254_FR as R
from ..utils.hash_to_curve import derive_pedersen_bases  # re-export for parity
from ..utils.merlin import Transcript
from ..utils.serialize import ser_g1_compressed, ser_u64

G1 = BN254_G1

__all__ = ["DLogPoK", "PedersenOpening", "pedersen_commit", "derive_pedersen_bases"]


def msm_select(bases: list, scalars: list[int], *, device="cuda") -> AffinePoint:
    """Small-MSM dispatcher (utils.rs:124-138; reference dlog.py:34-48):
    at most 16 points on the host oracle, more on the native C++ backend,
    and only where its library is missing ``get_msm(G1).run_host`` on
    `device`.  Show and verify MSMs are a few hundred points at most."""
    if len(bases) <= 16:
        return G1.msm(scalars, bases)
    from ..native import backend as nb

    if nb.available():
        return nb.msm("bn254_g1", [s % G1.n for s in scalars], bases)
    from ..ops.msm import get_msm

    return get_msm(G1).run_host(scalars, bases, device)


def _append(ts: Transcript, label: bytes, data: bytes):
    ts.append_message(label, data)


def _challenge(ts: Transcript) -> int:
    c_bytes = ts.challenge_bytes(b"\x00", 31)
    return int.from_bytes(c_bytes, "little")  # < 2^248 < r


@dataclass
class DLogPoK:
    c: int
    s: list  # s[i][j] responses per statement

    @staticmethod
    def prove(
        context: bytes | None,
        y: list,
        bases: list,
        scalars: list,
        eq_pos: list | None = None,
        rng: random.Random | None = None,
    ) -> "DLogPoK":
        assert len(y) == len(bases) == len(scalars)
        rng = rng or random.SystemRandom()
        ts = Transcript(b"\x00")
        _append(ts, b"context string", context or b"")

        r = [[rng.randrange(R) for _ in bs] for bs in bases]
        if eq_pos is not None:
            assert len(y) == 2
            for (i, j) in eq_pos:
                r[1][j] = r[0][i]

        ks = []
        for i in range(len(y)):
            _append(ts, b"num_bases", ser_u64(len(bases[i])))
            for b in bases[i]:
                _append(ts, b"base", ser_g1_compressed(b))
            ki = msm_select(bases[i], r[i])
            ks.append(ki)
            _append(ts, b"k", ser_g1_compressed(ki))
            _append(ts, b"y", ser_g1_compressed(y[i]))

        c = _challenge(ts)
        s = [
            [(r[i][j] - c * scalars[i][j]) % R for j in range(len(r[i]))]
            for i in range(len(y))
        ]
        return DLogPoK(c, s)

    def verify(
        self,
        context: bytes | None,
        bases: list,
        y: list,
        eq_pos: list | None = None,
    ) -> bool:
        ts = Transcript(b"\x00")
        _append(ts, b"context string", context or b"")

        for i in range(len(y)):
            if len(bases[i]) != len(self.s[i]):
                return False
            # recomputed k_i = sum_j s_ij * base_ij + c * y_i
            ki = msm_select(bases[i] + [y[i]], self.s[i] + [self.c])
            _append(ts, b"num_bases", ser_u64(len(bases[i])))
            for b in bases[i]:
                _append(ts, b"base", ser_g1_compressed(b))
            _append(ts, b"k", ser_g1_compressed(ki))
            _append(ts, b"y", ser_g1_compressed(y[i]))

        if eq_pos is not None:
            assert len(y) == 2
            for (i, j) in eq_pos:
                if self.s[0][i] != self.s[1][j]:
                    return False

        return _challenge(ts) == self.c


@dataclass
class PedersenOpening:
    """c = m*bases[0] + r*bases[1] (dlog.rs:22-29,178-196)."""

    bases: list
    m: int
    r: int
    c: AffinePoint


def pedersen_commit(
    m: int, bases: list, rng: random.Random | None = None, r: int | None = None
) -> PedersenOpening:
    assert len(bases) == 2
    rng = rng or random.SystemRandom()
    r = rng.randrange(R) if r is None else r
    c = msm_select(bases, [m % R, r])
    return PedersenOpening(list(bases), m % R, r, c)
