"""Array-backed affine point vectors (standard-form u16 limb planes).

The reference keeps SRS tables as `Vec<G1Affine>` / `Vec<G2Affine>` and
pays per-point (de)serialization through arkworks CanonicalSerialize
(forks/groth16/src/data_structures.rs, creds/src/utils.rs:140-197).  At
QAP scale (rs256@2048: 7.9M points, 596 MB on disk) the Python-int analog
of that — one `int.to_bytes`/`from_bytes` + tuple object per point — costs
tens of seconds per zksetup write and per prove param load.

`ArrayPointVec` holds the same data as a numpy array of little-endian
16-bit limbs, so

  * ark uncompressed (de)serialization is a byte *view* (utils/ark.py
    `ser_list` / `Reader.g1_vec` fast paths),
  * the native C++ backend's (n, 8|16) u64 layout is a byte view
    (`to_u64`; native/backend.py points_to_u64 / g2_to_u64 fast paths),
  * the device MSM tables upload as u16 planes with on-device Montgomery
    conversion (ops/ec.CurveCtx.points_to_device fast path), and
  * the device fixed-base SRS generator (ops/fixed_base.py) can emit its
    results without ever materializing Python ints.

Item access (`vec[i]`, iteration, slicing) lazily yields the classic
affine tuples (`(x, y)` ints for G1, `(Fq2, Fq2)` for G2, `None` for the
identity), so every list-shaped consumer keeps working unchanged.

Layout: `xs`/`ys` are (N, K) uint16 with K = 16 limbs for G1 and K = 32
for G2 (c0 limbs then c1 limbs — exactly ark's Fq2 byte order).  Identity
rows are all-zero coordinates plus a True in `inf` (matching the native
backend's zeros convention and ark's infinity-flag-with-zero-payload).
"""

from __future__ import annotations

import numpy as np

from ..core.fields import BN254_FQ, Fq2

INFINITY_FLAG = 0x40

_FQ_WORDS = np.frombuffer(int(BN254_FQ).to_bytes(32, "little"), dtype="<u8")


def _check_canonical(words: np.ndarray) -> None:
    """words: (M, 4) LE u64 — assert every 256-bit value < BN254_FQ."""
    lt = np.zeros(words.shape[0], dtype=bool)
    eq = np.ones(words.shape[0], dtype=bool)
    for w in range(3, -1, -1):
        col = words[:, w]
        lt |= eq & (col < _FQ_WORDS[w])
        eq &= col == _FQ_WORDS[w]
    if not lt.all():
        raise AssertionError("non-canonical field element in point vector")


class ArrayPointVec:
    """Vector of affine curve points over Fq (G1) or Fq2 (G2)."""

    __slots__ = ("xs", "ys", "inf", "g2")

    def __init__(self, xs: np.ndarray, ys: np.ndarray, inf: np.ndarray, g2: bool):
        k = 32 if g2 else 16
        assert xs.dtype == np.uint16 and ys.dtype == np.uint16
        assert xs.shape == ys.shape == (len(inf), k), (xs.shape, len(inf), k)
        self.xs, self.ys, self.inf, self.g2 = xs, ys, inf.astype(bool), g2

    # -- construction --------------------------------------------------------
    @classmethod
    def from_points(cls, pts, g2: bool = False) -> "ArrayPointVec":
        k = 32 if g2 else 16
        n = len(pts)
        xs = np.zeros((n, k), dtype=np.uint16)
        ys = np.zeros((n, k), dtype=np.uint16)
        inf = np.zeros(n, dtype=bool)
        for i, p in enumerate(pts):
            if p is None:
                inf[i] = True
                continue
            x, y = p
            if g2:
                xb = int(x.c0).to_bytes(32, "little") + int(x.c1).to_bytes(32, "little")
                yb = int(y.c0).to_bytes(32, "little") + int(y.c1).to_bytes(32, "little")
            else:
                xb = int(x).to_bytes(32, "little")
                yb = int(y).to_bytes(32, "little")
            xs[i] = np.frombuffer(xb, dtype="<u2")
            ys[i] = np.frombuffer(yb, dtype="<u2")
        return cls(xs, ys, inf, g2)

    @classmethod
    def from_limbs_u32(
        cls, xs: np.ndarray, ys: np.ndarray, inf: np.ndarray, g2: bool = False
    ) -> "ArrayPointVec":
        """(N, K) u32 arrays holding sub-2^16 standard-form limbs."""
        assert not (np.asarray(xs) >> 16).any() and not (np.asarray(ys) >> 16).any()
        xs16 = np.ascontiguousarray(xs, dtype=np.uint16)
        ys16 = np.ascontiguousarray(ys, dtype=np.uint16)
        inf = np.asarray(inf, dtype=bool)
        xs16[inf] = 0
        ys16[inf] = 0
        return cls(xs16, ys16, inf, g2)

    @classmethod
    def deser_uncompressed(cls, buf: bytes, n: int, g2: bool = False, checked: bool = False):
        """ark uncompressed items (no length header) -> (vec, bytes_read).

        Unchecked by default, matching Reader.g1/g2 and the reference's
        deserialize_uncompressed_unchecked (creds/src/utils.rs:185)."""
        size = 128 if g2 else 64
        raw = np.frombuffer(buf[: n * size], dtype=np.uint8)
        assert raw.size == n * size, "short read in point vector"
        arr = raw.reshape(n, size).copy()
        flags = arr[:, size - 1] & 0xC0
        inf = (flags & INFINITY_FLAG) != 0
        arr[:, size - 1] &= 0x3F
        if checked:
            _check_canonical(np.ascontiguousarray(arr).view("<u8").reshape(-1, 4))
        half = size // 2
        xs = np.ascontiguousarray(arr[:, :half]).view("<u2").copy()
        ys = np.ascontiguousarray(arr[:, half:]).view("<u2").copy()
        xs[inf] = 0
        ys[inf] = 0
        return cls(xs, ys, inf, g2), n * size

    # -- serialization -------------------------------------------------------
    def ser_items_uncompressed(self) -> bytes:
        """Concatenated ark uncompressed encodings (no length header) —
        byte-identical to mapping utils/serialize.ser_g1_uncompressed /
        ser_g2_uncompressed over the items."""
        xs, ys = self.xs, self.ys
        if self.inf.any():
            xs = xs.copy()
            ys = ys.copy()
            xs[self.inf] = 0
            ys[self.inf] = 0
        out = np.ascontiguousarray(np.hstack([xs, ys])).view(np.uint8)
        if self.inf.any():
            out = out.copy()
            out[self.inf, -1] |= INFINITY_FLAG
        return out.tobytes()

    def to_u64(self) -> np.ndarray:
        """Native backend layout: (N, 8) u64 for G1, (N, 16) for G2
        (x || y LE words; identity rows are all-zero)."""
        return np.ascontiguousarray(np.hstack([self.xs, self.ys])).view("<u8")

    # -- sequence protocol ---------------------------------------------------
    def __len__(self) -> int:
        return self.xs.shape[0]

    def _item(self, i: int):
        if self.inf[i]:
            return None
        xb = self.xs[i].tobytes()
        yb = self.ys[i].tobytes()
        if self.g2:
            return (
                Fq2(int.from_bytes(xb[:32], "little"), int.from_bytes(xb[32:], "little")),
                Fq2(int.from_bytes(yb[:32], "little"), int.from_bytes(yb[32:], "little")),
            )
        return (int.from_bytes(xb, "little"), int.from_bytes(yb, "little"))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ArrayPointVec(self.xs[i], self.ys[i], self.inf[i], self.g2)
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._item(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self._item(i)

    def to_list(self) -> list:
        return list(self)

    def __eq__(self, other):
        """Value equality against another vec or any point sequence — a
        deserialized ProvingKey table must compare equal to the list it
        was serialized from (tests/test_ark_serialize.py)."""
        if isinstance(other, ArrayPointVec):
            return (
                self.g2 == other.g2
                and np.array_equal(self.inf, other.inf)
                and np.array_equal(self.xs, other.xs)
                and np.array_equal(self.ys, other.ys)
            )
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    __hash__ = None  # mutable container semantics, like list

    def __repr__(self) -> str:  # pragma: no cover
        return f"ArrayPointVec(n={len(self)}, g2={self.g2})"
