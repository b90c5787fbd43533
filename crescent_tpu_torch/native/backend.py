"""ctypes binding and build step for the native host EC backend.

Compiles the bigcurve.cpp beside this file on first use (cached by source
hash under build/native/ at the repository root) and exposes batch EC entry points
mirroring the roles of the reference's Rust/asm host arithmetic
(forks/halo2curves src/msm.rs:336-464, derive field asm):

  * ``fixed_base(curve, base, scalars)``  — Groth16 SRS generation
    (forks/groth16/src/generator.rs) and any [k_i]*B batch.
  * ``msm(curve, scalars, points)``       — Pippenger MSM.
  * ``mul_many(curve, scalars, points)``  — independent k_i * P_i.
  * G2 variants of fixed_base/msm.

All value conversion is numpy-vectorized (ints <-> little-endian u64x4).
If no C++ toolchain is available the module degrades gracefully:
``available()`` returns False; the port's entry points then raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bigcurve.cpp")

CURVE_IDS = {"bn254_g1": 0, "p256": 1, "t256": 2}

_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _lib():
    """Compile (if needed) and load the shared library; None on failure."""
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(_HERE)), "build", "native"
        )
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"libbigcurve-{tag}.so")
        with _lock:
            if not os.path.exists(so_path):
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC, "-lpthread"],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        szt = ctypes.c_size_t
        cint = ctypes.c_int
        sigs = {
            "cn_fixed_base": [cint, u64p, u64p, szt, u64p, cint],
            "cn_msm": [cint, u64p, u64p, szt, u64p, cint],
            "cn_mul_many": [cint, u64p, u64p, szt, u64p, cint],
            "cn_fixed_base_g2": [u64p, u64p, szt, u64p, cint],
            "cn_msm_g2": [u64p, u64p, szt, u64p, cint],
            "cn_coo_matvec": [u64p, szt, u32p, u32p, u64p, u64p, u64p, szt],
            "cn_lagrange_at": [u64p, u64p, u64p, u64p, szt, u64p],
            "cn_vec_op": [u64p, cint, u64p, u64p, szt, u64p],
            "cn_batch_inv": [u64p, u64p, szt, u64p],
            "cn_powers": [u64p, u64p, u64p, szt, u64p],
            "cn_dot": [u64p, u64p, u64p, szt, u64p],
            "cn_sumcheck_quad": [u64p, szt, u64p, u64p, u64p, cint],
            "cn_sumcheck_cubic": [u64p, szt, u64p, u64p, u64p, u64p, u64p, cint],
            "cn_bind_top": [u64p, szt, u64p, u64p, u64p, cint],
            "cn_eq_evals": [u64p, u64p, szt, u64p],
            "cn_pairing_init": [u64p, u64p, u64p, u64p, cint],
            "cn_multi_pairing": [u64p, u64p, szt, u64p],
            "cn_witness_run": [u64p, u32p, szt, u64p, u64p, u32p, u64p, szt,
                               u64p, szt],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        return lib
    except Exception:
        return None


def available() -> bool:
    return _lib() is not None


def _nthreads() -> int:
    return min(int(os.environ.get("CRESCENT_NATIVE_THREADS", os.cpu_count() or 1)), 16)


# ---------------------------------------------------------------------------
# int <-> u64-limb conversion (numpy-vectorized)
# ---------------------------------------------------------------------------

def ints_to_u64(xs) -> np.ndarray:
    """list[int] (each < 2^256) -> (n, 4) uint64 little-endian."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), 4).copy()


def u64_to_ints(a: np.ndarray) -> list[int]:
    a = np.ascontiguousarray(a, dtype="<u8")
    flat = a.reshape(-1, 4)
    data = flat.tobytes()
    return [int.from_bytes(data[i * 32:(i + 1) * 32], "little") for i in range(flat.shape[0])]


def points_to_u64(points) -> np.ndarray:
    """Affine tuples/None -> (n, 8) uint64 (x,y LE; identity = zeros)."""
    from ..utils.pointvec import ArrayPointVec

    if isinstance(points, ArrayPointVec):
        assert not points.g2
        return points.to_u64()
    out = np.zeros((len(points), 8), dtype="<u8")
    buf = bytearray()
    for p in points:
        if p is None:
            buf += b"\x00" * 64
        else:
            buf += int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
    return np.frombuffer(bytes(buf), dtype="<u8").reshape(len(points), 8).copy()


def u64_to_points(a: np.ndarray) -> list:
    ints = u64_to_ints(a.reshape(-1, 4))
    out = []
    for i in range(0, len(ints), 2):
        x, y = ints[i], ints[i + 1]
        out.append(None if x == 0 and y == 0 else (x, y))
    return out


def g2_to_u64(points) -> np.ndarray:
    """G2 affine ((Fq2, Fq2) or None) -> (n, 16) uint64."""
    from ..utils.pointvec import ArrayPointVec

    if isinstance(points, ArrayPointVec):
        assert points.g2
        return points.to_u64()
    buf = bytearray()
    for p in points:
        if p is None:
            buf += b"\x00" * 128
        else:
            x, y = p
            buf += (int(x.c0).to_bytes(32, "little") + int(x.c1).to_bytes(32, "little")
                    + int(y.c0).to_bytes(32, "little") + int(y.c1).to_bytes(32, "little"))
    return np.frombuffer(bytes(buf), dtype="<u8").reshape(len(points), 16).copy()


def u64_to_g2(a: np.ndarray) -> list:
    from ..core.fields import Fq2

    ints = u64_to_ints(a.reshape(-1, 4))
    out = []
    for i in range(0, len(ints), 4):
        x0, x1, y0, y1 = ints[i:i + 4]
        if x0 == x1 == y0 == y1 == 0:
            out.append(None)
        else:
            out.append((Fq2(x0, x1), Fq2(y0, y1)))
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# Public API (host ints / affine tuples at the boundary)
# ---------------------------------------------------------------------------

def fixed_base(curve_name: str, base, scalars) -> list:
    """[k * base for k in scalars]; scalars reduced by the caller."""
    lib = _lib()
    n = len(scalars)
    if n == 0:
        return []
    sc = ints_to_u64(scalars)
    bp = points_to_u64([base])
    out = np.zeros((n, 8), dtype="<u8")
    rc = lib.cn_fixed_base(CURVE_IDS[curve_name], _ptr(bp), _ptr(sc), n, _ptr(out), _nthreads())
    assert rc == 0
    return u64_to_points(out)


def msm(curve_name: str, scalars, points):
    lib = _lib()
    n = len(scalars)
    assert n == len(points)
    if n == 0:
        return None
    sc = ints_to_u64(scalars)
    pt = points_to_u64(points)
    out = np.zeros((1, 8), dtype="<u8")
    rc = lib.cn_msm(CURVE_IDS[curve_name], _ptr(pt), _ptr(sc), n, _ptr(out), _nthreads())
    assert rc == 0
    return u64_to_points(out)[0]


def mul_many(curve_name: str, scalars, points) -> list:
    lib = _lib()
    n = len(scalars)
    if n == 0:
        return []
    sc = ints_to_u64(scalars)
    pt = points_to_u64(points)
    out = np.zeros((n, 8), dtype="<u8")
    rc = lib.cn_mul_many(CURVE_IDS[curve_name], _ptr(pt), _ptr(sc), n, _ptr(out), _nthreads())
    assert rc == 0
    return u64_to_points(out)


def fixed_base_g2(base, scalars) -> list:
    lib = _lib()
    n = len(scalars)
    if n == 0:
        return []
    sc = ints_to_u64(scalars)
    bp = g2_to_u64([base])
    out = np.zeros((n, 16), dtype="<u8")
    rc = lib.cn_fixed_base_g2(_ptr(bp), _ptr(sc), n, _ptr(out), _nthreads())
    assert rc == 0
    return u64_to_g2(out)


def msm_g2(scalars, points):
    if len(scalars) == 0:
        return None
    return msm_g2_raw(ints_to_u64(scalars), g2_to_u64(points))


def msm_g2_raw(sc_u64: np.ndarray, pt_u64: np.ndarray):
    """G2 MSM on pre-converted arrays ((n,4) scalars / (n,16) points u64 LE).

    Callers that hold a cached point table (ProvingKey.native_g2_table) and
    an already-converted scalar plane skip ~350 MB of per-prove Python
    bigint -> bytes churn (round-5 prove data-path cleanup)."""
    lib = _lib()
    n = sc_u64.shape[0]
    if n == 0:
        return None
    out = np.zeros((1, 16), dtype="<u8")
    rc = lib.cn_msm_g2(_ptr(pt_u64), _ptr(sc_u64), n, _ptr(out), _nthreads())
    assert rc == 0
    return u64_to_g2(out)[0]


# ---------------------------------------------------------------------------
# Modular vector kernels (standard-form values; modulus per call)
# ---------------------------------------------------------------------------

def _mod_arr(modulus: int) -> np.ndarray:
    return ints_to_u64([modulus])


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def coo_matvec(modulus: int, out_idx: np.ndarray, in_idx: np.ndarray,
               coeff_u64: np.ndarray, x_u64: np.ndarray, n_out: int,
               out_u64: np.ndarray | None = None) -> np.ndarray:
    """out[out_idx[k]] += coeff[k] * x[in_idx[k]] mod modulus.

    coeff_u64/x_u64: (nnz,4)/(nx,4) uint64 standard form (ints_to_u64).
    Returns (n_out, 4) uint64.
    """
    lib = _lib()
    out = out_u64 if out_u64 is not None else np.zeros((n_out, 4), dtype="<u8")
    oi = np.ascontiguousarray(out_idx, dtype=np.uint32)
    ii = np.ascontiguousarray(in_idx, dtype=np.uint32)
    rc = lib.cn_coo_matvec(_ptr(_mod_arr(modulus)), len(oi), _ptr32(oi), _ptr32(ii),
                           _ptr(coeff_u64), _ptr(x_u64), _ptr(out), n_out)
    assert rc == 0
    return out


def lagrange_at(modulus: int, w: int, t: int, factor: int, n: int) -> np.ndarray:
    lib = _lib()
    out = np.zeros((n, 4), dtype="<u8")
    rc = lib.cn_lagrange_at(
        _ptr(_mod_arr(modulus)), _ptr(ints_to_u64([w])), _ptr(ints_to_u64([t])),
        _ptr(ints_to_u64([factor])), n, _ptr(out))
    assert rc == 0
    return out


def vec_op(modulus: int, op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _lib()
    n = a.shape[0]
    out = np.zeros((n, 4), dtype="<u8")
    code = {"mul": 0, "add": 1, "sub": 2}[op]
    rc = lib.cn_vec_op(_ptr(_mod_arr(modulus)), code, _ptr(a), _ptr(b), n, _ptr(out))
    assert rc == 0
    return out


def batch_inv(modulus: int, a: np.ndarray) -> np.ndarray:
    lib = _lib()
    n = a.shape[0]
    out = np.zeros((n, 4), dtype="<u8")
    rc = lib.cn_batch_inv(_ptr(_mod_arr(modulus)), _ptr(a), n, _ptr(out))
    assert rc == 0
    return out


def powers(modulus: int, base: int, scale: int, n: int) -> np.ndarray:
    lib = _lib()
    out = np.zeros((n, 4), dtype="<u8")
    rc = lib.cn_powers(_ptr(_mod_arr(modulus)), _ptr(ints_to_u64([base])),
                       _ptr(ints_to_u64([scale])), n, _ptr(out))
    assert rc == 0
    return out


def sumcheck_quad(modulus: int, a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(e0, e2) round evals for sum_x A*B; a/b (2*half, 4) standard u64."""
    lib = _lib()
    half = a.shape[0] // 2
    out = np.zeros((2, 4), dtype="<u8")
    rc = lib.cn_sumcheck_quad(_ptr(_mod_arr(modulus)), half, _ptr(a), _ptr(b),
                              _ptr(out), _nthreads())
    assert rc == 0
    e = u64_to_ints(out)
    return e[0], e[1]


def sumcheck_cubic(modulus: int, a: np.ndarray, b: np.ndarray, c: np.ndarray,
                   d: np.ndarray) -> tuple[int, int, int]:
    """(e0, e2, e3) round evals for sum_x A*(B*C - D)."""
    lib = _lib()
    half = a.shape[0] // 2
    out = np.zeros((3, 4), dtype="<u8")
    rc = lib.cn_sumcheck_cubic(_ptr(_mod_arr(modulus)), half, _ptr(a), _ptr(b),
                               _ptr(c), _ptr(d), _ptr(out), _nthreads())
    assert rc == 0
    e = u64_to_ints(out)
    return e[0], e[1], e[2]


def bind_top(modulus: int, evals: np.ndarray, r: int) -> np.ndarray:
    """out[i] = lo[i] + r*(hi[i]-lo[i]); evals (2*half, 4) -> (half, 4)."""
    lib = _lib()
    half = evals.shape[0] // 2
    out = np.zeros((half, 4), dtype="<u8")
    rc = lib.cn_bind_top(_ptr(_mod_arr(modulus)), half, _ptr(evals),
                         _ptr(ints_to_u64([r % modulus])), _ptr(out), _nthreads())
    assert rc == 0
    return out


def eq_evals(modulus: int, rs: list[int]) -> np.ndarray:
    """eq(x, r) table over {0,1}^len(rs) as (2^m, 4) standard u64."""
    lib = _lib()
    m = len(rs)
    out = np.zeros((1 << m, 4), dtype="<u8")
    rc = lib.cn_eq_evals(_ptr(_mod_arr(modulus)),
                         _ptr(ints_to_u64([r % modulus for r in rs])), m, _ptr(out))
    assert rc == 0
    return out


def dot(modulus: int, a: np.ndarray, b: np.ndarray) -> int:
    lib = _lib()
    out = np.zeros((1, 4), dtype="<u8")
    rc = lib.cn_dot(_ptr(_mod_arr(modulus)), _ptr(a), _ptr(b), min(a.shape[0], b.shape[0]), _ptr(out))
    assert rc == 0
    return u64_to_ints(out)[0]


# ---------------------------------------------------------------------------
# BN254 pairing (verifier side; bigcurve.cpp pairing tower)
# ---------------------------------------------------------------------------

_pairing_ready = False


def witness_run(modulus: int, code: np.ndarray, coeffs_mont: np.ndarray,
                bigpool: np.ndarray, in_idx: np.ndarray, in_val: np.ndarray,
                nv: int) -> np.ndarray:
    """Execute a serialized witness program (r1cs/witness_program.py);
    returns the full (nv, 4) u64 standard-form assignment."""
    lib = _lib()
    values = np.zeros((nv, 4), dtype="<u8")
    code = np.ascontiguousarray(code, dtype=np.uint32)
    in_idx = np.ascontiguousarray(in_idx, dtype=np.uint32)
    in_val = np.ascontiguousarray(in_val, dtype="<u8")
    rc = lib.cn_witness_run(
        _ptr(_mod_arr(modulus)), _ptr32(code), len(code), _ptr(coeffs_mont),
        _ptr(bigpool), _ptr32(in_idx), _ptr(in_val), in_idx.shape[0],
        _ptr(values), nv,
    )
    assert rc == 0, f"cn_witness_run failed (rc={rc})"
    return values


def _pairing_init() -> bool:
    """One-time upload of the Frobenius constants and the hard-part exponent
    (computed exactly in core/fields.py) into the native pairing context."""
    global _pairing_ready
    if _pairing_ready:
        return True
    lib = _lib()
    if lib is None:
        return False
    from ..core import fields as F

    def fq2_arr(xs):
        vals = []
        for x in xs:
            vals += [x.c0, x.c1]
        return ints_to_u64(vals)

    c16 = fq2_arr(F.FROB_C1_6)
    c26 = fq2_arr(F.FROB_C2_6)
    c112 = fq2_arr(F.FROB_C1_12)
    p, r = F.BN254_FQ, F.BN254_FR
    e = (p**4 - p**2 + 1) // r
    nlimbs = (e.bit_length() + 63) // 64
    he = np.frombuffer(e.to_bytes(nlimbs * 8, "little"), dtype="<u8").copy()
    rc = lib.cn_pairing_init(_ptr(c16), _ptr(c26), _ptr(c112), _ptr(he), nlimbs)
    _pairing_ready = rc == 0
    return _pairing_ready


def multi_pairing_raw(pairs):
    """prod e(P_i, Q_i) as a list of 12 Fq ints in tower order
    (c0.c0.c0, c0.c0.c1, ..., c1.c2.c1), or None if unavailable.
    P_i: AffinePoint (None = identity); Q_i: (Fq2, Fq2) or None."""
    if not _pairing_init():
        return None
    lib = _lib()
    n = len(pairs)
    g1 = np.zeros((n, 8), dtype="<u8")
    g2 = np.zeros((n, 16), dtype="<u8")
    for i, (p, q) in enumerate(pairs):
        if p is not None:
            g1[i] = ints_to_u64([p[0], p[1]]).reshape(8)
        if q is not None:
            g2[i] = ints_to_u64(
                [q[0].c0, q[0].c1, q[1].c0, q[1].c1]
            ).reshape(16)
    out = np.zeros((12, 4), dtype="<u8")
    rc = lib.cn_multi_pairing(_ptr(g1), _ptr(g2), n, _ptr(out))
    if rc != 0:
        return None
    return u64_to_ints(out)
