"""Field and point kernels for one prime-field curve: the port's counterpart
of ``PallasEC`` (``crescent_tpu/ops/pallas_ec.py``).

Field ops (``csrc/ntt.cu``):

* ``mul(x, y)``: the Montgomery product x*y*2^-256 mod p
  (``PallasEC.mul`` / ``_mul_kernel``).
* ``butterfly(a, b, tw)``: (a + b*tw, a - b*tw) mod p
  (``PallasEC.butterfly`` / ``_bfly_kernel``), and ``butterfly_stage_``,
  one radix-2 NTT stage of the same kernel in place on an (n, 8) plane.

Point ops (``csrc/ec.cu``), on y^2 = x^3 + a*x + b over the field:

* ``inv(x)``: 1/x, 0 -> 0 (``PallasEC.inv`` / ``_inv_kernel``, a Fermat
  chain there, a constant-time divstep inversion here; the plain version
  is x^(p-2)).
* ``affine_denom(lx, ly, lv, rx, ry, rv)``: the denominator of the affine
  sum L + R (``_adenom_kernel``).
* ``affine_add(lx, ly, lv, rx, ry, rv, inv)``: affine L + R from
  1/denominator -> (x3, y3, valid3) (``_aadd_kernel``).
* ``jadd(x1, y1, z1, x2, y2, z2)``: complete Jacobian addition
  (``_jadd_kernel``).
* ``jdbl_n(x, y, z, count)`` and ``jdbl(x, y, z)``: chained and single
  Jacobian doubling (``_dbln_kernel``, ``_dbl_kernel``).
* ``madd(x1, y1, z1, qx, qy, valid, sign)``: mixed Jacobian + affine
  addition P + (sign ? -Q : Q), P passed through where valid == 0
  (``_madd_kernel``): madd-2007-bl's products in rounds
  (``csrc/warp.cuh`` ``madd_rounds``, ``csrc/madd.cuh``).
* ``fixed_base(table, sc)``: k * G for every scalar from the fixed base's
  window table, the 32 byte windows of a scalar in one launch, the table
  rows gathered in the kernel and each added by ``madd``'s lane body
  (``csrc/madd.cuh``); the plain version ``fixed_base_plain`` is the
  reference's scan of row gathers and ``madd``
  (``crescent_tpu/ops/fixed_base.py:138-144``, ``fixed_base_windows``).
* ``bucket_reduce(x, y, z, W, B)``: per-window weighted sums of a dense
  Jacobian bucket table, one launch (``_bucket_reduce_kernel``): a cluster
  of blocks a window, its level tables in their distributed shared memory
  (``csrc/bucket.cuh``).
* ``batch_inv(d, inv_floor)``: 1/d for every row, the reference's product
  tree of ``mul`` with ``inv`` on its root level
  (``crescent_tpu/ops/msm_affine.py`` ``batch_inv``) in one launch, one
  block a root (``csrc/batch_inv.cuh``); the plain version is that tree.

``CudaQuadEC`` is the counterpart of ``QuadPallasEC``: ``mul``, ``inv``,
``batch_inv``, ``butterfly``, the seven point ops and ``fixed_base`` over Fq2
(``csrc/ec2.cu``; ``ops/quadratic.py`` for the layout), for setup's G2 fixed
base and the G2 MSM of ``prove``.  The point ops of both classes share their wrappers
(``_Kernels``), their plain versions (the formula bodies below) and their
CUDA bodies (``csrc/point.cuh``; ``jdbl_n`` a warp a lane over Fq, two
over Fq2, and ``jadd`` and ``jdbl`` several threads a lane, in
``csrc/warp.cuh``; ``affine_add`` one thread a lane over Fq and two over
Fq2 in ``csrc/affine_add.cuh``; and ``inv`` the divsteps of
``csrc/field.cuh``, over Fq2 on the norm).

Tensors are packed (N, 8) int32 word rows (``ops/limb.py``), (N, 16) over
Fq2, canonical, Montgomery form where the op needs it; validity flags are
(N,) int32.  A tensor on the CPU takes the plain PyTorch version
(``<op>_plain``: one transcription of the reference's formula bodies over
``ModCtx`` or ``QuadCtx``, as ``crescent_tpu/ops/xla_pec.py`` is for the
reference); a CUDA tensor launches the kernel or raises.  ``<op>_launches``
count kernel launches and nothing else.  The modulus and the curve's ``a``
are kernel arguments, so one build serves every field and curve with
p < 2^255.  A modulus at or above 2^255 (T-256's base field, for Spartan's
MSMs) takes only the kernels in ``WIDE_KERNELS`` on the card: ``mul`` as it
is, ``jadd`` and ``jdbl`` as their kWide instances (a != 0), picked from the
modulus when the set is made; every other kernel refuses it on a CUDA
tensor (``WIDE_LATER``), and its plain version holds it on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .limb import NWORD, get_ctx
from .quadratic import QWORD, get_quad_ctx


def _check_strided(name: str, t: torch.Tensor, device: torch.device,
                   width: int = NWORD) -> int:
    """An (N, width) int32 tensor whose rows are packed and 16-byte aligned
    but may lie any multiple of 16 bytes apart; returns that distance in
    16-byte units (width / 4 for a packed plane)."""
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name}: expected an (N, {width}) int32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    row = t.stride(0) if t.shape[0] > 1 else width
    if t.stride(1) != 1 or row % 4 or row < 0 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be packed and 16-byte aligned")
    return row // 4


def _check_rows(name: str, t: torch.Tensor, device: torch.device,
                width: int = NWORD) -> None:
    """A packed (N, width) int32 plane."""
    if _check_strided(name, t, device, width) != width // 4:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_flags(name: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) int32 tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _words32(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(NWORD)]


# The kernels whose CUDA body holds a modulus p >= 2^255, each checked on
# the card over T-256 (chip_smoke.py): `mul` (field.cuh's fe_mont_mul keeps
# the carry out of 256 bits for any p < 2^256) and the kWide instances of
# `jadd` and `jdbl` (csrc/warp.cuh; crescent_jadd_wide and
# crescent_jdbl_wide, a != 0 only).  The others assume p < 2^255.
WIDE_KERNELS = ("mul", "jadd", "jdbl")
WIDE_LATER = ("is not lifted to a modulus at or above 2^255 on the card: its CUDA body "
              "assumes p < 2^255 (ROADMAP Queue 2 item 1)")

KERNELS = ("mul", "butterfly", "inv", "affine_denom", "affine_add", "jadd",
           "jdbl_n", "jdbl", "madd", "fixed_base", "bucket_reduce", "batch_inv")
QUAD_KERNELS = ("mul", "inv", "affine_denom", "affine_add", "jadd", "jdbl_n",
                "jdbl", "madd", "fixed_base", "bucket_reduce", "butterfly", "batch_inv")

# The fixed base's window table (``fixed_base``, ``ops/fixed_base.py``): a
# 256-bit scalar's 32 byte windows, 256 rows a window (w-major).
WBITS = 8
NWIN = NWORD * 32 // WBITS
TSIZE = 1 << WBITS


def tree_halvings(n: int, inv_floor: int) -> int:
    """How often ``batch_inv``'s product tree halves an n-row level while
    it is above inv_floor: its roots are the runs of 2^k leaves.  Raises
    where a level does not halve evenly (the reference asserts)."""
    if inv_floor < 1:
        raise ValueError(f"inv_floor must be >= 1, got {inv_floor}")
    k = 0
    while n > inv_floor:
        if n % 2:
            raise ValueError(f"batch_inv: a level of {n} rows does not halve evenly")
        n //= 2
        k += 1
    return k


# -- formula bodies shared by the prime-field and Fq2 plain versions ---------
# `f` is a ``ModCtx`` or a ``QuadCtx``; `a` is the curve's a as a Montgomery
# row of f, or None where a == 0.

def double_plain(f, a, X1, Y1, Z1):
    """dbl-2007-bl, plus a*ZZ^2 when a != 0 (``pallas_ec._double``)."""
    XX = f.mont_sqr(X1)
    YY = f.mont_sqr(Y1)
    YYYY = f.mont_sqr(YY)
    ZZ = f.mont_sqr(Z1)
    S = f.mont_sqr(f.add_mod(X1, YY))
    S = f.sub_mod(f.sub_mod(S, XX), YYYY)
    S = f.add_mod(S, S)
    M = f.add_mod(f.add_mod(XX, XX), XX)
    if a is not None:
        M = f.add_mod(M, f.mont_mul(a, f.mont_sqr(ZZ)))
    T = f.sub_mod(f.mont_sqr(M), f.add_mod(S, S))
    e8 = f.add_mod(YYYY, YYYY)
    e8 = f.add_mod(e8, e8)
    e8 = f.add_mod(e8, e8)
    Y3 = f.sub_mod(f.mont_mul(M, f.sub_mod(S, T)), e8)
    Z3 = f.sub_mod(f.sub_mod(f.mont_sqr(f.add_mod(Y1, Z1)), YY), ZZ)
    return T, Y3, Z3


def madd_plain(f, a, X1, Y1, Z1, qx, qy, valid, sign):
    """Mixed addition P + (sign ? -Q : Q), P where valid == 0
    (``pallas_ec._madd_body``): Q with Z = 1 when P is the identity, the
    doubling when P == Q, Z = 0 when P == -Q."""
    qy = f.select(sign != 0, f.neg_mod(qy), qy)
    Z1Z1 = f.mont_sqr(Z1)
    U2 = f.mont_mul(qx, Z1Z1)
    S2 = f.mont_mul(f.mont_mul(qy, Z1), Z1Z1)
    H = f.sub_mod(U2, X1)
    r = f.sub_mod(S2, Y1)

    h_zero = f.is_zero(H)
    r_zero = f.is_zero(r)
    p_inf = f.is_zero(Z1)

    HH = f.mont_sqr(H)
    I = f.add_mod(f.add_mod(HH, HH), f.add_mod(HH, HH))
    J = f.mont_mul(H, I)
    rr = f.add_mod(r, r)
    V = f.mont_mul(X1, I)
    X3 = f.sub_mod(f.sub_mod(f.mont_sqr(rr), J), f.add_mod(V, V))
    YJ = f.mont_mul(Y1, J)
    Y3 = f.sub_mod(f.mont_mul(rr, f.sub_mod(V, X3)), f.add_mod(YJ, YJ))
    Z3 = f.sub_mod(f.sub_mod(f.mont_sqr(f.add_mod(Z1, H)), Z1Z1), HH)

    dX, dY, dZ = double_plain(f, a, X1, Y1, Z1)

    same = h_zero & r_zero & ~p_inf
    negs = h_zero & ~r_zero & ~p_inf
    one = f.one_mont(Z1.device).expand_as(Z1)
    sel = f.select
    x = sel(p_inf, qx, sel(same, dX, X3))
    y = sel(p_inf, qy, sel(same, dY, Y3))
    z = sel(p_inf, one, sel(same, dZ, Z3))
    z = sel(negs, torch.zeros_like(z), z)
    keep = valid == 0
    return sel(keep, X1, x), sel(keep, Y1, y), sel(keep, Z1, z)


def jadd_plain(f, a, X1, Y1, Z1, X2, Y2, Z2):
    """Complete Jacobian addition (``pallas_ec._jadd_body``): the doubling
    when P == Q, the identity (Z = 0) when P == -Q, the other side when one
    is the identity."""
    Z1Z1 = f.mont_sqr(Z1)
    Z2Z2 = f.mont_sqr(Z2)
    U1 = f.mont_mul(X1, Z2Z2)
    U2 = f.mont_mul(X2, Z1Z1)
    S1 = f.mont_mul(f.mont_mul(Y1, Z2), Z2Z2)
    S2 = f.mont_mul(f.mont_mul(Y2, Z1), Z1Z1)
    H = f.sub_mod(U2, U1)
    r = f.sub_mod(S2, S1)

    h_zero = f.is_zero(H)
    r_zero = f.is_zero(r)
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    same = h_zero & r_zero & ~p_inf & ~q_inf
    negs = h_zero & ~r_zero & ~p_inf & ~q_inf

    I = f.mont_sqr(f.add_mod(H, H))
    J = f.mont_mul(H, I)
    rr = f.add_mod(r, r)
    V = f.mont_mul(U1, I)
    X3 = f.sub_mod(f.sub_mod(f.mont_sqr(rr), J), f.add_mod(V, V))
    SJ = f.mont_mul(S1, J)
    Y3 = f.sub_mod(f.mont_mul(rr, f.sub_mod(V, X3)), f.add_mod(SJ, SJ))
    Z3 = f.mont_mul(
        f.sub_mod(f.sub_mod(f.mont_sqr(f.add_mod(Z1, Z2)), Z1Z1), Z2Z2), H)

    # On the card the doubling is always computed (no wait on the device, and
    # the plain version stays capturable in a CUDA graph); on the CPU only
    # where a lane takes it (the selects below discard it elsewhere).
    if same.device.type != "cpu" or same.any():
        dX, dY, dZ = double_plain(f, a, X1, Y1, Z1)
    else:
        dX, dY, dZ = X3, Y3, Z3

    sel = f.select
    x = sel(p_inf, X2, sel(q_inf, X1, sel(same, dX, X3)))
    y = sel(p_inf, Y2, sel(q_inf, Y1, sel(same, dY, Y3)))
    z = sel(p_inf, Z2, sel(q_inf, Z1, sel(same, dZ, Z3)))
    z = sel(negs, torch.zeros_like(z), z)
    return x, y, z


def affine_denom_plain(f, lx, ly, lv, rx, ry, rv):
    """``pallas_ec._affine_denom_body``: 2*ly when L == R, 1 when a side is
    invalid or L == -R, else rx - lx."""
    both = (lv != 0) & (rv != 0)
    dx = f.sub_mod(rx, lx)
    same_x = f.is_zero(dx)
    same_y = f.is_zero(f.sub_mod(ry, ly))
    d = f.select(same_x & same_y, f.add_mod(ly, ly), dx)
    one = f.one_mont(lx.device).expand_as(lx)
    return f.select(both & ~(same_x & ~same_y), d, one)


def affine_add_plain(f, a, lx, ly, lv, rx, ry, rv, inv):
    """``pallas_ec._affine_add_body``: (x3, y3, valid3) from the inverse
    denominators: chord, tangent (3x^2 + a), infinity for L == -R, the one
    valid side passed through."""
    lv = lv != 0
    rv = rv != 0
    both = lv & rv
    same_x = f.is_zero(f.sub_mod(rx, lx))
    same_y = f.is_zero(f.sub_mod(ry, ly))
    dbl_case = same_x & same_y
    inf_case = same_x & ~same_y

    xx = f.mont_sqr(lx)
    num_dbl = f.add_mod(f.add_mod(xx, xx), xx)
    if a is not None:
        num_dbl = f.add_mod(num_dbl, a)
    num = f.select(dbl_case, num_dbl, f.sub_mod(ry, ly))
    lam = f.mont_mul(num, inv)
    x3 = f.sub_mod(f.sub_mod(f.mont_sqr(lam), lx), rx)
    y3 = f.sub_mod(f.mont_mul(lam, f.sub_mod(lx, x3)), ly)

    x = f.select(both, x3, f.select(lv, lx, rx))
    y = f.select(both, y3, f.select(lv, ly, ry))
    v = (lv | rv) & ~(both & inf_case)
    return x, y, v.to(torch.int32)


def bucket_levels(jadd, x, y, z, W: int, B: int):
    """Per-window weighted bucket sums of a dense (W * B, WIDTH) Jacobian
    table, level by level through `jadd` (one call a level): the suffix
    sums running_b = sum_{b' >= b} S_b' by shift-adds (j = 1, 2, 4, ...,
    the identity, zero rows, shifted in past column B - 1), then
    sum_{d >= 1} running_d by a halving tree over columns 1..B - 1 (B - 1 a
    power of two).  Returns three (W, WIDTH) planes.  The reference's
    unfused aggregate (``AffineMSM._aggregate_dense``) and its fused kernel
    (``_bucket_reduce_kernel``) add the same pairs in the same order."""
    nw = x.shape[-1]

    def flat(a):
        return a.reshape(-1, nw).contiguous()

    run = [a.reshape(W, B, nw) for a in (x, y, z)]
    j = 1
    while j < B:
        hi = [torch.cat([a[:, j:], torch.zeros_like(a[:, :j])], dim=1) for a in run]
        run = [o.reshape(W, B, nw) for o in jadd(*map(flat, run), *map(flat, hi))]
        j *= 2
    acc = [a[:, 1:] for a in run]
    n = B - 1
    while n > 1:
        h = n // 2
        acc = [o.reshape(W, h, nw) for o in
               jadd(*(flat(a[:, :h]) for a in acc), *(flat(a[:, h:]) for a in acc))]
        n = h
    return tuple(a[:, 0].contiguous() for a in acc)


def fixed_base_windows(madd, table, sc):
    """The reference's scan of the fixed base
    (``crescent_tpu/ops/fixed_base.py:138-144``) over ``madd(x1, y1, z1, qx,
    qy, valid, sign)``: for each of the 32 byte windows of the (n, 8)
    standard-form scalar words `sc`, one row gather from the (8192, 2 W)
    table (``index_select``) and one ``madd`` with valid = digit != 0 and
    sign = 0, into a Jacobian accumulator that starts as the identity.
    Over ``madd_plain`` it is ``fixed_base_plain``; over the ``madd``
    kernel, the launches that ``fixed_base`` replaces."""
    W = table.shape[1] // 2
    n = sc.shape[0]
    dev = sc.device
    digits = sc.contiguous().view(torch.uint8).to(torch.int64).T  # (32, n): byte w
    rows = digits + torch.arange(NWIN, dtype=torch.int64, device=dev)[:, None] * TSIZE
    valid = (digits != 0).to(torch.int32).contiguous()
    sign = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((n, W), dtype=torch.int32, device=dev)
    acc = (zero, zero, zero)
    for w in range(NWIN):
        g = table.index_select(0, rows[w])
        acc = madd(*acc, g[:, :W], g[:, W:], valid[w], sign)
    return acc


def batch_inv_tree(mul, inv, d: torch.Tensor, inv_floor: int = 512) -> torch.Tensor:
    """The reference's product tree (``msm_affine.batch_inv``) over
    ``mul(x, y, out=None)`` and ``inv(x)``: pair products level by level
    while a level is above inv_floor, the root level inverted, the tree
    unwound (1/le = inv * ro, 1/ro = inv * le, written interleaved).  Over
    the plain versions it is ``batch_inv_plain``; over the ``mul`` and
    ``inv`` kernels, the launches that ``batch_inv`` replaces."""
    tree_halvings(d.shape[0], inv_floor)
    levels = [d]
    while levels[-1].shape[0] > inv_floor:
        cur = levels[-1]
        levels.append(mul(cur[0::2], cur[1::2]))
    r = inv(levels[-1])
    for cur in levels[-2::-1]:
        out = torch.empty_like(cur)
        mul(r, cur[1::2], out=out[0::2])
        mul(r, cur[0::2], out=out[1::2])
        r = out
    return r


class _Kernels:
    """Launch counts, the device rule, and the point ops shared by the
    prime-field and Fq2 kernel sets: each subclass names its library
    (`LIB`), its entry points' prefix (`PREFIX`), its row width (`WIDTH`),
    and sets `ctx`, `_curve26`, `_inv_consts` (`inv`'s arguments after the
    curve's) and `_a`."""

    KERNELS: tuple = ()
    LIB = PREFIX = ""
    WIDTH = NWORD
    wide = False  # the modulus is at or above 2^255
    # The most buckets a window `bucket_reduce` takes: csrc/bucket.cuh keeps
    # a window's two level tables (6 planes of ceil(B / 4) + 1 rows of WIDTH
    # words) in the shared memory of a cluster of 4 blocks, at most
    # kBucketSmemMax = 200 KB a block (tests/test_torch_bucket_schedule.py
    # derives it from the source).
    BUCKET_B_MAX = 4097

    def reset_launches(self) -> None:
        for k in self.KERNELS:
            setattr(self, f"{k}_launches", 0)

    def launches(self) -> dict[str, int]:
        return {k: getattr(self, f"{k}_launches") for k in self.KERNELS}

    @staticmethod
    def _device(t: torch.Tensor) -> str:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {t.device}")
        return t.device.type

    def _launched(self, kernel: str, rc: int) -> None:
        """Count one launch of `kernel`, whose entry point returned rc."""
        if rc:
            raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
        setattr(self, f"{kernel}_launches", getattr(self, f"{kernel}_launches") + 1)

    def _entry(self, kernel: str, lib: str = ""):
        """The C entry point of `kernel` in this set's library (or `lib`):
        over a modulus p >= 2^255 its wide instance, and a refusal where it
        has none."""
        name = self.PREFIX + kernel
        if self.wide:
            if kernel not in WIDE_KERNELS:
                raise NotImplementedError(f"{kernel} {WIDE_LATER}")
            if kernel != "mul":
                if self.a_is_zero:
                    raise NotImplementedError(f"{kernel} with a = 0 {WIDE_LATER}")
                name += "_wide"
        return getattr(_build.library(lib or self.LIB), name)

    def _mul_args(self, x, y, out):
        """Checks of a strided product: (n, x stride, y stride (0: y is one
        broadcast row), out stride, out), in 16-byte units."""
        width = self.WIDTH
        n = x.shape[0]
        xs = _check_strided("x", x, x.device, width)
        ys = _check_strided("y", y, x.device, width)
        if y.shape[0] not in (1, n):
            raise ValueError(f"y has {y.shape[0]} rows, x has {n}")
        if y.shape[0] == 1 and n != 1:
            ys = 0
        if out is None:
            out = torch.empty((n, width), dtype=torch.int32, device=x.device)
        if out.shape[0] != n:
            raise ValueError(f"out has {out.shape[0]} rows, x has {n}")
        return n, xs, ys, _check_strided("out", out, x.device, width), out

    def _planes(self, names: str, tensors, flags=()) -> tuple[int, torch.device]:
        """Check (N, WIDTH) coordinate planes and (N,) flag vectors of one
        op."""
        dev = tensors[0].device
        n = tensors[0].shape[0]
        for name, t in zip(names.split(), tensors):
            _check_rows(name, t, dev, self.WIDTH)
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
        for name, t in flags:
            _check_flags(name, t, n, dev)
        return n, dev

    # -- plain versions -------------------------------------------------------
    def mul_plain(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.ctx.mont_mul(x, y)

    def inv_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self.ctx.inv_mod(x)

    def jdbl_plain(self, X1, Y1, Z1):
        """dbl-2007-bl, plus a*ZZ^2 when a != 0 (``pallas_ec._double``)."""
        return double_plain(self.ctx, self._a(X1.device), X1, Y1, Z1)

    def jdbl_n_plain(self, x, y, z, count: int):
        for _ in range(count):
            x, y, z = self.jdbl_plain(x, y, z)
        return x, y, z

    def jadd_plain(self, X1, Y1, Z1, X2, Y2, Z2):
        return jadd_plain(self.ctx, self._a(X1.device), X1, Y1, Z1, X2, Y2, Z2)

    def affine_denom_plain(self, lx, ly, lv, rx, ry, rv):
        return affine_denom_plain(self.ctx, lx, ly, lv, rx, ry, rv)

    def affine_add_plain(self, lx, ly, lv, rx, ry, rv, inv):
        return affine_add_plain(self.ctx, self._a(lx.device), lx, ly, lv, rx, ry,
                                rv, inv)

    def madd_plain(self, x1, y1, z1, qx, qy, valid, sign):
        return madd_plain(self.ctx, self._a(x1.device), x1, y1, z1, qx, qy,
                          valid, sign)

    def fixed_base_plain(self, table, sc):
        return fixed_base_windows(self.madd_plain, table, sc)

    def butterfly_plain(self, a, b, tw):
        t = self.ctx.mont_mul(b, tw)
        return self.ctx.add_mod(a, t), self.ctx.sub_mod(a, t)

    def bucket_reduce_plain(self, x, y, z, W: int, B: int):
        return bucket_levels(self.jadd_plain, x, y, z, W, B)

    def batch_inv_plain(self, d: torch.Tensor, inv_floor: int = 512) -> torch.Tensor:
        """The reference's product tree over ``mul_plain`` and
        ``inv_plain``."""
        def mul(x, y, out=None):
            r = self.mul_plain(x, y)
            return r if out is None else out.copy_(r)

        return batch_inv_tree(mul, self.inv_plain, d, inv_floor)

    # -- ops ------------------------------------------------------------------
    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of every row (Montgomery form; the divstep inversion,
        over Fq2 of the norm x0^2 + x1^2); 0 -> 0."""
        if self._device(x) == "cpu":
            return self.inv_plain(x)
        n, dev = self._planes("x", [x])
        out = torch.empty_like(x)
        self._launched("inv", self._entry("inv")(
            self._curve26, *self._inv_consts, x.data_ptr(), out.data_ptr(), n,
            _stream(dev)))
        return out

    def batch_inv(self, d: torch.Tensor, inv_floor: int = 512) -> torch.Tensor:
        """1/d for every row of an (n, WIDTH) plane, 0 -> 0 with the zero's
        whole run of the tree: the tree's result, bit for bit, in one
        launch.  n must halve evenly down to inv_floor (callers pad; a power
        of two always works)."""
        if self._device(d) == "cpu":
            return self.batch_inv_plain(d, inv_floor)
        n, dev = self._planes("d", [d])
        log_s = tree_halvings(n, inv_floor)
        out = torch.empty_like(d)
        if n:
            self._launched("batch_inv", self._entry("batch_inv")(
                self._curve26, *self._inv_consts, d.data_ptr(), out.data_ptr(), n,
                log_s, _stream(dev)))
        return out

    def affine_denom(self, lx, ly, lv, rx, ry, rv) -> torch.Tensor:
        """Pair denominators for a batched affine addition; invalid and
        infinity pairs get 1, so a batch inversion stays defined."""
        if self._device(lx) == "cpu":
            return self.affine_denom_plain(lx, ly, lv, rx, ry, rv)
        n, dev = self._planes("lx ly rx ry", [lx, ly, rx, ry],
                              (("lv", lv), ("rv", rv)))
        out = torch.empty_like(lx)
        self._launched("affine_denom", self._entry("affine_denom")(
            self._curve26, lx.data_ptr(), ly.data_ptr(), lv.data_ptr(),
            rx.data_ptr(), ry.data_ptr(), rv.data_ptr(), out.data_ptr(), n,
            _stream(dev)))
        return out

    def affine_add(self, lx, ly, lv, rx, ry, rv, inv):
        """Affine pair addition with the inverse denominators given.
        Returns (x3, y3, valid3), valid3 an (N,) int32 vector."""
        if self._device(lx) == "cpu":
            return self.affine_add_plain(lx, ly, lv, rx, ry, rv, inv)
        n, dev = self._planes("lx ly rx ry inv", [lx, ly, rx, ry, inv],
                              (("lv", lv), ("rv", rv)))
        ox, oy = torch.empty_like(lx), torch.empty_like(lx)
        ov = torch.empty(n, dtype=torch.int32, device=dev)
        self._launched("affine_add", self._entry("affine_add")(
            self._curve26, lx.data_ptr(), ly.data_ptr(), lv.data_ptr(),
            rx.data_ptr(), ry.data_ptr(), rv.data_ptr(), inv.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), ov.data_ptr(), n, _stream(dev)))
        return ox, oy, ov

    def jadd(self, x1, y1, z1, x2, y2, z2):
        """Complete Jacobian addition on (N, WIDTH) planes (identity:
        Z == 0)."""
        if self._device(x1) == "cpu":
            return self.jadd_plain(x1, y1, z1, x2, y2, z2)
        ins = [x1, y1, z1, x2, y2, z2]
        n, dev = self._planes("x1 y1 z1 x2 y2 z2", ins)
        outs = [torch.empty_like(x1) for _ in range(3)]
        self._launched("jadd", self._entry("jadd")(
            self._curve26, *(t.data_ptr() for t in ins + outs), n, _stream(dev)))
        return tuple(outs)

    def jdbl_n(self, x, y, z, count: int):
        """`count` chained Jacobian doublings in one launch."""
        if count < 0:
            raise ValueError(f"count must be >= 0, got {count}")
        if self._device(x) == "cpu":
            return self.jdbl_n_plain(x, y, z, count)
        ins = [x, y, z]
        n, dev = self._planes("x y z", ins)
        outs = [torch.empty_like(x) for _ in range(3)]
        self._launched("jdbl_n", self._entry("jdbl_n")(
            self._curve26, *(t.data_ptr() for t in ins + outs), n, int(count),
            _stream(dev)))
        return tuple(outs)

    def jdbl(self, x, y, z):
        """One Jacobian doubling."""
        if self._device(x) == "cpu":
            return self.jdbl_plain(x, y, z)
        ins = [x, y, z]
        n, dev = self._planes("x y z", ins)
        outs = [torch.empty_like(x) for _ in range(3)]
        self._launched("jdbl", self._entry("jdbl")(
            self._curve26, *(t.data_ptr() for t in ins + outs), n, _stream(dev)))
        return tuple(outs)

    def madd(self, x1, y1, z1, qx, qy, valid, sign):
        """P + (sign ? -Q : Q) where valid != 0, else P: P Jacobian
        (N, WIDTH) planes, Q affine (N, WIDTH) rows (views at any 16-byte
        row stride, such as the halves of one gathered (N, 2 * WIDTH) table
        row), flags (N,) int32.  Returns new (x, y, z) planes."""
        if self._device(x1) == "cpu":
            return self.madd_plain(x1, y1, z1, qx, qy, valid, sign)
        n, dev = self._planes("x1 y1 z1", [x1, y1, z1],
                              (("valid", valid), ("sign", sign)))
        qs = []
        for name, t in (("qx", qx), ("qy", qy)):
            qs.append(_check_strided(name, t, dev, self.WIDTH))
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
        outs = [torch.empty_like(x1) for _ in range(3)]
        self._launched("madd", self._entry("madd")(
            self._curve26, x1.data_ptr(), y1.data_ptr(), z1.data_ptr(),
            qx.data_ptr(), qy.data_ptr(), qs[0], qs[1], valid.data_ptr(),
            sign.data_ptr(), *(t.data_ptr() for t in outs), n, _stream(dev)))
        return tuple(outs)

    def fixed_base(self, table, sc):
        """k * G in Jacobian form (three (n, WIDTH) planes, the identity
        Z == 0) for the (n, 8) int32 standard-form scalar words `sc`, from
        the (8192, 2 * WIDTH) table of Montgomery rows [x | y], row
        w * 256 + d holding d * 2^(8 w) * G: one launch for the whole
        batch, each lane's 32 windows added in turn (``csrc/madd.cuh``).
        Bit-identical to ``fixed_base_plain``."""
        if self._device(sc) == "cpu":
            return self.fixed_base_plain(table, sc)
        dev = sc.device
        _check_rows("sc", sc, dev)
        _check_rows("table", table, dev, 2 * self.WIDTH)
        if table.shape[0] != NWIN * TSIZE:
            raise ValueError(f"the table holds {NWIN * TSIZE} rows, got {table.shape[0]}")
        n = sc.shape[0]
        outs = [torch.empty((n, self.WIDTH), dtype=torch.int32, device=dev) for _ in range(3)]
        if n:
            self._launched("fixed_base", self._entry("fixed_base")(
                self._curve26, table.data_ptr(), sc.data_ptr(), *(t.data_ptr() for t in outs),
                n, _stream(dev)))
        return tuple(outs)

    @staticmethod
    def bucket_stride(B: int) -> int:
        """Rows between windows of the table ``bucket_reduce`` reads: B.  The
        reference pads a window to a multiple of 128 lanes
        (``PallasEC.bucket_stride``) for the TPU's block widths; a CUDA
        block takes any width, so the port keeps the dense table as it is."""
        return B

    def bucket_reduce(self, x, y, z, W: int, B: int):
        """Dense (W * B, WIDTH) Jacobian bucket table, window w in rows
        w * B .. w * B + B - 1 (bucket 0 first) -> three (W, WIDTH) planes:
        sum_{b >= 1} b * S_{w, b} for every window, one launch (a cluster of
        blocks a window, ``csrc/bucket.cuh``).  Requires B - 1 a power of
        two and B <= BUCKET_B_MAX (4,097 over Fq, 2,049 over Fq2: window
        widths c <= 13 and c <= 12; prove's c = 11 gives B = 1025), on the
        card and on the CPU alike.  Bit-identical to ``bucket_levels`` over
        ``jadd``."""
        if B < 2 or (B - 1) & (B - 2):
            raise ValueError(f"bucket_reduce needs B - 1 a power of two, got B = {B}")
        if B > self.BUCKET_B_MAX:
            raise ValueError(f"bucket_reduce takes at most B = {self.BUCKET_B_MAX} buckets a "
                             f"window (its level tables in a cluster's shared memory), got "
                             f"B = {B}")
        if self._device(x) == "cpu":
            return self.bucket_reduce_plain(x, y, z, W, B)
        n, dev = self._planes("x y z", [x, y, z])
        if n != W * B:
            raise ValueError(f"bucket table has {n} rows, expected W * B = {W * B}")
        outs = [torch.empty((W, self.WIDTH), dtype=torch.int32, device=dev)
                for _ in range(3)]
        self._launched("bucket_reduce", self._entry("bucket_reduce")(
            self._curve26, x.data_ptr(), y.data_ptr(), z.data_ptr(),
            *(t.data_ptr() for t in outs), W, B, _stream(dev)))
        return tuple(outs)

    def bucket_reduce_fit(self, W: int, B: int) -> dict:
        """The card's launch of ``bucket_reduce`` at W windows of B buckets:
        blocks a cluster, threads a block, dynamic shared bytes a block, and
        how many clusters the card holds at once
        (cudaOccupancyMaxActiveClusters).  Needs the card."""
        out = (ctypes.c_int * 4)()
        rc = self._entry("bucket_reduce_fit")(W, B, out)
        if rc:
            raise RuntimeError(f"bucket_reduce_fit failed: cudaError {rc}")
        return dict(zip(("cluster", "threads", "smem_bytes", "max_active_clusters"), out))


def divstep_r3(modulus: int) -> int:
    """R^3 mod p, R = 2^256, for the `inv` kernels over Fq and Fq2
    (csrc/field.cuh fe_inv_divsteps; over Fq2 on the norm): the divsteps
    invert a Montgomery row xR into x^-1 R^-1, and one Montgomery product by
    R^3 turns that into x^-1 R.  The kernel reads p^-1 mod 2^30 off the
    curve's -p^-1 mod 2^32."""
    return pow(1 << 256, 3, modulus)


def _r3_words(modulus: int) -> tuple:
    """`inv`'s arguments after the curve's: R^3 mod p as 8 words."""
    return ((ctypes.c_uint32 * NWORD)(*_words32(divstep_r3(modulus))),)


def _curve26(modulus: int, one_mont: int, a_mont: int):
    """The kernels' curve constants: modulus words, -p^-1 mod 2^32,
    Montgomery 1, Montgomery a, a_is_zero."""
    ninv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
    return (ctypes.c_uint32 * 26)(
        *_words32(modulus), ninv32, *_words32(one_mont), *_words32(a_mont),
        int(a_mont == 0))


class CudaEC(_Kernels):
    """The field and point kernels over one prime field and curve
    coefficient `a` (0 where only the field ops are used)."""

    KERNELS = KERNELS
    LIB, PREFIX = "ec", "crescent_"

    def __init__(self, modulus: int, a_host: int = 0):
        self.modulus = modulus
        self.ctx = get_ctx(modulus)
        self.wide = self.ctx.wide
        self.a_host = a_host % modulus
        self.a_is_zero = self.a_host == 0
        self.a_mont = self.a_host * self.ctx.R % modulus
        ninv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self._mod9 = (ctypes.c_uint32 * 9)(*_words32(modulus), ninv32)
        self._curve26 = _curve26(modulus, self.ctx.r_mod_n, self.a_mont)
        self._inv_consts = _r3_words(modulus)
        self.reset_launches()

    def _a(self, device):
        """a as a Montgomery row for the plain versions, None when 0."""
        return None if self.a_is_zero else self.ctx.const_words(self.a_mont, device)

    # -- ops ----------------------------------------------------------------
    def mul(self, x: torch.Tensor, y: torch.Tensor, out=None) -> torch.Tensor:
        """x (N, 8) times y (N, 8), or y (1, 8) broadcast; `out` may be x.
        x, y and out may be strided views whose rows are packed (every
        second row of a plane, say)."""
        if self._device(x) == "cpu":
            r = self.mul_plain(x, y)
            return r if out is None else out.copy_(r)
        n, xs, ys, os_, out = self._mul_args(x, y, out)
        self._launched("mul", self._entry("mul", "ntt")(
            self._mod9, x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
            xs, ys, os_, _stream(x.device)))
        return out

    def _butterfly_launch(self, a, b, tw, npairs: int, log_half: int) -> None:
        self._launched("butterfly", self._entry("butterfly", "ntt")(
            self._mod9, a.data_ptr(), b.data_ptr(), tw.data_ptr(), npairs,
            log_half, _stream(a.device)))

    def butterfly(self, a, b, tw):
        """(a + b*tw, a - b*tw) on (N, 8) planes, as new tensors."""
        if self._device(a) == "cpu":
            return self.butterfly_plain(a, b, tw)
        n = a.shape[0]
        for name, t in (("a", a), ("b", b), ("tw", tw)):
            _check_rows(name, t, a.device)
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, a has {n}")
        o0, o1 = a.clone(), b.clone()
        # one "block" wider than the batch: pair i is row i of each plane
        self._butterfly_launch(o0, o1, tw, n, max(n - 1, 1).bit_length())
        return o0, o1

    def butterfly_stage_(self, x: torch.Tensor, tw: torch.Tensor, half: int):
        """One radix-2 stage in place on the (n, 8) plane x: for every block
        of 2*half rows and j < half, (x[j], x[j+half]) <- (x[j] + x[j+half]*tw[j],
        x[j] - x[j+half]*tw[j]).  tw holds the stage's `half` twiddles."""
        n = x.shape[0]
        if half < 1 or half & (half - 1) or n % (2 * half) or tw.shape[0] != half:
            raise ValueError(f"bad stage: n={n}, half={half}, tw rows={tw.shape[0]}")
        if self._device(x) == "cpu":
            v = x.view(n // (2 * half), 2, half, NWORD)
            o0, o1 = self.butterfly_plain(v[:, 0], v[:, 1], tw)
            v[:, 0] = o0
            v[:, 1] = o1
            return x
        _check_rows("x", x, x.device)
        _check_rows("tw", tw, x.device)
        self._butterfly_launch(x, x[half:], tw, n // 2, half.bit_length() - 1)
        return x


class CudaQuadEC(_Kernels):
    """``mul``, ``inv``, ``butterfly`` and the point ops over
    Fq2 = Fq[u]/(u^2 + 1) on (N, 16) int32 rows (``QuadPallasEC``); the
    curve's a is 0, as ``QuadPallasEC.__init__`` requires."""

    KERNELS = QUAD_KERNELS
    LIB, PREFIX, WIDTH = "ec2", "crescent_fq2_", QWORD
    BUCKET_B_MAX = 2049  # rows twice as wide as over Fq
    a_is_zero = True

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.ctx = get_quad_ctx(modulus)
        self._curve26 = _curve26(modulus, self.ctx.base.r_mod_n, 0)
        self._inv_consts = _r3_words(modulus)
        self.reset_launches()

    @staticmethod
    def _a(device):
        return None

    def mul(self, x: torch.Tensor, y: torch.Tensor, out=None) -> torch.Tensor:
        """x (N, 16) times y (N, 16), or y (1, 16) broadcast; strided row
        views and `out` as for ``CudaEC.mul``."""
        if self._device(x) == "cpu":
            r = self.mul_plain(x, y)
            return r if out is None else out.copy_(r)
        n, xs, ys, os_, out = self._mul_args(x, y, out)
        self._launched("mul", self._entry("mul")(
            self._curve26, x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
            xs, ys, os_, _stream(x.device)))
        return out

    def butterfly(self, a, b, tw):
        """(a + b*tw, a - b*tw) on (N, 16) planes, as new tensors
        (``QuadPallasEC.butterfly``; no path of the reference calls it)."""
        if self._device(a) == "cpu":
            return self.butterfly_plain(a, b, tw)
        n, dev = self._planes("a b tw", [a, b, tw])
        o0, o1 = torch.empty_like(a), torch.empty_like(a)
        self._launched("butterfly", self._entry("butterfly")(
            self._curve26, a.data_ptr(), b.data_ptr(), tw.data_ptr(),
            o0.data_ptr(), o1.data_ptr(), n, _stream(dev)))
        return o0, o1


@functools.lru_cache(maxsize=None)
def _get_cuda_ec(modulus: int, a: int) -> CudaEC:
    return CudaEC(modulus, a)


def get_cuda_ec(modulus: int, a: int = 0) -> CudaEC:
    """One instance (and one set of launch counts) per field and `a`."""
    return _get_cuda_ec(modulus, a % modulus)


@functools.lru_cache(maxsize=None)
def get_cuda_quad_ec(modulus: int) -> CudaQuadEC:
    """One instance (and one set of launch counts) per base field."""
    return CudaQuadEC(modulus)
