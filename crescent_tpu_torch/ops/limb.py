"""256-bit modular arithmetic on PyTorch tensors, and the host conversions.

Counterpart of ``crescent_tpu/ops/limb.py``, whose module imports jax.

Storage layout.  On the device a field element is one row of eight
little-endian 32-bit words, held as ``torch.int32`` bit patterns: a batch is
an ``(N, 8)`` int32 tensor, 32 bytes per element.  Those are the same bytes as
the JAX package's ``(N, 16)`` 16-bit limbs and the native backend's ``(N, 4)``
u64 words, so every boundary is a byte view (``u64_to_words``,
``limbs_to_words``, ``words_to_limbs``).  The JAX ``(N, 16)`` limb layout is
kept at the port's public functions; CUDA kernels (``ops/cuda_ec.py``) read
the words directly.  Montgomery form uses R = 2^256, as in the reference.

The plain ops of ``ModCtx`` (``mont_mul``, ``add_mod``, ``sub_mod``, ...) carry
limbs in int64: torch's ``uint32`` has no ``add`` and no ``>>`` on the CPU.
Sums and differences work on the eight 32-bit words; products split them into
sixteen 16-bit limbs, since int64 holds a column sum of sixteen 16x16-bit
products (< 2^36) exactly.  They are written for few tensor ops (whole-width
products, carries resolved for all limbs at once), because at test sizes the
time is the per-op overhead.  Inputs must be canonical (< p); results are
canonical, so they equal the reference's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NLIMB = 16  # 16-bit limbs per 256-bit element
NWORD = 8   # 32-bit words per element


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy; exact, byte-identical to the reference)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, nlimb: int = NLIMB) -> np.ndarray:
    assert x >> (LIMB_BITS * nlimb) == 0, "value too wide"
    return np.frombuffer(int(x).to_bytes(2 * nlimb, "little"), dtype="<u2").astype(
        np.uint32
    )


def ints_to_limbs(xs, nlimb: int = NLIMB) -> np.ndarray:
    """list of ints -> (n, nlimb) uint32 limbs < 2^16."""
    if len(xs) == 0:
        return np.zeros((0, nlimb), dtype=np.uint32)
    buf = b"".join(int(x).to_bytes(2 * nlimb, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimb).astype(np.uint32)


def u64_to_limbs(a: np.ndarray) -> np.ndarray:
    """(n, 4) LE uint64 words -> (n, 16) uint16 limbs (a byte view)."""
    a = np.ascontiguousarray(a, dtype="<u8")
    return a.view("<u2").reshape(a.shape[0], 4 * a.shape[1])


def limbs_to_u64(a: np.ndarray) -> np.ndarray:
    """(n, 16) limbs < 2^16 -> (n, 4) LE uint64 words."""
    a = np.asarray(a)
    assert not (a >> LIMB_BITS).any(), "limbs_to_u64: limbs must be < 2^16"
    a16 = np.ascontiguousarray(a.astype("<u2"))
    return a16.view("<u8").reshape(a.shape[0], a.shape[1] // 4)


def limbs_to_ints(a) -> list[int]:
    """(n, nlimb) limbs < 2^16 -> list of ints."""
    a = np.asarray(a)
    a = a.reshape(-1, a.shape[-1])
    assert not (a >> LIMB_BITS).any(), "limbs_to_ints: limbs must be < 2^16"
    nbytes = 2 * a.shape[-1]
    buf = a.astype("<u2").tobytes()
    return [
        int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(a.shape[0])
    ]


# ---------------------------------------------------------------------------
# Host <-> device words
# ---------------------------------------------------------------------------

def u64_to_words(a: np.ndarray, device="cpu") -> torch.Tensor:
    """(n, 4) LE uint64 -> (n, 8) int32 word tensor on `device`."""
    a = np.ascontiguousarray(a, dtype="<u8")
    w = torch.from_numpy(a.view("<i4").reshape(a.shape[0], NWORD).copy())
    return w.to(device)


def limbs_to_words(a: np.ndarray, device="cpu") -> torch.Tensor:
    """(n, 16) limbs < 2^16 -> (n, 8) int32 word tensor on `device`."""
    return u64_to_words(limbs_to_u64(a), device)


def words_to_u64(w: torch.Tensor) -> np.ndarray:
    """(n, 8) int32 word tensor -> (n, 4) LE uint64 on the host."""
    a = np.ascontiguousarray(w.detach().cpu().numpy(), dtype="<i4")
    return a.view("<u8").reshape(a.shape[0], 4)


def words_to_limbs(w: torch.Tensor) -> np.ndarray:
    """(n, 8) int32 word tensor -> (n, 16) uint32 limbs on the host (the
    reference's device plane layout, transposed to batch-major)."""
    return u64_to_limbs(words_to_u64(w)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Plain arithmetic on limbs carried in int64
# ---------------------------------------------------------------------------

_MUL_ROWS = 1 << 18  # rows per pass of the plain product
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1


def _split(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 limbs < 2^16 (the words'
    bytes read as little-endian 16-bit halves)."""
    if w.stride(-1) != 1:
        w = w.contiguous()
    return w.view(torch.int16).to(torch.int64) & LIMB_MASK


def _join(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limbs < 2^16 -> (..., 8) int32 words (bit patterns;
    the narrowing cast keeps the low 16 bits)."""
    return limbs.to(torch.int16).contiguous().view(torch.int32)


def _wide(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 8) int64 limbs < 2^32."""
    return w.to(torch.int64) & WORD_MASK


@functools.lru_cache(maxsize=None)
def _bit_tables(k: int, device: str):
    """(arange(k), 2^arange(k), 2^(arange(k) + 1)) as int64 on `device`."""
    bit = torch.arange(k, dtype=torch.int64, device=device)
    pow2 = torch.ones_like(bit) << bit
    return bit, pow2, pow2 << 1


def _pass(t: torch.Tensor) -> torch.Tensor:
    """One local carry pass over (..., k) non-negative 16-bit-radix limbs:
    every limb keeps its low 16 bits and takes what the limb below hands
    up.  What the top limb hands up is dropped (arithmetic mod 2^(16k))."""
    return (t & LIMB_MASK) + torch.nn.functional.pad(t >> LIMB_BITS, (1, -1))


def _resolve(t: torch.Tensor, bits: int, carry_in: int = 0):
    """Propagate the carries of (..., k) limbs of radix 2^bits, each in
    [0, 2^(bits+1) - 2] (a sum of two reduced limbs, say): returns the
    (..., k) reduced limbs and the (...) carry out of the top limb (0 or 1).

    A limb then hands up at most 1, and only a limb equal to 2^bits - 1
    hands an incoming carry on, so the ripple is resolved for all limbs at
    once as one integer addition on the limbs' generate and propagate bits
    (k + 1 <= 62 bits in an int64).  `carry_in` (0 or 1) enters limb 0."""
    k = t.shape[-1]
    mask = (1 << bits) - 1
    bit, pow2, pow2x2 = _bit_tables(k, str(t.device))
    low = t & mask
    gen2 = ((t >> bits) * pow2x2).sum(-1)
    prop = ((low == mask) * pow2).sum(-1)
    cin = (gen2 + prop + carry_in) ^ prop  # bit i: a carry enters limb i
    return (low + ((cin[..., None] >> bit) & 1)) & mask, cin >> k


def _toeplitz(b: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> the (..., 32, 16) view U with U[k, j] = b[k+j-15]
    (0 outside b), so that column k of the product of a and b is
    sum_j a[15-j] * U[k, j] (``ModCtx._table``'s layout)."""
    padded = torch.nn.functional.pad(b, (NLIMB - 1, NLIMB + 1))
    return padded.unfold(-1, NLIMB, 1)[..., : 2 * NLIMB, :]


@functools.lru_cache(maxsize=None)
def _column_of(device: str) -> torch.Tensor:
    """(256,) int64: i + j for the products a[i] b[j], i-major."""
    i = torch.arange(NLIMB, dtype=torch.int64, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs a and b of one shape -> the (..., 32) column sums of
    the schoolbook product a * b (< 2^36 for limbs < 2^16; column 31 is 0):
    the 256 limb products, each added into column i + j."""
    prods = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (NLIMB * NLIMB,))
    out = torch.zeros(a.shape[:-1] + (2 * NLIMB,), dtype=torch.int64, device=a.device)
    return out.index_add_(out.dim() - 1, _column_of(str(a.device)), prods)


def _const_columns(a: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limbs a and a constant's (16, rows) float64 table
    (``ModCtx._table``) -> the (..., rows) int64 columns of a times the
    constant, as one matrix product: exact, since the callers keep every
    product and column sum far below 2^53."""
    return (a.to(torch.float64) @ table).to(torch.int64)


class ModCtx:
    """Montgomery constants for one odd modulus p < 2^256, and the plain
    PyTorch field ops on (..., 8) int32 word tensors (any device, leading
    dimensions broadcast).  `wide` is p >= 2^255 (P-256's and T-256's
    base fields): a sum of two elements, and REDC's result below 2p, may
    then carry out of 256 bits."""

    nword = NWORD  # int32 words per element

    def __init__(self, modulus: int):
        assert modulus % 2 == 1 and modulus.bit_length() <= 256
        self.modulus = modulus
        self.wide = modulus.bit_length() == 256
        self.R = 1 << 256
        self.r_mod_n = self.R % modulus  # Montgomery 1
        self.r2 = self.R * self.R % modulus
        self._consts: dict = {}

    def _limbs(self, name: str, device, bits: int = LIMB_BITS) -> torch.Tensor:
        """int64 limbs of radix 2^bits of a constant: 'p', 'ninv'
        (-p^-1 mod 2^256) or 'comp' (2^256 - p)."""
        key = (name, bits, str(device))
        if key not in self._consts:
            value = {"p": self.modulus,
                     "ninv": (-pow(self.modulus, -1, self.R)) % self.R,
                     "comp": self.R - self.modulus}[name]
            self._consts[key] = torch.tensor(
                [(value >> (bits * i)) & ((1 << bits) - 1) for i in range(256 // bits)],
                dtype=torch.int64, device=device)
        return self._consts[key]

    def _table(self, name: str, rows: int, device) -> torch.Tensor:
        """The (16, rows) float64 table of the constant c = `name` with
        entry [i, k] = c[k - i] (its 16-bit limbs, 0 outside), for
        ``_const_columns``; cached."""
        key = (name, "table", rows, str(device))
        if key not in self._consts:
            u = _toeplitz(self._limbs(name, device))[:rows].flip(-1)  # u[k, i] = c[k - i]
            self._consts[key] = u.T.to(torch.float64).contiguous()
        return self._consts[key]

    # -- host conversions ---------------------------------------------------
    def to_mont_host(self, xs) -> np.ndarray:
        """ints -> Montgomery-form (n, 16) uint32 limbs."""
        return ints_to_limbs([int(x) * self.R % self.modulus for x in xs])

    def from_mont_host(self, a) -> list[int]:
        rinv = pow(self.R, -1, self.modulus)
        return [v * rinv % self.modulus for v in limbs_to_ints(a)]

    def words(self, xs, device="cpu") -> torch.Tensor:
        """ints (standard form, as given) -> (n, 8) int32 word tensor."""
        return limbs_to_words(ints_to_limbs(xs), device)

    host_zero = 0
    host_one = 1

    def host_mul(self, a: int, b: int) -> int:
        return a * b % self.modulus

    def host_inv(self, a: int) -> int:
        return pow(a, -1, self.modulus)

    # -- plain device ops ---------------------------------------------------
    def _cond_sub(self, x: torch.Tensor, bits: int, top: torch.Tensor) -> torch.Tensor:
        """Reduced limbs x of radix 2^bits and the bit `top` above them (a
        (...) int64 tensor of 0 and 1, always 0 for p < 2^255), value X =
        x + top 2^256 < 2p -> the limbs of X mod p (the reference's
        ``_cond_sub_top``): X - p where x - p does not borrow or top covers
        the borrow."""
        d, ge_p = _resolve(x + self._limbs("comp", x.device, bits), bits)  # x - p + 2^256
        return torch.where((ge_p | top)[..., None] != 0, d, x)

    def mont_mul(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x * y * 2^-256 mod p (REDC; the same value as
        pallas_ec._F.mont_mul)."""
        a = _split(x)
        b = a if y is x else _split(y)
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        rows = a.shape[:-1].numel()
        if rows > _MUL_ROWS:
            # bound the (rows, 32, 16) int64 product: 4 KiB per row
            shape = a.shape[:-1]
            a, b = a.reshape(rows, NLIMB), b.reshape(rows, NLIMB)
            out = torch.cat([
                self._mont_mul_limbs(a[i : i + _MUL_ROWS], b[i : i + _MUL_ROWS])
                for i in range(0, rows, _MUL_ROWS)])
            return out.reshape(shape + (NWORD,))
        return self._mont_mul_limbs(a, b)

    def _mont_mul_limbs(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """mont_mul on (..., 16) int64 limbs of one shape -> words."""
        dev = a.device
        t = _product_columns(a, b)  # 32 columns < 2^36, carries not propagated
        # m = (t mod 2^256) * (-p^-1) mod 2^256 from t's low half carried to
        # limbs < 2^16 + 2^5 (what its top limb hands up is dropped: mod
        # 2^256), so that the columns stay below 2^37.  Three passes leave
        # limbs < 2^16 + 2 (not reduced: m stands for a value below
        # 1.01 * 2^256 that is right mod 2^256, which is what makes the low
        # half of t + m*p cancel)
        tl = _pass(_pass(t[..., :NLIMB]))
        m = _pass(_pass(_pass(_const_columns(tl, self._table("ninv", NLIMB, dev)))))
        if self.wide:
            # m < 2^256 exactly, so that the result below stays under 2p
            m, _ = _resolve(m, LIMB_BITS)
        u = t + _const_columns(m, self._table("p", 2 * NLIMB, dev))  # columns < 2^38
        # two passes leave limbs < 2^16 + 2^7; the low 16 limbs cancel and
        # the high 16 are (t + m*p) / 2^256 < p * (p / 2^256 + 1.01) < 2p
        # for p < 2^255, < p * (p / 2^256 + 1) < 2p with m reduced; limb 32
        # takes the carry out of 2^512 that a value above 2^256 leaves
        x, _ = _resolve(_pass(_pass(torch.nn.functional.pad(u, (0, 1)))), LIMB_BITS)
        return _join(self._cond_sub(x[..., NLIMB:2 * NLIMB], LIMB_BITS, x[..., 2 * NLIMB]))

    def add_mod(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        s, top = _resolve(_wide(x) + _wide(y), WORD_BITS)
        return self._cond_sub(s, WORD_BITS, top).to(torch.int32)

    def sub_mod(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # x - y + 2^256 as x + ~y + 1; no carry out means it borrowed
        d, no_borrow = _resolve(_wide(x) + (WORD_MASK - _wide(y)), WORD_BITS, carry_in=1)
        plus, _ = _resolve(d + self._limbs("p", d.device, WORD_BITS), WORD_BITS)
        return torch.where(no_borrow[..., None] != 0, d, plus).to(torch.int32)

    def mont_sqr(self, x: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(x, x)

    def neg_mod(self, x: torch.Tensor) -> torch.Tensor:
        """0 - x (0 stays 0)."""
        return self.sub_mod(torch.zeros_like(x), x)

    def const_words(self, value: int, device) -> torch.Tensor:
        """The (1, 8) word row of `value` (as given) on `device`, cached."""
        key = (value, str(device))
        if key not in self._consts:
            self._consts[key] = self.words([value], device)
        return self._consts[key]

    def one_mont(self, device) -> torch.Tensor:
        """Montgomery 1 as a (1, 8) row."""
        return self.const_words(self.r_mod_n, device)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Standard form -> Montgomery form: a product by R^2."""
        return self.mont_mul(x, self.const_words(self.r2, x.device))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> standard form: a product by 1."""
        return self.mont_mul(x, self.const_words(1, x.device))

    @staticmethod
    def is_zero(x: torch.Tensor) -> torch.Tensor:
        """(..., 8) -> (...) bool."""
        return (x == 0).all(dim=-1)

    @staticmethod
    def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per element: mask (...) nonzero ? a : b."""
        return torch.where(mask.to(torch.bool)[..., None], a, b)

    def inv_mod(self, x: torch.Tensor) -> torch.Tensor:
        """x^(p-2) by square-and-multiply over the 256 exponent bits, MSB
        first (the chain of the reference's ``_inv_core``); 0 -> 0.  The
        product for a zero bit is skipped: it would be discarded."""
        e = self.modulus - 2
        acc = self.one_mont(x.device).expand_as(x)
        for i in range(255, -1, -1):
            acc = self.mont_sqr(acc)
            if (e >> i) & 1:
                acc = self.mont_mul(acc, x)
        return acc


@functools.lru_cache(maxsize=None)
def get_ctx(modulus: int) -> ModCtx:
    return ModCtx(modulus)
