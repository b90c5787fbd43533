"""Dense univariate polynomial arithmetic over a prime field (host, exact).

Backs the KZG range proof (creds/src/rangeproof.rs) whose polynomials are
tiny (degree <= 4*32), so host Python is the right place; the NTT kernels
take over for QAP-scale polynomials.  Coefficients are little-endian lists
of ints (coeffs[i] is the x^i coefficient); the zero polynomial is [].
"""

from __future__ import annotations

import random


def trim(p: list[int]) -> list[int]:
    while p and p[-1] == 0:
        p.pop()
    return p


def add(p: list[int], q: list[int], m: int) -> list[int]:
    n = max(len(p), len(q))
    return trim([((p[i] if i < len(p) else 0) + (q[i] if i < len(q) else 0)) % m for i in range(n)])


def sub(p: list[int], q: list[int], m: int) -> list[int]:
    n = max(len(p), len(q))
    return trim([((p[i] if i < len(p) else 0) - (q[i] if i < len(q) else 0)) % m for i in range(n)])


def scale(p: list[int], k: int, m: int) -> list[int]:
    return trim([c * k % m for c in p])


def mul(p: list[int], q: list[int], m: int) -> list[int]:
    if not p or not q:
        return []
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a == 0:
            continue
        for j, b in enumerate(q):
            out[i + j] = (out[i + j] + a * b) % m
    return trim(out)


def evaluate(p: list[int], x: int, m: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % m
    return acc


def divmod_poly(p: list[int], d: list[int], m: int) -> tuple[list[int], list[int]]:
    """Standard long division; d must be nonzero."""
    d = trim(list(d))
    assert d, "division by zero polynomial"
    r = list(p)
    q = [0] * max(0, len(r) - len(d) + 1)
    dlead_inv = pow(d[-1], -1, m)
    while len(trim(r)) >= len(d):
        r = trim(r)
        shift = len(r) - len(d)
        coeff = r[-1] * dlead_inv % m
        q[shift] = coeff
        for i, dc in enumerate(d):
            r[shift + i] = (r[shift + i] - coeff * dc) % m
    return trim(q), trim(r)


def div_by_linear(p: list[int], a: int, m: int) -> tuple[list[int], int]:
    """p(X) / (X - a) via synthetic division; returns (quotient, remainder)."""
    if not p:
        return [], 0
    n = len(p)
    q = [0] * (n - 1)
    if n > 1:
        q[n - 2] = p[n - 1] % m
        for i in range(n - 2, 0, -1):
            q[i - 1] = (p[i] + a * q[i]) % m
    rem = (p[0] + a * q[0]) % m if n > 1 else p[0] % m
    return trim(q), rem


def div_by_vanishing(p: list[int], n: int, m: int) -> tuple[list[int], list[int]]:
    """p(X) / (X^n - 1): fold coefficients (X^n ≡ 1 + (X^n - 1))."""
    r = list(p)
    q = [0] * max(0, len(r) - n)
    for i in range(len(r) - 1, n - 1, -1):
        c = r[i] % m
        if c:
            q[i - n] = (q[i - n] + c) % m
            r[i - n] = (r[i - n] + c) % m
        r[i] = 0
    return trim(q), trim(r)


def mul_by_vanishing(p: list[int], n: int, m: int) -> list[int]:
    """p(X) * (X^n - 1)."""
    out = [0] * (len(p) + n)
    for i, c in enumerate(p):
        out[i + n] = c % m
        out[i] = (out[i] - c) % m
    return trim(out)


def rand_poly(degree: int, m: int, rng: random.Random) -> list[int]:
    p = [rng.randrange(m) for _ in range(degree + 1)]
    if p[-1] == 0:
        p[-1] = 1
    return p
