"""The schedule of the fused bucket aggregate (crescent_tpu_torch/csrc/
bucket.cuh `bucket_reduce_kernel`), modelled in Python: a window on a
cluster of K blocks, block r holding rows r S .. r S + S - 1 (S =
ceil(B / K)) of two ping-pong tables in shared memory and a zero row
after them; each block copies its rows of the input into table 0, then
the suffix levels each block on its own rows; the weight tree
an even share of each level a block; the sum read from row `off` of
the last table by the block that holds it.  The model checks that each
level adds each of its pairs once, that every row read was written by the
level before (the copy of the input before the first, or it is the zero
row past the window), and that the pairs are
bucket_levels' (the unfused aggregate's, which the plain version is),
in the same order: both run on one symbolic addition that names each
(left, right) pair, so equal names mean equal expression trees and, the
additions being bit-equal to `jadd_plain`, bit-equal sums.  The launch
constants (cluster size, threads, executor switch-overs) are read
out of the source; the design alternatives' cluster sizes too.
No card needed; a few seconds.
"""

import os
import re

import pytest
import torch

from crescent_tpu_torch.core.fields import BN254_FQ
from crescent_tpu_torch.ops.cuda_ec import bucket_levels, get_cuda_ec, get_cuda_quad_ec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "crescent_tpu_torch", "csrc")
FIELDS = {"Fe": 2, "Fe2": 4}  # field type -> 16-byte vectors a row
SMS = 132                     # the H100's SMs
C = 11                        # prove's window width: W = 25 windows of B = 1025
W_PATH, B_PATH = (256 + C - 1) // C + 1, (1 << (C - 1)) + 1


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def constant(name: str, field: str) -> int:
    """A `template <class F> constexpr int` of bucket.cuh or warp.cuh at
    field type `field` (its specialisation where there is one)."""
    src = _source("bucket.cuh") + _source("warp.cuh")
    m = (re.search(rf"constexpr (?:int|long long) {name}<{field}> = (\d+)()();", src)
         or re.search(rf"constexpr (?:int|long long) {name} = (\d+)( \* (\d+))?;", src))
    return int(m.group(1)) * int(m.group(3) or 1)


def schedule(B: int, K: int):
    """The kernel's levels (bucket.cuh `bucket_level_at` for l below
    `bucket_levels_of`), each (src, dst, pofs, qofs, qlimit, shares: (lo, hi)
    a block), the last table and the sum's row."""
    S, nsuf = -(-B // K), (B - 1).bit_length()
    levels = []
    for l in range(2 * nsuf - 1):
        src = l & 1
        if l < nsuf:  # the suffix sums: each block its own rows
            shares = [(min(B, r * S), min(B, min(B, r * S) + S)) for r in range(K)]
            levels.append((src, src ^ 1, 0, 1 << l, B, shares))
        else:  # the weight tree: an even share of each level a block
            h = (B - 1) >> (l - nsuf + 1)
            q = -(-h // K)
            pofs = 1 if l == nsuf else 0
            shares = [(min(h, r * q), min(h, min(h, r * q) + q)) for r in range(K)]
            levels.append((src, src ^ 1, pofs, pofs + h, None, shares))
    return levels, len(levels) & 1, 1 if B == 2 else 0


def run_window(inputs: list, B: int, K: int, add) -> int:
    """One window's sum on the modelled cluster, `add` naming each pair."""
    S = -(-B // K)
    tables = [[[None] * S for _ in range(2)] for _ in range(K)]
    written = {}  # (table, row) -> the level that wrote it
    for r in range(K):  # each block copies its rows of the input into table 0
        for row in range(min(B, r * S + S) - min(B, r * S)):
            tables[r][0][row] = inputs[r * S + row]
            written[(0, r * S + row)] = -1
    levels, last, off = schedule(B, K)

    def read(level: int, t: int, c: int):
        assert written.get((t, c)) == level - 1, (level, t, c)
        r, row = divmod(c, S)
        assert r < K, (c, S)
        return tables[r][t][row]

    for li, (src, dst, pofs, qofs, qlimit, shares) in enumerate(levels):
        done = []
        for lo, hi in shares:
            for i in range(lo, hi):
                p = read(li, src, pofs + i)
                q = read(li, src, qofs + i) if qlimit is None or qofs + i < qlimit else 0
                r, row = divmod(i, S)
                tables[r][dst][row] = add(p, q)
                written[(dst, i)] = li
                done.append(i)
        lanes = B if qlimit is not None else qofs - pofs
        assert sorted(done) == list(range(lanes)), li  # each pair once
    r, row = divmod(off, S)
    assert written.get((last, off)) == len(levels) - 1
    return tables[r][last][row]


def naming_add(names: dict):
    """An addition that names each (left, right) pair: the same name for the
    same expression tree."""
    def add(p: int, q: int) -> int:
        return names.setdefault((p, q), 1 << 40 | len(names))
    return add


def levels_names(W: int, B: int, add) -> list:
    """bucket_levels over the naming addition: each window's sum's name."""
    def jadd(x1, y1, z1, x2, y2, z2):
        t = torch.tensor([add(p, q) for p, q in zip(x1[:, 0].tolist(), x2[:, 0].tolist())],
                         dtype=torch.int64)[:, None]
        return t, t, t

    ids = torch.arange(1, W * B + 1, dtype=torch.int64)[:, None]
    return bucket_levels(jadd, ids, ids, ids, W, B)[0][:, 0].tolist()


def _check(W: int, B: int, K: int) -> None:
    names: dict = {}
    add = naming_add(names)
    want = levels_names(W, B, add)
    got = [run_window(list(range(w * B + 1, (w + 1) * B + 1)), B, K, add)
           for w in range(W)]
    assert got == want, (W, B, K)


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("W, B", [(1, 2), (3, 3), (2, 5), (3, 17), (1, 65), (3, B_PATH)])
def test_bucket_schedule_matches_levels(field, W, B):
    """The kept design (the source's cluster size) adds bucket_levels'
    pairs, at prove's B = 1025 and at a few buckets."""
    _check(W, B, constant("kBucketCluster", field))


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("W, B", [(1, 3), (2, 17), (3, 65), (1, B_PATH)])
def test_bucket_schedule_designs_match_levels(K, W, B):
    """The other cluster sizes scripts/chain_designs.py times add the same
    pairs; B = 1025 and a few buckets."""
    _check(W, B, K)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_bucket_launch_shape(field):
    """At prove's 25 windows of 1025 buckets the kept launch takes one
    cluster a window in one wave of one block an SM, its two tables in the
    shared memory the kernel asks for, and every executor has at least one
    lane a pass; over Fq2 every share runs on product threads (the four-warp
    groups spill in this kernel)."""
    K, T = constant("kBucketCluster", field), constant("kBucketThreads", field)
    S = -(-B_PATH // K)
    smem = 6 * (S + 1) * FIELDS[field] * 16
    assert smem <= constant("kBucketSmemMax", field) <= 227 * 1024 - 2048
    assert 1 <= K <= 8 and W_PATH * K <= SMS
    assert T % constant("kJaddProductThreads", field) == 0
    assert T % 32 == 0 and T <= 1024
    groups = constant("kBucketGroupLanesMax", field)
    assert groups < S and (field == "Fe" or groups == 0)
    if groups:  # a warp a lane, two passes of the block's warps at most
        assert constant("kJaddGroupThreads", field) == 32 and groups <= 2 * T // 32


def _ec(field: str):
    return get_cuda_ec(BN254_FQ) if field == "Fe" else get_cuda_quad_ec(BN254_FQ)


def _fits(B: int, field: str) -> bool:
    """The kept launch's two tables of a window of B rows fit a block's
    shared memory."""
    S = -(-B // constant("kBucketCluster", field))
    return 6 * (S + 1) * FIELDS[field] * 16 <= constant("kBucketSmemMax", field)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_bucket_b_max_is_the_sources(field):
    """The wrapper's BUCKET_B_MAX is the largest B (B - 1 a power of two)
    whose tables fit the kept launch's shared memory: 4,097 over Fq,
    2,049 over Fq2."""
    b_max = _ec(field).BUCKET_B_MAX
    assert (b_max - 1) & (b_max - 2) == 0
    assert _fits(b_max, field) and not _fits(2 * b_max - 1, field)
    assert b_max == {"Fe": 4097, "Fe2": 2049}[field]


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_bucket_reduce_rejects_b_past_its_max(field):
    """Past BUCKET_B_MAX the wrapper raises a ValueError that names the
    limit, on the CPU as on the card."""
    ec = _ec(field)
    B = 2 * ec.BUCKET_B_MAX - 1
    t = torch.zeros((B, ec.WIDTH), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most B = {ec.BUCKET_B_MAX}"):
        ec.bucket_reduce(t, t, t, 1, B)
