"""The port's ``batch_inv`` (crescent_tpu_torch/ops/cuda_ec.py,
csrc/batch_inv.cuh) on the CPU over BN254 Fq and Fq2, bit for bit
(tolerance 0):

* ``batch_inv_plain``, the product tree that a CPU tensor takes, against
  the reference's ``crescent_tpu.ops.msm_affine.batch_inv`` over its XLA
  adapter (``mul`` and ``inv`` each jitted once at one lane count, inputs
  padded with zeros and results cut back: lane-wise ops, so the values are
  the adapter's own, as tests/test_torch_msm.py runs it);
* a replay in plain PyTorch of the CUDA kernel's grouping against that
  tree: one run of S = 2^k leaves a root, T = min(threads, S) threads a
  run, thread t walking the leaves t + j T with a running product and
  exclusive prefixes, the heap tree of the T products up, thread 0's
  inversion of the root, the tree down (each parent writing both
  children), the walk back.  T is the kernel's own (``kBatchInvThreads``,
  read out of the source) and 4 (several leaves a thread at these sizes).

Sizes are members of the quarter-power family the MSM's rounds quantize to
(n = 2^k (4 + i) / 4) at a floor of 16, so the root level R takes 10, 12,
14 and 16 lanes (the prove path's 320, 384, 448 and 512 in miniature), and
n <= inv_floor (R = n).  The reference runs one deep tree and shallow
ones (its eager ops compile anew for every shape, about 0.3 s a level).
Every input has a zero planted in one run, which must zero exactly that
run, and 1, p - 1 and Montgomery 1 among the leaves.
"""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from crescent_tpu.ops import msm_affine as ref_affine
from crescent_tpu.ops.xla_pec import QuadXlaPEC, XlaPEC
from crescent_tpu_torch.core import fields
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops import msm_affine as port_affine
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec, tree_halvings

P = fields.BN254_FQ
FLOOR = 16
# (n, leaf of the planted zero): R = n / S roots of S leaves
SIZES = [(320, 40),   # R = 10, S = 32
         (192, 5),    # R = 12, S = 16
         (112, 111),  # R = 14, S = 8
         (256, 128),  # R = 16, S = 16
         (12, 7),     # n <= inv_floor: R = n, S = 1
         (16, 0)]
# the reference's: a deep tree and R = 12, 14, 16 one level deep
REF_SIZES = [(320, 40), (24, 5), (28, 27), (32, 16), (12, 7)]
LANES = max(n for n, _ in SIZES + REF_SIZES)
BATCH_INV_CUH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "crescent_tpu_torch", "csrc", "batch_inv.cuh")


def _kernel_threads() -> int:
    with open(BATCH_INV_CUH) as f:
        m = re.search(r"constexpr int kBatchInvThreads = (\d+);", f.read())
    assert m, "batch_inv.cuh declares no kBatchInvThreads"
    return int(m.group(1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Padded:
    """The reference's XLA adapter with ``mul`` at LANES and ``inv`` at
    FLOOR lanes, each jitted once.  Planes come and go as numpy arrays, so
    the tree's strided slices and the padding are numpy's and only its
    concatenations and stacks are eager XLA ops (each compiles anew for
    every shape)."""

    def __init__(self, pec):
        self._mul = jax.jit(pec.mul)
        self._inv = jax.jit(pec.inv)

    @staticmethod
    def _pad(a, lanes):
        a = np.asarray(a)
        return np.pad(a, ((0, 0), (0, lanes - a.shape[1])))

    def mul(self, x, y):
        n = x.shape[1]
        return np.asarray(self._mul(self._pad(x, LANES), self._pad(y, LANES)))[:, :n]

    def inv(self, x):
        n = x.shape[1]
        return np.asarray(self._inv(self._pad(x, FLOOR)))[:, :n]


@pytest.fixture(scope="module")
def fq():
    return get_cuda_ec(P), _Padded(XlaPEC(P, 0))


@pytest.fixture(scope="module")
def fq2():
    return get_cuda_quad_ec(P), _Padded(QuadXlaPEC(P))


def _leaves(ec, n: int, zero: int, seed: int) -> torch.Tensor:
    """n seeded canonical leaves of ec's field with a zero at `zero` and 1,
    p - 1 and Montgomery 1 (over Fq2 also u) beside it."""
    rng = np.random.default_rng(seed)
    vals = [sum(int(v) << (64 * i) for i, v in enumerate(r)) % P
            for r in rng.integers(1, 1 << 62, size=(2 * n, 4))]
    one_m = (1 << 256) % P
    if ec.WIDTH == 8:
        xs = vals[:n]
        edges = [0, 1, P - 1, one_m]
    else:
        xs = [Fq2(a, b) for a, b in zip(vals[:n], vals[n:])]
        edges = [Fq2(0, 0), Fq2(1, 0), Fq2(P - 1, 0), Fq2(one_m, 0), Fq2(0, 1)]
    for k, e in enumerate(edges):
        xs[(zero + k) % n] = e
    return ec.ctx.words(xs)


def _to_ref(t: torch.Tensor) -> np.ndarray:
    """(N, 8) or (N, 16) words -> the reference's (16, N) or (32, N) limb
    plane."""
    return limb.words_to_limbs(t.reshape(-1, 8)).reshape(t.shape[0], -1).T.copy()


def _from_ref(a, width: int) -> torch.Tensor:
    a = np.asarray(jax.device_get(a)).T.reshape(-1, 16)
    return limb.limbs_to_words(a).reshape(-1, width)


def _ec(field: str):
    return get_cuda_ec(P) if field == "fq" else get_cuda_quad_ec(P)


@functools.lru_cache(maxsize=None)
def _tree(field: str, n: int, zero: int):
    """Seeded leaves of `field` and their plain product tree."""
    ec = _ec(field)
    d = _leaves(ec, n, zero, seed=n + ec.WIDTH)
    return d, ec.batch_inv_plain(d, FLOOR)


_INVERSES: dict = {}


def _inv_plain_memo(ec, x: torch.Tensor) -> torch.Tensor:
    """ec.inv_plain (a 256-step Fermat chain, about 0.16 s on a CPU), memoized
    by value: the replays of one size at any T share their roots."""
    key = (ec.WIDTH, x.numpy().tobytes())
    if key not in _INVERSES:
        _INVERSES[key] = ec.inv_plain(x)
    return _INVERSES[key]


def replay(ec, d: torch.Tensor, inv_floor: int, threads: int) -> torch.Tensor:
    """The CUDA kernel's grouping in plain PyTorch, every run and thread at
    once."""
    f = ec.ctx
    n, w = d.shape
    S = 1 << tree_halvings(n, inv_floor)
    R, T = n // S, min(threads, S)
    steps = S // T
    leaves = d.reshape(R, steps, T, w)  # leaf b S + j T + t
    # 1. running products; out[j] holds the exclusive prefix for j >= 1
    out = torch.empty_like(leaves)
    acc = leaves[:, 0]
    for j in range(1, steps):
        out[:, j] = acc
        acc = f.mont_mul(acc, leaves[:, j])
    # 2. the heap tree: node 1 the root, thread t's product at T + t
    tree = torch.zeros((R, 2 * T, w), dtype=d.dtype)
    tree[:, T:] = acc
    h = T // 2
    while h >= 1:
        tree[:, h:2 * h] = f.mont_mul(tree[:, 2 * h:4 * h:2], tree[:, 2 * h + 1:4 * h:2])
        h //= 2
    # 3. thread 0 inverts the root
    tree[:, 1] = _inv_plain_memo(ec, tree[:, 1].contiguous())
    # 4. down: parents p in [h, 2h) hold their inverses; 1/left = 1/p * right
    h = 1
    while h < T:
        p = torch.arange(h, 2 * h)
        left, right = tree[:, 2 * p], tree[:, 2 * p + 1]
        tree[:, 2 * p] = f.mont_mul(tree[:, p], right)
        tree[:, 2 * p + 1] = f.mont_mul(tree[:, p], left)
        h *= 2
    # 5. the walk back
    acc = tree[:, T:]
    for j in range(steps - 1, 0, -1):
        out[:, j] = f.mont_mul(acc, out[:, j])
        acc = f.mont_mul(acc, leaves[:, j])
    out[:, 0] = acc
    return out.reshape(n, w)


def _check_zeroed_run(ec, d, got, zero: int, inv_floor: int) -> None:
    """The planted zero's run is all zeros, every other leaf's inverse is
    exact."""
    S = 1 << tree_halvings(d.shape[0], inv_floor)
    run = torch.zeros(d.shape[0], dtype=torch.bool)
    run[zero // S * S:(zero // S + 1) * S] = True
    assert not got[run].any()
    one = ec.ctx.one_mont("cpu").expand(int((~run).sum()), -1)
    assert torch.equal(ec.ctx.mont_mul(d[~run], got[~run]), one)


@pytest.mark.parametrize("field", ["fq", "fq2"])
@pytest.mark.parametrize("n,zero", REF_SIZES)
def test_batch_inv_plain_matches_reference(request, field, n, zero):
    ec, ref = request.getfixturevalue(field)
    d, got = _tree(field, n, zero)
    want = _from_ref(ref_affine.batch_inv(ref, _to_ref(d), FLOOR), ec.WIDTH)
    assert torch.equal(got, want)
    _check_zeroed_run(ec, d, got, zero, FLOOR)


@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_batch_inv_op_takes_the_tree_on_cpu(field):
    """The op and the MSM's entry point take the plain tree on a CPU
    tensor."""
    ec = _ec(field)
    d, want = _tree(field, *SIZES[0])
    assert torch.equal(ec.batch_inv(d, FLOOR), want)
    assert torch.equal(port_affine.batch_inv(ec, d, FLOOR), want)


@pytest.mark.parametrize("field", ["fq", "fq2"])
@pytest.mark.parametrize("threads", [_kernel_threads(), 4])
@pytest.mark.parametrize("n,zero", SIZES)
def test_kernel_grouping_replay_matches_tree(field, threads, n, zero):
    ec = _ec(field)
    d, want = _tree(field, n, zero)
    assert torch.equal(replay(ec, d, FLOOR, threads), want)
    _check_zeroed_run(ec, d, want, zero, FLOOR)


def test_batch_inv_needs_even_levels():
    ec = get_cuda_ec(P)
    d = _leaves(ec, 20, 0, seed=3)  # 20 -> 10 -> 5, still above 4
    assert tree_halvings(20, 5) == 2 and tree_halvings(20, 20) == 0
    for call in (ec.batch_inv, ec.batch_inv_plain):
        with pytest.raises(ValueError):
            call(d, 4)
