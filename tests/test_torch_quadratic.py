"""The port's Fq2 layer (crescent_tpu_torch/ops/quadratic.py) and the plain
versions of its Fq2 kernels (crescent_tpu_torch/ops/cuda_ec.py CudaQuadEC:
mul, inv, madd) against the reference's QuadCtx and its XLA adapter
QuadXlaPEC, which runs the Pallas kernels' formula bodies over `_F2`.  (The
CUDA kernels against the plain versions: tests/test_torch_cuda.py and
chip_smoke.py.)

Layouts: the reference's QuadCtx takes (n, 2, 16) u32 Montgomery limbs, its
adapter (32, N) limb-major planes; the port (N, 16) int32 word rows, the
same bytes.  The same seeded values go through both; comparisons are exact
(tolerance 0), with the edge values 0, 1, p-1 and u planted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crescent_tpu.ops.quadratic import get_fq2_ctx as ref_fq2_ctx
from crescent_tpu.ops.xla_pec import get_quad_xla_pec
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops.cuda_ec import get_cuda_quad_ec
from crescent_tpu_torch.ops.quadratic import get_fq2_ctx

N = 20
EDGES = [Fq2(0, 0), Fq2(1, 0), Fq2(P - 1, 0), Fq2(0, 1)]  # 0, 1, p-1, u


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(seed: int, n: int = N) -> list[Fq2]:
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 2, 8), dtype=np.uint64)
    ints = [[int("".join(f"{int(x):08x}" for x in c), 16) % P for c in r] for r in w]
    return [Fq2(a, b) for a, b in ints]


def _operands(seed: int, first: bool) -> list[Fq2]:
    """Seeded values with every pair of the edges in rows 0..15: edge i // 4
    as the first operand, i % 4 as the second."""
    vals = _seeded(seed)
    vals[:16] = [EDGES[i // 4] if first else EDGES[i % 4] for i in range(16)]
    return vals


def _mont(vals) -> np.ndarray:
    """Fq2 values -> (n, 2, 16) Montgomery limbs (the reference's layout)."""
    return get_fq2_ctx().to_mont_host(vals)


def _words(a: np.ndarray) -> torch.Tensor:
    """(n, 2, 16) limbs -> (n, 16) int32 words."""
    return limb.limbs_to_words(a.reshape(-1, 16)).reshape(a.shape[0], 16)


def _limbs(w: torch.Tensor) -> np.ndarray:
    """(n, 16) words -> (n, 2, 16) limbs."""
    return limb.words_to_limbs(w.reshape(-1, 8)).reshape(-1, 2, 16)


def _plane(a: np.ndarray):
    """(n, 2, 16) limbs -> the adapter's (32, n) plane."""
    return jnp.asarray(a.reshape(a.shape[0], 32).T.copy())


def _from_plane(x) -> np.ndarray:
    return np.asarray(jax.device_get(x)).T.reshape(-1, 2, 16)


def test_host_conversions_and_host_ops_match_reference():
    ctx, ref = get_fq2_ctx(), ref_fq2_ctx()
    vals = _operands(1, True)
    a = ctx.to_mont_host(vals)
    np.testing.assert_array_equal(a, ref.to_mont_host(vals))
    assert ctx.from_mont_host(a) == vals
    assert ctx.from_mont_host(a.reshape(-1, 32)) == vals
    assert ctx.from_mont_host(_limbs(_words(a))) == vals
    np.testing.assert_array_equal(limb.words_to_limbs(ctx.one_mont("cpu").reshape(2, 8)),
                                  np.asarray(ref.one_mont))
    x, y = _seeded(2, 2)
    assert ctx.host_mul(x, y) == ref.host_mul(x, y) == x * y
    assert ctx.host_mul(ctx.host_inv(x), x) == ctx.host_one
    w = ctx.words([x, EDGES[3]])
    assert limb.limbs_to_ints(limb.words_to_limbs(w.reshape(-1, 8))) == [x.c0, x.c1, 0, 1]


@pytest.mark.parametrize("op", ["mont_mul", "mont_sqr", "add_mod", "sub_mod", "neg_mod"])
def test_quadctx_ops_match_reference(op):
    ctx, ref = get_fq2_ctx(), ref_fq2_ctx()
    x, y = _mont(_operands(3, True)), _mont(_operands(4, False))
    unary = op in ("mont_sqr", "neg_mod")
    args = (x,) if unary else (x, y)
    got = getattr(ctx, op)(*(_words(a) for a in args))
    want = np.asarray(jax.device_get(getattr(ref, op)(*(jnp.asarray(a) for a in args))))
    np.testing.assert_array_equal(_limbs(got), want)
    # and the host field
    xs, ys = ctx.from_mont_host(x), ctx.from_mont_host(y)
    host = {"mont_mul": lambda a, b: a * b, "mont_sqr": lambda a: a.square(),
            "add_mod": lambda a, b: a + b, "sub_mod": lambda a, b: a - b,
            "neg_mod": lambda a: -a}[op]
    expect = [host(a) for a in xs] if unary else [host(a, b) for a, b in zip(xs, ys)]
    assert ctx.from_mont_host(_limbs(got)) == expect


def test_quadctx_broadcast_select_and_is_zero():
    ctx = get_fq2_ctx()
    x = _words(_mont(_operands(5, True)))
    row = x[7:8]
    np.testing.assert_array_equal(ctx.mont_mul(x, row), ctx.mont_mul(x, row.expand_as(x)))
    z = ctx.is_zero(x)
    assert z.dtype == torch.bool and z[:4].all() and not z[4:].any()
    mask = torch.arange(N) % 2
    sel = ctx.select(mask, x, ctx.neg_mod(x))
    assert torch.equal(sel[1::2], x[1::2]) and torch.equal(sel[0::2], ctx.neg_mod(x)[0::2])


def test_plain_fq2_mul_and_inv_match_reference():
    ec = get_cuda_quad_ec(P)
    pec = get_quad_xla_pec(P)
    x, y = _mont(_operands(6, True)), _mont(_operands(7, False))
    got = ec.mul(_words(x), _words(y))
    np.testing.assert_array_equal(_limbs(got), _from_plane(pec.mul(_plane(x), _plane(y))))
    out = torch.zeros((2 * N, 16), dtype=torch.int32)
    ec.mul(_words(x), _words(y), out=out[0::2])  # strided rows, as batch_inv writes
    assert torch.equal(out[0::2], got) and not out[1::2].any()
    got = ec.inv(_words(x))
    np.testing.assert_array_equal(_limbs(got), _from_plane(pec.inv(_plane(x))))
    ctx = get_fq2_ctx()
    vals = ctx.from_mont_host(x)
    zero = Fq2(0, 0)
    assert ctx.from_mont_host(_limbs(got)) == [zero if v == zero else v.inv() for v in vals]
    assert (vals[0], vals[4], vals[12]) == (EDGES[0], EDGES[1], EDGES[3])
    assert ec.launches() == {"mul": 0, "inv": 0, "madd": 0}  # CPU: no kernel


def _madd_inputs(seed: int):
    """Jacobian P (seeded) and affine Q with the cases planted: P == Q,
    P == -Q, P the identity, valid == 0, and with sign == 1: -Q == P (the
    doubling), -Q == -P (the identity) and a generic lane."""
    px, py, pz, qx, qy = (_seeded(seed + k) for k in range(5))
    for i, neg in ((1, False), (2, True), (5, True), (6, False)):
        z2 = pz[i] * pz[i]
        px[i] = qx[i] * z2
        py[i] = qy[i] * z2 * pz[i]
        if neg:
            py[i] = -py[i]
    pz[3] = Fq2(0, 0)
    valid = np.ones(N, np.int32)
    valid[4] = 0
    sign = np.zeros(N, np.int32)
    sign[5:8] = 1
    return [_mont(v) for v in (px, py, pz, qx, qy)], valid, sign


def test_plain_fq2_madd_matches_reference():
    ec = get_cuda_quad_ec(P)
    pec = get_quad_xla_pec(P)
    planes, valid, sign = _madd_inputs(8)
    got = ec.madd(*(_words(a) for a in planes), torch.from_numpy(valid),
                  torch.from_numpy(sign))
    want = pec.madd(*(_plane(a) for a in planes), jnp.asarray(valid.astype(np.uint32)),
                    jnp.asarray(sign.astype(np.uint32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_limbs(g), _from_plane(w))
    ctx = get_fq2_ctx()
    z = ctx.from_mont_host(_limbs(got[2]))
    assert z[2] == z[6] == Fq2(0, 0) and all(z[i] != Fq2(0, 0) for i in (0, 1, 3, 5, 7))
    assert torch.equal(got[0][4], _words(planes[0])[4])   # valid == 0: P
    assert ctx.from_mont_host(_limbs(got[2][3:4])) == [Fq2(1, 0)]  # identity + Q: Z = 1
