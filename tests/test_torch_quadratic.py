"""The port's Fq2 layer (crescent_tpu_torch/ops/quadratic.py) and the plain
versions of its Fq2 kernels (crescent_tpu_torch/ops/cuda_ec.py CudaQuadEC:
mul, inv, butterfly, madd, affine_denom, affine_add, jadd, jdbl_n, jdbl)
against the reference's QuadCtx and its XLA adapter QuadXlaPEC, which runs
the Pallas kernels' formula bodies over `_F2`.  (bucket_reduce over Fq2:
tests/test_torch_msm.py, against the reference's unfused aggregate; its
Pallas kernel over `_F2` takes over ten minutes to compile in interpret
mode.)  (The CUDA kernels against the plain
versions: tests/test_torch_cuda.py and chip_smoke.py.)

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
from crescent_tpu_torch.core.curves import BN254G2 as G2
from crescent_tpu_torch.core.fields import BN254_FQ as P
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops.cuda_ec import QUAD_KERNELS, get_cuda_quad_ec
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
    assert ec.launches() == dict.fromkeys(QUAD_KERNELS, 0)  # CPU: no kernel


def test_plain_fq2_butterfly_matches_reference():
    """(a + b*tw, a - b*tw) over Fq2 against QuadXlaPEC.butterfly (the
    `_bfly_kernel` body over `_F2`): rows 0..15 of b and tw hold every pair
    of 0, 1, p-1 and u, and a those values too."""
    ec = get_cuda_quad_ec(P)
    pec = get_quad_xla_pec(P)
    a, b, tw = _mont(_operands(8, False)), _mont(_operands(9, True)), _mont(_operands(10, False))
    got = ec.butterfly(_words(a), _words(b), _words(tw))
    want = pec.butterfly(_plane(a), _plane(b), _plane(tw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_limbs(g), _from_plane(w))
    ctx = get_fq2_ctx()
    av, bv, tv = (ctx.from_mont_host(v) for v in (a, b, tw))
    assert ctx.from_mont_host(_limbs(got[0])) == [x + y * t for x, y, t in zip(av, bv, tv)]
    assert ctx.from_mont_host(_limbs(got[1])) == [x - y * t for x, y, t in zip(av, bv, tv)]
    assert ec.butterfly_launches == 0


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


# -- the G2 MSM's point kernels ------------------------------------------------

def _g2_points(seed: int, n: int = 8) -> list:
    """n affine G2 points from seeded scalars."""
    ks = [int(v.c0) % G2.n or 1 for v in _seeded(seed, n)]
    return nb.fixed_base_g2(G2.generator(), ks)


def _g2_jacobian(pts, seed: int):
    """Affine points (None: identity) -> Montgomery (x, y, z) (n, 2, 16)
    limbs with a seeded Z per lane: (x z^2, y z^3, z); an identity lane
    keeps seeded x, y and Z = 0."""
    zs = _seeded(seed, len(pts))
    xs, ys, zz = [], [], []
    for p, z in zip(pts, zs):
        if p is None:
            xs.append(z)
            ys.append(z * z)
            zz.append(Fq2(0, 0))
        else:
            xs.append(p[0] * z * z)
            ys.append(p[1] * z * z * z)
            zz.append(z)
    return _mont(xs), _mont(ys), _mont(zz)


def _edge_lanes(k: int) -> list[np.ndarray]:
    """k planes of four lanes whose coordinates are the edge values 0, 1,
    p-1 and u, rotated from plane to plane."""
    return [_mont([EDGES[(lane + j) % 4] for lane in range(4)]) for j in range(k)]


def _g2_jadd_inputs():
    """P, Q with the cases planted: generic, P == Q, P == -Q, the identity
    on the left, on the right, on both, P == Q through another
    representative (other Z), generic; then four lanes of edge values."""
    pp, qq = _g2_points(21), _g2_points(22)
    qq[1] = pp[1]
    qq[2] = G2.neg(pp[2])
    pp[3] = None
    qq[4] = None
    pp[5] = qq[5] = None
    qq[6] = pp[6]
    planes = (*_g2_jacobian(pp, 23), *_g2_jacobian(qq, 24))
    return tuple(np.concatenate([a, e]) for a, e in zip(planes, _edge_lanes(6)))


def _g2_pair_inputs():
    """Affine pairs with the cases planted: generic, L == R, L == -R, left
    only, right only, neither, L == R on an invalid side, generic; then four
    valid lanes of edge values."""
    ll, rr = _g2_points(25), _g2_points(26)
    rr[1] = ll[1]
    rr[2] = G2.neg(ll[2])
    rr[6] = ll[6]
    lv = np.ones(8, np.int32)
    rv = np.ones(8, np.int32)
    rv[3] = 0
    lv[4] = 0
    lv[5] = rv[5] = 0
    rv[6] = 0
    lx, ly = _mont([p[0] for p in ll]), _mont([p[1] for p in ll])
    rx, ry = _mont([p[0] for p in rr]), _mont([p[1] for p in rr])
    ex, ey, fx, fy = _edge_lanes(4)
    ones = np.ones(4, np.int32)
    return (np.concatenate([lx, ex]), np.concatenate([ly, ey]), np.concatenate([lv, ones]),
            np.concatenate([rx, fx]), np.concatenate([ry, fy]), np.concatenate([rv, ones]))


def _port(fn, *args):
    """Call a CudaQuadEC op on (n, 2, 16) limbs and (n,) flags; results as
    (n, 2, 16) limbs and (n,) ints."""
    outs = fn(*(_words(a) if a.ndim == 3 else torch.from_numpy(a) for a in args))
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [_limbs(o) if o.dim() == 2 else o.numpy() for o in outs]


def _ref(fn, *args):
    """The same through the adapter's (32, n) planes and u32 flags."""
    outs = fn(*(_plane(a) if a.ndim == 3 else jnp.asarray(a.astype(np.uint32))
                for a in args))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [_from_plane(o) if o.ndim == 2 else np.asarray(o).astype(np.int32)
            for o in outs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("op", ["affine_denom", "affine_add", "jadd", "jdbl", "jdbl_n"])
def test_plain_fq2_point_ops_match_reference(op):
    """The G2 MSM's five point ops over Fq2, on the case zoo, against the
    adapter (its jdbl_n as its jdbl applied twice: the same body, without
    compiling a loop), and against the host group law where a lane holds a
    point."""
    ec = get_cuda_quad_ec(P)
    pec = get_quad_xla_pec(P)
    ctx = get_fq2_ctx()
    if op in ("affine_denom", "affine_add"):
        args = _g2_pair_inputs()
        d = _port(ec.affine_denom, *args)
        if op == "affine_denom":
            _assert_same(d, _ref(pec.affine_denom, *args))
            dv = ctx.from_mont_host(d[0])
            assert dv[1] == ctx.from_mont_host(args[1])[1] * Fq2(2, 0)  # L == R: 2 ly
            assert dv[2:7] == [Fq2(1, 0)] * 5                           # no division
        else:
            inv = _port(ec.inv, d[0])[0]
            got = _port(ec.affine_add, *args, inv)
            _assert_same(got, _ref(pec.affine_add, *args, inv))
            assert got[2][:8].tolist() == [1, 1, 0, 1, 1, 0, 1, 1]
            xs, ys = (ctx.from_mont_host(g) for g in got[:2])
            ll = list(zip(*(ctx.from_mont_host(a) for a in args[:2])))
            rr = list(zip(*(ctx.from_mont_host(a) for a in args[3:5])))
            for i in (0, 1, 7):
                assert (xs[i], ys[i]) == G2.add(ll[i], rr[i]), i
            assert (xs[3], ys[3]) == ll[3] and (xs[4], ys[4]) == rr[4]
    else:
        args = _g2_jadd_inputs()
        if op == "jadd":
            got = _port(ec.jadd, *args)
            _assert_same(got, _ref(pec.jadd, *args))
            z = ctx.from_mont_host(got[2])
            assert z[2] == z[5] == Fq2(0, 0) and all(z[i] != Fq2(0, 0) for i in (0, 1, 3, 4, 6, 7))
            pp, qq = _g2_points(21), _g2_points(22)
            xs, ys = (ctx.from_mont_host(g) for g in got[:2])
            for i, want in ((0, G2.add(pp[0], qq[0])), (1, G2.add(pp[1], pp[1])),
                            (6, G2.add(pp[6], pp[6]))):
                zi = z[i].inv()
                assert (xs[i] * zi * zi, ys[i] * zi * zi * zi) == want, i
        elif op == "jdbl":
            _assert_same(_port(ec.jdbl, *args[:3]), _ref(pec.jdbl, *args[:3]))
        else:
            once = _ref(pec.jdbl, *args[:3])
            _assert_same(_port(lambda *a: ec.jdbl_n(*a, 2), *args[:3]), _ref(pec.jdbl, *once))
            _assert_same(_port(lambda *a: ec.jdbl_n(*a, 0), *args[:3]), list(args[:3]))
    assert ec.launches() == dict.fromkeys(QUAD_KERNELS, 0)  # CPU: no kernel
