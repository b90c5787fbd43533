"""Plain versions of the port's eight point kernels
(crescent_tpu_torch/ops/cuda_ec.py: inv, affine_denom, affine_add, jadd,
jdbl_n, jdbl, madd, bucket_reduce) against the reference's XLA adapter and
its Pallas kernels in interpret mode (bucket_reduce against the Pallas
kernel only, about a minute to compile: the adapter has none) (the CUDA kernels against the plain versions:
tests/test_torch_cuda.py and chip_smoke.py).

Planes: the reference takes (16, N) limb-major u32 Montgomery planes and
(N,) u32 flags; the port (N, 8) int32 word rows and (N,) int32 flags.  The
same seeded values go through both; the comparison is exact (tolerance 0),
lanes of invalid or garbage inputs included.

Eight lanes with the case zoo of the reference's own kernel tests: generic,
P == Q, P == -Q, identity on either side and on both; L == R, L == -R, left
only, right only, neither; for madd also valid == 0 and sign == 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crescent_tpu.core import fields as F
from crescent_tpu.ops.pallas_ec import get_pallas_ec
from crescent_tpu.ops.xla_pec import get_xla_pec
from crescent_tpu_torch.core.curves import BN254_G1
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec

P = F.BN254_FQ
N = 8
A_NONZERO = 0x1234567  # an arbitrary curve coefficient: the formulas are field expressions
BACKENDS = ["xla", "pallas_interpret"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_pec(backend: str, a: int = 0):
    return get_xla_pec(P, a) if backend == "xla" else get_pallas_ec(P, a, block=N)


def _seeded(seed: int, n: int = N) -> list[int]:
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int("".join(f"{int(x):08x}" for x in r), 16) % P for r in w]


def _mont(vals) -> np.ndarray:
    """ints -> (n, 16) Montgomery limbs."""
    return limb.get_ctx(P).to_mont_host(vals)


def _points(seed: int):
    """Eight affine BN254 G1 points from seeded scalars."""
    ks = [k % BN254_G1.n or 1 for k in _seeded(seed)]
    return nb.fixed_base("bn254_g1", BN254_G1.generator, ks)


def _jacobian(pts, seed: int):
    """Affine points (None: identity) -> Montgomery (x, y, z) limb planes
    with a seeded Z per lane: (x z^2, y z^3, z)."""
    zs = [z or 1 for z in _seeded(seed)]
    xs, ys, zz = [], [], []
    for p, z in zip(pts, zs):
        if p is None:
            xs.append(z)
            ys.append(z * z % P)
            zz.append(0)
        else:
            xs.append(p[0] * z * z % P)
            ys.append(p[1] * z * z * z % P)
            zz.append(z)
    return _mont(xs), _mont(ys), _mont(zz)


def _ref(fn, *args):
    """Call a reference op on limb planes ((n, 16) -> (16, n)) and flag
    vectors, and bring the results back to (n, 16) / (n,)."""
    outs = fn(*(jnp.asarray(a.T.copy() if a.ndim == 2 else a) for a in args))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    outs = [np.asarray(jax.device_get(o)) for o in outs]
    return [o.T if o.ndim == 2 else o for o in outs]


def _port(fn, *args):
    outs = fn(*(limb.limbs_to_words(a) if a.ndim == 2
                else torch.from_numpy(a.astype(np.int32)) for a in args))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [limb.words_to_limbs(o) if o.dim() == 2 else o.numpy().astype(np.uint32)
            for o in outs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.uint32))


def _jadd_inputs():
    pp, qq = _points(1), _points(2)
    qq[1] = pp[1]                              # P == Q
    qq[2] = BN254_G1.neg(pp[2])                # P == -Q
    pp[3] = None                               # identity on the left
    qq[4] = None                               # on the right
    pp[5] = qq[5] = None                       # on both
    return (*_jacobian(pp, 3), *_jacobian(qq, 4))


def _pair_inputs():
    ll, rr = _points(5), _points(6)
    rr[1] = ll[1]                              # L == R
    rr[2] = BN254_G1.neg(ll[2])                # L == -R
    rr[6] = ll[6]                              # L == R on an invalid side
    lv = np.ones(N, np.uint32)
    rv = np.ones(N, np.uint32)
    rv[3] = 0                                  # left only
    lv[4] = 0                                  # right only
    lv[5] = rv[5] = 0                          # neither
    rv[6] = 0
    lx, ly = _mont([p[0] for p in ll]), _mont([p[1] for p in ll])
    rx, ry = _mont([p[0] for p in rr]), _mont([p[1] for p in rr])
    return lx, ly, lv, rx, ry, rv


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_inv_matches_reference(backend):
    ec = get_cuda_ec(P)
    vals = _seeded(7)
    vals[:4] = [0, 1, P - 1, ec.ctx.r_mod_n]
    x = _mont(vals)
    got = _port(ec.inv, x)
    _assert_same(got, _ref(_ref_pec(backend).inv, x))
    rinv = ec.ctx.from_mont_host(got[0])
    assert rinv == [0] + [pow(v, -1, P) for v in vals[1:]]
    assert ec.inv_launches == 0  # CPU: no kernel


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_affine_denom_matches_reference(backend):
    ec = get_cuda_ec(P)
    args = _pair_inputs()
    got = _port(ec.affine_denom, *args)
    _assert_same(got, _ref(_ref_pec(backend).affine_denom, *args))
    one = ec.ctx.r_mod_n
    d = limb.limbs_to_ints(got[0])
    assert d[1] == 2 * limb.limbs_to_ints(args[1])[1] % P       # L == R: 2 ly
    assert d[2:7] == [one] * 5                                   # no division needed
    assert ec.affine_denom_launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_affine_add_matches_reference(backend):
    ec = get_cuda_ec(P)
    args = _pair_inputs()
    inv = _port(ec.inv, _port(ec.affine_denom, *args)[0])[0]
    got = _port(ec.affine_add, *args, inv)
    _assert_same(got, _ref(_ref_pec(backend).affine_add, *args, inv))
    # and the host curve law on the lanes that hold a sum
    xs, ys = (ec.ctx.from_mont_host(g) for g in got[:2])
    ll = list(zip(*(ec.ctx.from_mont_host(a) for a in args[:2])))
    rr = list(zip(*(ec.ctx.from_mont_host(a) for a in args[3:5])))
    assert got[2].tolist() == [1, 1, 0, 1, 1, 0, 1, 1]
    for i in (0, 1, 7):
        assert (xs[i], ys[i]) == BN254_G1.add(ll[i], rr[i]), i
    assert (xs[3], ys[3]) == ll[3] and (xs[4], ys[4]) == rr[4] and (xs[6], ys[6]) == ll[6]
    assert ec.affine_add_launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_jadd_matches_reference(backend):
    ec = get_cuda_ec(P)
    args = _jadd_inputs()
    got = _port(ec.jadd, *args)
    _assert_same(got, _ref(_ref_pec(backend).jadd, *args))
    z = limb.limbs_to_ints(got[2])
    assert z[2] == 0 and z[5] == 0 and all(z[i] for i in (0, 1, 3, 4, 6, 7))
    assert ec.jadd_launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_jdbl_matches_reference(backend):
    ec = get_cuda_ec(P)
    args = _jadd_inputs()[:3]  # lanes 3 and 5 hold the identity
    got = _port(ec.jdbl, *args)
    _assert_same(got, _ref(_ref_pec(backend).jdbl, *args))
    assert ec.jdbl_launches == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_jdbl_n_matches_reference(backend):
    ec = get_cuda_ec(P)
    args = _jadd_inputs()[:3]
    got = _port(lambda *a: ec.jdbl_n(*a, 3), *args)
    pec = _ref_pec(backend)
    if backend == "xla":
        # the adapter's jdbl_n is a compiled loop over the body of its jdbl;
        # applying jdbl three times op by op gives the same values in a
        # tenth of the compile's time
        want = args
        for _ in range(3):
            want = _ref(pec.jdbl, *want)
    else:
        want = _ref(lambda *a: pec.jdbl_n(*a, count=3), *args)
    _assert_same(got, want)
    _assert_same(_port(lambda *a: ec.jdbl_n(*a, 0), *args), args)
    assert ec.jdbl_n_launches == 0


def test_plain_point_ops_match_reference_with_nonzero_a():
    """The a-terms of jdbl, jdbl_n and affine_add (and of jadd's doubling
    case), over BN254 Fq with an arbitrary a, against the XLA adapter run
    op by op (jdbl_n as the adapter's jdbl applied twice: its jdbl_n is a
    loop over the same body)."""
    ec = get_cuda_ec(P, A_NONZERO)
    pec = get_xla_pec(P, A_NONZERO)
    assert not ec.a_is_zero and get_cuda_ec(P, A_NONZERO + P) is ec
    pt = _jadd_inputs()
    once = _ref(pec.jdbl, *pt[:3])
    _assert_same(_port(ec.jdbl, *pt[:3]), once)
    _assert_same(_port(lambda *a: ec.jdbl_n(*a, 2), *pt[:3]), _ref(pec.jdbl, *once))
    assert not np.array_equal(_port(get_cuda_ec(P).jdbl, *pt[:3])[0], once[0])
    _assert_same(_port(ec.jadd, *pt), _ref(pec.jadd, *pt))
    pair = _pair_inputs()
    inv = _port(ec.inv, _port(ec.affine_denom, *pair)[0])[0]
    _assert_same(_port(ec.affine_add, *pair, inv), _ref(pec.affine_add, *pair, inv))


def _madd_inputs():
    """Jacobian P (seeded Z) and affine Q with the cases planted: P == Q,
    P == -Q, P the identity, valid == 0, and with sign == 1: -Q == P (the
    doubling), -Q == -P (the identity) and a generic lane."""
    pp, qq = _points(11), _points(12)
    qq[1] = pp[1]                              # P == Q
    qq[2] = BN254_G1.neg(pp[2])                # P == -Q
    pp[3] = None                               # identity + Q
    qq[5] = BN254_G1.neg(pp[5])                # sign: -Q == P
    qq[6] = pp[6]                              # sign: -Q == -P
    x1, y1, z1 = _jacobian(pp, 13)
    valid = np.ones(N, np.uint32)
    valid[4] = 0
    sign = np.zeros(N, np.uint32)
    sign[5:8] = 1
    qx, qy = _mont([q[0] for q in qq]), _mont([q[1] for q in qq])
    return x1, y1, z1, qx, qy, valid, sign


@pytest.mark.parametrize("a", [0, A_NONZERO], ids=["a0", "a_nonzero"])
def test_plain_madd_matches_reference(a):
    """madd over BN254 Fq, on the curve's a = 0 and on an arbitrary a (the
    a-term of the doubling lanes), against the XLA adapter's madd."""
    ec = get_cuda_ec(P, a)
    args = _madd_inputs()
    got = _port(ec.madd, *args)
    _assert_same(got, _ref(get_xla_pec(P, a).madd, *args))
    z = limb.limbs_to_ints(got[2])
    assert z[2] == 0 and z[6] == 0 and all(z[i] for i in (0, 1, 3, 5, 7))
    assert z[3] == ec.ctx.r_mod_n                               # identity + Q: Z = 1
    np.testing.assert_array_equal(got[0][4], args[0][4])       # valid == 0: P
    xs, ys, zs = (ec.ctx.from_mont_host(g) for g in got[:3])
    if a == 0:  # on the curve: the host group law
        pp, qq = _points(11), _points(12)
        for i, want in ((0, BN254_G1.add(pp[0], qq[0])), (1, BN254_G1.add(pp[1], pp[1])),
                        (7, BN254_G1.add(pp[7], BN254_G1.neg(qq[7])))):
            zi = pow(zs[i], -1, P)
            assert (xs[i] * zi * zi % P, ys[i] * zi ** 3 % P) == want, i
    assert ec.madd_launches == 0


def test_plain_bucket_reduce_matches_reference_interpret():
    """bucket_reduce_plain at W = 2 windows of B = 5 buckets against
    PallasEC.bucket_reduce in interpret mode (the case of the reference's
    tests/test_pallas_ec.py:334), whose table is lane-padded to 128 columns
    a window: the Jacobian planes are equal, and each window's point is
    sum_b b * S_b.  Window 0 holds P == Q and P == -Q in neighbouring
    buckets (the doubling and the identity at the first level), window 1
    empty buckets (zero rows, as the scatter leaves them)."""
    W, B = 2, 5
    g0, p1, q, r, t = _points(13)[:5]
    cols = [g0, p1, p1, q, BN254_G1.neg(q), None, r, None, t, None]
    ec = get_cuda_ec(P)
    ctx = ec.ctx
    xs, ys = ([0 if pt is None else pt[i] for pt in cols] for i in (0, 1))
    planes = [_mont(xs), _mont(ys), _mont([0 if pt is None else 1 for pt in cols])]
    got = _port(lambda x, y, z: ec.bucket_reduce(x, y, z, W, B), *planes)
    pec = _ref_pec("pallas_interpret")
    Bp = pec.bucket_stride(B)
    padded = []
    for a in planes:
        table = np.zeros((W * Bp, 16), np.uint32)
        for w in range(W):
            table[w * Bp : w * Bp + B] = a[w * B : (w + 1) * B]
        padded.append(table)
    _assert_same(got, _ref(lambda x, y, z: pec.bucket_reduce(x, y, z, W, B), *padded))
    xs, ys, zs = (ctx.from_mont_host(g) for g in got)
    for w in range(W):
        want = None
        for b in range(1, B):
            if cols[w * B + b] is not None:
                want = BN254_G1.add(want, BN254_G1.mul(b, cols[w * B + b]))
        zi = pow(zs[w], -1, P)
        assert (xs[w] * zi * zi % P, ys[w] * zi ** 3 % P) == want, w
    assert ec.bucket_reduce_launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    ec = get_cuda_ec(P)
    x = limb.limbs_to_words(_mont(_seeded(9)))
    with pytest.raises(ValueError):
        ec.bucket_reduce(x, x, x, 2, 4)  # B - 1 not a power of two
    with pytest.raises(ValueError):
        ec.jdbl_n(x, x, x, -1)
    with pytest.raises(ValueError):
        ec.inv(x.to("meta"))
