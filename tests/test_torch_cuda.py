"""The port's CUDA kernels (crescent_tpu_torch/csrc/ntt.cu, ec.cu, ec2.cu)
against their plain PyTorch versions on a card, bit for bit, and the fixed
base and the small-N MSM on the card against the native host backend.

Needs a CUDA card and imports nothing of JAX, so it runs on a machine
without JAX; the repo's conftest imports jax, so there run it with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Where no card is present every test skips.
"""

import numpy as np
import pytest
import torch

from crescent_tpu_torch.core import fields
from crescent_tpu_torch.core.fields import Fq2
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec

FIELDS = {"Fr": fields.BN254_FR, "Fq": fields.BN254_FQ}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _elems(p: int, n: int, seed: int, device) -> torch.Tensor:
    """(n, 8) seeded canonical elements; rows 0..15 hold every pair of the
    edge values 0, 1, p-1, Montgomery 1 (seed parity picks the operand)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [int("".join(f"{int(w):08x}" for w in r[::-1]), 16) % p for r in words]
    edge = [0, 1, p - 1, (1 << 256) % p]
    vals[:16] = [edge[i // 4] if seed % 2 else edge[i % 4] for i in range(16)]
    return limb.get_ctx(p).words(vals, device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_cuda_kernels_match_plain(cuda, name):
    p = FIELDS[name]
    ec = get_cuda_ec(p)
    x = _elems(p, 4096, 7, cuda)
    y = _elems(p, 4096, 8, cuda)
    launches = ec.mul_launches, ec.butterfly_launches
    assert torch.equal(ec.mul(x, y), ec.mul_plain(x, y))
    assert torch.equal(ec.mul(x, y[3:4]), ec.mul_plain(x, y[3:4]))
    for got, want in zip(ec.butterfly(x, y, x), ec.butterfly_plain(x, y, x)):
        assert torch.equal(got, want)
    for s in (0, 5, 11):
        half = 1 << s
        tw = y[:half].contiguous()
        got = ec.butterfly_stage_(x.clone(), tw, half)
        v = x.clone().view(-1, 2, half, 8)
        r0, r1 = ec.butterfly_plain(v[:, 0], v[:, 1], tw)
        assert torch.equal(got, torch.stack([r0, r1], 1).view(-1, 8))
    assert (ec.mul_launches, ec.butterfly_launches) == (launches[0] + 2, launches[1] + 4)


def _planted_points(ec, n: int, seed: int, device, elems=None):
    """Jacobian batches P, Q with lanes 0..5: P == Q, P == Q through another
    representative, P == -Q, P at infinity, Q at infinity, both.
    `elems(seed)` gives the seeded rows (default: n - 16 Fq rows)."""
    p = ec.modulus
    elems = elems or (lambda s: _elems(p, n, s, device)[16:].contiguous())
    x1, y1, z1, x2, y2, z2 = (elems(seed + 2 * k) for k in range(6))
    f = ec.ctx
    x2[0], y2[0], z2[0] = x1[0], y1[0], z1[0]
    lam = x2[1:2].clone()
    l2 = f.mont_sqr(lam)
    x2[1:2] = f.mont_mul(x1[1:2], l2)
    y2[1:2] = f.mont_mul(y1[1:2], f.mont_mul(l2, lam))
    z2[1:2] = f.mont_mul(z1[1:2], lam)
    x2[2], y2[2], z2[2] = x1[2], f.neg_mod(y1[2:3])[0], z1[2]
    z1[3] = 0
    z2[4] = 0
    z1[5] = 0
    z2[5] = 0
    return x1, y1, z1, x2, y2, z2


def _planted_pairs(ec, n: int, seed: int, device, elems=None):
    """Affine pairs with lanes 0..4: L == R, L == -R, left only, right only,
    neither; seeded validity elsewhere.  `elems` as for
    ``_planted_points``."""
    p = ec.modulus
    elems = elems or (lambda s: _elems(p, n, s, device)[16:].contiguous())
    lx, ly, rx, ry = (elems(seed + 2 * k) for k in range(4))
    rng = np.random.default_rng(seed)
    lv = torch.from_numpy(rng.integers(0, 2, size=lx.shape[0]).astype(np.int32)).to(device)
    rv = torch.from_numpy(rng.integers(0, 2, size=lx.shape[0]).astype(np.int32)).to(device)
    rx[0], ry[0] = lx[0], ly[0]
    rx[1], ry[1] = lx[1], ec.ctx.neg_mod(ly[1:2])[0]
    for lane, (l, r) in enumerate([(1, 1), (1, 1), (1, 0), (0, 1), (0, 0)]):
        lv[lane], rv[lane] = l, r
    return lx, ly, lv, rx, ry, rv


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("a", [0, 0x1234567], ids=["a0", "a_nonzero"])
def test_cuda_point_kernels_match_plain(cuda, a):
    """inv, affine_denom, affine_add, jadd, jdbl_n and jdbl over BN254 Fq,
    on the curve's a = 0 and on an arbitrary a != 0; 3100 lanes (no multiple
    of the block size: the bounds check)."""
    from crescent_tpu_torch.ops.msm_affine import batch_inv

    ec = get_cuda_ec(fields.BN254_FQ, a)
    n = 3100 + 16
    before = ec.launches()
    x = _elems(ec.modulus, 512, 9, cuda)  # rows 0..15: 0, 1, p-1, Montgomery 1
    assert _equal(ec.inv(x), ec.inv_plain(x))
    pair = _planted_pairs(ec, n, 11, cuda)
    d = ec.affine_denom(*pair)
    assert _equal(d, ec.affine_denom_plain(*pair))
    inv = ec.inv(d)
    assert _equal(ec.affine_add(*pair, inv), ec.affine_add_plain(*pair, inv))
    assert ec.affine_add(*pair, inv)[2][:5].tolist() == [1, 0, 1, 1, 0]
    # the product tree on strided views: 3072 lanes down to a root of 12
    d3 = d[:3072].contiguous()
    tree = batch_inv(ec, d3, inv_floor=16)
    assert torch.equal(ec.mul(d3, tree), ec.ctx.one_mont(cuda).expand_as(d3))
    pq = _planted_points(ec, n, 13, cuda)
    assert _equal(ec.jadd(*pq), ec.jadd_plain(*pq))
    assert _equal(ec.jdbl(*pq[:3]), ec.jdbl_plain(*pq[:3]))
    p16 = tuple(t[:16].contiguous() for t in pq[:3])
    for count in (0, 1, 11):
        assert _equal(ec.jdbl_n(*p16, count), ec.jdbl_n_plain(*p16, count))
    after = ec.launches()
    grew = {k: after[k] - before[k] for k in after}
    assert grew["inv"] == 2 and grew["affine_denom"] == 1 and grew["affine_add"] == 2
    assert grew["batch_inv"] == 1 and grew["mul"] == 1  # the tree: one launch
    assert grew["jadd"] == 1 and grew["jdbl"] == 1 and grew["jdbl_n"] == 3
    with pytest.raises(ValueError):
        ec.jadd(*pq[:5], pq[5][1:])          # a plane of another length
    with pytest.raises(ValueError):
        ec.jdbl(pq[0][:, :4], pq[1], pq[2])  # not (N, 8) rows


def _planted_madd(f, n: int, seed: int, device, elems):
    """Jacobian P, affine Q and flags with lanes 0..6: P == Q, P == -Q,
    P the identity, valid == 0, sign with -Q == P, sign with -Q == -P, sign
    generic; seeded elsewhere.  `elems(seed)` gives (n, W) elements."""
    x1, y1, z1, qx, qy = (elems(seed + 2 * k) for k in range(5))
    for lane, neg in ((0, False), (1, True), (4, True), (5, False)):
        z = z1[lane : lane + 1]
        z2 = f.mont_sqr(z)
        x1[lane : lane + 1] = f.mont_mul(qx[lane : lane + 1], z2)
        y = f.mont_mul(qy[lane : lane + 1], f.mont_mul(z2, z))
        y1[lane : lane + 1] = f.neg_mod(y) if neg else y
    z1[2] = 0
    valid = torch.ones(n, dtype=torch.int32, device=device)
    valid[3] = 0
    sign = torch.zeros(n, dtype=torch.int32, device=device)
    sign[4:7] = 1
    return x1, y1, z1, qx, qy, valid, sign


@pytest.mark.cuda
@pytest.mark.parametrize("a", [0, 0x1234567], ids=["a0", "a_nonzero"])
def test_cuda_madd_matches_plain(cuda, a):
    """madd over BN254 Fq at 3,100 lanes, with Q read through the halves
    of gathered [x | y] rows, as the fixed base passes it."""
    ec = get_cuda_ec(fields.BN254_FQ, a)
    n = 3100
    before = ec.madd_launches
    args = _planted_madd(ec.ctx, n, 21, cuda,
                         lambda s: _elems(ec.modulus, n + 16, s, cuda)[16:].contiguous())
    q = torch.cat([args[3], args[4]], dim=1)
    strided = args[:3] + (q[:, :8], q[:, 8:]) + args[5:]
    got = ec.madd(*strided)
    assert _equal(got, ec.madd_plain(*args))
    assert _equal(ec.madd(*args), got)
    assert got[2][1].eq(0).all() and got[2][5].eq(0).all() and got[2][0].any()
    assert torch.equal(got[0][3], args[0][3])
    assert ec.madd_launches == before + 2


@pytest.mark.cuda
def test_cuda_fq2_kernels_match_plain(cuda):
    """mul (strided rows and a broadcast row), inv (0 -> 0) and madd over
    Fq2, against their plain versions."""
    from crescent_tpu_torch.ops.msm_affine import batch_inv

    ec = get_cuda_quad_ec(fields.BN254_FQ)
    f = ec.ctx
    p = fields.BN254_FQ

    def elems(seed, n=3100):
        return torch.cat([_elems(p, n + 16, seed, cuda), _elems(p, n + 16, seed + 1, cuda)],
                         dim=1)[16:].contiguous()

    before = ec.launches()
    x, y = elems(31), elems(33)
    assert _equal(ec.mul(x, y), ec.mul_plain(x, y))
    assert _equal(ec.mul(x, y[5:6]), ec.mul_plain(x, y[5:6]))
    out = torch.zeros_like(x)
    ec.mul(x[0::2], y[1::2], out=out[1::2])
    assert torch.equal(out[1::2], ec.mul_plain(x[0::2], y[1::2])) and not out[0::2].any()
    z = x[:512].clone()
    z[0] = 0
    z[1, 8:] = 0  # a base-field element
    got = ec.inv(z)
    assert _equal(got, ec.inv_plain(z)) and not got[0].any()
    assert torch.equal(ec.mul(z[1:], got[1:]), f.one_mont(cuda).expand(511, 16))
    d = x[:3072].contiguous()
    assert torch.equal(ec.mul(d, batch_inv(ec, d, inv_floor=16)),
                       f.one_mont(cuda).expand_as(d))
    args = _planted_madd(f, 3100, 41, cuda, elems)
    q = torch.cat([args[3], args[4]], dim=1)
    got = ec.madd(*args[:3], q[:, :16], q[:, 16:], *args[5:])
    assert _equal(got, ec.madd_plain(*args))
    assert got[2][1].eq(0).all() and got[2][5].eq(0).all() and got[2][0].any()
    after = ec.launches()
    assert after["madd"] == before["madd"] + 1 and after["inv"] == before["inv"] + 1
    assert after["batch_inv"] == before["batch_inv"] + 1
    with pytest.raises(ValueError):
        ec.mul(x[:, :8].contiguous(), y[:, :8].contiguous())  # not (N, 16) rows


def _elems2(n: int, seed: int, device) -> torch.Tensor:
    """(n, 16) seeded Fq2 rows (c0, then c1)."""
    p = fields.BN254_FQ
    return torch.cat([_elems(p, n + 16, seed, device), _elems(p, n + 16, seed + 1, device)],
                     dim=1)[16:].contiguous()


@pytest.mark.cuda
def test_cuda_fq2_point_kernels_match_plain(cuda):
    """affine_denom, affine_add, jadd, jdbl_n and jdbl over Fq2 (the G2
    MSM's) against their plain versions at 3,100 lanes, the cases
    planted."""
    ec = get_cuda_quad_ec(fields.BN254_FQ)
    n = 3100
    before = ec.launches()
    pair = _planted_pairs(ec, n, 51, cuda, lambda s: _elems2(n, s, cuda))
    d = ec.affine_denom(*pair)
    assert _equal(d, ec.affine_denom_plain(*pair))
    inv = ec.inv(d)
    got = ec.affine_add(*pair, inv)
    assert _equal(got, ec.affine_add_plain(*pair, inv))
    assert got[2][:5].tolist() == [1, 0, 1, 1, 0]
    pq = _planted_points(ec, n, 61, cuda, lambda s: _elems2(n, s, cuda))
    got = ec.jadd(*pq)
    assert _equal(got, ec.jadd_plain(*pq))
    assert not got[2][2].any() and not got[2][5].any() and got[2][0].any()
    assert _equal(ec.jdbl(*pq[:3]), ec.jdbl_plain(*pq[:3]))
    p16 = tuple(t[:16].contiguous() for t in pq[:3])
    for count in (0, 1, 11):
        assert _equal(ec.jdbl_n(*p16, count), ec.jdbl_n_plain(*p16, count))
    after = ec.launches()
    grew = {k: after[k] - before[k] for k in after}
    assert (grew["affine_denom"], grew["affine_add"], grew["jadd"], grew["jdbl"],
            grew["jdbl_n"]) == (1, 1, 1, 1, 3)
    with pytest.raises(ValueError):
        ec.jadd(*(t[:, :8].contiguous() for t in pq))  # not (N, 16) rows


@pytest.mark.cuda
def test_cuda_g2_chunk_matches_native(cuda):
    """One AffineMSM chunk of 4,096 G2 points at the prove path's window
    width (c = 11) on the card, the cases planted, against the native G2
    MSM; and get_g2_msm's run_device of 3 * 2^12 points as three chunks
    added by the Fq2 jadd."""
    import random

    from crescent_tpu_torch.core.curves import BN254G2
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops.ec import JPoints, get_g2_ctx, points_valid
    from crescent_tpu_torch.ops.msm import MSM
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    ctx = get_g2_ctx()
    rng = random.Random(7)
    n = 3 << 12
    pts = nb.fixed_base_g2(BN254G2.generator(), [rng.randrange(1, ctx.n) for _ in range(n)])
    ks = [rng.randrange(ctx.n) for _ in range(n)]
    pts[5] = None
    ks[6], ks[7] = 0, ctx.n - 1
    pts[9], ks[9] = pts[8], ks[8]
    pts[11], ks[11] = BN254G2.neg(pts[10]), ks[10]
    P = ctx.points_to_device(pts, cuda)
    valid = torch.from_numpy(points_valid(pts)).to(cuda)
    sc = limb.limbs_to_words(limb.ints_to_limbs(ks), cuda)
    ck = 1 << 12
    res = AffineMSM(ctx, ctx.ec).run(P.x[:ck], P.y[:ck], valid[:ck], sc[:ck])
    assert ctx.points_to_host(JPoints(*(a[None] for a in res)))[0] == nb.msm_g2(ks[:ck], pts[:ck])
    m = MSM(ctx, max_chunk=ck)
    res = m.run_device(P.x, P.y, valid, sc)
    assert ctx.points_to_host(JPoints(*(a[None] for a in res)))[0] == nb.msm_g2(ks, pts)


@pytest.mark.cuda
def test_cuda_fixed_base_matches_native(cuda):
    """FixedBaseMSM on the card for G1 and G2 (704 scalars, padded to 1024
    in the affine conversion; 0, 1, n - 1) against the native fixed base:
    one `fixed_base` launch for the batch, no `madd`."""
    import random

    from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx
    from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM

    rng = random.Random(5)
    for ctx, base, native in (
            (get_curve_ctx(BN254_G1), BN254_G1.generator,
             lambda b, ks: nb.fixed_base("bn254_g1", b, ks)),
            (get_g2_ctx(), BN254G2.generator(), nb.fixed_base_g2)):
        fb = FixedBaseMSM(ctx)
        table = native(base, fb.table_scalars())
        ks = [0, 1, ctx.n - 1, (ctx.n + 1) // 2] + [rng.randrange(ctx.n) for _ in range(700)]
        before = ctx.ec.launches()
        out = fb.run(table, limb.ints_to_limbs(ks), cuda)
        assert list(out) == native(base, ks)
        after = ctx.ec.launches()
        assert (after["fixed_base"], after["madd"]) == (before["fixed_base"] + 1,
                                                        before["madd"])


def _fixed_base_inputs(group: str, n: int, seed: int, device):
    """The curve context, its generator G, a real window table (row
    w * 256 + d = max(d, 1) * 2^(8 w) * G), two planted ones (every row G,
    so that the second valid window doubles; G in even windows and -G in odd
    ones, so that sums reach the identity mid-chain) as (8192, 2 W) planes,
    and n scalar words with 0, 1, n - 1 and (n + 1) / 2 first and zero
    digits in every eighth scalar."""
    import random

    from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx
    from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM

    if group == "G1":
        ctx, curve = get_curve_ctx(BN254_G1), BN254_G1
        g = BN254_G1.generator
        table = nb.fixed_base("bn254_g1", g, FixedBaseMSM(ctx).table_scalars())
    else:
        ctx, curve = get_g2_ctx(), BN254G2
        g = BN254G2.generator()
        table = nb.fixed_base_g2(g, FixedBaseMSM(ctx).table_scalars())
    fb = FixedBaseMSM(ctx)
    planes = {"real": fb.table_planes(table, device),
              "every row G": fb.table_planes([g] * 8192, device),
              "G and -G": fb.table_planes([g if i // 256 % 2 == 0 else curve.neg(g)
                                           for i in range(8192)], device)}
    rng = random.Random(seed)
    ks = [rng.randrange(ctx.n) for _ in range(n)]
    ks[:4] = [0, 1, ctx.n - 1, (ctx.n + 1) // 2]
    for i in range(4, n, 8):  # zero bytes among the digits
        ks[i] &= ~(0xFFFF << (8 * (i % 30)))
    return ctx, planes, limb.limbs_to_words(limb.ints_to_limbs(ks), device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_cuda_fixed_base_kernel_matches_chain(cuda, group):
    """The window kernel over Fq (G1) and Fq2 (G2) at 3,100 lanes, on the
    real table and the two planted ones: Jacobian planes bit-equal to the
    chain of 32 row gathers and `madd` launches (the port before the window
    kernel) and to fixed_base_plain, one launch each."""
    from crescent_tpu_torch.ops.cuda_ec import fixed_base_windows

    ctx, planes, sc = _fixed_base_inputs(group, 3100, 23, cuda)
    ec = ctx.ec
    for name, table in planes.items():
        before = ec.launches()
        got = ec.fixed_base(table, sc)
        after = ec.launches()
        assert (after["fixed_base"], after["madd"]) == (before["fixed_base"] + 1,
                                                        before["madd"]), name
        assert _equal(got, fixed_base_windows(ec.madd, table, sc)), name
        assert _equal(got, ec.fixed_base_plain(table, sc)), name
        inf = ~got[2].any(1)
        assert inf[0] and (not inf[1:].any() if name == "real" else True), name
        if name == "G and -G":  # as many G as -G: a sum at the identity
            assert inf[1:].any()
    with pytest.raises(ValueError):
        ec.fixed_base(planes["real"][:100], sc)  # not the whole table


@pytest.mark.cuda
def test_cuda_setup_launches_the_window_kernel(cuda, monkeypatch):
    """A setup on the card's device branch launches `fixed_base` once for
    G1 and once for G2, no `madd` and no row gather, and its key equals the
    native branch's."""
    import random

    from crescent_tpu_torch.core.curves import BN254_G1
    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx

    r1cs, _ = groth16.dummy_circuit(8, random.Random(3))
    monkeypatch.setenv("CRESCENT_SETUP_TPU_MIN", "0")
    gathers = []
    real = torch.Tensor.index_select
    monkeypatch.setattr(torch.Tensor, "index_select",
                        lambda self, *a, **k: gathers.append(1) or real(self, *a, **k))
    ecs = (get_curve_ctx(BN254_G1).ec, get_g2_ctx().ec)
    before = [ec.launches() for ec in ecs]
    pk = groth16.setup(r1cs, random.Random(4), device="cuda")
    after = [ec.launches() for ec in ecs]
    monkeypatch.undo()
    for b, a in zip(before, after):
        assert (a["fixed_base"] - b["fixed_base"], a["madd"] - b["madd"]) == (1, 0)
    assert not gathers
    monkeypatch.setenv("CRESCENT_SETUP_TPU", "0")
    native = groth16.setup(r1cs, random.Random(4), device="cuda")
    assert pk.a_query == native.a_query and pk.b_g2_query == native.b_g2_query


def _bucket_table(ec, W: int, B: int, seed: int, device):
    """A dense (W * B) Jacobian bucket table of seeded rows with the cases
    planted in every window, as far as B has room: a bucket equal to the
    next one (P == Q at the first level), empty buckets (zero rows) and one
    the negative of the next (P == -Q)."""
    elems = (lambda s: _elems2(W * B, s, device)) if ec.WIDTH == 16 else (
        lambda s: _elems(ec.modulus, W * B + 16, s, device)[16:].contiguous())
    x, y, z = (elems(seed + k).view(W, B, -1) for k in range(3))
    for a in (x, y, z):
        a[:, 2] = a[:, 1]
        a[:, min(3, B - 1)] = 0
        a[:, B - 1] = 0
    if B > 6:
        x[:, 5], z[:, 5] = x[:, 4], z[:, 4]
        y[:, 5] = ec.ctx.neg_mod(y[:, 4].contiguous())
    return tuple(a.view(W * B, -1) for a in (x, y, z))


# bucket_reduce's shapes (windows, buckets): the fused aggregate's B = 1025
# (c = 11) at 3 windows and 1, and a few buckets (B = 3, 5, 17)
BUCKET_SHAPES = ((3, 1025), (1, 1025), (2, 5), (1, 3), (3, 3), (3, 5), (1, 17), (3, 17))


@pytest.mark.cuda
def test_cuda_bucket_reduce_matches_plain(cuda):
    """bucket_reduce over Fq (a = 0 and a != 0) and Fq2, one launch (a
    cluster of blocks a window, csrc/bucket.cuh), against its plain version
    (bucket_levels over jadd_plain) and the card's unfused levels
    (bucket_levels over the `jadd` kernel) at the prove path's B = 1025 and
    at a few buckets, the cases planted; its clusters fit the card."""
    from crescent_tpu_torch.ops.cuda_ec import bucket_levels

    for ec in (get_cuda_ec(fields.BN254_FQ), get_cuda_ec(fields.BN254_FQ, 0x1234567),
               get_cuda_quad_ec(fields.BN254_FQ)):
        for W, B in BUCKET_SHAPES:
            table = _bucket_table(ec, W, B, 71 + B, cuda)
            before = ec.bucket_reduce_launches
            got = ec.bucket_reduce(*table, W, B)
            assert ec.bucket_reduce_launches == before + 1
            assert _equal(got, ec.bucket_reduce_plain(*table, W, B)), (W, B)
            assert _equal(got, bucket_levels(ec.jadd, *table, W, B)), (W, B)
            assert got[0].shape == (W, ec.WIDTH)
        with pytest.raises(ValueError):
            ec.bucket_reduce(*table, W + 1, B)  # not W * B rows
        assert ec.bucket_reduce_fit(25, 1025)["max_active_clusters"] >= 1


@pytest.mark.cuda
def test_cuda_bucket_reduce_at_its_largest_b(cuda):
    """One window of the most buckets bucket_reduce takes (BUCKET_B_MAX:
    4,097 over Fq, 2,049 over Fq2, its tables near a block's shared memory
    limit) against its plain version and the card's unfused levels; one
    step further is a ValueError that names the limit."""
    from crescent_tpu_torch.ops.cuda_ec import bucket_levels

    for ec in (get_cuda_ec(fields.BN254_FQ), get_cuda_quad_ec(fields.BN254_FQ)):
        B = ec.BUCKET_B_MAX
        table = _bucket_table(ec, 1, B, 73, cuda)
        got = ec.bucket_reduce(*table, 1, B)
        assert _equal(got, ec.bucket_reduce_plain(*table, 1, B)), B
        assert _equal(got, bucket_levels(ec.jadd, *table, 1, B)), B
        with pytest.raises(ValueError, match=f"at most B = {B}"):
            ec.bucket_reduce(*_bucket_table(ec, 1, 2 * B - 1, 73, cuda), 1, 2 * B - 1)


@pytest.mark.cuda
def test_cuda_fq2_butterfly_matches_plain(cuda):
    ec = get_cuda_quad_ec(fields.BN254_FQ)
    a, b, tw = (_elems2(4096, s, cuda) for s in (81, 83, 85))
    before = ec.butterfly_launches
    assert _equal(ec.butterfly(a, b, tw), ec.butterfly_plain(a, b, tw))
    assert ec.butterfly_launches == before + 1


@pytest.mark.cuda
def test_cuda_small_msm_matches_native(cuda):
    """run_device below small_cutoff on the card (the direct path: jdbl,
    jadd and torch.where over 256 steps, then a jadd tree) for G1 and G2,
    against the native MSMs; the identity, 0 and n - 1 planted."""
    import random

    from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops.msm import get_g2_msm, get_msm

    rng = random.Random(9)
    for m, make, native in (
            (get_msm(BN254_G1), lambda ks: nb.fixed_base("bn254_g1", BN254_G1.generator, ks),
             lambda ks, pts: nb.msm("bn254_g1", ks, pts)),
            (get_g2_msm(), lambda ks: nb.fixed_base_g2(BN254G2.generator(), ks), nb.msm_g2)):
        n = 100
        pts = make([rng.randrange(1, m.ctx.n) for _ in range(n)])
        ks = [rng.randrange(m.ctx.n) for _ in range(n)]
        pts[3] = None
        ks[4], ks[5] = 0, m.ctx.n - 1
        before = m.ctx.ec.launches()
        assert m.run_host(ks, pts, cuda) == native(ks, pts)
        after = m.ctx.ec.launches()
        assert after["jdbl"] - before["jdbl"] == 256
        assert after["jadd"] - before["jadd"] == 256 + 7  # and a tree over 128 rows


def _fq2_inv_inputs(device) -> torch.Tensor:
    """512 seeded Fq2 rows with the norm's edge inputs planted in rows
    0..25: (0, 0), (1, 0), (0, 1), (p - 1, 0), (0, p - 1), (R mod p, 0),
    (a, a), (a, p - a), and 2^k in c0 and in c1."""
    p = fields.BN254_FQ
    x = _elems2(512, 19, device)
    a = 0x1234567890ABCDEF
    ks = (1, 31, 32, 64, 128, 200, 253, 254, 255)
    edge = ([Fq2(0, 0), Fq2(1, 0), Fq2(0, 1), Fq2(p - 1, 0), Fq2(0, p - 1),
             Fq2((1 << 256) % p, 0), Fq2(a, a), Fq2(a, p - a)]
            + [Fq2(1 << k, 0) for k in ks] + [Fq2(0, 1 << k) for k in ks])
    x[: len(edge)] = get_cuda_quad_ec(p).ctx.words(edge, device)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIELDS) + ["Fq2"])
def test_cuda_inv_divsteps_matches_plain(cuda, name):
    """The divstep `inv` against the plain inverse (x^(p-2), over Fq2 of
    the norm) at batch_inv's 512-lane root and at 3 lanes: 0, 1, p - 1,
    R mod p (rows 0..15; over Fq2 the norm's edges), 2^k,
    x * inv(x) == 1."""
    if name == "Fq2":
        ec = get_cuda_quad_ec(fields.BN254_FQ)
        x = _fq2_inv_inputs(cuda)
    else:
        p = FIELDS[name]
        ec = get_cuda_ec(p)
        x = _elems(p, 512, 9, cuda)
        x[16:26] = ec.ctx.words([1 << k for k in (1, 29, 30, 31, 32, 60, 64, 128, 200, 253)],
                                cuda)
    ctx = ec.ctx
    before = ec.inv_launches
    got = ec.inv(x)
    assert _equal(got, ec.inv_plain(x))
    nz = ~ctx.is_zero(x)
    assert torch.equal(ec.mul(x, got)[nz],
                       ctx.one_mont(cuda).expand(int(nz.sum()), x.shape[1]))
    assert not got[~nz].any()
    x3 = x[1:4].contiguous()
    assert _equal(ec.inv(x3), ec.inv_plain(x3))
    assert ec.inv_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("field, a", [("Fq", 0), ("Fq", 0x1234567), ("Fq2", 0)],
                         ids=["a0", "a_nonzero", "fq2"])
def test_cuda_jdbl_n_fold_shapes_match_plain(cuda, field, a):
    """warp.cuh's `jdbl_n` (a warp a lane) over BN254 Fq (a = 0 and
    a != 0) and (two warps a lane) over Fq2 (a = 0) at the window combine's
    five shapes (16 lanes x 11 .. 1 lane x 176), identities (Z = 0)
    planted in lanes 3 and 5, then 100 lanes x 0, 1 and 3."""
    if field == "Fq2":
        ec = get_cuda_quad_ec(fields.BN254_FQ)
        pt = _planted_points(ec, 100, 17, cuda, lambda s: _elems2(100, s, cuda))[:3]
    else:
        ec = get_cuda_ec(fields.BN254_FQ, a)
        pt = _planted_points(ec, 100 + 16, 17, cuda)[:3]
    before = ec.jdbl_n_launches
    shapes = ((16, 11), (8, 22), (4, 44), (2, 88), (1, 176), (100, 0), (100, 1), (100, 3))
    for lanes, count in shapes:
        pl = tuple(t[:lanes].contiguous() for t in pt)
        assert _equal(ec.jdbl_n(*pl, count), ec.jdbl_n_plain(*pl, count)), (lanes, count)
    assert ec.jdbl_n_launches == before + len(shapes)


# The bucket aggregate's `jadd` launches of a chunk (25 windows of 1025
# buckets): the suffix sums (25,625 lanes), the weight tree's first and
# last levels (12,800 and 25), the window combine's first and last (16 and
# 1), and 2^17 lanes.
JADD_SHAPES = (25625, 12800, 25, 16, 1, 1 << 17)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", JADD_SHAPES)
@pytest.mark.parametrize("field, a", [("Fq", 0), ("Fq", 0x1234567), ("Fq2", 0)],
                         ids=["fq", "fq_a_nonzero", "fq2"])
def test_cuda_jadd_aggregate_shapes_match_plain(cuda, field, a, lanes):
    """warp.cuh's `jadd` (groups of 8 threads a product on the narrow
    levels, a thread a product on the wide ones) over BN254 Fq (a = 0 and
    a != 0) and over Fq2 (a = 0) at the aggregate's shapes, bit for bit
    against jadd_plain, with P == Q (twice), P == -Q, P at the identity, Q
    at the identity and both planted in lanes 0..5; the one-lane shape runs
    each of those lanes and a seeded one alone."""
    n = max(lanes, 7)
    if field == "Fq2":
        ec = get_cuda_quad_ec(fields.BN254_FQ)
        pq = _planted_points(ec, n, 23, cuda, lambda s: _elems2(n, s, cuda))
    else:
        ec = get_cuda_ec(fields.BN254_FQ, a)
        pq = _planted_points(ec, n + 16, 23, cuda)
    calls = [pq] if lanes >= 6 else [tuple(t[o:o + lanes].contiguous() for t in pq)
                                     for o in range(7)]
    before = ec.jadd_launches
    for args in calls:
        got = ec.jadd(*args)
        assert _equal(got, ec.jadd_plain(*args)), lanes
    if lanes >= 6:
        z = got[2]
        assert z[0].any() and not z[2].any() and not z[5].any()
        assert torch.equal(got[0][3], pq[3][3]) and torch.equal(got[0][4], pq[0][4])
    assert ec.jadd_launches == before + len(calls)


@pytest.mark.cuda
def test_cuda_prove_matches_native(cuda, monkeypatch):
    """A small circuit proved with the fold on the card (one 512-point chunk
    a problem at c = 11: `batch_inv`, with the divstep inversion on each
    root, and the warp `jdbl_n` among its kernels) equals the native
    configuration's proof, and verifies."""
    import random

    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.ops import msm

    def proof_ints(pr):
        b = pr.b
        return (tuple(pr.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(pr.c))

    r1cs, z = groth16.dummy_circuit(8, random.Random(3))
    pk = groth16.setup(r1cs, random.Random(4), device="cuda")
    ec = get_cuda_ec(fields.BN254_FQ)
    monkeypatch.setenv("CRESCENT_MSM_CHUNK", "512")
    msm.get_msm.cache_clear()  # an MSM reads its chunk size when it is made
    try:
        monkeypatch.setenv("CRESCENT_PROVE_MSM", "device")
        before = ec.launches()
        fold = groth16.prove(pk, r1cs, z, random.Random(7), device="cuda")
        after = ec.launches()
    finally:
        msm.get_msm.cache_clear()
    assert after["batch_inv"] > before["batch_inv"] and after["jdbl_n"] > before["jdbl_n"]
    assert after["inv"] == before["inv"]
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "native")
    native = groth16.prove(pk, r1cs, z, random.Random(7), device="cuda")
    assert proof_ints(fold) == proof_ints(native)
    assert groth16.verify(pk.vk.prepare(), fold, z[1 : r1cs.num_instance])


def _rows(n: int, width: int, seed: int, device) -> torch.Tensor:
    """(n, width) seeded canonical rows of Fq (8 words) or Fq2 (16), made
    in bulk."""
    p = fields.BN254_FQ
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, width), dtype=np.uint64)
    for top in range(7, width, 8):
        w[:, top] = rng.integers(0, p >> 224, size=n, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def _chunk_batch_inv_shapes() -> list[int]:
    """The leaves of a 2^17-point chunk's 22 batch_inv calls at c = 11:
    each round's two pair levels (2 mn and mn lanes)."""
    from crescent_tpu_torch.core.curves import BN254_G1
    from crescent_tpu_torch.ops.ec import get_curve_ctx
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    ctx = get_curve_ctx(BN254_G1)
    return [w for mn in AffineMSM(ctx, ctx.ec)._round_schedule(1 << 17) for w in (2 * mn, mn)]


def _check_batch_inv(ec, d, inv_floor: int, zero: int) -> None:
    """batch_inv on d with a zero planted at leaf `zero`: one launch, equal
    to batch_inv_plain and to the card's tree of mul and inv, the zero's
    run zeroed and the other leaves inverted."""
    from crescent_tpu_torch.ops.cuda_ec import batch_inv_tree, tree_halvings

    d = d.clone()
    d[zero] = 0
    before = ec.batch_inv_launches
    got = ec.batch_inv(d, inv_floor)
    assert ec.batch_inv_launches == before + 1
    assert _equal(got, ec.batch_inv_plain(d, inv_floor)), d.shape
    assert _equal(got, batch_inv_tree(ec.mul, ec.inv, d, inv_floor)), d.shape
    S = 1 << tree_halvings(d.shape[0], inv_floor)
    run = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    run[zero // S * S:(zero // S + 1) * S] = True
    assert not got[run].any()
    one = ec.ctx.one_mont(d.device).expand(int((~run).sum()), -1)
    assert torch.equal(ec.mul(d[~run].contiguous(), got[~run].contiguous()), one)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["Fq", "Fq2"])
def test_cuda_batch_inv_chunk_shapes_match_plain(cuda, field):
    """csrc/batch_inv.cuh over Fq and Fq2 at the distinct shapes of a
    chunk's 22 calls (2^21 down to 32,768 leaves, roots of 512 or 384
    lanes), on affine_denom output (1 on the invalid pairs) with a zero
    planted in run 1, against batch_inv_plain and the card's own tree."""
    from crescent_tpu_torch.ops.cuda_ec import tree_halvings

    ec = get_cuda_quad_ec(fields.BN254_FQ) if field == "Fq2" else get_cuda_ec(fields.BN254_FQ)
    shapes = sorted(set(_chunk_batch_inv_shapes()), reverse=True)
    assert len(_chunk_batch_inv_shapes()) == 22 and shapes[0] == 1 << 21
    n = shapes[0]
    lx, ly, rx, ry = (_rows(n, ec.WIDTH, 81 + k, cuda) for k in range(4))
    rng = np.random.default_rng(85)
    lv, rv = (torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)).to(cuda)
              for _ in range(2))
    d = ec.affine_denom(lx, ly, lv, rx, ry, rv)
    for lanes in shapes:
        _check_batch_inv(ec, d[:lanes], 512, (1 << tree_halvings(lanes, 512)) + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["Fq", "Fq2"])
@pytest.mark.parametrize("n, inv_floor", [(1 << 16, 512), (1 << 12, 512), (256, 256),
                                          (100, 512), (1, 512)])
def test_cuda_batch_inv_fixed_base_and_small_shapes(cuda, field, n, inv_floor):
    """batch_inv at the fixed base's shapes (a power of two, floor
    min(512, p2)) and at n <= inv_floor (a block a leaf), a zero planted."""
    ec = get_cuda_quad_ec(fields.BN254_FQ) if field == "Fq2" else get_cuda_ec(fields.BN254_FQ)
    d = _rows(n, ec.WIDTH, 91, cuda)
    d[n // 2:n // 2 + 1] = ec.ctx.one_mont(cuda)
    _check_batch_inv(ec, d, inv_floor, n // 3)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_cuda_chunk_batch_inv_launches(cuda, group):
    """One 2^17-point chunk at c = 11 on the card equals the native MSM,
    and its 11 rounds take 22 batch_inv launches and no mul or inv."""
    import functools
    import random

    from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    rng = random.Random(11)
    n = 1 << 17
    if group == "G1":
        ctx = get_curve_ctx(BN254_G1)
        pts = nb.fixed_base("bn254_g1", BN254_G1.generator,
                            [rng.randrange(1, ctx.n) for _ in range(n)])
        native = functools.partial(nb.msm, "bn254_g1")
    else:
        ctx = get_g2_ctx()
        pts = nb.fixed_base_g2(BN254G2.generator(), [rng.randrange(1, ctx.n) for _ in range(n)])
        native = nb.msm_g2
    ks = [rng.randrange(ctx.n) for _ in range(n)]
    P = ctx.points_to_device(pts, cuda)
    valid = torch.from_numpy(points_valid(pts)).to(cuda)
    sc = limb.limbs_to_words(limb.ints_to_limbs(ks), cuda)
    ec = ctx.ec
    before = ec.launches()
    res = AffineMSM(ctx, ec).run(P.x, P.y, valid, sc)
    after = ec.launches()
    assert ctx.points_to_host(JPoints(*(a[None] for a in res)))[0] == native(ks, pts)
    grew = {k: after[k] - before[k] for k in after}
    assert (grew["batch_inv"], grew["mul"], grew["inv"]) == (22, 0, 0)


def _planted_warp_pairs(ec, n: int, seed: int, device, warp: int = 16):
    """Affine pairs of n seeded lanes (about one side in 64 invalid) with the
    cases planted warp by warp, a warp being `warp` lanes of the kernel (16
    over Fq2: two threads a lane; 32 over Fq: one): warp w < `warp` holds
    L == R, L == -R, left only, right only, neither and L == R on an invalid
    side from position w on (each case at every position), the next four
    warps L == -R alone (no tangent lane), the four after them one L == R
    lane alone; then the same pattern again in the last warps of each 2^14
    lanes."""
    width = ec.WIDTH
    lx, ly, rx, ry = (_rows(n, width, seed + k, device) for k in range(4))
    rng = np.random.default_rng(seed + 9)
    lv, rv = (torch.from_numpy((rng.integers(0, 64, size=n) != 0).astype(np.int32)).to(device)
              for _ in range(2))
    cases = ("tangent", "opposite", "left_only", "right_only", "neither", "tangent_invalid")
    lanes = {c: [] for c in cases}
    warps = warp + 8
    for base in sorted({0} | set(range((1 << 14) - warps * warp, n - warps * warp + 1, 1 << 14))):
        for w in range(warps):
            plant = cases if w < warp else ("opposite",) if w < warp + 4 else ("tangent",)
            for k, case in enumerate(plant):
                i = base + warp * w + (w + k) % warp
                if i < n:
                    lanes[case].append(i)
    flags = {"left_only": (1, 0), "right_only": (0, 1), "neither": (0, 0),
             "tangent_invalid": (0, 1), "tangent": (1, 1), "opposite": (1, 1)}
    for case, idx in lanes.items():
        idx = torch.tensor(idx, dtype=torch.long, device=device)
        if case in ("tangent", "tangent_invalid", "opposite"):
            rx[idx] = lx[idx]
            ry[idx] = ec.ctx.neg_mod(ly[idx]) if case == "opposite" else ly[idx]
        lv[idx], rv[idx] = flags[case]
    return lx, ly, lv, rx, ry, rv


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["Fq", "Fq2"])
def test_cuda_affine_add_chunk_widths_match_plain(cuda, field):
    """`affine_add` over Fq (affine_add.cuh, one thread a lane, x^2 only
    on a warp with a valid tangent lane) and Fq2 (affine_add.cuh, two
    threads a lane, a half element each) at the widths of a chunk's 22
    pair-level calls and at 2^21 lanes, against affine_add_plain, the cases
    planted at every position of the kernel's warp (32 lanes over Fq, 16
    over Fq2), warps with one tangent lane and warps with none among them.
    The Fq kernel takes one design at every width, so it has no switch
    width to hold apart."""
    ec = get_cuda_quad_ec(fields.BN254_FQ) if field == "Fq2" else get_cuda_ec(fields.BN254_FQ)
    widths = _chunk_batch_inv_shapes()
    assert len(widths) == 22 and max(widths) == 1 << 21
    pair = _planted_warp_pairs(ec, 1 << 21, 97, cuda, 16 if field == "Fq2" else 32)
    inv = ec.inv(ec.affine_denom(*pair))  # a lane each: no batch_inv shape rule
    before = ec.affine_add_launches
    for lanes in sorted(set(widths), reverse=True):
        args = tuple(a[:lanes] for a in pair) + (inv[:lanes],)
        got = ec.affine_add(*args)
        assert _equal(got, ec.affine_add_plain(*args)), lanes
    assert got[2][:6].tolist() == [1, 0, 1, 1, 0, 1]  # warp 0 from position 0
    assert ec.affine_add_launches == before + len(set(widths))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 255, 256, 257, 511, 512, 513, 1024, 32767,
                                   32768, 32769, 1 << 17])
@pytest.mark.parametrize("field, a", [("Fq", 0), ("Fq", 0x1234567), ("Fq2", 0)],
                         ids=["a0", "a_nonzero", "fq2"])
def test_cuda_jdbl_lane_counts_match_plain(cuda, field, a, lanes):
    """`jdbl` over Fq, a = 0 and a != 0, and over Fq2, both on warp.cuh's
    `launch_jdbl_lanes` (the jdbl_n lane body, a warp a lane over Fq and
    two over Fq2, up to kJdblGroupLanesMax lanes; product threads above;
    over Fq one thread a lane from kJdblOneThreadLanesMin on), at 1
    (verify's public input), 31, 32, 33, 255, 256, 257 and 511, 512, 513
    (the group switches over Fq2 and Fq), 1,024 (the small MSM), 32,767,
    32,768, 32,769 (the one-thread switch over Fq) and 2^17 lanes,
    identities (Z = 0) planted in lanes 3 and 5 and the last: against
    jdbl_plain, and against jadd(P, P) off the identities, where the
    doubling must keep Z = 0; one lane runs a seeded lane and an identity
    alone."""
    n = max(lanes, 7)
    if field == "Fq2":
        ec = get_cuda_quad_ec(fields.BN254_FQ)
        pt = _planted_points(ec, n, 29, cuda, lambda s: _elems2(n, s, cuda))[:3]
    else:
        ec = get_cuda_ec(fields.BN254_FQ, a)
        pt = _planted_points(ec, n + 16, 29, cuda)[:3]
    pt[2][-1] = 0
    calls = [pt] if lanes > 1 else [tuple(t[o:o + 1].contiguous() for t in pt) for o in (0, 3)]
    before = ec.jdbl_launches
    for args in calls:
        got = ec.jdbl(*args)
        assert _equal(got, ec.jdbl_plain(*args)), lanes
        inf = args[2].eq(0).all(dim=1)
        assert not got[2][inf].any()
        fin = ~inf
        want = ec.jadd(*args, *args)
        assert all(torch.equal(g[fin], w[fin]) for g, w in zip(got, want))
    if lanes > 1:
        assert inf[3] and inf[5] and inf[-1] and int(inf.sum()) == 3
    assert ec.jdbl_launches == before + len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 64, 128, 256, 512, 513, 1024, 1025, 8192, 16383, 16384,
                                   32768])
def test_cuda_t256_jadd_jdbl_match_plain(cuda, lanes):
    """`jadd` and `jdbl` over T-256's base field (p >= 2^255, a = p - 3):
    warp.cuh's kWide instances (crescent_jadd_wide, crescent_jdbl_wide)
    against their plain versions at Spartan's widths (64 to 16,384 lanes)
    and at each executor's switch, P + P (a tangent with a != 0), P + (-P)
    and the identity planted, and coordinates whose Montgomery words are
    p - 1 and 2^255 (sums and products across 2^256); `jdbl` also against
    jadd(P, P) off the identities; `mul` by R^2 as points_to_device runs
    it."""
    from crescent_tpu_torch.core.curves import T256

    ec = get_cuda_ec(T256.p, T256.a)
    n = max(lanes, 16)
    x1, y1, z1, x2, y2, z2 = _planted_points(ec, n + 16, 37, cuda)
    top, half = (ec.ctx.words([v], cuda)[0] for v in (T256.p - 1, 1 << 255))
    z1[6], x1[7], x2[7], y1[8], z2[8] = top, top, top, half, half
    x1[9], y1[9], z1[9] = top, top, top
    x2[9], y2[9], z2[9] = top, top, top
    pq = tuple(t[:lanes].contiguous() for t in (x1, y1, z1, x2, y2, z2))
    before = ec.jadd_launches, ec.jdbl_launches
    assert _equal(ec.jadd(*pq), ec.jadd_plain(*pq))
    got = ec.jdbl(*pq[:3])
    assert _equal(got, ec.jdbl_plain(*pq[:3]))
    fin = pq[2].ne(0).any(dim=1)
    twice = ec.jadd(*pq[:3], *pq[:3])
    assert all(torch.equal(g[fin], w[fin]) for g, w in zip(got, twice))
    assert (ec.jadd_launches, ec.jdbl_launches) == (before[0] + 2, before[1] + 1)
    base = get_cuda_ec(T256.p)
    x = _elems(T256.p, lanes + 16, 41, cuda)
    r2 = base.ctx.const_words(base.ctx.r2, cuda)
    assert torch.equal(base.mul(x, r2), base.mul_plain(x, r2))


@pytest.mark.cuda
def test_cuda_t256_refuses_the_unlifted_kernels(cuda):
    """Over T-256 (p >= 2^255) every kernel but `mul`, `jadd` and `jdbl`
    refuses a CUDA tensor, naming ROADMAP Queue 2 item 1, and launches
    nothing."""
    from crescent_tpu_torch.core.curves import T256

    ec = get_cuda_ec(T256.p, T256.a)
    x = _elems(T256.p, 64, 3, cuda)
    flags = torch.ones(64, dtype=torch.int32, device=cuda)
    table = torch.zeros((8192, 16), dtype=torch.int32, device=cuda)
    calls = {
        "inv": lambda: ec.inv(x),
        "batch_inv": lambda: ec.batch_inv(x, 16),
        "affine_denom": lambda: ec.affine_denom(x, x, flags, x, x, flags),
        "affine_add": lambda: ec.affine_add(x, x, flags, x, x, flags, x),
        "jdbl_n": lambda: ec.jdbl_n(x, x, x, 2),
        "madd": lambda: ec.madd(x, x, x, x, x, flags, flags),
        "fixed_base": lambda: ec.fixed_base(table, x),
        "bucket_reduce": lambda: ec.bucket_reduce(x[:5], x[:5], x[:5], 1, 5),
        "butterfly": lambda: ec.butterfly(x, x, x),
    }
    before = ec.launches()
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 1"):
            call()
    assert ec.launches() == before
    assert set(calls) | {"mul", "jadd", "jdbl"} == set(ec.KERNELS)
