"""The port's MSM layers (crescent_tpu_torch/ops/msm.py, msm_affine.py,
ec.py) on the CPU, through the plain versions of the kernels, against the
reference's functions over its XLA adapter and against the native host MSM.

The same seeded inputs go through both packages; comparisons are exact
(tolerance 0) and include the lanes that hold no valid entry.  Reference
planes are (16, N) limb-major u32, the port's (N, 8) int32 word rows.

The reference's functions (``batch_inv``, ``_round1``, ``_round``,
``_scatter_dense``, ``_aggregate_dense``) run as they are, over the XLA
adapter's ops: ``XlaPEC`` for G1, ``QuadXlaPEC`` (32-row planes, Fq2) for
G2, whose (N, 16) word rows hold the same bytes.  XLA compiles every op anew for every lane count, and a round
has a dozen of them, so the adapter is wrapped (``_PaddedPEC``): each op pads
its planes to one fixed lane count with zeros, runs (``mul``, ``inv``,
``affine_denom`` and ``affine_add`` each jitted by itself; ``jadd`` and
``jdbl`` op by op, which is quicker than their compile) and cuts the result
back.  The ops are lane-wise, so the values are the adapter's own.  Its
``jdbl_n`` (a compiled loop for every count) is its ``jdbl`` applied count
times, which has the same body.  ``_aggregate_dense`` is held on a table of
three windows, unfused and fused (``bucket_reduce``).  G2's MSM is also
held against the native host G2 MSM, through ``run_device`` (one chunk and
two) and the repaired ``run_host``.

The group law of ``CurveCtx`` (``double``, ``add``, ``add_mixed``,
``scalar_mul``) and the direct path of ``run_device`` for small N run
through the plain versions of ``jdbl``, ``jadd`` and ``madd``: over G1
against the reference's ``CurveCtx`` (one jitted program) and the host,
over G2 against the host group law and the native G2 MSM (the reference's
Fq2 group law compiles for over a minute on a CPU, its ``_small`` for two;
its formula bodies are held against the port's Fq2 point ops in
tests/test_torch_quadratic.py).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254_G1 as REF_G1
from crescent_tpu.ops import ec as ref_ec
from crescent_tpu.ops import msm as ref_msm
from crescent_tpu.ops import msm_affine as ref_affine
from crescent_tpu.ops.xla_pec import QuadXlaPEC, XlaPEC
from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops import msm as port_msm
from crescent_tpu_torch.ops import msm_affine as port_affine
from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid
from crescent_tpu_torch.utils.pointvec import ArrayPointVec

P = BN254_G1.p
C = 5            # window width of the small MSMs: W = 53 windows of B = 17 buckets
FLOOR = 16       # min_bucket and inv_floor of the small MSMs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(seed: int, n: int, mod: int) -> list[int]:
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int("".join(f"{int(x):08x}" for x in r), 16) % mod for r in w]


def _problem(seed: int, n: int):
    """n seeded affine points and scalars with the cases planted: an
    identity, a zero scalar, -1, the same point twice (L == R in its
    bucket) and a point with its negative (L == -R)."""
    pts = nb.fixed_base("bn254_g1", BN254_G1.generator,
                        [k or 1 for k in _ints(seed, n, BN254_G1.n)])
    ks = _ints(seed + 1, n, BN254_G1.n)
    pts[1] = None
    ks[2] = 0
    ks[3] = BN254_G1.n - 1
    pts[5], ks[5] = pts[4], ks[4]
    pts[7], ks[7] = BN254_G1.neg(pts[6]), ks[6]
    return pts, ks


def _g2_problem(seed: int, n: int):
    """`_problem` on G2: n seeded affine G2 points and Fr scalars with the
    same cases planted."""
    pts = nb.fixed_base_g2(BN254G2.generator(), [k or 1 for k in _ints(seed, n, BN254G2.n)])
    ks = _ints(seed + 1, n, BN254G2.n)
    pts[1] = None
    ks[2] = 0
    ks[3] = BN254G2.n - 1
    pts[5], ks[5] = pts[4], ks[4]
    pts[7], ks[7] = BN254G2.neg(pts[6]), ks[6]
    return pts, ks


def _limbs(t: torch.Tensor) -> np.ndarray:
    """(N, 8) or (N, 16) words -> (N, 16) or (N, 32) limbs (an Fq2 row:
    c0's limbs, then c1's)."""
    return limb.words_to_limbs(t.reshape(-1, 8)).reshape(t.shape[0], -1)


def _to_ref(t: torch.Tensor):
    """(N, 8) words -> (16, N) u32 plane, (N, 16) -> (32, N); (N,) ints ->
    (N,) u32."""
    if t.dim() == 2:
        return jnp.asarray(_limbs(t).T.copy())
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(jax.device_get(want))
    if got.dim() == 2:
        np.testing.assert_array_equal(_limbs(got), want.T)
    else:
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


class _PaddedPEC(XlaPEC):
    """The XLA adapter with every op run at one fixed lane count."""

    BASE = XlaPEC

    def __init__(self, lanes: int, inv_lanes: int, jit: bool):
        self._init_base()
        self.lanes, self.inv_lanes = lanes, inv_lanes
        wrap = jax.jit if jit else (lambda f: f)
        self._ops = {name: wrap(getattr(self.BASE, name).__get__(self))
                     for name in ("mul", "inv", "affine_denom", "affine_add", "jadd", "jdbl")}

    def _init_base(self):
        XlaPEC.__init__(self, P, 0)

    def _call(self, name: str, args, lanes=None):
        lanes = lanes or self.lanes
        n = args[0].shape[-1]
        assert n <= lanes, (name, n, lanes)
        padded = [jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, lanes - n)]) for a in args]
        outs = self._ops[name](*padded)
        if isinstance(outs, (tuple, list)):
            return tuple(o[..., :n] for o in outs)
        return outs[..., :n]

    def mul(self, x, y):
        return self._call("mul", (x, y))

    def inv(self, x):
        return self._call("inv", (x,), self.inv_lanes)

    def affine_denom(self, *a):
        return self._call("affine_denom", a)

    def affine_add(self, *a):
        return self._call("affine_add", a)

    def jadd(self, *a):
        return self._call("jadd", a)

    def jdbl(self, *a):
        return self._call("jdbl", a)

    def jdbl_n(self, x1, y1, z1, count: int):
        for _ in range(count):
            x1, y1, z1 = self.jdbl(x1, y1, z1)
        return x1, y1, z1


class _PaddedQuadPEC(_PaddedPEC, QuadXlaPEC):
    """The same over Fq2: QuadXlaPEC's field, inverse and 32-row planes."""

    BASE = QuadXlaPEC

    def _init_base(self):
        QuadXlaPEC.__init__(self, P)


class _PortQuadPEC:
    """The port's plain Fq2 ``jadd`` and ``jdbl_n`` behind the adapter's
    interface on 32-row planes, for the reference's ``_aggregate_dense``
    over G2.  The adapter's own Fq2 ops there, op by op, take over a minute
    on a CPU; these equal them bit for bit on the case zoo
    (tests/test_torch_quadratic.py), so what the comparison holds is the
    pipeline around them: table layout, shifts, the weight tree and the
    window combine at 32 rows."""

    ROWS = 32

    def __init__(self):
        self.ec = get_g2_ctx().ec

    @staticmethod
    def _words(a) -> torch.Tensor:
        a = np.asarray(jax.device_get(a))
        return limb.limbs_to_words(a.T.reshape(-1, 16)).reshape(a.shape[1], 16)

    def jadd(self, *a):
        return tuple(_to_ref(o) for o in self.ec.jadd(*map(self._words, a)))

    def jdbl_n(self, x1, y1, z1, count: int):
        return tuple(_to_ref(o) for o in self.ec.jdbl_n(*map(self._words, (x1, y1, z1)),
                                                          count))


N1 = 32          # points of the round tests: 32 * 53 = 1696 sorted entries


@pytest.fixture(scope="module")
def pair():
    """The port's and the reference's AffineMSM at the small parameters."""
    ctx = get_curve_ctx(BN254_G1)
    port = port_affine.AffineMSM(ctx, ctx.ec, c=C, min_bucket=FLOOR, inv_floor=FLOOR)
    lanes = 2 * port._round_schedule(N1)[0]  # the widest pair level
    ref = ref_affine.AffineMSM(ref_ec.get_curve_ctx(REF_G1),
                               _PaddedPEC(lanes, FLOOR, jit=True), c=C,
                               min_bucket=FLOOR, inv_floor=FLOOR)
    return port, ref


@pytest.fixture(scope="module")
def pair_g2():
    """`pair` on G2: the port's AffineMSM over CudaQuadEC and the
    reference's over QuadXlaPEC (rows = 32)."""
    ctx = get_g2_ctx()
    port = port_affine.AffineMSM(ctx, ctx.ec, c=C, min_bucket=FLOOR, inv_floor=FLOOR)
    lanes = 2 * port._round_schedule(N1)[0]
    ref = ref_affine.AffineMSM(ref_ec.get_g2_ctx(), _PaddedQuadPEC(lanes, FLOOR, jit=True),
                               c=C, min_bucket=FLOOR, inv_floor=FLOOR)
    return port, ref


def _sorted(port, pts, ks):
    """A problem up to the sort, in the port's tensors: (spk, spay, tx, ty,
    n)."""
    n = len(pts)
    ctx = port.ctx
    Pd = ctx.points_to_device(pts, "cpu")
    valid = torch.from_numpy(points_valid(pts))
    digits, signs = port_msm.scalar_digits_signed(limb.limbs_to_words(limb.ints_to_limbs(ks)), C)
    ok = (digits != 0) & (valid[:, None] != 0)
    keys = torch.where(ok, torch.arange(port.W)[None, :] * port.B + digits,
                       torch.full_like(digits, port.sentinel))
    pk = (keys * 2 + ok.to(torch.int64)).reshape(-1)
    pay = ((torch.arange(n)[:, None] << 1) | signs).reshape(-1)
    spk, order = torch.sort(pk, stable=True)
    tx = torch.cat([Pd.x, Pd.x])
    ty = torch.cat([Pd.y, ctx.fctx.neg_mod(Pd.y)])
    return spk, pay[order], tx, ty, n


@pytest.fixture(scope="module")
def sorted_entries(pair):
    """A 32-point problem up to the sort."""
    return _sorted(pair[0], *_problem(21, N1))


@pytest.fixture(scope="module")
def sorted_entries_g2(pair_g2):
    """A 32-point G2 problem up to the sort."""
    return _sorted(pair_g2[0], *_g2_problem(22, N1))


@pytest.mark.parametrize("c", [5, 8, 11, 16])
def test_scalar_digits_signed_matches_reference(c):
    ks = _ints(31 + c, 24, BN254_G1.n)
    ks[:3] = [0, BN254_G1.n - 1, (1 << 256) - 1]  # full width: the carry window
    digs, signs = port_msm.scalar_digits_signed(limb.get_ctx(P).words(ks), c)
    rd, rs = ref_msm.digits_signed_jit(jnp.asarray(limb.ints_to_limbs(ks)), c)
    np.testing.assert_array_equal(digs.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(rs))
    half = 1 << (c - 1)
    for k, d, s in zip(ks, digs.tolist(), signs.tolist()):
        assert all(0 <= x <= half for x in d)
        assert sum((-x if sg else x) << (c * w) for w, (x, sg) in enumerate(zip(d, s))) == k


def test_quantize_and_round_schedule_match_reference(pair):
    for floor in (16, 512):
        for n in list(range(1, 70)) + [511, 512, 513, 1000, 4097, 1 << 17, 3276800, 838483]:
            assert port_affine.quantize(n, floor) == ref_affine.quantize(n, floor)
    port, ref = pair
    assert (port.W, port.B, port.sentinel) == (ref.W, ref.B, ref.sentinel)
    for n in (16, 32, 48, 512, 1 << 17):
        assert port._round_schedule(n) == ref._round_schedule(n)
    ctx = port.ctx
    big = port_affine.AffineMSM(ctx, ctx.ec)  # the prove path's parameters
    assert (big.c, big.W, big.B, big.min_bucket, big.inv_floor) == (11, 25, 1025, 512, 512)
    assert big._round_schedule(1 << 17)[0] == 1 << 20


def test_batch_inv_matches_reference(pair):
    port, ref = pair
    ctx = port.ctx
    vals = [v or 1 for v in _ints(41, 96, P)]  # 96 -> 48 -> 24 -> 12 lanes
    d = limb.limbs_to_words(ctx.fctx.to_mont_host(vals))
    got = port_affine.batch_inv(ctx.ec, d, inv_floor=FLOOR)
    _same(got, ref_affine.batch_inv(ref.pec, _to_ref(d), FLOOR))
    assert ctx.fctx.from_mont_host(limb.words_to_limbs(got)) == [pow(v, -1, P) for v in vals]


def _check_rounds(pair, sorted_entries):
    port, ref = pair
    spk, spay, tx, ty, n = sorted_entries
    m1, m2 = port._round_schedule(n)[:2]
    pk1, x1, y1 = port._round1(spk, spay, tx, ty, m1, n)
    txy = jnp.concatenate([_to_ref(tx), _to_ref(ty)], axis=0)
    rpk1, rx1, ry1 = ref._round1(_to_ref(spk), _to_ref(spay), txy, m1, n)
    _same(pk1, rpk1), _same(x1, rx1), _same(y1, ry1)
    pk2, x2, y2 = port._round(pk1, x1, y1, m2)
    rpk2, rx2, ry2 = ref._round(rpk1, rx1, ry1, m2)
    _same(pk2, rpk2), _same(x2, rx2), _same(y2, ry2)
    assert int((pk2 & 1).sum()) < int((pk1 & 1).sum()) < int((spk & 1).sum())


def test_round1_and_round_match_reference(pair, sorted_entries):
    _check_rounds(pair, sorted_entries)


def test_g2_round1_and_round_match_reference(pair_g2, sorted_entries_g2):
    """The first two rounds on G2: (N, 16) Fq2 rows against the reference's
    32-row planes."""
    _check_rounds(pair_g2, sorted_entries_g2)


_REF_AGGREGATE = {}  # the reference's aggregate, once per group and process


def _check_aggregate(ctx, ref_ctx, ref_pec, curve, pts, fused=False):
    """Scatter and aggregate of a three-window table (c = 3, five buckets a
    window), seeded survivors in some buckets and none in others; `fused`:
    the port's through ``bucket_reduce``, which must also equal its own
    unfused aggregate, in Jacobian form."""
    port = port_affine.AffineMSM(ctx, ctx.ec, c=3)
    ref = ref_affine.AffineMSM(ref_ctx, ref_pec, c=3)
    port.W = ref.W = 3
    port.sentinel = ref.sentinel = 3 * port.B
    Pd = ctx.points_to_device(pts, "cpu")
    # survivors: key << 1 | valid; two lanes hold nothing
    keys = [1, 2, 4, 6, 8, 9, 13, 15]
    pk = torch.tensor([k * 2 + 1 for k in keys[:6]] + [2 * port.sentinel] * 2)
    dense = port._scatter_dense(pk, Pd.x, Pd.y, fused)
    if ctx.name not in _REF_AGGREGATE:
        rdense = ref._scatter_dense(_to_ref(pk), _to_ref(Pd.x), _to_ref(Pd.y))
        _REF_AGGREGATE[ctx.name] = rdense, ref._aggregate_dense(*rdense)
    rdense, want = _REF_AGGREGATE[ctx.name]
    for got, w in zip(dense, rdense):
        _same(got, w)
    got = port._aggregate_dense(*dense, fused)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_limbs(g[None])[0], np.asarray(w).reshape(-1))
    if fused:
        for g, w in zip(got, port._aggregate_dense(*dense)):
            assert torch.equal(g, w)
    # sum over windows w and buckets b of b * 2^(3w) * S[w, b]
    host = None
    for k, p in zip(keys[:6], pts):
        w, b = divmod(k, port.B)
        host = curve.add(host, curve.mul(b << (3 * w), p))
    assert ctx.points_to_host(JPoints(*(a[None] for a in got)))[0] == host


def test_aggregate_dense_matches_reference():
    _check_aggregate(get_curve_ctx(BN254_G1), ref_ec.get_curve_ctx(REF_G1),
                     _PaddedPEC(15, 15, jit=False), BN254_G1,
                     nb.fixed_base("bn254_g1", BN254_G1.generator, [3, 5, 7, 11, 13, 17, 19, 23]))


def test_g2_aggregate_dense_matches_reference():
    """The reference's scatter and aggregate at 32 rows, over the port's
    Fq2 point ops (``_PortQuadPEC``)."""
    _check_aggregate(get_g2_ctx(), ref_ec.get_g2_ctx(), _PortQuadPEC(), BN254G2,
                     nb.fixed_base_g2(BN254G2.generator(), [3, 5, 7, 11, 13, 17, 19, 23]))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fused_aggregate_matches_unfused_and_reference(group):
    """``_aggregate_dense(fused=True)``: the suffix sums and the weighting
    by ``bucket_reduce`` (its plain version here) equal the port's unfused
    aggregate and the reference's, bit for bit in Jacobian form."""
    ks = [3, 5, 7, 11, 13, 17, 19, 23]
    if group == "g1":
        _check_aggregate(get_curve_ctx(BN254_G1), ref_ec.get_curve_ctx(REF_G1),
                         _PaddedPEC(15, 15, jit=False), BN254_G1,
                         nb.fixed_base("bn254_g1", BN254_G1.generator, ks), fused=True)
    else:
        _check_aggregate(get_g2_ctx(), ref_ec.get_g2_ctx(), _PortQuadPEC(), BN254G2,
                         nb.fixed_base_g2(BN254G2.generator(), ks), fused=True)


def test_fused_aggregate_switch(pair, monkeypatch):
    """CRESCENT_MSM_FUSED_AGG=1 sends a chunk's scatter and aggregate the
    fused way (the reference's switch, msm_affine.py:284-297)."""
    port, _ = pair
    seen = []
    monkeypatch.setattr(port, "_scatter_dense", lambda pk, ex, ey, fused: (pk, ex, fused))
    monkeypatch.setattr(port, "_aggregate_dense", lambda *a: seen.append(a))
    for env in ("0", "1"):
        monkeypatch.setenv("CRESCENT_MSM_FUSED_AGG", env)
        port._aggregate(1, 2, 3)
    assert seen == [(1, 2, False, False), (1, 2, True, True)]


def test_affine_msm_run_matches_native(pair):
    """One whole AffineMSM.run, reached as a user reaches it: run_host ->
    run_device (40 points padded to 64, one chunk) -> AffineMSM.run."""
    port, _ = pair
    m = port_msm.MSM(BN254_G1, affine_c=C, small_cutoff=8, max_chunk=64)
    m._affine = port                     # the small floors, for the CPU
    pts, ks = _problem(51, 40)
    got = m.run_host(ks, pts, device="cpu")
    assert got == nb.msm("bn254_g1", ks, pts) == BN254_G1.msm(ks, pts)
    ec = m.ctx.ec
    assert ec.launches() == dict.fromkeys(ec.launches(), 0)  # CPU: no kernel


def test_g2_run_host_matches_native(pair_g2):
    """G2's MSM at the small parameters, against the native host G2 MSM:
    run_host -> run_device -> one AffineMSM.run of 32 points.  run_host
    makes Fr words of the scalars whatever the curve's field.  (Two chunks
    added by the Fq2 jadd: the G2 MSM of tests/test_torch_groth16.py's
    prove under CRESCENT_NATIVE=0.)"""
    port, _ = pair_g2
    pts, ks = _g2_problem(91, 32)
    m = port_msm.MSM(get_g2_ctx(), affine_c=C, small_cutoff=8, max_chunk=32)
    m._affine = port                     # the small floors, for the CPU
    assert m.run_host(ks, pts, device="cpu") == nb.msm_g2(ks, pts)
    ec = m.ctx.ec
    assert ec.launches() == dict.fromkeys(ec.launches(), 0)  # CPU: no kernel


def _check_chunks_add_up(ctx, problem, native):
    """run_device above max_chunk: the problem is padded to whole chunks,
    cut into them, and the chunks' Jacobian results are added up by a tree
    of jadd (four chunks, three, where one is carried over a level, and
    two).  The chunk MSM here is a stand-in that answers from the native
    host MSM, so that what is tested is the cutting and the adding."""

    class HostChunk:
        """AffineMSM.run answered by the native host MSM."""

        calls = 0

        def run(self, px, py, pvalid, sc):
            HostChunk.calls += 1
            z = torch.where(pvalid[:, None] != 0, ctx.fctx.one_mont("cpu"),
                            torch.zeros((), dtype=torch.int32))
            pts = ctx.points_to_host(JPoints(px, py, z))
            ks = limb.limbs_to_ints(limb.words_to_limbs(sc))
            res = native(ks, pts)
            return JPoints(*(a[0] for a in ctx.points_to_device([res], "cpu")))

    for n, chunk, want_calls in ((16, 4, 4), (9, 4, 3), (12, 6, 2)):
        pts, ks = problem(81 + n, n)
        m = port_msm.MSM(ctx, small_cutoff=2, max_chunk=chunk)
        m._affine = HostChunk()
        HostChunk.calls = 0
        assert m.run_host(ks, pts, device="cpu") == native(ks, pts)
        assert HostChunk.calls == want_calls


def test_run_device_adds_up_its_chunks():
    _check_chunks_add_up(get_curve_ctx(BN254_G1), _problem,
                         lambda ks, pts: nb.msm("bn254_g1", ks, pts))


def test_g2_run_device_adds_up_its_chunks():
    """The same on G2: the chunks' results added by the Fq2 jadd."""
    _check_chunks_add_up(get_g2_ctx(), _g2_problem, nb.msm_g2)


def test_run_device_fold_of_three_chunks_matches_native(pair, monkeypatch):
    """One problem of three chunks, the last one padded; the table goes up
    through the array path of points_to_device."""
    port, _ = pair
    monkeypatch.setenv("CRESCENT_MSM_CHUNK", "32")
    m = port_msm.MSM(BN254_G1, affine_c=C, small_cutoff=8)
    assert m.max_chunk == 32
    m._affine = port                     # the small floors, for the CPU
    n = 72
    pts, ks = _problem(61, n)
    ctx = m.ctx
    vec = ArrayPointVec.from_points(pts)  # the array path of points_to_device
    Pd = ctx.points_to_device(vec, "cpu")
    keep = torch.from_numpy(points_valid(vec)).bool()  # an identity's x, y are free
    for a, b in zip(Pd, ctx.points_to_device(pts, "cpu")):
        assert torch.equal(a[keep], b[keep])
    assert not Pd.z[~keep].any() and not keep[1]
    valid = torch.from_numpy(points_valid(vec))
    sc = ctx.fctx.words(ks)
    fold = m.run_device_fold([(Pd.x, Pd.y, valid, sc)])
    got = ctx.points_to_host(JPoints(*(torch.stack(c) for c in zip(*fold))))
    assert got == [nb.msm("bn254_g1", ks, pts)]
    # eight points, at the cutoff: the direct path
    res = m.run_device(Pd.x[:8], Pd.y[:8], valid[:8], sc[:8])
    assert ctx.points_to_host(JPoints(*(a[None] for a in res))) == [
        nb.msm("bn254_g1", ks[:8], pts[:8])]


def test_points_round_trip_and_identity():
    ctx = get_curve_ctx(BN254_G1)
    pts, _ = _problem(71, 8)
    Pd = ctx.points_to_device(pts, "cpu")
    assert ctx.points_to_host(Pd) == pts
    ident = ctx.identity((3,))
    assert ctx.points_to_host(ident) == [None] * 3
    want = ref_ec.get_curve_ctx(REF_G1).identity((3,))
    for g, w in zip(ident, want):
        np.testing.assert_array_equal(limb.words_to_limbs(g), np.asarray(w))
    rP = ref_ec.get_curve_ctx(REF_G1).points_to_device(pts)
    for g, w in zip(Pd, rP):
        np.testing.assert_array_equal(limb.words_to_limbs(g), np.asarray(w))


# -- the group law of CurveCtx and the direct path for small N -------------------

def _group(name: str):
    """(port ctx, host curve, seeded affine points) of G1 or G2."""
    if name == "g1":
        return (get_curve_ctx(BN254_G1), BN254_G1,
                lambda ks: nb.fixed_base("bn254_g1", BN254_G1.generator, ks))
    return get_g2_ctx(), BN254G2, lambda ks: nb.fixed_base_g2(BN254G2.generator(), ks)


def _zoo(name: str):
    """Eight lanes of each group law's cases, as the port's batches.

    P, Q Jacobian, each lane scaled to another Z: generic, P == Q (the same
    triple), P == -Q, P the identity, Q the identity, both, P == Q through
    another Z, generic.  Q's affine rows and q_valid for add_mixed: lane 7
    has q_valid == 0.  Scalars for scalar_mul of P: 0, 1, n - 1, the rest
    seeded."""
    ctx, curve, make = _group(name)
    f = ctx.fctx
    pp = make([k or 1 for k in _ints(301, 8, curve.n)])
    qq = make([k or 1 for k in _ints(302, 8, curve.n)])
    qq[1] = qq[6] = None
    qq[2] = curve.neg(pp[2])
    pp[3] = None
    qq[4] = None
    pp[5] = qq[5] = None
    qq[1], qq[6] = pp[1], pp[6]
    lams = [ctx.points_to_device(make([k or 1 for k in _ints(s, 8, curve.n)]), "cpu").x
            for s in (303, 304)]

    def scaled(pts, lam):
        A = ctx.points_to_device(pts, "cpu")
        l2 = f.mont_sqr(lam)
        return JPoints(f.mont_mul(A.x, l2), f.mont_mul(A.y, f.mont_mul(l2, lam)),
                       f.mont_mul(A.z, lam))

    P, Q = scaled(pp, lams[0]), scaled(qq, lams[1])
    for t in Q:
        t[1] = 0
    Q = JPoints(*(torch.where(torch.arange(8)[:, None] == 1, p, q) for p, q in zip(P, Q)))
    A = ctx.points_to_device(qq, "cpu")
    qv = torch.from_numpy(points_valid(qq))
    qv[7] = 0
    ks = [0, 1, curve.n - 1] + _ints(305, 5, curve.n)
    return ctx, curve, pp, qq, P, Q, A, qv, ks


def _affine(ctx, P) -> list:
    return ctx.points_to_host(P)


@pytest.fixture(scope="module")
def ref_g1():
    """The reference's CurveCtx group law over G1 on the zoo, as one jitted
    program: (double, add, add_mixed, scalar_mul) as the port's word
    tensors."""
    ctx, _, _, _, P, Q, A, qv, ks = _zoo("g1")
    rctx = ref_ec.get_curve_ctx(REF_G1)

    def lim(t):
        return jnp.asarray(_limbs(t))

    @jax.jit
    def run(P, Q, ax, ay, av, k):
        P, Q = ref_ec.JPoints(*P), ref_ec.JPoints(*Q)
        return (rctx.double(P), rctx.add(P, Q), rctx.add_mixed(P, ax, ay, av),
                rctx.scalar_mul(k, P))

    k = jnp.asarray(limb.ints_to_limbs(ks))
    outs = run(tuple(map(lim, P)), tuple(map(lim, Q)), lim(A.x), lim(A.y),
               jnp.asarray(qv.numpy().astype(np.uint32)), k)
    return [JPoints(*(limb.limbs_to_words(np.asarray(c).reshape(-1, 16)) for c in o))
            for o in outs]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_law_matches_reference(group, request):
    """double, add, add_mixed and scalar_mul of the port's CurveCtx (the
    plain jdbl, jadd and madd) on the zoo: in affine form against the host
    group law; over G1 also against the reference's CurveCtx, bit for bit
    in Jacobian form."""
    ctx, curve, pp, qq, P, Q, A, qv, ks = _zoo(group)
    sc = limb.limbs_to_words(limb.ints_to_limbs(ks))
    got = [ctx.double(P), ctx.add(P, Q), ctx.add_mixed(P, A.x, A.y, qv),
           ctx.scalar_mul(sc, P)]
    qm = [q if v else None for q, v in zip(qq, qv.tolist())]
    want = [[curve.add(p, p) for p in pp], [curve.add(p, q) for p, q in zip(pp, qq)],
            [curve.add(p, q) for p, q in zip(pp, qm)],
            [None if p is None else curve.mul(k, p) for p, k in zip(pp, ks)]]
    for g, w in zip(got, want):
        assert _affine(ctx, g) == w
    assert _affine(ctx, got[1])[2] is None and _affine(ctx, got[3])[0] is None
    # batches of any shape: a (2, 4) batch gives the same rows
    two = JPoints(*(t.reshape(2, 4, -1) for t in P))
    assert all(torch.equal(a.reshape(8, -1), b) for a, b in zip(ctx.double(two), got[0]))
    if group == "g1":
        for g, w in zip(got, request.getfixturevalue("ref_g1")):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
    ec = ctx.ec
    assert ec.launches() == dict.fromkeys(ec.launches(), 0)  # CPU: no kernel


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_small_run_device_matches_reference(group, request):
    """run_device at N <= small_cutoff: the zoo's eight points P (two of
    them the identity; scalars 0, 1 and n - 1 among them) take the direct
    path (scalar_mul, then a jadd tree).  The point equals the native MSM
    and, over G1, the sum of the reference's scalar_mul products of the
    same points (what the reference's ``_small`` folds), in affine form."""
    ctx, curve, pp, _, P, _, _, _, ks = _zoo(group)
    m = port_msm.get_msm(BN254_G1) if group == "g1" else port_msm.get_g2_msm()
    assert m.small_cutoff == 1024
    A = ctx.points_to_device(pp, "cpu")
    valid = torch.from_numpy(points_valid(pp))
    res = m.run_device(A.x, A.y, valid, limb.limbs_to_words(limb.ints_to_limbs(ks)))
    got = _affine(ctx, JPoints(*(a[None] for a in res)))
    native = nb.msm("bn254_g1", ks, pp) if group == "g1" else nb.msm_g2(ks, pp)
    assert got == [native] and native is not None
    if group == "g1":
        acc = None
        for p in _affine(ctx, request.getfixturevalue("ref_g1")[3]):
            acc = curve.add(acc, p)
        assert got == [acc]
