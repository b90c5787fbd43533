"""The port's scan Pippenger and run_device_many (crescent_tpu_torch/ops/msm.py)
and prove under CRESCENT_PROVE_FUSED=0 on the CPU, through the plain
versions of the kernels, against the reference.

G1: the port's ``MSM(c=8, lanes=16, small_cutoff=0)`` on the scan route
(CRESCENT_MSM_AFFINE=0) against the reference's MSM of the same settings,
``run_device`` as tests/test_ec_msm_ntt.py:76-90 runs it (on a CPU the
reference has no affine route, so that is its scan Pippenger, XLA's form),
on 200 points with the cases planted, as there.  That program compiles for about a
minute here and runs for seconds, so it is compiled once: the other
holds are against its result and the native host MSM, the reference's own
oracle.  ``run_device_many`` over three unequal problems (one scan over
the batch) gives the native MSM's points; the reference's
``run_device_many`` is the same program under ``vmap``, whose compile
takes another minute.  G2: the reference's
Fq2 scan compiles for minutes on a CPU, so the port's G2 scan (the Fq2
``madd`` and ``jadd``) is held against the native host G2 MSM.  Those
run at a window width of 4 or 5: the point does not depend on it, and at
c = 8 every run takes about 800 calls of the plain versions, whose cost
grows with the bucket additions, N x (256 / c + 2).  Both forms
of phases 1-2 (the kernel form and the XLA form under
CRESCENT_MSM_PALLAS=0) give the same (x, y, z); the two switches are read
as the reference reads them.  ``prove`` under CRESCENT_PROVE_FUSED=0 gives
the reference's proof for the same r and s, on the scan route (the four G1
MSMs in one batch) and on the affine route (one problem after another).

Inputs are made from seeds; comparisons are exact (tolerance 0): points in
affine form, proofs as ints.
"""

import random

import numpy as np
import pytest
import torch

from crescent_tpu.core.curves import BN254_G1 as REF_G1
from crescent_tpu.models import groth16 as ref
from crescent_tpu.ops import msm as ref_msm
from crescent_tpu_torch.convert import proving_key_from_reference
from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
from crescent_tpu_torch.models import groth16 as port
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops import msm as port_msm
from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid

LANES = 16      # the reference test's lane cap


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _scan_route(monkeypatch):
    monkeypatch.setenv("CRESCENT_MSM_AFFINE", "0")


def _ints(seed: int, n: int, mod: int) -> list[int]:
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int("".join(f"{int(x):08x}" for x in r), 16) % mod for r in w]


def _problem(curve, make, seed: int, n: int):
    """n seeded affine points and scalars with the cases planted: an
    identity, a zero scalar, 1, -1 (negative digits in every window), the
    same point twice (P == Q in its buckets) and a point with its negative
    (P == -Q)."""
    pts = make([k or 1 for k in _ints(seed, n, curve.n)])
    ks = _ints(seed + 1, n, curve.n)
    pts[1] = None
    ks[2], ks[8] = 0, 1
    ks[3] = curve.n - 1
    pts[5], ks[5] = pts[4], ks[4]
    pts[7], ks[7] = curve.neg(pts[6]), ks[6]
    return pts, ks


def _g1_problem(seed: int, n: int):
    return _problem(BN254_G1, lambda ks: nb.fixed_base("bn254_g1", BN254_G1.generator, ks),
                    seed, n)


def _planes(ctx, pts, ks):
    P = ctx.points_to_device(pts, "cpu")
    return (P.x, P.y, torch.from_numpy(points_valid(pts)),
            limb.limbs_to_words(limb.ints_to_limbs([k % ctx.n for k in ks])))


def _host(ctx, res) -> list:
    return ctx.points_to_host(JPoints(*(a.reshape(-1, a.shape[-1]) for a in res)))


@pytest.fixture(scope="module")
def g1_case():
    """200 G1 points: the port's point on the scan route at c = 8 and the
    reference's (run_host, its scan route on a CPU)."""
    pts, ks = _g1_problem(1, 200)
    ctx = get_curve_ctx(BN254_G1)
    m = port_msm.MSM(ctx, c=8, lanes=LANES, small_cutoff=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRESCENT_MSM_AFFINE", "0")
        got = _host(ctx, m.run_device(*_planes(ctx, pts, ks)))[0]
    want = ref_msm.MSM(REF_G1, c=8, lanes=LANES, small_cutoff=0).run_host(ks, pts)
    return pts, ks, got, want


def test_scan_msm_g1_matches_reference(g1_case):
    pts, ks, got, want = g1_case
    assert got == want == nb.msm("bn254_g1", ks, pts)
    assert got is not None


def test_run_device_many_matches_native():
    """Three problems of unequal N (100, 60 and 9 points) in one batch,
    padded to 128: one scan over 3 x 8 lanes a step (c = 4), each result
    the native MSM's."""
    pts, ks = _g1_problem(3, 100)
    probs = [(pts, ks), _g1_problem(5, 60), (pts[:9], ks[50:59])]
    ctx = get_curve_ctx(BN254_G1)
    scans = []
    impl = port_msm._msm_impl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_msm, "_msm_impl",
                   lambda ctx, px, *a, **kw: scans.append(px.shape) or impl(ctx, px, *a, **kw))
        res = port_msm.MSM(ctx, c=4, lanes=LANES, small_cutoff=0).run_device_many(
            [_planes(ctx, *p) for p in probs])
    assert scans == [(3, 128, 8)]
    assert _host(ctx, res) == [nb.msm("bn254_g1", k, p) for p, k in probs]


def test_scan_msm_g2_matches_native():
    """G2 (Fq2 madd with its sign flag, Fq2 jadd), 40 points padded to
    64, c = 4, against the native host G2 MSM."""
    pts, ks = _problem(BN254G2, lambda k: nb.fixed_base_g2(BN254G2.generator(), k), 5, 40)
    ctx = get_g2_ctx()
    m = port_msm.MSM(ctx, c=4, lanes=LANES, small_cutoff=0)
    assert _host(ctx, m.run_device(*_planes(ctx, pts, ks))) == [nb.msm_g2(ks, pts)]


def test_xla_form_gives_the_kernel_forms_buckets(monkeypatch):
    """CRESCENT_MSM_PALLAS=0: phases 1-2 in the reference's XLA form (the
    sign by a negation and a select, add_mixed, add) give the kernel form's
    (x, y, z) bit for bit, and the native MSM's point; c = 5, whose last
    window reaches past bit 255."""
    pts, ks = _g1_problem(7, 64)
    ctx = get_curve_ctx(BN254_G1)
    m = port_msm.MSM(ctx, c=5, lanes=4, small_cutoff=0)
    args = _planes(ctx, pts, ks)
    kernel = m.run_device(*args)
    monkeypatch.setenv("CRESCENT_MSM_PALLAS", "0")
    xla = m.run_device(*args)
    assert all(torch.equal(a, b) for a, b in zip(kernel, xla))
    assert _host(ctx, kernel) == [nb.msm("bn254_g1", ks, pts)]


@pytest.mark.parametrize("env", [{}, {"CRESCENT_MSM_AFFINE": "0"},
                                 {"CRESCENT_MSM_PALLAS": "0"}, {"CRESCENT_MSM_AFFINE": "no"},
                                 {"CRESCENT_MSM_PALLAS": "off"}])
def test_switches_read_as_the_reference_reads_them(env, monkeypatch):
    """The affine route is off exactly where the reference's is on a
    device with its kernels (its backend check stubbed to say "tpu"), and
    phases 1-2 take the kernel form exactly where the reference's take the
    Pallas form; values other than "0" are the default.  With the affine
    route off the fold returns None, as the reference's does."""
    monkeypatch.delenv("CRESCENT_MSM_AFFINE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(ref_msm.jax, "default_backend", lambda: "tpu")
    ref_m = ref_msm.MSM(REF_G1)
    port_m = port_msm.MSM(BN254_G1)
    assert (port_m._affine_msm() is None) == (ref_m._affine_msm() is None)
    assert port_msm._kernel_accumulate() == (ref_msm._pallas_for(ref_m.ctx) is not None)
    if port_m._affine_msm() is None:
        assert port_m.run_device_fold([]) is None


def test_get_msm_defaults_match_reference():
    for port_m, ref_m in ((port_msm.get_msm(BN254_G1), ref_msm.get_msm(REF_G1)),
                          (port_msm.get_g2_msm(), ref_msm.get_g2_msm())):
        assert (port_m.c, port_m.lanes, port_m.small_cutoff, port_m.affine_c) == (
            ref_m.c, ref_m.lanes, ref_m.small_cutoff, ref_m.affine_c)
    assert port_msm.MSM(BN254_G1).lanes == ref_msm.MSM(REF_G1).lanes == 256
    for n in (1, 255, 256, 4096, 1 << 16, 1 << 20):
        assert port_msm.get_msm(BN254_G1)._lanes_for(n) == ref_msm.get_msm(REF_G1)._lanes_for(n)


# -- prove under CRESCENT_PROVE_FUSED=0 ----------------------------------------

LOG = 5  # dummy_circuit(5): 30 constraints, domain 32


@pytest.fixture(scope="module")
def bundle():
    r1cs, z = ref.dummy_circuit(LOG, random.Random(41))
    pk = ref.setup(r1cs, random.Random(42))
    r, s = 0x5EED5EED, 0xD5EE5EED
    want = ref.prove(pk, r1cs, z, random.Random(0), r=r, s=s)
    return r1cs, z, pk, r, s, want


def _proof_ints(proof) -> tuple:
    b = proof.b
    return (tuple(proof.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(proof.c))


class _NativeChunk:
    """AffineMSM.run of a G1 chunk answered by the native host MSM."""

    def __init__(self, ctx):
        self.ctx = ctx

    def run(self, px, py, pvalid, sc):
        ctx = self.ctx
        z = torch.where(pvalid[:, None] != 0, ctx.fctx.one_mont("cpu"),
                        torch.zeros((), dtype=torch.int32))
        pts = ctx.points_to_host(JPoints(px, py, z))
        res = nb.msm("bn254_g1", limb.limbs_to_ints(limb.words_to_limbs(sc)), pts)
        return JPoints(*(a[0] for a in ctx.points_to_device([res], "cpu")))


def _spy(monkeypatch, obj, name: str, seen: list, key):
    """Wrap obj.name to append key(*args) to `seen` on every call."""
    fn = getattr(obj, name)

    def spy(*args, **kw):
        seen.append(key(*args))
        return fn(*args, **kw)

    monkeypatch.setattr(obj, name, spy)


@pytest.mark.parametrize("route", ["scan", "affine", "fold_falls_back"])
def test_prove_fused_off_matches_reference(bundle, route, monkeypatch):
    """The four G1 MSMs of prove as one run_device_many on the device (the
    CPU's plain versions).  Under CRESCENT_PROVE_FUSED=0 h(x) comes from
    the Python lists and the fold is not called: on the scan route
    (CRESCENT_MSM_AFFINE=0) one scan over the four problems, on the affine
    route one AffineMSM run a problem (answered by the native MSM here: the
    plain versions of a chunk are held in tests/test_torch_msm.py).  With
    the default switch but the affine route off, the fold returns None, as
    the reference's does, and prove takes the same batch.  The scan runs at
    c = 4, which the proof does not depend on.  The proof equals the
    reference's for the same r and s and verifies in both packages."""
    r1cs, z, pk, r, s, want = bundle
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(41))
    ppk = proving_key_from_reference(pk)
    scans, chunks, folds, h_lists = [], [], [], []
    if route == "affine":
        monkeypatch.delenv("CRESCENT_MSM_AFFINE")
        g1 = port_msm.MSM(port.G1, small_cutoff=8, max_chunk=64)
        g1._affine = _NativeChunk(g1.ctx)
        _spy(monkeypatch, g1._affine, "run", chunks, lambda px, *a: px.shape[0])
    else:
        g1 = port_msm.MSM(port.G1, c=4, lanes=LANES, small_cutoff=0)
        _spy(monkeypatch, port_msm, "_msm_impl", scans, lambda ctx, px, *a: px.shape[0])
    if route != "fold_falls_back":
        monkeypatch.setenv("CRESCENT_PROVE_FUSED", "0")
        monkeypatch.setattr(g1, "run_device_fold", lambda probs: folds.append(probs))
    _spy(monkeypatch, port, "_compute_h", h_lists, lambda *a, **kw: True)
    monkeypatch.setattr(port, "get_msm", lambda curve: g1)
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "device")
    got = port.prove(ppk, pr1cs, z, random.Random(0), r=r, s=s, device="cpu")
    assert _proof_ints(got) == _proof_ints(want)
    assert not folds
    assert scans == ([] if route == "affine" else [4])
    assert chunks == ([64] * 4 if route == "affine" else [])
    assert h_lists == ([] if route == "fold_falls_back" else [True])
    pubs = z[1 : r1cs.num_instance]
    assert port.verify(ppk.vk.prepare(), got, pubs)
    assert ref.verify(pk.vk.prepare(), ref.Proof(got.a, got.b, got.c), pubs)
