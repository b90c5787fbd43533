"""The port's own host layer (crescent_tpu_torch/core, native, utils) against
the JAX package's, which it was copied from, on seeded calls; and a walk over
the port's sources that finds no import of jax or of the JAX package.

Values are compared as plain ints (the two packages define their own field
and point classes).  Exact comparisons (tolerance 0).
"""

import ast
import glob
import os

import numpy as np
import pytest

from crescent_tpu.core import curves as rcurves
from crescent_tpu.core import fields as rfields
from crescent_tpu.core import pairing as rpairing
from crescent_tpu.native import backend as rnb
from crescent_tpu.utils import pointvec as rpointvec
from crescent_tpu_torch.core import curves as pcurves
from crescent_tpu_torch.core import fields as pfields
from crescent_tpu_torch.core import pairing as ppairing
from crescent_tpu_torch.native import backend as pnb
from crescent_tpu_torch.utils import pointvec as ppointvec
from crescent_tpu_torch.utils import trace as ptrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = rfields.BN254_FR
Q = rfields.BN254_FQ


def _ints(rng, n, mod):
    """n seeded ints below mod (numpy words -> Python ints)."""
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int("".join(f"{int(x):08x}" for x in r), 16) % mod for r in w]


def _flat(v):
    """Field elements, points and towers of either package -> nested ints."""
    if v is None or isinstance(v, int):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_flat(x) for x in v)
    slots = getattr(type(v), "__slots__", None)
    return (type(v).__name__,) + tuple(_flat(getattr(v, s)) for s in slots)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(glob.glob(os.path.join(ROOT, "crescent_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]
    # the port's scripts: every one that imports it
    for path in sorted(glob.glob(os.path.join(ROOT, "scripts", "*.py"))):
        with open(path) as f:
            if "crescent_tpu_torch" in f.read():
                files.append(path)
    assert len(files) > 19
    # the credential pipeline's modules among them, device binding's too
    for mod in ("cli.py", "credentials/api.py", "credentials/circuits.py",
                "credentials/prep_inputs.py", "r1cs/builder.py", "r1cs/witness_program.py",
                "utils/ark.py", "utils/jwt.py", "core/poseidon.py", "models/spartan.py",
                "models/spartan_ser.py", "credentials/ecdsa_pop.py", "credentials/device.py",
                # the mDL half and the thin client
                "utils/cbor.py", "credentials/daystamp.py", "r1cs/dates.py", "r1cs/p256.py",
                "credentials/mdl.py", "utils/drbg.py", "client.py"):
        assert os.path.join(ROOT, "crescent_tpu_torch", mod) in files, mod
    banned = ("jax", "crescent_tpu")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
    assert not os.path.exists(os.path.join(ROOT, "crescent_tpu_torch", "_host.py"))


def test_native_backend_builds_from_the_ports_own_source():
    assert pnb.available() and rnb.available()
    assert os.path.dirname(pnb._SRC) == os.path.join(ROOT, "crescent_tpu_torch", "native")
    built = glob.glob(os.path.join(ROOT, "build", "native", "libbigcurve-*.so"))
    assert built, "the port's backend compiles into build/native/"


def test_fields_match_reference():
    rng = np.random.default_rng(101)
    a, b, c, d = (_ints(rng, 6, Q) for _ in range(4))
    assert pfields.BN254_FR == R and pfields.BN254_FQ == Q
    assert (pfields.Fr.multiplicative_generator == rfields.Fr.multiplicative_generator)
    for n in (1, 2, 1 << 10, 1 << 21):
        assert (pfields.PrimeField(R).root_of_unity(n)
                == rfields.PrimeField(R).root_of_unity(n))
    for i in range(6):
        px, py = pfields.Fq2(a[i], b[i]), pfields.Fq2(c[i], d[i])
        rx, ry = rfields.Fq2(a[i], b[i]), rfields.Fq2(c[i], d[i])
        for op in ("__add__", "__sub__", "__mul__"):
            assert _flat(getattr(px, op)(py)) == _flat(getattr(rx, op)(ry))
        assert _flat(px.inv()) == _flat(rx.inv())
        assert _flat(-px) == _flat(-rx)
    p6 = pfields.Fq6(pfields.Fq2(a[0], b[0]), pfields.Fq2(a[1], b[1]), pfields.Fq2(a[2], b[2]))
    r6 = rfields.Fq6(rfields.Fq2(a[0], b[0]), rfields.Fq2(a[1], b[1]), rfields.Fq2(a[2], b[2]))
    assert _flat(p6 * p6) == _flat(r6 * r6)
    assert _flat(p6.inv()) == _flat(r6.inv())
    p12, r12 = pfields.Fq12(p6, p6 * p6), rfields.Fq12(r6, r6 * r6)
    assert _flat(p12 * p12) == _flat(r12 * r12)
    assert _flat(p12.inv()) == _flat(r12.inv())


def test_curves_match_reference():
    rng = np.random.default_rng(102)
    ks = _ints(rng, 6, R)
    for name in ("BN254_G1", "P256", "T256"):
        pc, rc = getattr(pcurves, name), getattr(rcurves, name)
        assert (pc.p, pc.a, pc.b, pc.n, pc.generator) == (rc.p, rc.a, rc.b, rc.n, rc.generator)
        pp = [pc.mul(k % pc.n, pc.generator) for k in ks[:3]]
        rp = [rc.mul(k % rc.n, rc.generator) for k in ks[:3]]
        assert pp == rp and all(pc.is_on_curve(p) for p in pp)
        assert pc.add(pp[0], pp[1]) == rc.add(rp[0], rp[1])
        assert pc.add(pp[0], pc.neg(pp[0])) is None
        assert pc.double(pp[2]) == rc.double(rp[2])
        assert pc.msm(ks[3:], pp) == rc.msm(ks[3:], rp)
    pg, rg = pcurves.BN254G2, rcurves.BN254G2
    pq = pg.mul(ks[0], pg.generator())
    rq = rg.mul(ks[0], rg.generator())
    assert _flat(pq) == _flat(rq) and pg.is_on_curve(pq)
    assert _flat(pg.add(pq, pg.generator())) == _flat(rg.add(rq, rg.generator()))
    assert pg.add(pq, pg.neg(pq)) is None


@pytest.mark.parametrize("host_pairing", ["0", "1"])
def test_pairing_matches_reference(monkeypatch, host_pairing):
    """The native multi-pairing and the pure-Python one of both packages."""
    monkeypatch.setenv("CRESCENT_HOST_PAIRING", host_pairing)
    rng = np.random.default_rng(103)
    k1, k2 = _ints(rng, 2, R)
    pG, rG = pcurves.BN254_G1, rcurves.BN254_G1
    pp, rp = pG.mul(k1, pG.generator), rG.mul(k1, rG.generator)
    pq = pcurves.BN254G2.mul(k2, pcurves.BN254G2.generator())
    rq = rcurves.BN254G2.mul(k2, rcurves.BN254G2.generator())
    got = ppairing.pairing(pp, pq)
    assert _flat(got) == _flat(rpairing.pairing(rp, rq))
    # e(k1 G, k2 H) * e(-k1 k2 G, H) == 1
    neg = pG.neg(pG.mul(k1 * k2 % R, pG.generator))
    assert ppairing.pairing_product_is_one([(pp, pq), (neg, pcurves.BN254G2.generator())])
    assert not ppairing.pairing_product_is_one([(pp, pq), (pp, pcurves.BN254G2.generator())])


def test_native_msm_fixed_base_powers_and_matvec_match_reference():
    rng = np.random.default_rng(104)
    n = 40
    ks = _ints(rng, n, R)
    G = pcurves.BN254_G1.generator
    base_scalars = _ints(rng, n, R)
    ppts = pnb.fixed_base("bn254_g1", G, base_scalars)
    assert ppts == rnb.fixed_base("bn254_g1", G, base_scalars)
    ppts[3] = None
    assert pnb.msm("bn254_g1", ks, ppts) == rnb.msm("bn254_g1", ks, ppts)
    assert pnb.msm("bn254_g1", ks, ppts) == pcurves.BN254_G1.msm(ks, ppts)
    assert (pnb.mul_many("bn254_g1", ks[:5], ppts[5:10])
            == rnb.mul_many("bn254_g1", ks[:5], ppts[5:10]))

    pg2 = pnb.fixed_base_g2(pcurves.BN254G2.generator(), base_scalars[:8])
    rg2 = rnb.fixed_base_g2(rcurves.BN254G2.generator(), base_scalars[:8])
    assert _flat(pg2) == _flat(rg2)
    want = _flat(rnb.msm_g2(ks[:8], rg2))
    assert _flat(pnb.msm_g2(ks[:8], pg2)) == want
    assert _flat(pnb.msm_g2_raw(pnb.ints_to_u64(ks[:8]), pnb.g2_to_u64(pg2))) == want

    base, scale = ks[0], ks[1]
    np.testing.assert_array_equal(pnb.powers(R, base, scale, 33), rnb.powers(R, base, scale, 33))
    assert pnb.u64_to_ints(pnb.powers(R, base, scale, 4)) == [
        scale * pow(base, i, R) % R for i in range(4)]

    nnz, nx, nout = 200, 30, 17
    out_idx = rng.integers(0, nout, size=nnz).astype(np.uint32)
    in_idx = rng.integers(0, nx, size=nnz).astype(np.uint32)
    coeffs = pnb.ints_to_u64(_ints(rng, nnz, R))
    x = pnb.ints_to_u64(_ints(rng, nx, R))
    got = pnb.coo_matvec(R, out_idx, in_idx, coeffs, x, nout)
    np.testing.assert_array_equal(got, rnb.coo_matvec(R, out_idx, in_idx, coeffs, x, nout))
    for op in ("mul", "add", "sub"):
        np.testing.assert_array_equal(pnb.vec_op(R, op, x, x[::-1].copy()),
                                      rnb.vec_op(R, op, x, x[::-1].copy()))
    w = pfields.PrimeField(R).root_of_unity(16)
    np.testing.assert_array_equal(pnb.lagrange_at(R, w, ks[2], ks[3], 16),
                                  rnb.lagrange_at(R, w, ks[2], ks[3], 16))


def test_pointvec_and_trace_match_reference(capsys):
    rng = np.random.default_rng(105)
    pts = pnb.fixed_base("bn254_g1", pcurves.BN254_G1.generator, _ints(rng, 6, R))
    pts[2] = None
    pv, rv = ppointvec.ArrayPointVec.from_points(pts), rpointvec.ArrayPointVec.from_points(pts)
    for f in ("xs", "ys", "inf"):
        np.testing.assert_array_equal(getattr(pv, f), getattr(rv, f))
    assert pv.to_list() == pts and len(pv[1:4]) == 3 and pv == pts
    np.testing.assert_array_equal(pv.to_u64(), rv.to_u64())
    assert pv.ser_items_uncompressed() == rv.ser_items_uncompressed()
    g2 = pnb.fixed_base_g2(pcurves.BN254G2.generator(), [5, 7])
    pv2 = ppointvec.ArrayPointVec.from_points(g2, g2=True)
    assert _flat(pv2.to_list()) == _flat(g2)
    assert not hasattr(ptrace, "jax_profile")
    with ptrace.timed("quiet"):
        pass
    assert capsys.readouterr().err == ""
