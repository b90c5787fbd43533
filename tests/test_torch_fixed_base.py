"""Setup's device SRS in the port (crescent_tpu_torch/ops/fixed_base.py and
the device branch of models/groth16.setup) on the CPU, through the plain
versions of madd, mul and inv over Fq and Fq2.

* FixedBaseMSM for G1 and G2 against the port's native fixed base, bit for
  bit in the affine results (the reference's tests/test_fixed_base.py, at
  the same sizes: several chunks of 64 scalars and padding lanes).
* setup(..., device="cpu") with CRESCENT_SETUP_TPU=force equals the
  reference's setup (its native branch, same seed) table for table, and a
  prove on that key equals the reference's prove(r=, s=).  The key's
  identity rows come up with y = 0 from its ArrayPointVec tables (the
  reference's list path gives y = Montgomery 1), which must change no proof.
Exact comparisons (tolerance 0).
"""

import copy
import random

import pytest
import torch

from crescent_tpu.models import groth16 as ref
from crescent_tpu.utils.pointvec import ArrayPointVec as RefPointVec
from crescent_tpu_torch.convert import proving_key_from_reference
from crescent_tpu_torch.core.curves import BN254_G1, BN254G2
from crescent_tpu_torch.models import groth16 as port
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops import msm as port_msm
from crescent_tpu_torch.ops import msm_affine as port_affine
from crescent_tpu_torch.ops.ec import get_curve_ctx, get_g2_ctx
from crescent_tpu_torch.ops.fixed_base import FixedBaseMSM, pec_for
from crescent_tpu_torch.utils.pointvec import ArrayPointVec

LOG = 5  # dummy_circuit(5, num_public=2): 30 constraints, domain 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalars(rng, order, n):
    ks = [0, 1, 2, order - 1, order - 2, (order + 1) // 2]
    ks += [rng.randrange(order) for _ in range(n - len(ks))]
    return ks[:n]


def test_fixed_base_g1_matches_native():
    rng = random.Random(11)
    ctx = get_curve_ctx(BN254_G1)
    fb = FixedBaseMSM(ctx)  # 150 lanes: 106 padding lanes in the affine conversion
    assert fb.pec is ctx.ec and fb.width == 8
    g = BN254_G1.generator
    table = nb.fixed_base("bn254_g1", g, fb.table_scalars())
    ks = _scalars(rng, BN254_G1.n, 150)
    out = fb.run(table, limb.ints_to_limbs(ks), "cpu")
    assert isinstance(out, ArrayPointVec) and not out.g2 and out.xs.shape == (150, 16)
    assert list(out) == nb.fixed_base("bn254_g1", g, ks)
    assert out.inf[0] and not out.inf[1:].any()
    assert not out.xs[0].any() and not out.ys[0].any()
    assert ctx.ec.launches() == dict.fromkeys(ctx.ec.launches(), 0)  # CPU: no kernel


def test_fixed_base_g2_matches_native():
    rng = random.Random(12)
    ctx = get_g2_ctx()
    fb = FixedBaseMSM(ctx)
    assert pec_for(ctx) is ctx.ec and fb.width == 16
    h = BN254G2.generator()
    table = nb.fixed_base_g2(h, fb.table_scalars())
    ks = _scalars(rng, BN254G2.n, 70)
    out = fb.run(table, limb.ints_to_limbs(ks), "cpu")
    assert out.g2 and out.xs.shape == (70, 32)
    assert list(out) == nb.fixed_base_g2(h, ks)
    # the table's upload and the curve context's round trip over Fq2
    P = ctx.points_to_device(table[:5] + [None], "cpu")
    assert P.x.shape == (6, 16) and ctx.points_to_host(P) == table[:5] + [None]
    Pa = ctx.points_to_device(ArrayPointVec.from_points(table[:5] + [None], g2=True), "cpu")
    assert torch.equal(Pa.x[:5], P.x[:5]) and torch.equal(Pa.z, P.z)


@pytest.fixture(scope="module")
def keys():
    """The reference's key (native branch) and the port's device-branch key
    of one circuit and seed."""
    r1cs, z = ref.dummy_circuit(LOG, random.Random(77), num_public=2)
    pk_ref = ref.setup(r1cs, random.Random(42))
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(77), num_public=2)
    mp = pytest.MonkeyPatch()
    mp.setenv("CRESCENT_SETUP_TPU", "force")
    mp.setenv("CRESCENT_SETUP_TPU_MIN", "0")
    timings = {}
    try:
        ppk = port.setup(pr1cs, random.Random(42), device="cpu", timings=timings)
    finally:
        mp.undo()
    return r1cs, pr1cs, z, pk_ref, ppk, timings


TABLES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")
VK = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2", "gamma_abc_g1")


def test_setup_device_branch_matches_reference(keys):
    _, _, _, pk_ref, ppk, timings = keys
    conv = proving_key_from_reference(pk_ref)
    for f in TABLES:
        got = getattr(ppk, f)
        assert isinstance(got, ArrayPointVec), f
        assert got == getattr(conv, f), f
    assert ppk.b_g2_query.g2 and ppk.a_query.inf.any()  # identity rows present
    for f in ("beta_g1", "delta_g1"):
        assert getattr(ppk, f) == getattr(conv, f), f
    for f in VK:
        assert getattr(ppk.vk, f) == getattr(conv.vk, f), f
    assert set(timings) == {"qap_evals", "scalar_prep", "g1_dispatch", "g2_dispatch",
                            "g1_fetch", "g2_fetch", "assemble"}


def test_convert_takes_a_reference_key_of_array_tables(keys):
    """A reference key whose tables are the reference's ArrayPointVec (as its
    device branch returns them) converts to the port's class, equal."""
    _, _, _, pk_ref, ppk, _ = keys
    pk_arrays = copy.copy(pk_ref)
    for f in TABLES:
        setattr(pk_arrays, f, RefPointVec.from_points(list(getattr(pk_ref, f)),
                                                      g2=f == "b_g2_query"))
    conv = proving_key_from_reference(pk_arrays)
    for f in TABLES:
        got = getattr(conv, f)
        assert isinstance(got, ArrayPointVec) and got == getattr(ppk, f), f


def test_prove_on_the_device_key_matches_reference(keys, monkeypatch):
    """The fold of affine MSMs (plain versions, c = 5, floors of 16) and the
    native configuration, both on the device-branch key, against the
    reference's prove on its own key."""
    r1cs, pr1cs, z, pk_ref, ppk, _ = keys
    r, s = 0x1357, 0x2468
    want = ref.prove(pk_ref, r1cs, z, random.Random(0), r=r, s=s)
    want = (tuple(want.a), (want.b[0].c0, want.b[0].c1, want.b[1].c0, want.b[1].c1),
            tuple(want.c))

    def small_msm(curve):
        m = port_msm.MSM(curve, affine_c=5, max_chunk=64)
        m._affine = port_affine.AffineMSM(m.ctx, m.ctx.ec, c=5, min_bucket=16,
                                          inv_floor=16)
        return m

    monkeypatch.setattr(port, "get_msm", small_msm)
    for mode in ("device", "native"):
        monkeypatch.setenv("CRESCENT_PROVE_MSM", mode)
        got = port.prove(ppk, pr1cs, z, random.Random(0), r=r, s=s, device="cpu")
        b = got.b
        assert (tuple(got.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(got.c)) == want
    # the device planes of an ArrayPointVec table: identity rows have y = 0
    x, y, valid = ppk.device_table("a_query", small_msm(port.G1), "cpu")
    assert not valid.all() and not y[valid == 0].any()
    assert port.verify(ppk.vk.prepare(), got, z[1 : r1cs.num_instance])


def test_setup_switch_and_threshold(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("CRESCENT_SETUP_TPU", raising=False)
    assert not port._setup_device_enabled(cpu) and port._setup_device_enabled(cuda)
    monkeypatch.setenv("CRESCENT_SETUP_TPU", "1")
    assert not port._setup_device_enabled(cpu) and port._setup_device_enabled(cuda)
    monkeypatch.setenv("CRESCENT_SETUP_TPU", "0")
    assert not port._setup_device_enabled(cpu) and not port._setup_device_enabled(cuda)
    monkeypatch.setenv("CRESCENT_SETUP_TPU", "force")
    assert port._setup_device_enabled(cpu) and port._setup_device_enabled(cuda)
    # below CRESCENT_SETUP_TPU_MIN the native branch runs, whatever the switch
    monkeypatch.setenv("CRESCENT_SETUP_TPU_MIN", str(1 << 30))
    r1cs, _ = port.dummy_circuit(4, random.Random(5))
    pk = port.setup(r1cs, random.Random(6), device="cpu")
    assert isinstance(pk.a_query, list) and isinstance(pk.b_g2_query, list)
    # any other value is auto, as in the reference (groth16.py:451-456)
    monkeypatch.setenv("CRESCENT_SETUP_TPU", "yes")
    assert not port._setup_device_enabled(cpu) and port._setup_device_enabled(cuda)
