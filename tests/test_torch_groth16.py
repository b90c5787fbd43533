"""Port Groth16 (crescent_tpu_torch/models/groth16.py) against the reference
on identical inputs, on the CPU (plain versions of the kernels).

The reference runs as its own tests run it here: `prove` in its CPU
configuration (XLA h(x), native MSMs), `_compute_h_device` through the
Pallas kernels in interpret mode.  The port's `prove` runs in both of its
MSM configurations (CRESCENT_PROVE_MSM=native and =device, the latter through
the plain versions of the MSM kernels at a small window width), and with
the native backend off (CRESCENT_NATIVE=0), where the G2 MSM joins the G1
fold on the device (below `small_cutoff` points by its direct path) and
verify's public-input MSM runs on the device too.  Exact
comparisons (tolerance 0); proofs are compared as tuples of ints, since the
two packages define their own field classes.
"""

import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from crescent_tpu.models import groth16 as ref
from crescent_tpu_torch.convert import proving_key_from_reference
from crescent_tpu_torch.models import groth16 as port
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import ec as port_ec
from crescent_tpu_torch.ops import limb
from crescent_tpu_torch.ops import msm as port_msm
from crescent_tpu_torch.ops import msm_affine as port_affine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = 6  # dummy_circuit(6): 62 constraints, domain 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    r1cs, z = ref.dummy_circuit(LOG, random.Random(11))
    pk = ref.setup(r1cs, random.Random(12))
    dom = ref._domain_for(r1cs)
    zu = ref.nb.ints_to_u64([x % ref.R for x in z])
    h_ref = np.asarray(jax.device_get(ref._compute_h_device(r1cs, zu, dom)))
    return r1cs, z, pk, zu, h_ref


def _small_msm(curve, chunk: int):
    """An MSM with a window width of 5, floors of 16 lanes and chunks of
    `chunk` points (the prove path's 11 and 512 take minutes through the
    plain versions); the proof does not depend on them."""
    m = port_msm.MSM(curve, affine_c=5, small_cutoff=8, max_chunk=chunk)
    m._affine = port_affine.AffineMSM(m.ctx, m.ctx.ec, c=5, min_bucket=16, inv_floor=16)
    return m


def _proof_ints(proof) -> tuple:
    b = proof.b
    return (tuple(proof.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(proof.c))


def test_dummy_circuit_matches_reference(bundle):
    r1cs, z, _, _, _ = bundle
    pr1cs, pz = port.dummy_circuit(LOG, random.Random(11))
    assert pz == z
    assert pr1cs.constraints == r1cs.constraints
    assert (pr1cs.num_instance, pr1cs.num_witness) == (r1cs.num_instance, r1cs.num_witness)
    assert pr1cs.is_satisfied(z) and not pr1cs.is_satisfied(z[:-1] + [z[-1] + 1])


def test_h_matches_reference_device_pipeline(bundle):
    r1cs, z, _, zu, h_ref = bundle
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    h = port._compute_h_device(pr1cs, zu, port._domain_for(pr1cs), "cpu")
    assert h.dtype == np.uint16 and h.shape == h_ref.shape == (64, 16)
    np.testing.assert_array_equal(h, h_ref)


def test_setup_matches_reference(bundle):
    r1cs, _, pk, _, _ = bundle
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    ppk = port.setup(pr1cs, random.Random(12), device="cpu")
    for f in ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
              "h_query", "l_query"):
        assert getattr(ppk, f) == getattr(pk, f), f
    for f in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2", "gamma_abc_g1"):
        assert getattr(ppk.vk, f) == getattr(pk.vk, f), f


@pytest.mark.parametrize("witness", ["ints", "u64"])
def test_prove_matches_reference(bundle, witness):
    r1cs, z, pk, zu, _ = bundle
    r, s = 0x1234567 + len(witness), 0x7654321
    want = ref.prove(pk, r1cs, z, random.Random(0), r=r, s=s)
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    ppk = proving_key_from_reference(pk)
    timings = {}
    got = port.prove(ppk, pr1cs, z if witness == "ints" else zu, random.Random(0),
                     r=r, s=s, device="cpu", timings=timings)
    assert _proof_ints(got) == _proof_ints(want)
    assert set(timings) == {"matvec", "h", "msm", "msm_g1", "msm_g2", "assemble"}
    pubs = z[1 : r1cs.num_instance]
    assert ref.verify(pk.vk.prepare(), ref.Proof(got.a, got.b, got.c), pubs)
    pvk = ppk.vk.prepare()
    assert port.verify(pvk, got, pubs)
    assert not port.verify(pvk, got, [(pubs[0] + 1) % port.R])


def test_prove_device_msm_matches_reference_and_native(bundle, monkeypatch):
    """CRESCENT_PROVE_MSM=device on the CPU: the fold of sorted-segment
    affine MSMs through the plain versions.  The MSM is made with a window
    width of 5 and floors of 16 lanes (the prove path's 11 and 512 take
    minutes through the plain versions); the proof does not depend on them."""
    r1cs, z, pk, zu, _ = bundle
    r, s = 0x2468ACE, 0xECA8642
    want = _proof_ints(ref.prove(pk, r1cs, z, random.Random(0), r=r, s=s))
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    ppk = proving_key_from_reference(pk)

    monkeypatch.setattr(port, "get_msm", lambda curve: _small_msm(curve, 64))
    proofs = {}
    for mode in ("device", "native"):
        monkeypatch.setenv("CRESCENT_PROVE_MSM", mode)
        timings = {}
        proofs[mode] = _proof_ints(port.prove(ppk, pr1cs, zu, random.Random(0), r=r, s=s,
                                              device="cpu", timings=timings))
        assert timings["msm_g1"] > 0 and timings["msm_g2"] > 0
    assert proofs["device"] == proofs["native"] == want
    assert set(ppk._dev) == {("a_query", "cpu"), ("b_g1_query", "cpu"),
                             ("h_query", "cpu"), ("l_query", "cpu"), "b_g2_query:u64"}
    # a value the switch does not name is auto, as in the reference: on the
    # CPU the native MSMs
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "host")
    assert _proof_ints(port.prove(ppk, pr1cs, zu, random.Random(0), r=r, s=s,
                                  device="cpu")) == want


class _NativeChunk:
    """AffineMSM.run of a G1 chunk answered by the native host MSM."""

    def __init__(self, ctx):
        self.ctx = ctx

    def run(self, px, py, pvalid, sc):
        ctx = self.ctx
        z = torch.where(pvalid[:, None] != 0, ctx.fctx.one_mont("cpu"),
                        torch.zeros((), dtype=torch.int32))
        pts = ctx.points_to_host(port_ec.JPoints(px, py, z))
        ks = limb.limbs_to_ints(limb.words_to_limbs(sc))
        res = nb.msm("bn254_g1", ks, pts)
        return port_ec.JPoints(*(a[0] for a in ctx.points_to_device([res], "cpu")))


def test_prove_with_native_off_matches_reference(bundle, monkeypatch):
    """CRESCENT_NATIVE=0 on the CPU: the MSMs take the device route (the
    reference's `_native_msm_prove`), the G2 MSM too, behind the G1 fold:
    its 65 points as one chunk through the plain Fq2 point ops; no native G2
    table is built.  The G1 fold's chunks are answered by the native MSM
    here (their plain versions run in the test above), so that the time
    goes to G2.  The proof equals the reference's and verifies."""
    r1cs, z, pk, zu, _ = bundle
    r, s = 0x13579BD, 0xDB97531
    want = _proof_ints(ref.prove(pk, r1cs, z, random.Random(0), r=r, s=s))
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    ppk = proving_key_from_reference(pk)
    g1 = port_msm.MSM(port.G1, max_chunk=64)
    g1._affine = _NativeChunk(g1.ctx)
    monkeypatch.setattr(port, "get_msm", lambda curve: g1)
    g2 = _small_msm(port_ec.get_g2_ctx(), 128)
    monkeypatch.setattr(port, "get_g2_msm", lambda: g2)
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "native")  # overridden: the backend is off
    timings = {}
    got = port.prove(ppk, pr1cs, zu, random.Random(0), r=r, s=s, device="cpu",
                     timings=timings)
    assert _proof_ints(got) == want
    assert timings["msm_g1"] > 0 and timings["msm_g2"] > 0
    assert set(ppk._dev) == {("a_query", "cpu"), ("b_g1_query", "cpu"), ("h_query", "cpu"),
                             ("l_query", "cpu"), ("b_g2_query", "cpu")}
    monkeypatch.setenv("CRESCENT_NATIVE", "1")  # verify natively (off: the test below)
    assert port.verify(ppk.vk.prepare(), got, z[1 : r1cs.num_instance])


def test_prove_with_native_off_at_small_n_matches_default(monkeypatch):
    """CRESCENT_NATIVE=0 with num_vars <= 1024: the G2 MSM of
    dummy_circuit(4)'s 17 points (padded to 32) takes get_g2_msm()'s direct
    path (scalar_mul over Fq2, then a jadd tree), where the port used to
    raise.  The proof equals the default one for the same r and s.  The G1
    fold's chunks are answered by the native MSM, as above."""
    r1cs, z = port.dummy_circuit(4, random.Random(21))
    pk = port.setup(r1cs, random.Random(22), device="cpu")
    r, s = 0x1A2B3C4, 0x4C3B2A1
    want = _proof_ints(port.prove(pk, r1cs, z, random.Random(0), r=r, s=s, device="cpu"))
    g1 = port_msm.MSM(port.G1, max_chunk=64)
    g1._affine = _NativeChunk(g1.ctx)
    monkeypatch.setattr(port, "get_msm", lambda curve: g1)
    g2 = port_msm.MSM(port_ec.get_g2_ctx())
    assert r1cs.num_vars <= g2.small_cutoff
    monkeypatch.setattr(port, "get_g2_msm", lambda: g2)
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    got = port.prove(pk, r1cs, z, random.Random(0), r=r, s=s, device="cpu")
    assert _proof_ints(got) == want
    assert g2._affine is None  # no chunk MSM was made for G2


def test_prepare_inputs_with_native_off_matches_native(monkeypatch):
    """prepare_inputs under CRESCENT_NATIVE=0: get_msm(G1).run_host on the
    device (its direct path) gives the native backend's point, for six
    public inputs (0, one >= r, r - 1 among them) over gamma_abc points one
    of which is the identity; and verify, which takes that route, accepts a
    proof of a circuit with six public inputs."""
    import dataclasses

    r1cs, z = port.dummy_circuit(3, random.Random(31), num_public=6)
    pk = port.setup(r1cs, random.Random(32), device="cpu")
    proof = port.prove(pk, r1cs, z, random.Random(0), device="cpu")
    abc = list(pk.vk.gamma_abc_g1)
    abc[4] = None
    wide = dataclasses.replace(pk.vk, gamma_abc_g1=abc)
    xs = [0, port.R + 5, port.R - 1, 12345, 2**200 + 1, 77]
    want = port.prepare_inputs(wide, xs)
    acc = abc[0]
    for x, p in zip(xs, abc[1:]):
        acc = port.G1.add(acc, None if p is None else port.G1.mul(x % port.R, p))
    assert want == acc
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setattr(nb, "msm", None)  # the native MSM may not be reached
    assert port.prepare_inputs(wide, xs, "cpu") == want
    assert port.verify(pk.vk.prepare(), proof, z[1 : r1cs.num_instance], device="cpu")


def test_native_switch(monkeypatch):
    """CRESCENT_NATIVE (default 1) as the reference reads it: with it off,
    prove's MSMs take the device route on any device."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("CRESCENT_PROVE_MSM", raising=False)
    monkeypatch.delenv("CRESCENT_NATIVE", raising=False)
    assert port._native_ok()
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    assert not port._native_ok()
    for mode in ("auto", "device", "native", "host"):
        monkeypatch.setenv("CRESCENT_PROVE_MSM", mode)
        assert port._device_msm_prove(cpu) and port._device_msm_prove(cuda)


def test_device_table_of_g2_matches_reference(bundle):
    """ProvingKey.device_table of b_g2_query over Fq2: (N, 16) word rows,
    carried from the reference's (N, 2, 16) limbs by
    convert.device_table_from_reference."""
    from crescent_tpu.ops.msm import get_g2_msm as ref_get_g2_msm
    from crescent_tpu_torch.convert import device_table_from_reference

    _, _, pk, _, _ = bundle
    ppk = proving_key_from_reference(pk)
    want = device_table_from_reference(pk.device_table("b_g2_query", ref_get_g2_msm()))
    got = ppk.device_table("b_g2_query", port_msm.get_g2_msm(), "cpu")
    assert got[0].shape == want[0].shape == (len(pk.b_g2_query), 16)
    keep = want[2].bool()  # an identity's x, y are free
    assert torch.equal(got[2], want[2]) and keep.any() and not keep.all()
    assert torch.equal(got[0][keep], want[0][keep])
    assert torch.equal(got[1][keep], want[1][keep])


def test_device_table_matches_reference(bundle):
    """ProvingKey.device_table: the port's planes equal the reference's,
    carried over by convert.device_table_from_reference."""
    from crescent_tpu.ops.msm import get_msm as ref_get_msm
    from crescent_tpu_torch.convert import device_table_from_reference

    _, _, pk, _, _ = bundle
    ppk = proving_key_from_reference(pk)
    msm_g1 = port_msm.get_msm(port.G1)
    for name in ("a_query", "h_query"):
        want = device_table_from_reference(pk.device_table(name, ref_get_msm(ref.G1)))
        got = ppk.device_table(name, msm_g1, "cpu")
        assert got is ppk.device_table(name, msm_g1, torch.device("cpu"))  # cached
        keep = want[2].bool()  # an identity's x, y are free
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0][keep], want[0][keep])
        assert torch.equal(got[1][keep], want[1][keep])
    assert ppk.native_g2_table() is ppk.native_g2_table()
    np.testing.assert_array_equal(ppk.native_g2_table(), pk.native_g2_table())


def test_prove_runs_on_the_card_unless_asked_for_the_cpu(bundle, monkeypatch):
    """`device` defaults to the card; without one the call raises, whatever
    the MSM configuration: nothing picks the CPU because it found no card."""
    import inspect

    for fn in (port.prove, port._compute_h_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    r1cs, z, pk, zu, _ = bundle
    pr1cs, _ = port.dummy_circuit(LOG, random.Random(11))
    ppk = proving_key_from_reference(pk)
    for mode in ("auto", "native", "device"):
        monkeypatch.setenv("CRESCENT_PROVE_MSM", mode)
        with pytest.raises((RuntimeError, AssertionError)):
            port.prove(ppk, pr1cs, z, random.Random(0))
    with pytest.raises((RuntimeError, AssertionError)):
        port._compute_h_device(pr1cs, zu, port._domain_for(pr1cs))


def test_msm_configuration_switch(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("CRESCENT_PROVE_MSM", raising=False)
    assert not port._device_msm_prove(cpu) and port._device_msm_prove(cuda)
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "native")
    assert not port._device_msm_prove(cpu) and not port._device_msm_prove(cuda)
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "device")
    assert port._device_msm_prove(cpu) and port._device_msm_prove(cuda)
    # any other value is auto, as in the reference (groth16.py:105-110)
    monkeypatch.setenv("CRESCENT_PROVE_MSM", "host")
    assert not port._device_msm_prove(cpu) and port._device_msm_prove(cuda)


_NO_JAX = """
import random, sys
sys.modules["jax"] = None
sys.modules["crescent_tpu"] = None
from crescent_tpu_torch.models import groth16 as g
r1cs, z = g.dummy_circuit(5, random.Random(3))
pk = g.setup(r1cs, random.Random(4), device="cpu")
proof = g.prove(pk, r1cs, z, random.Random(5), device="cpu")
assert g.verify(pk.vk.prepare(), proof, z[1:r1cs.num_instance])
import crescent_tpu_torch.convert, crescent_tpu_torch.ops.msm
import crescent_tpu_torch.cli, crescent_tpu_torch.utils.ark
import crescent_tpu_torch.r1cs.jwt_circuit, crescent_tpu_torch.r1cs.witness_program
import crescent_tpu_torch.credentials.device, crescent_tpu_torch.models.spartan_ser
import crescent_tpu_torch.credentials.mdl, crescent_tpu_torch.r1cs.p256
import crescent_tpu_torch.client
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "crescent_tpu"))
assert leaked == ["crescent_tpu", "jax"], leaked
assert sys.modules["jax"] is None and sys.modules["crescent_tpu"] is None
print("no-jax prove ok")
"""


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no-jax prove ok" in out.stdout
