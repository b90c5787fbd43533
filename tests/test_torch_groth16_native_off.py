"""The rest of the port's models/groth16.py against the reference on the CPU:
the routes the reference takes with the native host backend off
(CRESCENT_NATIVE=0), `fixed_base_mul` and `rerandomize_proof`.

Under CRESCENT_NATIVE=0 the port's `setup` takes the host branch (Python
Lagrange coefficients, QAP loops and h scalars, both fixed-base batches by
`fixed_base_mul`'s double-and-add through the plain versions of `jadd` and
`jdbl`), and `prove` computes h(x) from the Python matvec (`_compute_h`);
with the native QAP, matvec, powers and fixed-base functions made to raise,
both still finish and give the reference's key and proof.  The reference
runs in its default configuration.  Exact comparisons (tolerance 0), as
ints: the two packages define their own field classes.
"""

import random

import pytest
import torch

from crescent_tpu.models import groth16 as ref
from crescent_tpu_torch.convert import proof_from_reference
from crescent_tpu_torch.models import groth16 as port
from crescent_tpu_torch.native import backend as nb
from crescent_tpu_torch.ops import ec as port_ec
from crescent_tpu_torch.ops import limb

# the native functions that setup and prove may not reach with the backend off
NATIVE_ROUTES = ("lagrange_at", "coo_matvec", "powers", "fixed_base", "fixed_base_g2",
                 "vec_op")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_circuit(mod):
    """a*b = pub0, a*a = pub1, b*b = pub2 (tests/test_groth16rand.py):
    variables [1, pub0, pub1, pub2, a, b], three instance identity rows."""
    a, b = 3, 12345
    cons = [
        ([(4, 1)], [(5, 1)], [(1, 1)]),
        ([(4, 1)], [(4, 1)], [(2, 1)]),
        ([(5, 1)], [(5, 1)], [(3, 1)]),
    ]
    return mod.R1CS(4, 2, cons), [1, a * b, a * a, b * b, a, b]


def _proof_ints(proof) -> tuple:
    b = proof.b
    return (tuple(proof.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(proof.c))


def _g2_ints(pts) -> list:
    return [None if p is None else (p[0].c0, p[0].c1, p[1].c0, p[1].c1) for p in pts]


def _raise(name):
    def f(*args, **kwargs):
        raise AssertionError(f"nb.{name} reached with the native backend off")
    return f


class _NativeMSM:
    """A stand-in for prove's device MSMs that answers each problem by the
    native host MSM, so that the test's time goes to the routes under test
    (the device MSMs under CRESCENT_NATIVE=0 are held in
    tests/test_torch_groth16.py)."""

    def __init__(self, ctx, g2: bool):
        self.ctx, self.g2 = ctx, g2

    def run_device(self, px, py, pvalid, sc):
        ctx = self.ctx
        z = torch.where(pvalid[:, None] != 0, ctx.fctx.one_mont("cpu"),
                        torch.zeros((), dtype=torch.int32))
        pts = ctx.points_to_host(port_ec.JPoints(px, py, z))
        ks = limb.limbs_to_ints(limb.words_to_limbs(sc))
        res = nb.msm_g2(ks, pts) if self.g2 else nb.msm("bn254_g1", ks, pts)
        return port_ec.JPoints(*(a[0] for a in ctx.points_to_device([res], "cpu")))

    def run_device_fold(self, problems):
        return [self.run_device(*p) for p in problems]


@pytest.fixture(scope="module")
def keys():
    """The reference's default setup, and the port's under CRESCENT_NATIVE=0
    with the native routes raising and every fixed_base_mul call recorded."""
    rr, z = small_circuit(ref)
    pk = ref.setup(rr, random.Random(5))
    pr1cs, _ = small_circuit(port)
    calls = []
    fbm = port.fixed_base_mul

    def spy(base, scalars, g2=False, *, device="cuda"):
        out = fbm(base, scalars, g2, device=device)
        calls.append((base, list(scalars), g2, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRESCENT_NATIVE", "0")
        mp.setenv("CRESCENT_SETUP_TPU", "force")  # the gate's switch alone may not pick it
        mp.setenv("CRESCENT_SETUP_TPU_MIN", "0")
        mp.setattr(port, "fixed_base_mul", spy)
        for name in NATIVE_ROUTES:
            mp.setattr(nb, name, _raise(name))
        ppk = port.setup(pr1cs, random.Random(5), device="cpu")
    return rr, z, pk, pr1cs, ppk, calls


def test_setup_with_native_off_matches_reference(keys):
    """The host branch (the reference's route with the backend off) gives
    the reference's default key, table for table."""
    _, _, pk, _, ppk, calls = keys
    assert isinstance(ppk.a_query, list)  # not the device branch's ArrayPointVec
    for f in ("beta_g1", "delta_g1", "a_query", "b_g1_query", "h_query", "l_query"):
        assert getattr(ppk, f) == getattr(pk, f), f
    assert _g2_ints(ppk.b_g2_query) == _g2_ints(pk.b_g2_query)
    for f in ("alpha_g1", "delta_g1", "gamma_abc_g1"):
        assert getattr(ppk.vk, f) == getattr(pk.vk, f), f
    for f in ("beta_g2", "gamma_g2", "delta_g2"):
        assert _g2_ints([getattr(ppk.vk, f)]) == _g2_ints([getattr(pk.vk, f)]), f
    assert [(len(c[1]), c[2]) for c in calls] == [(3 * 6 + 7 + 3, False), (6 + 3, True)]


def test_fixed_base_mul_matches_reference(keys):
    """Setup's two batches through the port's fixed_base_mul with the
    backend off (scalar_mul on the plain jadd and jdbl; 28 G1 scalars in 32
    lanes, 9 G2 scalars in 16) equal the reference's fixed_base_mul on the
    same scalars; so does the native route, with edge scalars."""
    from crescent_tpu.core.curves import BN254G2 as RG2

    *_, calls = keys
    for base, scalars, g2, got in calls:  # setup's bases are the generators
        want = ref.fixed_base_mul(RG2.generator() if g2 else base, scalars, g2=g2)
        assert (_g2_ints(got) == _g2_ints(want)) if g2 else (got == want)
    n = port.G1.n
    edges = [0, 1, n - 1, n, n + 1, 2**256 - 1, 0x1234567]
    assert port.fixed_base_mul(port.G1.generator, edges, device="cpu") == \
        ref.fixed_base_mul(port.G1.generator, edges)
    got = port.fixed_base_mul(port.G2.generator(), edges, g2=True, device="cpu")
    assert _g2_ints(got) == _g2_ints(ref.fixed_base_mul(RG2.generator(), edges, g2=True))
    assert port.fixed_base_mul(port.G1.generator, [], device="cpu") == []


def test_fixed_base_mul_edges_with_native_off(monkeypatch):
    """fixed_base_mul's device route alone, on a base other than the
    generator: 0, 1, n - 1, n, n + 1 and a scalar above 2^255 in one batch
    of 8 lanes (one a padding lane)."""
    n = port.G1.n
    base = port.G1.mul(0x1234567, port.G1.generator)
    edges = [0, 1, n - 1, n, n + 1, 2**256 - 1, 0x7654321]
    want = ref.fixed_base_mul(base, edges)
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setattr(nb, "fixed_base", _raise("fixed_base"))
    assert port.fixed_base_mul(base, edges, device="cpu") == want
    assert want[0] is None and want[1] == base and want[3] is None


def test_fixed_base_mul_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import inspect

    assert inspect.signature(port.fixed_base_mul).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for native in ("1", "0"):
        monkeypatch.setenv("CRESCENT_NATIVE", native)
        with pytest.raises(RuntimeError):
            port.fixed_base_mul(port.G1.generator, [3])


def test_prove_with_native_off_matches_reference(keys, monkeypatch):
    """prove under CRESCENT_NATIVE=0 takes _compute_h (the Python matvec,
    then h(x) through the plain mul and butterfly) and gives the
    reference's proof for the same r and s, from a list and from a u64
    array; verify accepts it in both packages."""
    rr, z, pk, pr1cs, ppk, _ = keys
    r, s = 0x1A2B3C4D, 0x4D3C2B1A
    want = ref.prove(pk, rr, z, random.Random(0), r=r, s=s)
    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setattr(port, "get_msm", lambda curve: _NativeMSM(port.get_curve_ctx(curve),
                                                                   False))
    monkeypatch.setattr(port, "get_g2_msm", lambda: _NativeMSM(port.get_g2_ctx(), True))
    # the domain's twiddle and coset tables first: they are the NTT's, which
    # the reference also builds natively wherever the library is loaded
    # (crescent_tpu/ops/ntt.py:119-127), and they are cached per device
    port._h_pipeline(port._domain_for(pr1cs), "cpu")
    for name in NATIVE_ROUTES:
        monkeypatch.setattr(nb, name, _raise(name))
    for wit in (z, nb.ints_to_u64(z)):
        timings = {}
        got = port.prove(ppk, pr1cs, wit, random.Random(0), r=r, s=s, device="cpu",
                         timings=timings)
        assert _proof_ints(got) == _proof_ints(want)
        assert timings["matvec"] > 0 and timings["h"] > 0
    monkeypatch.setenv("CRESCENT_NATIVE", "1")
    monkeypatch.undo()
    pubs = z[1 : rr.num_instance]
    assert port.verify(ppk.vk.prepare(), got, pubs, device="cpu")
    assert ref.verify(pk.vk.prepare(), ref.Proof(got.a, want.b, got.c), pubs)


def test_compute_h_matches_reference(keys):
    """_compute_h (native off) gives the reference's _compute_h h(x) and the
    default route's words; an unsatisfied witness trips the degree bound."""
    rr, z, _, pr1cs, _, _ = keys
    dom = port._domain_for(pr1cs)
    want = ref._compute_h(rr, z, ref._domain_for(rr))
    hw = port._compute_h(pr1cs, z, dom, "cpu")
    assert hw.shape == (dom.n, 8)
    assert limb.limbs_to_ints(limb.words_to_limbs(hw))[:-1] == want
    assert torch.equal(hw, port._h_device_words(pr1cs, nb.ints_to_u64(z), dom, "cpu"))
    with pytest.raises(AssertionError, match="degree bound"):
        port._compute_h(pr1cs, z[:-1] + [z[-1] + 1], dom, "cpu")


@pytest.mark.parametrize("native", ["1", "0"])
def test_matvec_evals_match_reference(monkeypatch, native):
    """Both branches of _matvec_evals, on dummy_circuit(6) (62 constraints)
    with two public inputs (domain 128), equal the reference's under the
    same switch."""
    rr, z = ref.dummy_circuit(6, random.Random(41), num_public=2)
    pr1cs, pz = port.dummy_circuit(6, random.Random(41), num_public=2)
    assert pz == z
    monkeypatch.setenv("CRESCENT_NATIVE", native)
    if native == "0":
        monkeypatch.setattr(nb, "coo_matvec", _raise("coo_matvec"))
    got = port._matvec_evals(pr1cs, z, port._domain_for(pr1cs))
    assert got == ref._matvec_evals(rr, z, ref._domain_for(rr))
    # 62 constraint rows, 3 instance identity rows, zeros to the domain's 128
    assert len(got[0]) == 128 and got[0][62:66] == z[:3] + [0]


@pytest.mark.parametrize("native", ["1", "0"])
def test_qap_evals_and_lagrange_match_reference(monkeypatch, native):
    """_qap_evals_at_t's two branches, _lagrange_coeffs_at and
    _batch_inv_host equal the reference's (zeros in the batch inversion's
    input are outside its contract, as in the reference)."""
    rr, _ = ref.dummy_circuit(6, random.Random(42), num_public=3)
    pr1cs, _ = port.dummy_circuit(6, random.Random(42), num_public=3)
    t = random.Random(43).randrange(1, port.R)
    rdom, pdom = ref._domain_for(rr), port._domain_for(pr1cs)
    monkeypatch.setenv("CRESCENT_NATIVE", native)
    assert port._qap_evals_at_t(pr1cs, pdom, t) == ref._qap_evals_at_t(rr, rdom, t)
    L = port._lagrange_coeffs_at(pdom, t)
    assert L == ref._lagrange_coeffs_at(rdom, t) and len(L) == pdom.n == 128
    xs = [random.Random(44 + i).randrange(1, port.R) for i in range(9)] + [1, port.R - 1]
    inv = port._batch_inv_host(xs)
    assert inv == ref._batch_inv_host(xs)
    assert all(x * y % port.R == 1 for x, y in zip(xs, inv))


@pytest.mark.parametrize("native", ["1", "0"])
def test_is_satisfied_matches_reference(monkeypatch, native):
    """R1CS.is_satisfied's two branches: the Python loop (<= 512
    constraints given a list, or the backend off) and the native matvecs
    (more constraints, or a u64 array), on satisfied and unsatisfied
    witnesses, as lists and arrays, against the reference."""
    monkeypatch.setenv("CRESCENT_NATIVE", native)
    if native == "0":
        for name in ("coo_matvec", "vec_op"):
            monkeypatch.setattr(nb, name, _raise(name))
    for log in (4, 10):  # 14 and 1,022 constraints
        rr, z = ref.dummy_circuit(log, random.Random(45))
        pr1cs, _ = port.dummy_circuit(log, random.Random(45))
        bad = z[:-1] + [(z[-1] + 1) % port.R]
        for w in (z, bad, [x + port.R for x in z]):
            for arg in (w, nb.ints_to_u64([x % port.R for x in w])):
                assert pr1cs.is_satisfied(arg) == rr.is_satisfied(arg)
        assert pr1cs.is_satisfied(z) and not pr1cs.is_satisfied(bad)
        assert not pr1cs.is_satisfied(nb.ints_to_u64(bad))


def test_rerandomize_proof_matches_reference(keys):
    """rerandomize_proof with fixed r1, r2, and with both drawn from a
    seeded rng (r1 first), equals the reference's; the result verifies and
    differs from the proof it came from."""
    rr, z, pk, _, ppk, _ = keys
    proof = ref.prove(pk, rr, z, random.Random(1), r=0x1111, s=0x2222)
    pproof = proof_from_reference(proof)
    r1, r2 = 0x5DEECE66D, 0xB
    want = ref.rerandomize_proof(pk.vk, proof, random.Random(0), r1, r2)
    got = port.rerandomize_proof(ppk.vk, pproof, random.Random(0), r1, r2)
    assert _proof_ints(got) == _proof_ints(want)
    want = ref.rerandomize_proof(pk.vk, proof, random.Random(9))
    got = port.rerandomize_proof(ppk.vk, pproof, random.Random(9))
    assert _proof_ints(got) == _proof_ints(want)
    assert got.a != pproof.a
    pubs = z[1 : rr.num_instance]
    assert port.verify(ppk.vk.prepare(), got, pubs, device="cpu")
    assert not port.verify(ppk.vk.prepare(), got, [pubs[0] + 1] + pubs[1:], device="cpu")
