"""The port's show path against the reference on the CPU: the host modules it
copied (keccak, merlin, serialize, poly, hash_to_curve, structs), Pedersen
commitments and DLog proofs (credentials/dlog.py), KZG (models/kzg.py), the
range proof (credentials/rangeproof.py) and the rerandomized Groth16 show
(credentials/groth16rand.py), on seeded inputs.

Both packages draw from `random.Random`s of the same seeds, so every object
must come out the same: compared as nested ints (`_flat`), tolerance 0.  A
show made by either package is also checked by the other's verifiers
(`_cross` rebuilds an object in the other package's classes), and
`convert.client_state_from_reference` / `range_keys_from_reference` let one
reference bundle drive both.  One case runs the range setup with the native
backend off, its KZG powers by double-and-add through the plain `jadd` and
`jdbl` (two batches of 128 lanes).
"""

import dataclasses
import enum
import importlib
import random

import pytest
import torch

from crescent_tpu.core import curves as rcurves
from crescent_tpu.core import fields as rfields
from crescent_tpu.credentials import dlog as rdlog
from crescent_tpu.credentials import groth16rand as rrand
from crescent_tpu.credentials import rangeproof as rrange
from crescent_tpu.credentials import structs as rstructs
from crescent_tpu.models import groth16 as rg16
from crescent_tpu.models import kzg as rkzg
from crescent_tpu.utils import hash_to_curve as rh2c
from crescent_tpu.utils import keccak as rkeccak
from crescent_tpu.utils import merlin as rmerlin
from crescent_tpu.utils import poly as rpoly
from crescent_tpu.utils import serialize as rser
from crescent_tpu_torch import convert
from crescent_tpu_torch.core import curves as pcurves
from crescent_tpu_torch.core import fields as pfields
from crescent_tpu_torch.credentials import dlog as pdlog
from crescent_tpu_torch.credentials import groth16rand as prand
from crescent_tpu_torch.credentials import rangeproof as prange
from crescent_tpu_torch.credentials import structs as pstructs
from crescent_tpu_torch.models import groth16 as pg16
from crescent_tpu_torch.models import kzg as pkzg
from crescent_tpu_torch.native import backend as pnb
from crescent_tpu_torch.utils import hash_to_curve as ph2c
from crescent_tpu_torch.utils import keccak as pkeccak
from crescent_tpu_torch.utils import merlin as pmerlin
from crescent_tpu_torch.utils import poly as ppoly
from crescent_tpu_torch.utils import serialize as pser

R = pfields.BN254_FR
G1 = pcurves.BN254_G1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(v):
    """Objects of either package -> nested ints: dataclasses by their
    fields (class name first), field towers by their slots."""
    if v is None or isinstance(v, (int, str, bytes)):
        return v
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (tuple, list)):
        return tuple(_flat(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _flat(x)) for k, x in sorted(v.items()))
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,) + tuple(
            _flat(getattr(v, f.name)) for f in dataclasses.fields(v) if not f.name.startswith("_"))
    slots = getattr(type(v), "__slots__", None)
    if slots is None and hasattr(v, "to_list"):  # ArrayPointVec
        return _flat(v.to_list())
    return (type(v).__name__,) + tuple(_flat(getattr(v, s)) for s in slots)


def _cross(obj, to_port: bool):
    """A show object (proofs, commitments, points, ints) rebuilt in the
    other package's classes: same module path, same class name."""
    src, dst = (("crescent_tpu.", "crescent_tpu_torch.") if to_port
                else ("crescent_tpu_torch.", "crescent_tpu."))
    if obj is None or isinstance(obj, (int, str, bytes)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cross(x, to_port) for x in obj)
    if isinstance(obj, (rfields.Fq2, pfields.Fq2)):
        return (pfields.Fq2 if to_port else rfields.Fq2)(int(obj.c0), int(obj.c1))
    assert dataclasses.is_dataclass(obj) and type(obj).__module__.startswith(src), obj
    cls = getattr(importlib.import_module(type(obj).__module__.replace(src, dst, 1)),
                  type(obj).__name__)
    return cls(**{f.name: _cross(getattr(obj, f.name), to_port)
                  for f in dataclasses.fields(obj) if f.init})


def _points(curve, n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [curve.mul(rng.randrange(1, curve.n), curve.generator) for _ in range(n)]


# -- the copied host modules ------------------------------------------------

def test_keccak_and_merlin_match_reference():
    rng = random.Random(1)
    for _ in range(3):
        state = bytes(rng.randrange(256) for _ in range(200))
        a, b = bytearray(state), bytearray(state)
        pkeccak.keccak_f1600(a)
        rkeccak.keccak_f1600(b)
        assert a == b and a != bytearray(state)
    # merlin's own test vector (transcript.rs tests)
    t = pmerlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    ts = [m.Transcript(b"\x00") for m in (pmerlin, rmerlin)]
    outs = [[], []]
    for k in range(6):
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 300)))
        x = rng.getrandbits(64)
        for t, out in zip(ts, outs):
            t.append_message(b"m%d" % k, msg)
            t.append_u64(b"u", x)
            out.append(t.challenge_bytes(b"\x00", 31 + k))
    assert outs[0] == outs[1]


def test_serialize_matches_reference():
    g1 = _points(G1, 4, 2) + [None]
    for p in g1:
        for f in ("ser_g1_compressed", "ser_g1_uncompressed"):
            b = getattr(pser, f)(p)
            assert b == getattr(rser, f)(p)
            assert getattr(pser, "de" + f)(b) == p
    g2 = [pcurves.BN254G2.mul(k, pcurves.BN254G2.generator()) for k in (7, R - 3)] + [None]
    for p in g2:
        rp = _cross(p, to_port=False)
        for f in ("ser_g2_compressed", "ser_g2_uncompressed"):
            assert getattr(pser, f)(p) == getattr(rser, f)(rp)
        back = pser.deser_g2_uncompressed(pser.ser_g2_uncompressed(p))
        assert _flat(back) == _flat(p)
    t = pcurves.T256.mul(12345, pcurves.T256.generator)
    assert pser.ser_t256_compressed(t) == rser.ser_t256_compressed(t)
    assert pser.deser_t256_compressed(pser.ser_t256_compressed(t)) == t
    for x in (0, 1, R - 1, 2**250 + 7):
        assert pser.ser_fr(x) == rser.ser_fr(x) and pser.deser_fr(pser.ser_fr(x)) == x
        assert pser.ser_fq(x) == rser.ser_fq(x)
    assert pser.ser_u64(2**64 - 2) == rser.ser_u64(2**64 - 2)
    assert pser.ser_vec(g1, pser.ser_g1_compressed) == rser.ser_vec(g1, rser.ser_g1_compressed)
    data = bytes(range(40))
    assert pser.to_b64url(data) == rser.to_b64url(data)
    assert pser.from_b64url(pser.to_b64url(data)) == data


def test_poly_matches_reference():
    rp, pp = random.Random(3), random.Random(3)
    p, q = ppoly.rand_poly(10, R, pp), ppoly.rand_poly(3, R, pp)
    assert p == rpoly.rand_poly(10, R, rp) and q == rpoly.rand_poly(3, R, rp)
    a = pp.randrange(R)
    for f, args in (("add", (p, q, R)), ("sub", (q, p, R)), ("scale", (p, a, R)),
                    ("mul", (p, q, R)), ("evaluate", (p, a, R)),
                    ("divmod_poly", (p, q, R)), ("div_by_linear", (p, a, R)),
                    ("mul_by_vanishing", (p, 8, R)), ("trim", (p + [0, 0],)),
                    ("div_by_vanishing", (ppoly.mul_by_vanishing(p, 8, R), 8, R))):
        assert getattr(ppoly, f)(*args) == getattr(rpoly, f)(*args), f
    qv, rv = ppoly.div_by_vanishing(ppoly.mul_by_vanishing(p, 8, R), 8, R)
    assert qv == ppoly.trim(list(p)) and rv == []


def test_hash_to_curve_and_structs_match_reference():
    assert ph2c.derive_pedersen_bases() == rh2c.derive_pedersen_bases()
    assert ph2c.derive_pedersen_bases(pcurves.T256) == rh2c.derive_pedersen_bases(rcurves.T256)
    for s in ("", "crescent", "x" * 100):
        assert ph2c.hash_to_curve_vartime(s) == rh2c.hash_to_curve_vartime(s)
    assert ph2c.t256_hash_to_curve(b"msg") == rh2c.t256_hash_to_curve(b"msg")
    assert (ph2c.expand_message_xmd(b"abc", b"dst", 96)
            == rh2c.expand_message_xmd(b"abc", b"dst", 96))
    text = "exp_value,1\nmodulus[0],2\nmodulus[1],3\nname_value,4\n"
    p, r = pstructs.IOLocations.from_str(text), rstructs.IOLocations.from_str(text)
    assert p.to_str() == r.to_str() and p.get_all_names() == r.get_all_names()
    assert p.get_io_location("name_value") == r.get_io_location("name_value") == 4
    assert p.get_public_key_indices() == r.get_public_key_indices() == [1, 2]
    assert p.to_str() == text
    assert [t.value for t in pstructs.PublicIOType] == [t.value for t in rstructs.PublicIOType]


# -- Pedersen commitments and DLog proofs ------------------------------------

def test_pedersen_and_dlog_match_reference():
    """pedersen_commit, and DLogPoK over three statements (2, 5 and 20
    bases: msm_select's host oracle and, above 16 points, the native MSM)
    and with an equality position; each package verifies the other's."""
    bases = ph2c.derive_pedersen_bases()
    m = 0xDEADBEEF
    po = pdlog.pedersen_commit(m, bases, rng=random.Random(4))
    assert _flat(po) == _flat(rdlog.pedersen_commit(m, bases, rng=random.Random(4)))
    assert po.c == G1.msm([m, po.r], bases)
    groups = [bases, _points(G1, 5, 5), _points(G1, 20, 6)]
    rng = random.Random(7)
    scalars = [[rng.randrange(R) for _ in g] for g in groups]
    y = [G1.msm(s, g) for s, g in zip(scalars, groups)]
    assert pdlog.msm_select(groups[2], scalars[2], device="cpu") == y[2]
    pok = pdlog.DLogPoK.prove(b"ctx", y, groups, scalars, rng=random.Random(8))
    rpok = rdlog.DLogPoK.prove(b"ctx", y, groups, scalars, rng=random.Random(8))
    assert _flat(pok) == _flat(rpok)
    assert pok.verify(b"ctx", groups, y) and rpok.verify(b"ctx", groups, y)
    assert _cross(rpok, True).verify(b"ctx", groups, y)
    assert _cross(pok, False).verify(b"ctx", groups, y)
    assert not pok.verify(b"other ctx", groups, y)
    # DLEQ: scalars[0][1] == scalars[1][2]
    s1 = list(scalars[1])
    s1[2] = scalars[0][1]
    y1 = G1.msm(s1, groups[1])
    args = (None, [y[0], y1], groups[:2], [scalars[0], s1])
    pok = pdlog.DLogPoK.prove(*args, eq_pos=[(1, 2)], rng=random.Random(9))
    assert _flat(pok) == _flat(rdlog.DLogPoK.prove(*args, eq_pos=[(1, 2)],
                                                   rng=random.Random(9)))
    assert pok.verify(None, groups[:2], [y[0], y1], eq_pos=[(1, 2)])
    assert not pok.verify(None, groups[:2], [y[0], y1], eq_pos=[(0, 2)])


# -- KZG and the range proof --------------------------------------------------

@pytest.fixture(scope="module")
def kzg_keys():
    return (pkzg.setup(64, random.Random(11), device="cpu"),
            rkzg.setup(64, random.Random(11)))


def test_kzg_matches_reference(kzg_keys):
    """setup, commit (with hiding), open_proof, check and batch_check."""
    (powers, vk), (rpowers, rvk) = kzg_keys
    assert _flat(powers) == _flat(rpowers) and _flat(vk) == _flat(rvk)
    assert _flat(convert.kzg_powers_from_reference(rpowers)) == _flat(powers)
    assert _flat(convert.kzg_verifier_key_from_reference(rvk)) == _flat(vk)
    p = ppoly.rand_poly(20, R, random.Random(12))
    com, rand = pkzg.commit(powers, p, 1, random.Random(13))
    rcom, rrand_ = rkzg.commit(rpowers, p, 1, random.Random(13))
    assert _flat((com, rand)) == _flat((rcom, rrand_))
    z = 0x31337
    v = ppoly.evaluate(p, z, R)
    proof = pkzg.open_proof(powers, p, z, rand)
    assert _flat(proof) == _flat(rkzg.open_proof(rpowers, p, z, rrand_))
    assert pkzg.check(vk, com, z, v, proof)
    assert not pkzg.check(vk, com, z, (v + 1) % R, proof)
    coms, zs, vs, proofs = [com, com], [z, z + 1], [v, ppoly.evaluate(p, z + 1, R)], [proof]
    proofs.append(pkzg.open_proof(powers, p, z + 1, rand))
    assert pkzg.batch_check(vk, coms, zs, vs, proofs, random.Random(14))
    assert rkzg.batch_check(rvk, _cross(coms, False), zs, vs, _cross(proofs, False),
                            random.Random(14))
    assert not pkzg.batch_check(vk, coms, zs, [v, v], proofs, random.Random(14))


@pytest.fixture(scope="module")
def range_keys():
    return (prange.setup(32, random.Random(13), device="cpu"),
            rrange.setup(32, random.Random(13)))


def test_range_proof_matches_reference(range_keys):
    """rangeproof.setup(32), prove_n_bits and verify_n_bits on a 32-bit
    value; each package verifies the other's proof; 2^32 and a commitment
    with another blinding are refused."""
    (pk, vk), (rpk, rvk) = range_keys
    assert _flat((pk, vk)) == _flat((rpk, rvk))
    assert _flat(convert.range_keys_from_reference(rpk, rvk)) == _flat((pk, vk))
    bases = ph2c.derive_pedersen_bases()
    ped = pdlog.pedersen_commit(0xFFFFFFFF, bases, rng=random.Random(15))
    rped = rdlog.pedersen_commit(0xFFFFFFFF, bases, rng=random.Random(15))
    proof = prange.prove_n_bits(ped, 32, pk.powers, rng=random.Random(16))
    rproof = rrange.prove_n_bits(rped, 32, rpk.powers, rng=random.Random(16))
    assert _flat(proof) == _flat(rproof)
    assert prange.verify_n_bits(proof, ped.c, bases, 32, vk, rng=random.Random(17))
    assert prange.verify_n_bits(_cross(rproof, True), ped.c, bases, 32, vk)
    assert rrange.verify_n_bits(_cross(proof, False), ped.c, bases, 32, rvk)
    other = pdlog.pedersen_commit(0xFFFFFFFF, bases, rng=random.Random(18))
    assert not prange.verify_n_bits(proof, other.c, bases, 32, vk)
    big = pdlog.pedersen_commit(1 << 32, bases, rng=random.Random(19))
    with pytest.raises(AssertionError):
        prange.prove_n_bits(big, 32, pk.powers, rng=random.Random(20))


def test_range_setup_with_native_off_matches_reference(monkeypatch):
    """rangeproof.setup under CRESCENT_NATIVE=0 on the CPU: kzg.setup's
    powers by fixed_base_mul's double-and-add through the plain jadd and
    jdbl, with the native fixed base made to raise, give the reference's
    keys.  At 16 bits (65 and 66 scalars, 128 lanes each): the route is
    the one of 32 bits, whose 256-lane batches take twice as long through
    the plain versions here (chip_smoke.py runs 32 bits on the card)."""
    rpk, rvk = rrange.setup(16, random.Random(13))

    def no_native(*args, **kwargs):
        raise AssertionError("the native fixed base was reached with the backend off")

    monkeypatch.setenv("CRESCENT_NATIVE", "0")
    monkeypatch.setattr(pnb, "fixed_base", no_native)
    pk, vk = prange.setup(16, random.Random(13), device="cpu")
    assert _flat((pk, vk)) == _flat((rpk, rvk))
    assert (len(pk.powers.powers_of_g), len(pk.powers.powers_of_gamma_g)) == (65, 66)


def test_setups_run_on_the_card_unless_asked_for_the_cpu():
    import inspect

    for fn in (pkzg.setup, prange.setup):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        pkzg.setup(4, random.Random(1))
    with pytest.raises(RuntimeError):
        prange.setup(2, random.Random(1))


# -- the rerandomized Groth16 show -------------------------------------------

def small_circuit(mod):
    """Constraints: a*b = pub0 (32-bit), a*a = pub1, b*b = pub2 (the
    reference's tests/test_groth16rand.py).  Variables: [1, pub0, pub1,
    pub2, a, b]."""
    a, b = 3, 12345
    cons = [
        ([(4, 1)], [(5, 1)], [(1, 1)]),
        ([(4, 1)], [(4, 1)], [(2, 1)]),
        ([(5, 1)], [(5, 1)], [(3, 1)]),
    ]
    return mod.R1CS(4, 2, cons), [1, a * b, a * a, b * b, a, b]


@pytest.fixture(scope="module")
def bundle(range_keys):
    """One credential in both packages: the keys set up from the same seed
    (they must be equal), the port's proof (held against the reference's
    prove in tests/test_torch_groth16.py; the reference's verify must
    accept it here), a ClientState each, and the range keys."""
    rr, z = small_circuit(rg16)
    rpk = rg16.setup(rr, random.Random(21))
    pr1cs, _ = small_circuit(pg16)
    ppk = pg16.setup(pr1cs, random.Random(21), device="cpu")
    assert _flat(ppk) == _flat(rpk)
    pproof = pg16.prove(ppk, pr1cs, z, random.Random(22), device="cpu")
    rproof = _cross(pproof, to_port=False)
    rpvk = rpk.vk.prepare()
    assert rg16.verify(rpvk, rproof, z[1:4])
    rcs = rrand.ClientState(inputs=z[1:4], aux=None, proof=rproof, vk=rpk.vk,
                            pvk=rpvk, config_str="{}")
    pcs = prand.ClientState(inputs=z[1:4], aux=None, proof=pproof, vk=ppk.vk,
                            pvk=ppk.vk.prepare(), config_str="{}")
    return z, rcs, pcs, range_keys


def _io_types(structs):
    T = structs.PublicIOType
    return [T.COMMITTED, T.REVEALED, T.HIDDEN]


def test_client_states_match_reference(bundle):
    """The port's key, proof and prepared key equal the reference's, and so
    does the reference's ClientState carried across by convert."""
    _, rcs, pcs, _ = bundle
    assert _flat(pcs) == _flat(rcs)
    assert _flat(convert.client_state_from_reference(rcs)) == _flat(pcs)


def test_show_groth16_matches_reference(bundle):
    """show_groth16 with a Committed, a Revealed and a Hidden input, from
    the same rng: the same ShowGroth16 (rerandomized proof, commitments,
    DLog proof) and openings; the port's verifier and the reference's accept
    both shows; a changed revealed input or context is refused."""
    z, rcs, pcs, _ = bundle
    ctx = b"test context"
    show = pcs.show_groth16(ctx, _io_types(pstructs), rng=random.Random(23))
    rshow = rcs.show_groth16(ctx, _io_types(rstructs), rng=random.Random(23))
    assert _flat(show) == _flat(rshow)
    assert _flat(pcs.committed_input_openings) == _flat(rcs.committed_input_openings)
    assert pcs.input_com_randomness == rcs.input_com_randomness
    revealed = [z[2]]
    T = _io_types(pstructs)
    assert show.verify(pcs.vk, pcs.pvk, ctx, T, revealed)
    assert _cross(rshow, True).verify(pcs.vk, pcs.pvk, ctx, T, revealed)
    assert _cross(show, False).verify(rcs.vk, rcs.pvk, ctx, _io_types(rstructs), revealed)
    assert not show.verify(pcs.vk, pcs.pvk, ctx, T, [(z[2] + 1) % R])
    assert not show.verify(pcs.vk, pcs.pvk, b"wrong", T, revealed)
    # unlinkable: another show of the same credential looks different
    again = pcs.show_groth16(None, T, rng=random.Random(24))
    assert again.rand_proof.a != show.rand_proof.a
    assert again.verify(pcs.vk, pcs.pvk, None, T, revealed)


def test_show_range_matches_reference(bundle):
    """show_range over the committed input (32 bits), from a ClientState
    that convert carried over from the reference: the same ShowRange, which
    both verifiers accept; another commitment and a value of 2^32 are
    refused."""
    z, rcs, _, ((pk, vk), (rpk, rvk)) = bundle
    rcs.show_groth16(b"ctx", _io_types(rstructs), rng=random.Random(25))
    pcs = convert.client_state_from_reference(rcs)
    opening = pcs.committed_input_openings[0]
    assert opening.m == z[1]
    sr = pcs.show_range(opening, 32, pk, rng=random.Random(26))
    rsr = rcs.show_range(rcs.committed_input_openings[0], 32, rpk, rng=random.Random(26))
    assert _flat(sr) == _flat(rsr)
    locs = pstructs.IOLocations({"exp_value": 1, "square_a": 2, "square_b": 3})
    rlocs = rstructs.IOLocations({"exp_value": 1, "square_a": 2, "square_b": 3})
    assert sr.verify(opening.c, 32, vk, locs, pcs.vk, "exp_value", rng=random.Random(27))
    assert _cross(rsr, True).verify(opening.c, 32, vk, locs, pcs.vk, "exp_value")
    assert _cross(sr, False).verify(rcs.committed_input_openings[0].c, 32, rvk, rlocs,
                                    rcs.vk, "exp_value")
    assert not sr.verify(G1.double(opening.c), 32, vk, locs, pcs.vk, "exp_value")
    big = dataclasses.replace(opening, m=1 << 32)
    with pytest.raises(AssertionError):
        pcs.show_range(big, 32, pk, rng=random.Random(28))
