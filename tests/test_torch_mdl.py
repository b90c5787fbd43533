"""The port's mDL statement against the reference on the CPU: the CBOR
encoder (utils/cbor.py), the day stamps (credentials/daystamp.py), the date
gadgets (r1cs/dates.py), the non-native P-256 gadgets (r1cs/p256.py) and the
real mdl1 statement (credentials/mdl.py MDLFrontend), with its synthesis and
the compiled witness program's native replay.

The statement is the CLI's MDL1_CONFIG (five attributes, device bound) at
the smallest multiple of 64 that holds the issued MSO, its TBS message SHA-256
padded (576 bytes where MDL1_CONFIG says 1792).  One credential is issued by
the reference's `prepare_mdl_prover_inputs` from a seeded rng and goes
through both packages; a second, issued by the port's own `issue_mdl` for
other attributes, must satisfy both packages' statements (each replays its
own compiled program).  ECDSA signing in `cryptography` draws its own nonce,
so the two issuances are not compared byte for byte.  The circuit is
specialised to its issuer's key while the witness cache keys on the config,
so the cache is cleared around each package's runs.

Exact comparisons (tolerance 0): constraints through the .r1cs bytes that
`write_r1cs` gives, assignments as ints, CBOR as bytes.
"""

import datetime
import hashlib
import json
import random

import numpy as np
import pytest

from crescent_tpu.credentials import api as rapi
from crescent_tpu.credentials import daystamp as rday
from crescent_tpu.credentials import device as rdev
from crescent_tpu.credentials import mdl as rmdl
from crescent_tpu.credentials import prep_inputs as rprep
from crescent_tpu.r1cs import builder as rbuilder
from crescent_tpu.r1cs import dates as rdates
from crescent_tpu.r1cs import p256 as rp256
from crescent_tpu.r1cs import reader as rreader
from crescent_tpu.utils import cbor as rcbor
from crescent_tpu_torch import cli as pcli
from crescent_tpu_torch.core.curves import P256
from crescent_tpu_torch.credentials import api as papi
from crescent_tpu_torch.credentials import daystamp as pday
from crescent_tpu_torch.credentials import mdl as pmdl
from crescent_tpu_torch.credentials import prep_inputs as pprep
from crescent_tpu_torch.native import backend as pnb
from crescent_tpu_torch.r1cs import builder as pbuilder
from crescent_tpu_torch.r1cs import dates as pdates
from crescent_tpu_torch.r1cs import p256 as pp256
from crescent_tpu_torch.r1cs import reader as preader
from crescent_tpu_torch.utils import cbor as pcbor
from crescent_tpu_torch.utils import trace as ptrace

PACKAGES = {"reference": (rcbor, rday, rdates, rp256, rbuilder, rreader),
            "port": (pcbor, pday, pdates, pp256, pbuilder, preader)}


def _r1cs_bytes(reader, r1cs, path) -> bytes:
    """The .r1cs file that `reader.write_r1cs` writes for `r1cs`."""
    reader.write_r1cs(str(path), r1cs.constraints, n_wires=r1cs.num_vars,
                      n_pub_out=r1cs.num_instance - 1, n_pub_in=0,
                      n_prv_in=r1cs.num_witness)
    return path.read_bytes()


# ---------------------------------------------------------------------------
# CBOR
# ---------------------------------------------------------------------------

CBOR_CASES = {
    # unsigned ints at each head size: inline, 1, 2, 4 and 8 bytes
    "uint_0": lambda c: 0,
    "uint_23": lambda c: 23,
    "uint_24": lambda c: 24,
    "uint_255": lambda c: 255,
    "uint_256": lambda c: 256,
    "uint_65535": lambda c: 65535,
    "uint_65536": lambda c: 65536,
    "uint_2^32": lambda c: 1 << 32,
    "neg_1": lambda c: -1,
    "neg_24": lambda c: -24,
    "neg_25": lambda c: -25,
    "neg_257": lambda c: -257,
    "neg_2^32-1": lambda c: -(1 << 32) - 1,
    "bytes_empty": lambda c: b"",
    "bytes_32": lambda c: bytes(range(32)),
    "bytes_300": lambda c: bytes(300),
    "text_empty": lambda c: "",
    "text_ascii": lambda c: "org.iso.18013.5.1.mDL",
    "text_utf8": lambda c: "Ærø über",
    "bool_none": lambda c: [True, False, None],
    "list_nested": lambda c: [1, [2, [3, b"x"]], "y"],
    "map_mixed_keys": lambda c: {"version": "1.0", 1: -7, -1: b"\x01", "a": [1, 2]},
    "tag_1004_date": lambda c: c.Tag(1004, "1990-05-17"),
    "tag_24_bstr": lambda c: c.Tag(24, c.encode({"digestID": 3, "random": bytes(16)})),
    "tag_0_tdate": lambda c: c.Tag(0, "2033-01-01T00:00:00Z"),
}


@pytest.mark.parametrize("case", sorted(CBOR_CASES))
def test_cbor_encode_matches_reference(case):
    make = CBOR_CASES[case]
    assert pcbor.encode(make(pcbor)) == rcbor.encode(make(rcbor))


@pytest.mark.parametrize("n", [0, 1, 23, 24, 32, 95, 255])
def test_cbor_bstr_head_matches_reference(n):
    assert pcbor.bstr_head(n) == rcbor.bstr_head(n)
    for major in range(8):
        assert pcbor._head(major, n) == rcbor._head(major, n)


def test_cbor_refuses_what_the_reference_refuses():
    for mod in (pcbor, rcbor):
        with pytest.raises(TypeError):
            mod.encode(1.5)
        with pytest.raises(AssertionError):
            mod.bstr_head(256)


# ---------------------------------------------------------------------------
# day stamps
# ---------------------------------------------------------------------------

def _days(start: datetime.date, end: datetime.date):
    d = start
    while d <= end:
        yield d
        d += datetime.timedelta(days=1)


SPANS = {
    "1900": (datetime.date(1900, 2, 20), datetime.date(1900, 3, 5)),   # no Feb 29
    "2000": (datetime.date(1999, 12, 25), datetime.date(2000, 3, 5)),  # Feb 29
    "2024": (datetime.date(2023, 12, 25), datetime.date(2024, 3, 5)),  # Feb 29
    "2033": (datetime.date(2032, 12, 25), datetime.date(2033, 1, 5)),
}


@pytest.mark.parametrize("span", sorted(SPANS))
def test_ymd_to_ordinal_matches_reference(span):
    for d in _days(*SPANS[span]):
        got = pday.ymd_to_ordinal(d.year, d.month, d.day)
        assert got == rday.ymd_to_ordinal(d.year, d.month, d.day) == d.toordinal()
        assert pday.days_in_month(d.year, d.month) == rday.days_in_month(d.year, d.month)
        assert pday.days_before_year(d.year) == rday.days_before_year(d.year)
    for mod in (pday, rday):
        with pytest.raises(AssertionError):
            mod.ymd_to_ordinal(2023, 2, 29)


@pytest.mark.parametrize("today", ["2024-02-29", "2024-03-01", "2025-02-28", "2026-10-18"])
def test_days_to_be_age_matches_reference(today):
    """Equal for every age, or an AssertionError in both (age 0, but on
    Feb 29, whose past day is Feb 28)."""
    day = datetime.date.fromisoformat(today)

    def outcome(mod, age):
        try:
            return mod.days_to_be_age(age, day)
        except AssertionError:
            return AssertionError

    for age in (0, 1, 18, 21, 65, 100):
        assert outcome(pday, age) == outcome(rday, age)
    assert outcome(pday, 18) > 18 * 365


# ---------------------------------------------------------------------------
# the date gadgets
# ---------------------------------------------------------------------------

def _date_circuit(dates_mod, builder_mod, ymd):
    """The day stamp (its table covers 1900..2030) and the unix timestamp
    (2024..2040) of ymd, as far as their tables reach."""
    cs = builder_mod.ConstraintSystem()
    y, m, d = (cs.alloc(v) for v in ymd)
    out = {}
    if ymd[0] < dates_mod.DBY_BASE + 131:
        out["daystamp"] = dates_mod.daystamp(cs, y, m, d)
    if ymd[0] >= dates_mod.YEAR_TS_BASE:
        out["unix"] = dates_mod.unix_timestamp(cs, y, m, d)
    return cs, out


@pytest.mark.parametrize("ymd", [(1990, 5, 17), (2000, 2, 29), (2024, 2, 29), (2028, 12, 31),
                                 (2033, 1, 1)], ids=lambda t: "%04d-%02d-%02d" % t)
def test_date_gadgets_match_reference(ymd, tmp_path):
    (p_cs, p_out), (r_cs, r_out) = (_date_circuit(PACKAGES[k][2], PACKAGES[k][4], ymd)
                                    for k in ("port", "reference"))
    assert {k: p_cs.value(v) for k, v in p_out.items()} == {
        k: r_cs.value(v) for k, v in r_out.items()}
    want = {"daystamp": lambda: pday.ymd_to_ordinal(*ymd),
            "unix": lambda: pmdl.circuit_unix_timestamp("%04d-%02d-%02d" % ymd)}
    assert {k: p_cs.value(v) for k, v in p_out.items()} == {k: want[k]() for k in p_out}
    assert p_cs.assignment() == r_cs.assignment()
    assert p_cs.is_satisfied() and r_cs.is_satisfied()
    pb = _r1cs_bytes(preader, p_cs.to_r1cs(), tmp_path / "p.r1cs")
    assert pb == _r1cs_bytes(rreader, r_cs.to_r1cs(), tmp_path / "r.r1cs")


# ---------------------------------------------------------------------------
# the P-256 gadgets
# ---------------------------------------------------------------------------

def _both(build):
    """build(p256 module, builder module) -> ConstraintSystem, in each package."""
    return tuple(build(PACKAGES[k][3], PACKAGES[k][4]) for k in ("port", "reference"))


def _same_circuit(p_cs, r_cs, tmp_path):
    assert p_cs.assignment() == r_cs.assignment()
    pb = _r1cs_bytes(preader, p_cs.to_r1cs(), tmp_path / "p.r1cs")
    rb = _r1cs_bytes(rreader, r_cs.to_r1cs(), tmp_path / "r.r1cs")
    assert hashlib.sha256(pb).digest() == hashlib.sha256(rb).digest()


def test_p256_unit_gadgets_match_reference(tmp_path):
    """nn_mul, nn_enforce and add_unequal on the reference's
    tests/test_p256_gadget.py shapes, from one seed in both packages (the
    fixed-base products run inside ecdsa_verify_gadget, below)."""
    rng = random.Random(20240817)
    a, b, c = (rng.randrange(pp256.P) for _ in range(3))
    g = (P256.gx, P256.gy)
    p1 = P256.msm([rng.randrange(2, P256.n)], [g])
    p2 = P256.msm([rng.randrange(2, P256.n)], [g])

    def build(nn, bld):
        cs = bld.ConstraintSystem()
        la, _ = nn.nn_alloc(cs, a)
        lb, _ = nn.nn_alloc(cs, b)
        r, _ = nn.nn_mul(cs, la, lb, nn.P)
        assert nn.limbs_value(cs, r) == a * b % nn.P
        lc, _ = nn.nn_alloc(cs, c)
        ld, _ = nn.nn_alloc(cs, (a * b + c) % nn.P)
        nn.nn_enforce(cs, [(1, la, lb)], [(1, lc), (-1, ld)], nn.P)
        pts = [nn.nn_alloc(cs, v)[0] for v in (*p1, *p2)]
        x3, y3 = nn.add_unequal(cs, (pts[0], pts[1]), (pts[2], pts[3]))
        assert (nn.limbs_value(cs, x3), nn.limbs_value(cs, y3)) == P256.add(p1, p2)
        assert cs.to_r1cs().is_satisfied(cs.assignment())
        return cs

    _same_circuit(*_both(build), tmp_path)


def _es256_inputs():
    """A real ES256 signature as the reference's tests/test_p256_gadget.py
    makes it: (r, s, the message's SHA-256 as an int, the public key)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature

    priv = ec.generate_private_key(ec.SECP256R1())
    msg = b"crescent-tpu es256 gadget test"
    r, s = decode_dss_signature(priv.sign(msg, ec.ECDSA(hashes.SHA256())))
    nums = priv.public_key().public_numbers()
    return r, s, int.from_bytes(hashlib.sha256(msg).digest(), "big"), (nums.x, nums.y)


def _ecdsa(r_v, s_v, h_v, pub):
    def build(nn, bld):
        cs = bld.ConstraintSystem()
        r, s, h = (nn.nn_alloc(cs, v)[0] for v in (r_v, s_v, h_v))
        nn.ecdsa_verify_gadget(cs, r, s, h, pub)
        return cs

    return build


def test_ecdsa_verify_gadget_matches_reference(tmp_path):
    """The same R1CS (sha256 of its .r1cs bytes) and assignment in both
    packages for a real signature, satisfied; a signature with r + 1 builds
    the same constraints and is unsatisfied in both."""
    r_v, s_v, h_v, pub = _es256_inputs()
    p_cs, r_cs = _both(_ecdsa(r_v, s_v, h_v, pub))
    _same_circuit(p_cs, r_cs, tmp_path)
    p_r1cs = p_cs.to_r1cs()
    assert p_r1cs.is_satisfied(p_cs.assignment())
    assert r_cs.to_r1cs().is_satisfied(r_cs.assignment())
    bad_p, bad_r = _both(_ecdsa((r_v + 1) % pp256.Q, s_v, h_v, pub))
    assert bad_p.assignment() == bad_r.assignment()
    assert bad_p.to_r1cs().constraints == p_r1cs.constraints
    assert not bad_p.to_r1cs().is_satisfied(bad_p.assignment())
    assert not bad_r.to_r1cs().is_satisfied(bad_r.assignment())


# ---------------------------------------------------------------------------
# the mdl1 statement
# ---------------------------------------------------------------------------

ATTRS_A = dict(pcli.MDL1_ATTRIBUTES)
ATTRS_B = {"birth_date": "1985-12-03", "resident_state": "OR", "height": 182,
           "family_name": "Zetaxyz", "given_name": "Bobby"}


def _merged(pi_aux) -> dict:
    pi, aux = pi_aux
    out = dict(pi)
    for k, v in aux.items():
        out.setdefault(k, v)
    return out


@pytest.fixture(scope="module")
def issued():
    """The issuer and device keys, the cut config and two issuances: A by the
    reference's prepare_mdl_prover_inputs, B by the port's."""
    priv, pub = rmdl.generate_es256_issuer_keypair()
    dev = rdev.TestDevice(rng=random.Random(1618))

    def issue(mdl, prep, config, attrs, seed):
        return mdl.prepare_mdl_prover_inputs(
            prep.parse_config(json.dumps(config)), attrs, "2033-01-01", pub,
            device_pub_pem=dev.public_pem(), issuer_priv_pem=priv, rng=random.Random(seed))

    full = issue(rmdl, rprep, pcli.MDL1_CONFIG, ATTRS_A, 7)[0]
    assert len(full["message"]) == pcli.MDL1_CONFIG["max_cred_len"]
    mcl = -(-full["message_padded_bytes"] // 64) * 64
    config = dict(pcli.MDL1_CONFIG, max_cred_len=mcl)
    config_str = json.dumps(config)
    a = _merged(issue(rmdl, rprep, config, ATTRS_A, 7))
    b = _merged(issue(pmdl, pprep, config, ATTRS_B, 8))
    assert a["message_padded_bytes"] <= mcl and b["message_padded_bytes"] <= mcl
    return {"pub": pub, "mcl": mcl, "config_str": config_str, "a": a, "b": b}


@pytest.fixture(scope="module")
def reference(issued):
    """The reference's `_synthesize_cached` on A (synthesis, then its program
    compiled) and on B (its native replay): ([(r1cs, assignment, io)], the
    compiled program)."""
    config = rprep.parse_config(issued["config_str"])
    fe = rmdl.MDLFrontend(issued["pub"])
    rapi._WITNESS_CACHE.clear()
    try:
        runs = [rapi._synthesize_cached(fe, config, issued["config_str"], issued[k])
                for k in ("a", "b")]
        prog = rapi._WITNESS_CACHE[(type(fe).__qualname__, issued["config_str"])][2]
    finally:
        rapi._WITNESS_CACHE.clear()
    return runs, prog


@pytest.fixture(scope="module")
def port(issued):
    """The port's `_synthesize_cached` on A twice (synthesis and compile, then
    the native replay) and on B (replay): ([(its result, the labels of its
    trace spans)], the compiled program)."""
    config = pprep.parse_config(issued["config_str"])
    fe = pmdl.MDLFrontend(issued["pub"])
    papi._WITNESS_CACHE.clear()
    runs = []
    try:
        for k in ("a", "a", "b"):
            with ptrace.recording() as spans:
                out = papi._synthesize_cached(fe, config, issued["config_str"], issued[k])
            runs.append((out, [s[1] for s in spans]))
        prog = papi._WITNESS_CACHE[(type(fe).__qualname__, issued["config_str"])][2]
    finally:
        papi._WITNESS_CACHE.clear()
    return runs, prog


def test_mdl_setup_r1cs_matches_reference(issued, reference, tmp_path):
    """The port's `setup` (no inputs) builds the reference's statement: the
    .r1cs bytes of the R1CS that the reference synthesized, and its IO
    locations."""
    assert issued["mcl"] == 576
    r_r1cs, _, r_io = reference[0][0]
    p_r1cs, p_io = pmdl.MDLFrontend(issued["pub"]).setup(
        pprep.parse_config(issued["config_str"]))
    assert (p_r1cs.num_instance, p_r1cs.num_witness) == (r_r1cs.num_instance,
                                                         r_r1cs.num_witness)
    # digests of family_name and given_name, the key's 12 limbs, validUntil,
    # the device key's two halves, three claim values and the constant one
    assert p_r1cs.num_instance == 21
    pb = _r1cs_bytes(preader, p_r1cs, tmp_path / "p.r1cs")
    rb = _r1cs_bytes(rreader, r_r1cs, tmp_path / "r.r1cs")
    assert hashlib.sha256(pb).digest() == hashlib.sha256(rb).digest()
    assert p_io.to_str() == r_io.to_str()


def test_mdl_synthesis_matches_reference(reference, port):
    r_r1cs, r_z, r_io = reference[0][0]
    (p_r1cs, p_z, p_io), labels = port[0][0]
    assert "prove::frontend.synthesize (witness)" in labels
    assert "prove::witness-program compile" in labels
    assert "prove::witness replay (native)" not in labels
    assert p_z == r_z
    assert p_r1cs.constraints == r_r1cs.constraints
    assert p_io.to_str() == r_io.to_str()


def test_mdl_native_replay_matches_reference(reference, port):
    """The second call on A replays the compiled program natively (the
    P-256 hints among its ops) to the reference's assignment; the program is
    the reference's, array for array."""
    r_r1cs, r_z, _ = reference[0][0]
    runs, prog = port
    (p_r1cs, p_z, _), labels = runs[1]
    assert "prove::witness replay (native)" in labels
    assert "prove::frontend.synthesize (witness)" not in labels
    assert p_r1cs is runs[0][0][0]
    assert isinstance(p_z, np.ndarray) and p_z.shape == (r_r1cs.num_vars, 4)
    assert pnb.u64_to_ints(p_z) == [v % r_r1cs.field for v in r_z]
    assert p_r1cs.is_satisfied(p_z)
    for a, b in zip(prog.serialize(), reference[1].serialize(), strict=True):
        assert np.array_equal(a, b)


def test_port_issuance_satisfies_both_statements(reference, port):
    """A credential issued by the port's issue_mdl (other attributes, another
    signature) satisfies the port's statement and the reference's, each
    replaying its own compiled program, to the same assignment."""
    r_r1cs, r_zb, _ = reference[0][1]
    (p_r1cs, p_zb, _), labels = port[0][2]
    assert "prove::witness replay (native)" in labels
    assert np.array_equal(p_zb, r_zb)
    assert p_r1cs.is_satisfied(p_zb)
    assert r_r1cs.is_satisfied(r_zb)
    # B's public values differ from A's: its own credential, not a replay of A
    ni = p_r1cs.num_instance
    assert not np.array_equal(p_zb[:ni], port[0][1][0][1][:ni])
