"""mdl1's protocol (credentials/api.py create_show_proof_mdl,
verify_show_mdl), the port's CLI for mdl1 and the thin client (client.py,
utils/drbg.py) against the reference on the CPU.

The stub mDL statement (credentials/mdl.py StubMDLFrontend; the real one is
tests/test_torch_mdl.py's, and chip_smoke.py's at 1792 bytes on the card)
on the CLI's MDL1_CONFIG goes through both packages' run_zksetup ->
create_client_state(credtype="mdl") with `device="cpu"`, every draw from a
seeded `random.Random`, and then through each package's thin client, whose
mDL branch (disc_uid crescent://over_21) calls create_show_proof_mdl with a
seeded HashDRBG at one fixed time.  The Spartan prover's OS entropy
(``RandomTape``, models/spartan.py) is patched to the same bytes in both,
and so is the device's signing nonce (the client loads the device key from
its PEM, `TestDevice.new_from_pem`, which signs from the OS), so every
artifact file and the show proof, its DeviceProof and the birth date's
"over 21" range proof among them, must be the same bytes.  The show must
pass the other package's verify_show_mdl with the verification time pinned,
as must a show made by the port's CLI; tampered shows must be refused by
both.  The thin client must reproduce the golden show vectors in
sample/client/test/show_vectors.json byte for byte.  Comparisons are exact
(tolerance 0).
"""

import contextlib
import hashlib
import io
import json
import os
import random
import types

import pytest
import torch

from crescent_tpu import client as rclient
from crescent_tpu.credentials import api as rapi
from crescent_tpu.credentials import device as rdev
from crescent_tpu.credentials import mdl as rmdl
from crescent_tpu.credentials import prep_inputs as rprep
from crescent_tpu.credentials.structs import IOLocations as RIOLocations
from crescent_tpu.models import spartan as rsp
from crescent_tpu.utils import ark as rark
from crescent_tpu.utils import drbg as rdrbg
from crescent_tpu_torch import cli as pcli
from crescent_tpu_torch import client as pclient
from crescent_tpu_torch.credentials import api as papi
from crescent_tpu_torch.credentials import device as pdev
from crescent_tpu_torch.credentials import mdl as pmdl
from crescent_tpu_torch.credentials import prep_inputs as pprep
from crescent_tpu_torch.credentials.structs import IOLocations as PIOLocations
from crescent_tpu_torch.models import spartan as psp
from crescent_tpu_torch.utils import ark as park
from crescent_tpu_torch.utils import drbg as pdrbg
from crescent_tpu_torch.utils.serialize import from_b64url, to_b64url

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = pcli.MDL1_CONFIG
CHALLENGE = "an mDL challenge"
MESSAGE = hashlib.sha256(CHALLENGE.encode()).digest()
# the client puts the challenge's digest and the disc_uid's age into the spec
SPEC = json.dumps({"revealed": ["resident_state", "height", "family_name", "given_name"],
                   "device_bound": True})
DISC_UID = "crescent://over_21"
NOW = 1_900_000_000   # before the credential's validUntil, 2033-01-01
REVEALED = {"resident_state_value": "WA", "height_value": "170",
            "family_name": "Example", "given_name": "Alice"}
ARTIFACTS = ("io_locations", "range_pk", "range_vk", "groth16_vk", "groth16_pvk",
             "prover_params", "client_state", "show_proof")
PACKAGES = {
    "reference": types.SimpleNamespace(api=rapi, mdl=rmdl, prep=rprep, device=rdev, sp=rsp,
                                       ark=rark, client=rclient, IOLocations=RIOLocations,
                                       dev_kw={}),
    "port": types.SimpleNamespace(api=papi, mdl=pmdl, prep=pprep, device=pdev, sp=psp,
                                  ark=park, client=pclient, IOLocations=PIOLocations,
                                  dev_kw={"device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def issuer_pub():
    return rmdl.generate_es256_issuer_keypair()[1]


def _device_pem(secret: int) -> str:
    """The P-256 private key `secret` as a PKCS#8 PEM, as the client takes it."""
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (Encoding, NoEncryption,
                                                              PrivateFormat)

    key = ec.derive_private_key(secret, ec.SECP256R1())
    return key.private_bytes(Encoding.PEM, PrivateFormat.PKCS8, NoEncryption()).decode()


def _verifier_spec(prep):
    """The spec that the client's show answers: SPEC with the challenge's
    digest and the age of DISC_UID."""
    spec = prep.ProofSpec.from_json(SPEC)
    spec.presentation_message = MESSAGE
    spec.range_over_year = {"birth_date": 21}
    return spec


def _pipeline(pkg, base: str, issuer_pub: str):
    """zksetup -> prove on the stub mDL statement, seeded, then the show by
    the package's thin client with the Spartan tape's entropy and the
    device's nonces fixed; returns the artifact files' bytes and the
    verifier's parameters."""
    os.makedirs(base)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(CONFIG, f)
    dev = pkg.device.TestDevice(rng=random.Random(21))
    config = pkg.prep.parse_config(json.dumps(CONFIG))
    pi, aux = pkg.mdl.prepare_mdl_prover_inputs(
        config, pcli.MDL1_ATTRIBUTES, "2033-01-01", issuer_pub, device_pub_pem=dev.public_pem())
    frontend = pkg.mdl.StubMDLFrontend()
    pkg.api.run_zksetup(base, frontend, random.Random(11), **pkg.dev_kw)
    paths = pkg.api.CachePaths(base)
    cs = pkg.api.create_client_state(paths, pi, frontend, prover_aux=json.dumps(aux),
                                     credtype="mdl", rng=random.Random(12), **pkg.dev_kw)
    pkg.api.write_to_file(cs, paths.client_state)
    with open(paths.io_locations) as f:
        io_str = f.read()
    files = {}
    for name in ARTIFACTS[:-1]:
        with open(getattr(paths, name), "rb") as f:
            files[name] = f.read()

    device_cls = pkg.device.TestDevice
    load = device_cls.__dict__["new_from_pem"]
    saved_os = pkg.sp._os
    device_cls.new_from_pem = classmethod(
        lambda cls, pem: cls(secret=load.__func__(cls, pem).secret, rng=random.Random(22)))
    pkg.sp._os = types.SimpleNamespace(urandom=lambda n: bytes(range(7, 7 + n)))
    try:
        show = pkg.client.create_show_proof_client(
            to_b64url(files["client_state"]), to_b64url(files["range_pk"]), io_str, DISC_UID,
            CHALLENGE, to_b64url(SPEC.encode()), device_priv_key=_device_pem(dev.secret),
            rng_seed=b"mdl seed", cur_time=NOW)
    finally:
        device_cls.new_from_pem = load
        pkg.sp._os = saved_os
    files["show_proof"] = from_b64url(show)
    vp = pkg.api.VerifierParams(
        vk=pkg.api.read_from_file(paths.groth16_vk), pvk=pkg.api.read_from_file(paths.groth16_pvk),
        range_vk=pkg.api.read_from_file(paths.range_vk), io_locations_str=io_str,
        issuer_pem=issuer_pub, config_str=json.dumps(CONFIG))
    return files, vp


@pytest.fixture(scope="module")
def pipelines(issuer_pub, tmp_path_factory):
    base = tmp_path_factory.mktemp("mdl")
    out = {}
    for name, pkg in PACKAGES.items():
        pkg.api._WITNESS_CACHE.clear()
        out[name] = _pipeline(pkg, str(base / name), issuer_pub)
        pkg.api._WITNESS_CACHE.clear()
    return out


def _show(name: str, files: dict):
    """The show proof of `files`, read by package `name`."""
    pkg = PACKAGES[name]
    return pkg.ark.deserialize(files["show_proof"], pkg.api.ShowProof)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_mdl_stub_pipeline_artifacts_are_byte_equal(pipelines, name):
    ref_files, port_files = pipelines["reference"][0], pipelines["port"][0]
    assert port_files[name] == ref_files[name]
    assert len(port_files[name]) > 0


def test_mdl_show_carries_the_age_and_device_proofs(pipelines):
    show = _show("port", pipelines["port"][0])
    assert len(show.show_range_attr) == 1
    assert show.device_proof is not None and show.device_proof.digest == MESSAGE
    assert show.cur_time == NOW
    assert json.loads(show.revealed_preimages) == {"family_name": "Example",
                                                   "given_name": "Alice"}


def test_mdl_reference_show_verifies_in_the_port(pipelines):
    """The reference's show (the same bytes as the port's) passes the port's
    verify_show_mdl, the verification time pinned; the port's passes the
    reference's in test_cli_mdl1_show_verifies_in_the_reference."""
    ref_files, port_vp = pipelines["reference"][0], pipelines["port"][1]
    ok, revealed = papi.verify_show_mdl(port_vp, _show("port", ref_files),
                                        _verifier_spec(pprep), now_seconds=NOW + 10)
    assert ok, revealed
    assert json.loads(revealed) == REVEALED


def _tamper(case: str, show, spec):
    """Changes `show` (or `spec`) in place as `case` says."""
    if case == "stale":
        show.cur_time -= 1000
    elif case == "revealed_input":
        show.revealed_inputs[0] += 1
    elif case == "mallory_preimage":
        pre = json.loads(show.revealed_preimages)
        pre["family_name"] = "Mallory"
        show.revealed_preimages = json.dumps(pre)
    elif case == "flipped_pi2":
        pi2 = bytearray(show.device_proof.pi2)
        pi2[len(pi2) // 2] ^= 1
        show.device_proof.pi2 = bytes(pi2)
    elif case == "missing_device_proof":
        show.device_proof = None
    elif case == "wrong_range_count":
        show.show_range_attr = []
    elif case == "other_message":
        spec.presentation_message = hashlib.sha256(b"another challenge").digest()
    elif case == "other_age":
        spec.range_over_year = {"birth_date": 18}


@pytest.mark.parametrize("case", ["stale", "revealed_input", "mallory_preimage", "flipped_pi2",
                                  "missing_device_proof", "wrong_range_count",
                                  "other_message", "other_age"])
def test_mdl_tampered_show_is_refused_by_both(pipelines, case):
    """With `now_seconds` pinned where the untouched show verifies, each
    package refuses the tampered show with the same message."""
    results = []
    for name, pkg in PACKAGES.items():
        files, vp = pipelines[name]
        show, spec = _show(name, files), _verifier_spec(pkg.prep)
        _tamper(case, show, spec)
        results.append(pkg.api.verify_show_mdl(vp, show, spec, now_seconds=NOW + 10))
    assert results[0] == results[1]
    assert results[0][0] is False, results


# -- the CLI ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """gen-fixtures (an X.509 chain for the ES256 issuer key, a signed MSO,
    a device key), zksetup, prove, show and verify for mdl1 on the stub
    statement and the CPU: (the base directory, each command's exit code
    and output)."""
    base = str(tmp_path_factory.mktemp("cli"))
    papi._WITNESS_CACHE.clear()
    out = {}
    for cmd in ("gen-fixtures", "zksetup", "prove", "show", "verify"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pcli.main(["--base", base, cmd, "--name", "mdl1", "--frontend", "stub",
                            "--device", "cpu"])
        out[cmd] = (rc, buf.getvalue())
    papi._WITNESS_CACHE.clear()
    return base, out


def test_cli_mdl1_runs_all_five_commands(cli_run):
    base, out = cli_run
    for cmd, (rc, text) in out.items():
        assert rc == 0, (cmd, text)
    assert "verify: PASS" in out["verify"][1]
    assert json.loads(out["verify"][1].split("revealed: ", 1)[1]) == REVEALED
    assert "(range proof0)" in out["show"][1] and "(device signature proof)" in out["show"][1]
    paths = papi.CachePaths(os.path.join(base, "mdl1"))
    with open(paths.config) as f:
        assert json.load(f) == pcli.MDL1_CONFIG
    show = papi.read_from_file(paths.show_proof)
    assert len(show.show_range_attr) == 1 and show.device_proof is not None


def test_cli_mdl1_show_verifies_in_the_reference(cli_run):
    """The port's show, made by its CLI, passes the reference's
    verify_show_mdl with the CLI's resolved spec and artifacts."""
    base, _ = cli_run
    paths = rapi.CachePaths(os.path.join(base, "mdl1"))
    with open(paths.proof_spec + ".resolved") as f:
        spec = rprep.ProofSpec.from_json(f.read())
    with open(paths.io_locations) as f:
        io_str = f.read()
    with open(paths.issuer_pem) as f:
        issuer = f.read()
    with open(paths.config) as f:
        config = f.read()
    vp = rapi.VerifierParams(
        vk=rapi.read_from_file(paths.groth16_vk), pvk=rapi.read_from_file(paths.groth16_pvk),
        range_vk=rapi.read_from_file(paths.range_vk), io_locations_str=io_str,
        issuer_pem=issuer, config_str=config)
    with open(paths.show_proof, "rb") as f:
        show = rark.deserialize(f.read(), rapi.ShowProof)
    ok, revealed = rapi.verify_show_mdl(vp, show, spec, now_seconds=show.cur_time + 10)
    assert ok, revealed
    assert json.loads(revealed) == REVEALED


def test_cli_mdl1_wants_the_card_unless_given_the_cpu(cli_run):
    """zksetup and prove without --device run on the card, and raise
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    base, _ = cli_run
    try:
        for cmd in ("zksetup", "prove"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pcli.main(["--base", base, cmd, "--name", "mdl1", "--frontend", "stub"])
    finally:
        papi._WITNESS_CACHE.clear()


# -- the thin client ----------------------------------------------------------------

def _vectors() -> list:
    with open(os.path.join(ROOT, "sample", "client", "test", "show_vectors.json")) as f:
        return json.load(f)["cases"]


@pytest.mark.parametrize("case", [c["name"] for c in _vectors()])
def test_client_reproduces_the_golden_show_vectors(case):
    c, = (v for v in _vectors() if v["name"] == case)
    got = pclient.create_show_proof_client(
        c["client_state_b64url"], c["range_pk_b64url"], c["io_locations_str"], c["disc_uid"],
        c["challenge"], c["proof_spec_b64url"], rng_seed=from_b64url(c["rng_seed_b64url"]),
        cur_time=c["cur_time"])
    assert got == c["expected_show_proof_b64url"]


@pytest.mark.parametrize("seed", [b"", b"crescent", "text seed", bytes(range(64))])
def test_hash_drbg_streams_match_reference(seed):
    p, r = pdrbg.HashDRBG(seed), rdrbg.HashDRBG(seed)
    for n in (1, 2, 255, 256, 2**64, 2**254 + 12345, 3**200):
        assert p.randrange(n) == r.randrange(n)
        assert p.randrange(n, 2 * n + 7) == r.randrange(n, 2 * n + 7)
    for k in (1, 7, 8, 9, 64, 253):
        assert p.getrandbits(k) == r.getrandbits(k)
    assert p.random() == r.random()
    assert p._take(100) == r._take(100)
    for drbg in (p, r):
        with pytest.raises(ValueError):
            drbg.randrange(5, 5)


def test_client_disc_uid_to_age_matches_reference():
    for uid in ("crescent://over_18", "crescent://over_21", "crescent://over_65"):
        assert pclient._disc_uid_to_age(uid) == rclient._disc_uid_to_age(uid)
    for mod in (pclient, rclient):
        with pytest.raises(ValueError):
            mod._disc_uid_to_age("crescent://over_30")


def test_client_refuses_empty_inputs_as_the_reference():
    for mod in (pclient, rclient):
        with pytest.raises(ValueError, match="Received empty challenge"):
            mod.create_show_proof_client("a", "b", "c", "d", "", "f")
