"""The port's credential API (credentials/api.py) and CLI (cli.py) against
the reference on the CPU: input preparation (credentials/prep_inputs.py),
the stub rs256 statement through run_zksetup -> create_client_state ->
create_show_proof -> verify_show with `device="cpu"`, and the artifacts'
on-disk form (utils/ark.py).

Both packages draw from `random.Random`s of the same seeds and show at one
fixed time, so every artifact file must come out byte for byte the same
(tolerance 0); each package's show proof must pass the other's verify_show,
and a changed revealed input must be refused by both.
"""

import json
import os
import random

import pytest
import torch

from crescent_tpu.core import curves as rcurves
from crescent_tpu.credentials import api as rapi
from crescent_tpu.credentials import circuits as rcircuits
from crescent_tpu.credentials import prep_inputs as rprep
from crescent_tpu.credentials.structs import IOLocations as RIOLocations
from crescent_tpu.utils import ark as rark
from crescent_tpu.utils import jwt as rjwt
from crescent_tpu_torch import cli as pcli
from crescent_tpu_torch.core import curves as pcurves
from crescent_tpu_torch.core import pairing as ppairing
from crescent_tpu_torch.credentials import api as papi
from crescent_tpu_torch.credentials import circuits as pcircuits
from crescent_tpu_torch.credentials import prep_inputs as pprep
from crescent_tpu_torch.credentials.groth16rand import ClientState
from crescent_tpu_torch.credentials.structs import IOLocations as PIOLocations
from crescent_tpu_torch.utils import ark as park
from crescent_tpu_torch.utils import jwt as pjwt
from crescent_tpu_torch.utils.pointvec import ArrayPointVec

CONFIG = {
    "alg": "RS256",
    "max_cred_len": 384,
    "exp": {"type": "number", "max_claim_byte_len": 31, "reveal": True},
    "email": {"type": "string", "reveal": True, "max_claim_byte_len": 31,
              "reveal_domain_only": True},
    "family_name": {"type": "string", "max_claim_byte_len": 31, "reveal_digest": True},
}
CLAIMS = {"email": "alice@contoso.com", "exp": 2000000000, "family_name": "Example",
          "iat": 1700000000, "sub": "alice"}
SPEC = '{"revealed": ["email", "family_name"]}'
NOW = CLAIMS["exp"] - 86400
ARTIFACTS = ("io_locations", "range_pk", "range_vk", "groth16_vk", "groth16_pvk",
             "prover_params", "client_state", "show_proof")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def issuer():
    """(private PEM, public PEM, token) of one issuer key."""
    priv, pub = pjwt.generate_rsa_keypair(2048)
    return priv, pub, pjwt.sign_jwt_rs256(CLAIMS, priv)


# -- input preparation ---------------------------------------------------------

def test_jwt_helpers_match_reference(issuer):
    priv, pub, token = issuer
    assert rjwt.sign_jwt_rs256(CLAIMS, priv) == token   # PKCS#1 v1.5 is deterministic
    assert pjwt.decode_jwt(token) == rjwt.decode_jwt(token)
    assert pjwt.b64url(b"\xff\x00") == rjwt.b64url(b"\xff\x00")
    assert pprep.pem_key_type(pub) == rprep.pem_key_type(pub) == "RS256"
    assert pprep.pem_to_inputs(pub) == rprep.pem_to_inputs(pub)
    assert len(pprep.pem_to_inputs(pub)) == 17


def test_parse_config_matches_reference():
    for cfg in (CONFIG, {"alg": "RS256", "max_cred_len": 100},
                {"alg": "RS256", "device_bound": True,
                 "email": {"type": "string", "reveal": True, "max_claim_byte_len": 31}}):
        assert pprep.parse_config(json.dumps(cfg)) == rprep.parse_config(json.dumps(cfg))
    for bad in ({"max_cred_len": 64}, {"alg": "HS256"}, {"alg": "RS256", "x": 1},
                {"alg": "RS256", "x": {"reveal": True}}, {"alg": "RS256", "max_cred_len": "64"}):
        with pytest.raises(pprep.PrepError) as pe:
            pprep.parse_config(json.dumps(bad))
        with pytest.raises(rprep.PrepError) as re_:
            rprep.parse_config(json.dumps(bad))
        assert str(pe.value) == str(re_.value)


def test_prepare_prover_inputs_matches_reference(issuer):
    priv, pub, token = issuer
    config = pprep.parse_config(json.dumps(CONFIG))
    got = pprep.prepare_prover_inputs(config, token, pub)
    assert got == rprep.prepare_prover_inputs(rprep.parse_config(json.dumps(CONFIG)), token, pub)
    assert got[1] == {"family_name": "Example"}
    forged = token[:-4] + ("AAAA" if token[-4:] != "AAAA" else "BBBB")
    with pytest.raises(Exception):
        pprep.prepare_prover_inputs(config, forged, pub)


def test_proof_spec_internal_matches_reference():
    config_str = json.dumps(CONFIG)
    for spec in (SPEC, '{"revealed": ["email"], "range_over_year": {"exp": 3}}',
                 '{"revealed": [], "device_bound": true, "presentation_message": [1, 2]}'):
        p = pprep.create_proof_spec_internal(pprep.ProofSpec.from_json(spec), config_str)
        r = rprep.create_proof_spec_internal(rprep.ProofSpec.from_json(spec), config_str)
        assert vars(p) == vars(r)
        assert papi._context_json(p) == rapi._context_json(r)
        assert pprep.ProofSpec.from_json(spec).to_json() == rprep.ProofSpec.from_json(spec).to_json()
    with pytest.raises(pprep.PrepError, match="not found"):
        pprep.create_proof_spec_internal(pprep.ProofSpec(revealed=["nope"]), config_str)


def test_g2_prepared_matches_pairing():
    """The PreparedVerifyingKey's ell coefficients (utils/ark.py) reproduce
    the port's pairing, and serialize as the reference's."""
    p = pcurves.BN254_G1.mul(987654321, pcurves.BN254_G1.generator)
    q = pcurves.BN254G2.mul(123456789, pcurves.BN254G2.generator())
    ell, inf = park.g2_prepare(q)
    assert not inf
    f = ppairing.final_exponentiation(park.miller_loop_from_ell(p, ell))
    assert f == ppairing.pairing(p, q)
    rq = rcurves.BN254G2.mul(123456789, rcurves.BN254G2.generator())
    assert park.ser_g2_prepared((ell, inf)) == rark.ser_g2_prepared(rark.g2_prepare(rq))
    assert park.ser_g2_prepared(park.g2_prepare(None)) == bytes(8) + b"\x01"


# -- the stub statement through both packages' APIs -------------------------------

def _pipeline(api, circuits, prep, IOLocations, base, issuer, **dev):
    """zksetup -> prove -> show on the stub frontend, seeded; returns the
    artifact files' bytes and the verifier's parameters."""
    _, pub, token = issuer
    os.makedirs(base)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(CONFIG, f)
    frontend = circuits.StubJWTFrontend()
    api.run_zksetup(base, frontend, random.Random(11), **dev)
    paths = api.CachePaths(base)
    with open(paths.config) as f:
        config = prep.parse_config(f.read())
    pi, aux, _ = prep.prepare_prover_inputs(config, token, pub)
    cs = api.create_client_state(paths, pi, frontend, prover_aux=json.dumps(aux),
                                 rng=random.Random(12), **dev)
    api.write_to_file(cs, paths.client_state)
    cs = api.read_from_file(paths.client_state)
    show = api.create_show_proof(
        cs, api.read_from_file(paths.range_pk), IOLocations.from_file(paths.io_locations),
        prep.ProofSpec.from_json(SPEC), rng=random.Random(13), cur_time=NOW)
    api.write_to_file(show, paths.show_proof)
    with open(paths.io_locations) as f:
        io_str = f.read()
    vp = api.VerifierParams(
        vk=api.read_from_file(paths.groth16_vk), pvk=api.read_from_file(paths.groth16_pvk),
        range_vk=api.read_from_file(paths.range_vk), io_locations_str=io_str,
        issuer_pem=pub, config_str=json.dumps(CONFIG))
    files = {}
    for name in ARTIFACTS:
        with open(getattr(paths, name), "rb") as f:
            files[name] = f.read()
    return files, vp


@pytest.fixture(scope="module")
def pipelines(issuer, tmp_path_factory):
    base = tmp_path_factory.mktemp("api")
    rapi._WITNESS_CACHE.clear()
    papi._WITNESS_CACHE.clear()
    ref = _pipeline(rapi, rcircuits, rprep, RIOLocations, str(base / "ref"), issuer)
    port = _pipeline(papi, pcircuits, pprep, PIOLocations, str(base / "port"), issuer,
                     device="cpu")
    return ref, port


@pytest.mark.parametrize("name", ARTIFACTS)
def test_stub_pipeline_artifacts_are_byte_equal(pipelines, name):
    (ref_files, _), (port_files, _) = pipelines
    assert port_files[name] == ref_files[name]
    assert len(port_files[name]) > 0


def test_show_proofs_cross_verify(pipelines):
    (ref_files, ref_vp), (port_files, port_vp) = pipelines
    p_spec = pprep.ProofSpec.from_json(SPEC)
    r_spec = rprep.ProofSpec.from_json(SPEC)
    ref_show = park.deserialize(ref_files["show_proof"], papi.ShowProof)
    ok, revealed = papi.verify_show(port_vp, ref_show, p_spec, now_seconds=NOW + 10)
    assert ok
    assert json.loads(revealed) == {"email_value": "contoso.com", "family_name": "Example"}
    port_show = rark.deserialize(port_files["show_proof"], rapi.ShowProof)
    assert rapi.verify_show(ref_vp, port_show, r_spec, now_seconds=NOW + 10) == (ok, revealed)
    # stale
    assert not papi.verify_show(port_vp, ref_show, p_spec, now_seconds=NOW + 400)[0]


def test_changed_revealed_input_is_refused(pipelines):
    (ref_files, ref_vp), (port_files, port_vp) = pipelines
    p_spec = pprep.ProofSpec.from_json(SPEC)
    show = park.deserialize(port_files["show_proof"], papi.ShowProof)
    show.revealed_inputs[0] += 1
    assert papi.verify_show(port_vp, show, p_spec, now_seconds=NOW) == (False, "")
    r_show = rark.deserialize(park.serialize(show), rapi.ShowProof)
    assert rapi.verify_show(ref_vp, r_show, rprep.ProofSpec.from_json(SPEC),
                            now_seconds=NOW) == (False, "")
    # a changed preimage of the hashed claim
    show = park.deserialize(port_files["show_proof"], papi.ShowProof)
    show.revealed_preimages = json.dumps({"family_name": '"Exampel"'})
    assert not papi.verify_show(port_vp, show, p_spec, now_seconds=NOW)[0]


def test_prover_params_read_back_as_arrays(pipelines):
    """The SRS tables read back vectorised, as ArrayPointVec, and write
    again to the same bytes."""
    _, (port_files, _) = pipelines
    pp = park.deserialize(port_files["prover_params"], papi.ProverParams)
    pk = pp.groth16_params
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        assert isinstance(getattr(pk, name), ArrayPointVec), name
    assert pk.b_g2_query.g2 and not pk.a_query.g2
    assert park.serialize(pp) == port_files["prover_params"]
    assert park.serialize(pk.vk) == port_files["groth16_vk"]


def test_device_binding_raises_until_ported(pipelines, tmp_path):
    """Device binding is ported (tests/test_torch_api_db.py runs it end to
    end).  A device-bound spec against this credential, whose config
    commits no device key, now fails in the port as it does in the
    reference (no io location device_key_0_value), in show and in verify,
    and ser_device_proof takes only a DeviceProof, as the reference's."""
    (ref_files, ref_vp), (port_files, port_vp) = pipelines
    show = park.deserialize(port_files["show_proof"], papi.ShowProof)
    spec = pprep.ProofSpec(revealed=["email"], presentation_message=b"m", device_bound=True)
    r_spec = rprep.ProofSpec(revealed=["email"], presentation_message=b"m", device_bound=True)
    r_show = rark.deserialize(port_files["show_proof"], rapi.ShowProof)
    for verify, vp, sh, sp in ((papi.verify_show, port_vp, show, spec),
                               (rapi.verify_show, ref_vp, r_show, r_spec)):
        with pytest.raises(KeyError, match="device_key_0_value"):
            verify(vp, sh, sp, now_seconds=NOW)
    cs = park.deserialize(port_files["client_state"], ClientState)
    r_cs = rark.deserialize(ref_files["client_state"], rapi.ClientState)
    for create, c, sp, loc in ((papi.create_show_proof, cs, spec, PIOLocations),
                               (rapi.create_show_proof, r_cs, r_spec, RIOLocations)):
        with pytest.raises(KeyError, match="device_key_0_value"):
            create(c, None, loc.from_str(port_vp.io_locations_str), sp,
                   device_signature=bytes(64), rng=random.Random(1), cur_time=NOW)
    for ser in (park.ser_device_proof, rark.ser_device_proof):
        with pytest.raises(AttributeError):
            ser(object())


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card, zksetup's device work raises unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    base = tmp_path / "set"
    base.mkdir()
    (base / "config.json").write_text(json.dumps(CONFIG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papi.run_zksetup(str(base), pcircuits.StubJWTFrontend(), random.Random(1))


# -- the CLI ------------------------------------------------------------------------

def test_cli_stub_runs_all_five_commands(tmp_path, capsys):
    papi._WITNESS_CACHE.clear()
    base = str(tmp_path)
    for cmd in ("gen-fixtures", "zksetup", "prove", "show", "verify"):
        rc = pcli.main(["--base", base, cmd, "--name", "rs256-sd", "--frontend", "stub",
                        "--device", "cpu"])
        assert rc == 0, cmd
    out = capsys.readouterr().out
    assert "verify: PASS" in out
    assert '"family_name": "Example"' in out
    with open(os.path.join(base, "rs256-sd", "config.json")) as f:
        assert json.load(f) == pcli.DEFAULT_CONFIGS["rs256-sd"]


@pytest.mark.parametrize("name", ["rs256-db", "mdl1"])
def test_cli_refuses_the_sets_not_ported(tmp_path, capsys, name):
    """No parameter set is refused any more.  Both device-bound sets, refused
    until their halves were ported, write their fixtures with exit code 0:
    rs256-db its config, the issuer's key and the device's key pair, whose
    public x rides in the token's claims; mdl1 its config (cli.MDL1_CONFIG),
    an ES256 issuer key in a three-certificate X.509 chain, the device's key
    pair, and the signed MSO's circuit inputs and aux data."""
    rc = pcli.main(["--base", str(tmp_path), "gen-fixtures", "--name", name])
    base = os.path.join(tmp_path, name)
    assert rc == 0
    assert "not ported" not in capsys.readouterr().err
    with open(os.path.join(base, "config.json")) as f:
        config = json.load(f)
    if name == "mdl1":
        assert config == pcli.MDL1_CONFIG and config["device_bound"]
        fnames = ("issuer.pub", "issuer.prv", "issuer_chain.pem", "device.prv", "device.pub",
                  "prover_inputs.json", "prover_aux.json", "proof_spec.json")
    else:
        assert config == pcli.DEFAULT_CONFIGS["rs256-db"]
        assert pcli.DEFAULT_CONFIGS["rs256-db"]["device_bound"]
        fnames = ("device.prv", "device.pub", "issuer.pub", "token.jwt")
    for fname in fnames:
        assert os.path.exists(os.path.join(base, fname)), fname
