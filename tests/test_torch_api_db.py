"""rs256-db (device-bound credentials) through the port's CLI and API on the
CPU, against the reference (the reference's tests/test_api_db.py end to
end, lib.rs:964).

The port's CLI runs gen-fixtures -> zksetup -> prove -> show -> verify for
rs256-db with the stub statement (the real JWT statement's h(x) through the
plain kernels takes minutes on a CPU; chip_smoke.py runs it on the card at
576 bytes) and `--device cpu`, at the smallest max_cred_len that holds the
generated token.  The token carries the device's public x as the claims
device_key_0/1; the show commits them and carries a DeviceProof (sigma
proofs and a Spartan proof of the device's ECDSA signature on the digest of
the presentation message).  The reference's verify_show must accept the
port's show, the port's must accept a show the reference builds from the
port's client state, and both must refuse a presentation message other
than the signed one; the port's must refuse a show whose device proof is
tampered with or missing.
"""

import contextlib
import hashlib
import io
import json
import os

import pytest
import torch

from crescent_tpu.credentials import api as rapi
from crescent_tpu.credentials import prep_inputs as rprep
from crescent_tpu.credentials.structs import IOLocations as RIOLocations
from crescent_tpu.utils import ark as rark
from crescent_tpu_torch import cli as pcli
from crescent_tpu_torch.credentials import api as papi
from crescent_tpu_torch.credentials import prep_inputs as pprep
from crescent_tpu_torch.utils import ark as park

NAME = "rs256-db"
COMMANDS = ("gen-fixtures", "zksetup", "prove", "show", "verify")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; threads inside
    torch's ops on top of that make the workers wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The port's five commands for rs256-db; after gen-fixtures the config
    is rewritten with the smallest max_cred_len that holds the token (its
    signed part, SHA-256 padded).  Returns the CachePaths, each command's
    exit code and output, and that max_cred_len."""
    base = str(tmp_path_factory.mktemp("db"))
    papi._WITNESS_CACHE.clear()
    out = {}

    def run(cmd):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pcli.main(["--base", base, cmd, "--name", NAME, "--frontend", "stub",
                            "--device", "cpu"])
        out[cmd] = (rc, buf.getvalue())

    run("gen-fixtures")
    paths = papi.CachePaths(os.path.join(base, NAME))
    with open(paths.jwt) as f:
        signed = f.read().strip().rsplit(".", 1)[0]
    mcl = -(-(len(signed) + 9) // 64) * 64
    with open(paths.config) as f:
        config = json.load(f)
    assert config == pcli.DEFAULT_CONFIGS[NAME] and mcl < config["max_cred_len"]
    config["max_cred_len"] = mcl
    with open(paths.config, "w") as f:
        json.dump(config, f)
    for cmd in COMMANDS[1:]:
        run(cmd)
    return paths, out, mcl


def _vp(api, paths):
    """The verifier's parameters from the artifact files, read by `api`."""
    with open(paths.io_locations) as f:
        io_str = f.read()
    with open(paths.issuer_pem) as f:
        issuer = f.read()
    with open(paths.config) as f:
        config = f.read()
    return api.VerifierParams(
        vk=api.read_from_file(paths.groth16_vk), pvk=api.read_from_file(paths.groth16_pvk),
        range_vk=api.read_from_file(paths.range_vk), io_locations_str=io_str,
        issuer_pem=issuer, config_str=config)


def _spec(prep, paths):
    with open(paths.proof_spec + ".resolved") as f:
        return prep.ProofSpec.from_json(f.read())


def _read(ark, path, typ):
    with open(path, "rb") as f:
        return ark.deserialize(f.read(), typ)


def test_cli_db_runs_all_five_commands(db):
    paths, out, mcl = db
    for cmd in COMMANDS:
        assert out[cmd][0] == 0, (cmd, out[cmd][1])
    assert "verify: PASS" in out["verify"][1]
    assert '"email_value": "contoso.com"' in out["verify"][1]
    assert "(device signature proof)" in out["show"][1]
    spec = _spec(pprep, paths)
    assert spec.device_bound
    assert spec.presentation_message == hashlib.sha256(b"default presentation message").digest()
    show = papi.read_from_file(paths.show_proof)
    assert show.device_proof is not None and show.device_proof.digest == spec.presentation_message
    with open(paths.config) as f:
        assert json.load(f)["max_cred_len"] == mcl


def test_db_show_proofs_cross_verify(db):
    """The reference's verify_show accepts the port's show; the port's
    accepts a show that the reference builds from the port's client state,
    signed by the same device key."""
    paths, _, _ = db
    r_vp, p_vp = _vp(rapi, paths), _vp(papi, paths)
    r_spec, p_spec = _spec(rprep, paths), _spec(pprep, paths)
    port_show = _read(rark, paths.show_proof, rapi.ShowProof)
    ok, revealed = rapi.verify_show(r_vp, port_show, r_spec)
    assert ok and json.loads(revealed) == {"email_value": "contoso.com"}
    cs = _read(rark, paths.client_state, rapi.ClientState)
    sig = pcli._load_device(paths).sign(r_spec.presentation_message)
    ref_show = rapi.create_show_proof(
        cs, _read(rark, paths.range_pk, rapi.rp.RangeProofPK),
        RIOLocations.from_file(paths.io_locations), r_spec, device_signature=sig)
    assert ref_show.device_proof is not None
    as_port = park.deserialize(rark.serialize(ref_show), papi.ShowProof)
    assert papi.verify_show(p_vp, as_port, p_spec) == (True, revealed)


def test_db_changed_presentation_message_is_refused(db):
    paths, _, _ = db
    other = hashlib.sha256(b"another presentation message").digest()
    for api, prep, ark in ((papi, pprep, park), (rapi, rprep, rark)):
        spec = _spec(prep, paths)
        spec.presentation_message = other
        show = _read(ark, paths.show_proof, api.ShowProof)
        assert not api.verify_show(_vp(api, paths), show, spec)[0]


def test_db_tampered_or_missing_device_proof_is_refused(db):
    paths, _, _ = db
    vp, spec = _vp(papi, paths), _spec(pprep, paths)
    show = papi.read_from_file(paths.show_proof)
    dp = show.device_proof
    pi2 = bytearray(dp.pi2)
    pi2[len(pi2) // 2] ^= 1
    dp.pi2 = bytes(pi2)
    assert papi.verify_show(vp, show, spec) == (False, "")
    show.device_proof = None
    assert papi.verify_show(vp, show, spec) == (False, "Device proof missing in show_proof")
