"""The port's JWT statement against the reference on the CPU: the R1CS that
the real rs256 frontend builds (r1cs/{builder,sha256,bigint,jwt_circuit}.py
through credentials/circuits.py JWTFrontend), its assignment by Python
synthesis, and by the compiled witness program's native replay
(r1cs/witness_program.py), for a token that the reference's
`prepare_prover_inputs` prepared.

max_cred_len 192 is the smallest multiple of 64 at which the test token's
statement holds: at 128 the token fits, but the statement is not satisfied,
in the reference as in the port (the first failing constraint lies in the
claim blocks).
Exact comparisons (tolerance 0): constraints through the .r1cs bytes that
`write_r1cs` gives, assignments as ints.
"""

import hashlib
import json

import numpy as np
import pytest

from crescent_tpu.credentials import circuits as rcircuits
from crescent_tpu.credentials import prep_inputs as rprep
from crescent_tpu.r1cs import reader as rreader
from crescent_tpu.r1cs import witness_program as rwp
from crescent_tpu.utils import jwt as rjwt
from crescent_tpu_torch.credentials import api as papi
from crescent_tpu_torch.credentials import circuits as pcircuits
from crescent_tpu_torch.native import backend as pnb
from crescent_tpu_torch.r1cs import reader as preader
from crescent_tpu_torch.utils import trace as ptrace

CONFIG = {
    "alg": "RS256",
    "max_cred_len": 192,
    "exp": {"type": "number", "max_claim_byte_len": 31, "reveal": True},
    "email": {"type": "string", "reveal": True, "max_claim_byte_len": 31,
              "reveal_domain_only": True},
    "tier": {"type": "string", "max_claim_byte_len": 31, "reveal_digest": True},
}
CLAIMS = {"email": "alice@contoso.com", "exp": 2000000000, "tier": "gold"}


@pytest.fixture(scope="module")
def statement():
    """(config_str, config, the merged prover inputs) from the reference's
    `prepare_prover_inputs`."""
    priv, pub = rjwt.generate_rsa_keypair(2048)
    token = rjwt.sign_jwt_rs256(CLAIMS, priv)
    config_str = json.dumps(CONFIG)
    config = rprep.parse_config(config_str)
    pi, aux, _ = rprep.prepare_prover_inputs(config, token, pub)
    merged = dict(pi)
    for k, v in aux.items():
        merged.setdefault(k, v)
    return config_str, config, merged


@pytest.fixture(scope="module")
def reference(statement):
    _, config, inputs = statement
    return rcircuits.JWTFrontend().synthesize(config, inputs)


@pytest.fixture(scope="module")
def port(statement):
    """The port's `_synthesize_cached` twice on one config: the first call
    synthesizes in Python and compiles the witness program, the second
    replays it natively.  Returns ([(its result, the labels of its trace
    spans)] for each call, the compiled program)."""
    config_str, config, inputs = statement
    papi._WITNESS_CACHE.clear()
    fe = pcircuits.JWTFrontend()
    runs = []
    try:
        for _ in range(2):
            with ptrace.recording() as spans:
                out = papi._synthesize_cached(fe, config, config_str, inputs)
            runs.append((out, [s[1] for s in spans]))
        prog = papi._WITNESS_CACHE[(type(fe).__qualname__, config_str)][2]
    finally:
        papi._WITNESS_CACHE.clear()
    return runs, prog


def _r1cs_bytes(mod, r1cs, path) -> bytes:
    """The .r1cs file that `mod.write_r1cs` writes for `r1cs`."""
    mod.write_r1cs(str(path), r1cs.constraints, n_wires=r1cs.num_vars,
                   n_pub_out=r1cs.num_instance - 1, n_pub_in=0,
                   n_prv_in=r1cs.num_witness)
    return path.read_bytes()


def test_write_r1cs_writes_the_same_bytes(tmp_path):
    cons = [([(1, 3)], [(2, 1)], [(0, 5), (2, 7)])]
    args = dict(n_wires=3, n_pub_out=1, n_pub_in=0, n_prv_in=1)
    preader.write_r1cs(str(tmp_path / "p.r1cs"), cons, **args)
    rreader.write_r1cs(str(tmp_path / "r.r1cs"), cons, **args)
    blob = (tmp_path / "p.r1cs").read_bytes()
    assert blob == (tmp_path / "r.r1cs").read_bytes()
    f = preader.read_r1cs(blob)
    assert (f.n_wires, f.num_instance) == (3, 2)
    assert f.to_r1cs().constraints == cons


def test_jwt_setup_r1cs_matches_reference(statement, reference, tmp_path):
    _, config, _ = statement
    r_r1cs, _, r_io = reference
    p_r1cs, p_io = pcircuits.JWTFrontend().setup(config)
    assert (p_r1cs.num_instance, p_r1cs.num_witness) == (r_r1cs.num_instance,
                                                         r_r1cs.num_witness)
    assert p_r1cs.num_instance == 21  # 17 modulus limbs, a digest, exp and email
    pb = _r1cs_bytes(preader, p_r1cs, tmp_path / "p.r1cs")
    rb = _r1cs_bytes(rreader, r_r1cs, tmp_path / "r.r1cs")
    assert hashlib.sha256(pb).digest() == hashlib.sha256(rb).digest()
    assert p_io.to_str() == r_io.to_str()


def test_jwt_synthesis_matches_reference(reference, port):
    r_r1cs, r_z, r_io = reference
    (p_r1cs, p_z, p_io), labels = port[0][0]
    assert "prove::frontend.synthesize (witness)" in labels
    assert "prove::witness replay (native)" not in labels
    assert p_z == r_z
    assert p_r1cs.num_instance == r_r1cs.num_instance
    assert p_r1cs.constraints == r_r1cs.constraints
    assert p_io.to_str() == r_io.to_str()
    assert p_r1cs.is_satisfied(p_z)


def test_native_replay_matches_reference(statement, reference, port):
    """The second `_synthesize_cached` call takes the native replay, and its
    (nv, 4) u64 assignment equals the reference's synthesis; the compiled
    program is the reference's, array for array."""
    _, config, inputs = statement
    r_r1cs, r_z, _ = reference
    runs, prog = port
    (p_r1cs, p_z, _), labels = runs[1]
    assert "prove::witness replay (native)" in labels
    assert "prove::frontend.synthesize (witness)" not in labels
    assert p_r1cs is runs[0][0][0]
    assert isinstance(p_z, np.ndarray) and p_z.shape == (r_r1cs.num_vars, 4)
    assert pnb.u64_to_ints(p_z) == [v % r_r1cs.field for v in r_z]
    assert p_r1cs.is_satisfied(p_z)
    r_prog = rwp.compile_witness_program(r_r1cs)
    for a, b in zip(prog.serialize(), r_prog.serialize()):
        assert np.array_equal(a, b)


def test_replay_without_the_native_backend_raises(statement, port, monkeypatch):
    _, config, inputs = statement
    _, prog = port
    monkeypatch.setattr(pnb, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host backend"):
        prog.run_native(pcircuits.JWTFrontend().replay_inputs(config, inputs))
