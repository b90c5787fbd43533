"""Thin client prover — the wasm_lib.rs equivalent.

A copy of ``crescent_tpu/client.py``.  The reference compiles `creds` to
WASM so the browser extension can run the show protocol locally
(`creds/src/wasm_lib.rs:46 create_show_proof_wasm`).  Its analog here is
this host-only module: the show protocol is host-side crypto (rerandomize +
sigma proofs + a 32-bit KZG range proof — Python-int EC math), so a client
needs no card.  The string-in/string-out surface mirrors the wasm export
exactly, so anything that drove the reference's wasm (the sample browser
extension, the client_helper service) maps 1:1.

Inputs/outputs are b64url over ark CanonicalSerialize bytes — the byte
schema of creds/src/utils.rs:140-197.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .credentials import api
from .credentials.prep_inputs import ProofSpec
from .credentials.structs import IOLocations
from .utils.serialize import from_b64url, to_b64url


def _disc_uid_to_age(disc_uid: str) -> int:
    """wasm_lib.rs:36-43 (disc_uid_to_age)."""
    ages = {
        "crescent://over_18": 18,
        "crescent://over_21": 21,
        "crescent://over_65": 65,
    }
    if disc_uid not in ages:
        raise ValueError("disc_uid_to_age: invalid disclosure uid")
    return ages[disc_uid]


def create_show_proof_client(
    client_state_b64url: str,
    range_pk_b64url: str,
    io_locations_str: str,
    disc_uid: str,
    challenge: str,
    proof_spec_b64url: str,
    device_priv_key: Optional[str] = None,
    rng_seed: Optional[bytes] = None,
    cur_time: Optional[int] = None,
) -> str:
    """create_show_proof_wasm (wasm_lib.rs:46-159), argument for argument.

    Returns the b64url ShowProof.  Raises ValueError on malformed inputs
    (the wasm returns Err strings; callers map exceptions the same way).

    `rng_seed`/`cur_time` make the output deterministic (HashDRBG — the
    same stream the JS prover sample/client/crypto/show.js derives), used
    to generate the cross-language golden vectors in sample/client/test/.
    """
    from .credentials.rangeproof import RangeProofPK
    from .utils import ark

    for name, v in (
        ("client_state_b64url", client_state_b64url),
        ("range_pk_b64url", range_pk_b64url),
        ("disc_uid", disc_uid),
        ("io_locations_str", io_locations_str),
        ("challenge", challenge),
        ("proof_spec", proof_spec_b64url),
    ):
        if not v:
            raise ValueError(f"Received empty {name}")

    client_state = ark.deserialize(from_b64url(client_state_b64url), api.ClientState)
    range_pk = ark.deserialize(from_b64url(range_pk_b64url), RangeProofPK)
    io_locations = IOLocations.from_str(io_locations_str)
    proof_spec = ProofSpec.from_json(from_b64url(proof_spec_b64url).decode())

    # presentation message = SHA-256 of the verifier challenge (wasm_lib.rs:105)
    proof_spec.presentation_message = hashlib.sha256(challenge.encode()).digest()

    device_signature = None
    if getattr(proof_spec, "device_bound", None) and device_priv_key:
        from .credentials.device import TestDevice

        device = TestDevice.new_from_pem(device_priv_key)
        device_signature = device.sign(proof_spec.presentation_message)

    rng = None
    if rng_seed is not None:
        from .utils.drbg import HashDRBG

        rng = HashDRBG(rng_seed)

    if client_state.credtype == "mdl":
        age = _disc_uid_to_age(disc_uid)
        proof_spec.range_over_year = {"birth_date": age}
        show_proof = api.create_show_proof_mdl(
            client_state, range_pk, proof_spec, io_locations, device_signature,
            rng=rng, cur_time=cur_time,
        )
    else:
        show_proof = api.create_show_proof(
            client_state, range_pk, io_locations, proof_spec,
            device_signature=device_signature, rng=rng, cur_time=cur_time,
        )
    return to_b64url(ark.serialize(show_proof))
