"""crescent CLI: zksetup / prove / show / verify (+ gen-fixtures).

Mirrors creds/src/main.rs:52-93: subcommands share state through the
`test-vectors/<name>/` directory layout (CachePaths).  `gen-fixtures`
replaces the reference's run_setup.sh:96-126 sample-credential generation
(random issuer key + deterministic-structure JWT; for device-bound sets a
P-256 device key pair, gen_mdl_device_key.sh equivalent).

Parameter sets (README.md:38-44): rs256, rs256-sd, rs256-db (device
bound: the show carries a Spartan proof of an ECDSA signature on the
presentation message) and mdl1 (an ISO 18013-5 mDL: an ES256-signed
COSE MSO, an "over 18" range proof on the birth date, device bound).

Usage:
  python -m crescent_tpu_torch.cli gen-fixtures --name rs256
  python -m crescent_tpu_torch.cli zksetup --name rs256
  python -m crescent_tpu_torch.cli prove   --name rs256
  python -m crescent_tpu_torch.cli show    --name rs256
  python -m crescent_tpu_torch.cli verify  --name rs256

--device names where zksetup and prove run their device work: the card
(cuda, the default) or the CPU (cpu: the kernels' plain versions).
--frontend stub swaps in the IO-compatible placeholder statement (fast,
NOT sound) for protocol testing; the default is the real JWT circuit, or
the real mDL statement where config.json's credtype is "mdl".
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from .credentials import api
from .credentials.circuits import JWTFrontend, StubJWTFrontend
from .credentials.prep_inputs import ProofSpec, parse_config, prepare_prover_inputs
from .credentials.structs import IOLocations

DEFAULT_BASE = "test-vectors"

_EMAIL_CLAIM = {
    "type": "string", "reveal": True, "max_claim_byte_len": 31,
    "reveal_domain_only": True,
}
DEFAULT_CONFIGS = {
    "rs256": {
        "alg": "RS256",
        # the reference default scale (creds/src/prep_inputs.rs:24); use
        # rs256-sd for a smaller instance
        "max_cred_len": 2048,
        "exp": {"type": "number", "max_claim_byte_len": 31, "reveal": True},
        "email": dict(_EMAIL_CLAIM),
    },
    "rs256-sd": {
        "alg": "RS256",
        "max_cred_len": 384,
        "exp": {"type": "number", "max_claim_byte_len": 31, "reveal": True},
        "family_name": {
            "type": "string", "max_claim_byte_len": 31, "reveal_digest": True,
        },
    },
    "rs256-db": {
        "alg": "RS256",
        "max_cred_len": 576,
        "device_bound": True,
        "exp": {"type": "number", "max_claim_byte_len": 31, "reveal": True},
        "email": dict(_EMAIL_CLAIM),
    },
}
DEFAULT_PROOF_SPECS = {
    "rs256": '{"revealed": ["email"]}',
    "rs256-sd": '{"revealed": ["family_name"]}',
    "rs256-db": '{"revealed": ["email"], "device_bound": true}',
    "mdl1": json.dumps({
        "revealed": ["resident_state", "height", "family_name", "given_name"],
        "range_over_year": {"birth_date": 18},
        "device_bound": True,
        "presentation_message": [1, 2, 3, 4],
    }),
}

MDL1_CONFIG = {
    "credtype": "mdl",
    "alg": "ES256",
    "device_bound": True,
    "max_cred_len": 1792,
    "birth_date": {"type": "date", "reveal": True, "max_claim_byte_len": 31},
    "resident_state": {"type": "string", "reveal": True, "max_claim_byte_len": 31},
    "height": {"type": "integer", "reveal": True, "max_claim_byte_len": 31},
    "family_name": {"type": "string", "reveal_digest": True, "max_claim_byte_len": 62},
    "given_name": {"type": "string", "reveal_digest": True, "max_claim_byte_len": 62},
}
MDL1_ATTRIBUTES = {
    "birth_date": "1990-05-17",
    "resident_state": "WA",
    "height": 170,
    "family_name": "Example",
    "given_name": "Alice",
}


def _paths(args) -> api.CachePaths:
    base = os.path.join(args.base, args.name)
    os.makedirs(base, exist_ok=True)
    return api.CachePaths(base)


def _is_mdl(paths) -> bool:
    try:
        with open(paths.config) as f:
            return json.load(f).get("credtype") == "mdl"
    except FileNotFoundError:
        return False


def _frontend(args, paths):
    if _is_mdl(paths):
        from .credentials.mdl import MDLFrontend, StubMDLFrontend

        if args.frontend == "stub":
            return StubMDLFrontend()
        with open(paths.issuer_pem) as f:
            return MDLFrontend(issuer_pem=f.read())
    if args.frontend == "stub":
        return StubJWTFrontend()
    return JWTFrontend()


def _load_device(paths):
    from .credentials.device import TestDevice

    with open(paths.base + "device.prv") as f:
        secret = int(f.read().strip())
    return TestDevice(secret=secret)


def cmd_gen_fixtures(args):
    from .utils import jwt as jwtutil

    paths = _paths(args)
    if args.name == "mdl1":
        return _gen_mdl_fixtures(paths)
    default_cfg = DEFAULT_CONFIGS.get(args.name, DEFAULT_CONFIGS["rs256"])
    if not os.path.exists(paths.config):
        with open(paths.config, "w") as f:
            json.dump(default_cfg, f, indent=2)
    with open(paths.config) as f:
        config = json.load(f)
    priv, pub = jwtutil.generate_rsa_keypair(2048)
    with open(paths.issuer_pem, "w") as f:
        f.write(pub)
    with open(paths.base + "issuer.prv", "w") as f:
        f.write(priv)
    claims = {
        "email": "alice@contoso.com",
        "family_name": "Example",
        "exp": int(time.time()) + 365 * 86400,
        "iat": int(time.time()),
        "sub": "alice",
    }
    if config.get("device_bound", False):
        from .credentials.device import TestDevice
        from .credentials.ecdsa_pop import split_public_key_x

        dev = TestDevice()
        with open(paths.base + "device.prv", "w") as f:
            f.write(str(dev.secret))
        with open(paths.device_pub_pem, "w") as f:
            f.write(dev.public_pem())
        q0, q1 = split_public_key_x(dev.public[0])
        claims["device_key_0"] = q0
        claims["device_key_1"] = q1
    token = jwtutil.sign_jwt_rs256(claims, priv)
    with open(paths.jwt, "w") as f:
        f.write(token)
    if not os.path.exists(paths.proof_spec):
        with open(paths.proof_spec, "w") as f:
            f.write(DEFAULT_PROOF_SPECS.get(args.name, api.DEFAULT_PROOF_SPEC))
    print(f"fixtures written under {paths.base}")
    return 0


def _gen_mdl_fixtures(paths):
    """mdl-gen + gen_mdl_device_key.sh equivalent: ES256 issuer key in a
    3-cert X.509 chain, P-256 device key, a signed MSO and its circuit
    inputs as prover_inputs.json / prover_aux.json (what the reference's
    mdl prove path reads, SURVEY.md §3.2)."""
    from .credentials.device import TestDevice
    from .credentials.mdl import gen_x509_cert_chain, prepare_mdl_prover_inputs

    if not os.path.exists(paths.config):
        with open(paths.config, "w") as f:
            json.dump(MDL1_CONFIG, f, indent=2)
    priv, pub, chain = gen_x509_cert_chain()
    with open(paths.issuer_pem, "w") as f:
        f.write(pub)
    with open(paths.base + "issuer.prv", "w") as f:
        f.write(priv)
    with open(paths.base + "issuer_chain.pem", "w") as f:
        f.write(chain)
    dev = TestDevice()
    with open(paths.base + "device.prv", "w") as f:
        f.write(str(dev.secret))
    with open(paths.device_pub_pem, "w") as f:
        f.write(dev.public_pem())
    with open(paths.config) as f:
        config = parse_config(f.read())
    pi, aux = prepare_mdl_prover_inputs(
        config, MDL1_ATTRIBUTES, valid_until="2033-01-01",
        issuer_pem=pub, device_pub_pem=dev.public_pem(),
        issuer_priv_pem=priv,  # real issuance: signed MSO + circuit inputs
        x5chain_pem=chain,
    )
    with open(paths.mdl_prover_inputs, "w") as f:
        json.dump(pi, f, indent=2)
    with open(paths.mdl_prover_aux, "w") as f:
        json.dump(aux, f, indent=2)
    if not os.path.exists(paths.proof_spec):
        with open(paths.proof_spec, "w") as f:
            f.write(DEFAULT_PROOF_SPECS["mdl1"])
    print(f"mdl fixtures written under {paths.base}")
    return 0


def cmd_zksetup(args):
    paths = _paths(args)
    t0 = time.time()
    api.run_zksetup(paths.base, _frontend(args, paths), device=args.device)
    print(f"zksetup completed in {time.time()-t0:.1f}s; artifacts in {paths.cache}")
    return 0


def cmd_prove(args):
    paths = _paths(args)
    if _is_mdl(paths):
        return _cmd_prove_mdl(args, paths)
    with open(paths.config) as f:
        config = parse_config(f.read())
    with open(paths.jwt) as f:
        token = f.read().strip()
    with open(paths.issuer_pem) as f:
        issuer_pem = f.read()
    device_pub_pem = None
    if config.get("device_bound", False):
        with open(paths.device_pub_pem) as f:
            device_pub_pem = f.read()
    t0 = time.time()
    prover_inputs, prover_aux, _ = prepare_prover_inputs(
        config, token, issuer_pem, device_pub_pem=device_pub_pem
    )
    cs = api.create_client_state(
        paths, prover_inputs, _frontend(args, paths), prover_aux=json.dumps(prover_aux),
        device=args.device,
    )
    api.write_to_file(cs, paths.client_state)
    print(f"Proving time: {time.time()-t0:.1f}s; client state written to {paths.client_state}")
    return 0


def _cmd_prove_mdl(args, paths):
    """mDL prove: reads prover_inputs.json / prover_aux.json (main.rs mdl
    path; the CBOR mdoc parser feeding these is mdl-tools territory)."""
    with open(paths.mdl_prover_inputs) as f:
        pi = json.load(f)
    with open(paths.mdl_prover_aux) as f:
        aux = json.load(f)
    t0 = time.time()
    cs = api.create_client_state(
        paths, pi, _frontend(args, paths), prover_aux=json.dumps(aux),
        credtype="mdl", device=args.device,
    )
    api.write_to_file(cs, paths.client_state)
    print(f"Proving time: {time.time()-t0:.1f}s; client state written to {paths.client_state}")
    return 0


def _load_proof_spec(paths, args):
    """main.rs:168-196: load the spec, with the presentation message given
    on the command line, if any; when device-bound, replace the raw
    presentation message with its SHA-256 digest."""
    with open(paths.proof_spec) as f:
        spec = ProofSpec.from_json(f.read())
    if args and getattr(args, "presentation_message", None):
        spec.presentation_message = args.presentation_message.encode()
    if spec.device_bound and spec.presentation_message is not None:
        spec.presentation_message = hashlib.sha256(spec.presentation_message).digest()
    elif spec.device_bound:
        # a fresh show still needs a message to sign; default like the CLI
        spec.presentation_message = hashlib.sha256(b"default presentation message").digest()
    return spec


def cmd_show(args):
    paths = _paths(args)
    client_state = api.read_from_file(paths.client_state)
    range_pk = api.read_from_file(paths.range_pk)
    io_locations = IOLocations.from_file(paths.io_locations)
    spec = _load_proof_spec(paths, args)
    device_signature = None
    if spec.device_bound:
        device_signature = _load_device(paths).sign(spec.presentation_message)
    t0 = time.time()
    if _is_mdl(paths):
        sp = api.create_show_proof_mdl(
            client_state, range_pk, spec, io_locations,
            device_signature=device_signature,
        )
    else:
        sp = api.create_show_proof(client_state, range_pk, io_locations, spec,
                                   device_signature=device_signature)
    api.write_to_file(sp, paths.show_proof)
    with open(paths.proof_spec + ".resolved", "w") as f:
        f.write(spec.to_json())
    with open(paths.show_proof, "rb") as f:
        blob = f.read()
    _print_show_proof_size(sp)
    print(f"show completed in {time.time()-t0:.1f}s; proof size {len(blob)} bytes -> {paths.show_proof}")
    return 0


def _print_show_proof_size(sp) -> int:
    """Per-component proof-size breakdown (main.rs:138-166
    show_proof_size): Groth16 + expiry range + per-attribute ranges +
    device proof."""
    from .utils import ark

    parts = [("Groth16 proof", len(ark.serialize(sp.show_groth16))),
             ("range proof", len(ark.serialize(sp.show_range_exp)))]
    parts += [
        (f"range proof{i}", len(ark.serialize(r)))
        for i, r in enumerate(sp.show_range_attr)
    ]
    if sp.device_proof is not None:
        parts.append(("device signature proof", len(ark.serialize(sp.device_proof))))
    total = sum(n for _, n in parts)
    breakdown = " + ".join(f"{n} ({label})" for label, n in parts)
    print(f"Show proof size: {breakdown} = {total} bytes total")
    return total


def cmd_verify(args):
    paths = _paths(args)
    with open(paths.io_locations) as f:
        io_locations_str = f.read()
    with open(paths.issuer_pem) as f:
        issuer_pem = f.read()
    with open(paths.config) as f:
        config_str = f.read()
    vp = api.VerifierParams(
        vk=api.read_from_file(paths.groth16_vk),
        pvk=api.read_from_file(paths.groth16_pvk),
        range_vk=api.read_from_file(paths.range_vk),
        io_locations_str=io_locations_str,
        issuer_pem=issuer_pem,
        config_str=config_str,
    )
    show_proof = api.read_from_file(paths.show_proof)
    if os.path.exists(paths.proof_spec + ".resolved"):
        with open(paths.proof_spec + ".resolved") as f:
            spec = ProofSpec.from_json(f.read())
    else:
        spec = _load_proof_spec(paths, None)
    t0 = time.time()
    if _is_mdl(paths):
        ok, revealed = api.verify_show_mdl(vp, show_proof, spec)
    else:
        ok, revealed = api.verify_show(vp, show_proof, spec)
    print(f"Verification time: {time.time()-t0:.2f}s")
    print(f"verify: {'PASS' if ok else 'FAIL'}")
    if ok:
        print(f"revealed: {revealed}")
    return 0 if ok else 1


def main(argv=None) -> int:
    """Runs one command; returns its exit code."""
    p = argparse.ArgumentParser(prog="crescent", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", default=DEFAULT_BASE, help="base directory for parameter sets")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [
        ("gen-fixtures", cmd_gen_fixtures),
        ("zksetup", cmd_zksetup),
        ("prove", cmd_prove),
        ("show", cmd_show),
        ("verify", cmd_verify),
    ]:
        sp = sub.add_parser(name)
        sp.add_argument("--name", default="rs256")
        sp.add_argument(
            "--frontend", choices=["real", "stub"], default="real",
            help="statement circuit: the real statement or fast IO-stub",
        )
        sp.add_argument(
            "--device", default="cuda",
            help="where zksetup and prove run their device work (cuda or cpu)",
        )
        if name == "show":
            sp.add_argument("--presentation-message", default=None)
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
