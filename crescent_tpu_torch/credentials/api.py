"""Top-level Crescent API: zksetup / prove (client state) / show / verify.

The equivalent of creds/src/lib.rs: the four-role pipeline sharing
artifacts through a CachePaths directory layout identical to the
reference's `test-vectors/<name>/` scheme (lib.rs:141-209), the same
ProverParams/ShowParams/VerifierParams bundles (lib.rs:59-106), and the
same show/verify semantics:

  create_show_proof  (lib.rs:305): exp committed + fresh 32-bit range proof
    that exp - cur_time >= 0, issuer-key IOs revealed, proof-spec'd claims
    revealed (or their digest preimages sent), device-bound keys committed,
    everything bound to the serialized internal proof spec as context.
  verify_show (lib.rs:531): rebuild io_types, hash preimages (circom
    Bits2Num over the first 248 digest bits), reassemble the revealed-input
    vector sorted by IO location, check show + freshness (300 s) + range
    (+ device proof).

Statement circuits plug in through `CircuitFrontend`; the native builder
frontend lives in credentials/circuits.py.

Both halves, JWT and mDL, device binding included (a `device_bound` proof
spec: the DeviceProof of credentials/device.py, a Spartan proof of an
ECDSA signature on the presentation message).  The entry points that reach
the device, `run_zksetup` and `create_client_state`, take a keyword-only
`device`, the card by default, and pass it to `groth16.setup`, `prove`,
`verify` and `rangeproof.setup`; they raise without a card unless given
"cpu".  Show and verify run on the host, as the show path does
(credentials/groth16rand.py), the DeviceProof's Spartan NIZK on the native
backend (models/spartan.py).  The mDL half, `create_show_proof_mdl` and
`verify_show_mdl`, is host-only too; its statement is credentials/mdl.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

from ..core.curves import BN254_G1 as G1
from ..core.fields import BN254_FR as R
from ..models import groth16
from . import rangeproof as rp
from .groth16rand import ClientState, ShowGroth16, ShowRange
from .prep_inputs import (
    ProofSpec,
    ProofSpecInternal,
    create_proof_spec_internal,
    pem_to_inputs,
    unpack_int_to_string_unquoted,
)
from .structs import IOLocations, PublicIOType
from ..utils.trace import timed

RANGE_PROOF_INTERVAL_BITS = 32      # lib.rs:50
SHOW_PROOF_VALIDITY_SECONDS = 300   # lib.rs:51
DEFAULT_PROOF_SPEC = '{"revealed" : ["email"]}'  # lib.rs:52


def utc_now_seconds() -> int:
    return int(time.time())


# ---------------------------------------------------------------------------
# CachePaths (lib.rs:141-209) — identical file layout
# ---------------------------------------------------------------------------

class CachePaths:
    def __init__(self, base_path: str):
        assert os.path.isdir(base_path), f"invalid path {base_path}"
        base = base_path.rstrip("/") + "/"
        cache = base + "cache/"
        os.makedirs(cache, exist_ok=True)
        self.base = base
        self.jwt = base + "token.jwt"
        self.issuer_pem = base + "issuer.pub"
        self.config = base + "config.json"
        self.io_locations = base + "io_locations.sym"
        self.wasm = base + "main.wasm"
        self.r1cs = base + "main_c.r1cs"
        self.cache = cache
        self.range_pk = cache + "range_pk.bin"
        self.range_vk = cache + "range_vk.bin"
        self.groth16_vk = cache + "groth16_vk.bin"
        self.groth16_pvk = cache + "groth16_pvk.bin"
        self.prover_params = cache + "prover_params.bin"
        self.client_state = cache + "client_state.bin"
        self.show_proof = cache + "show_proof.bin"
        self.mdl_prover_inputs = base + "prover_inputs.json"
        self.mdl_prover_aux = base + "prover_aux.json"
        self.proof_spec = base + "proof_spec.json"
        self.device_pub_pem = base + "device.pub"
        self.device_prv_pem = base + "device.prv"


def write_to_file(obj, path: str):
    """ark CanonicalSerialize uncompressed bytes, exactly the reference's
    write_to_file (creds/src/utils.rs:140-152); layouts in utils/ark.py."""
    from ..utils import ark

    with open(path, "wb") as f:
        f.write(ark.serialize(obj))


# Single-slot cache for the QAP-scale ProverParams bundle (596 MB at
# rs256@2048): the serving path (sample client_helper) and repeat CLI
# proves in one process re-read the identical file every prove; the
# deserialized bundle is immutable, so one (path, mtime_ns, size)-keyed
# slot makes warm proves skip the parse AND lets ProvingKey's device/
# native table caches survive across proves.  One slot only — switching
# parameter sets evicts, bounding resident params to a single set.
_PARAMS_CACHE: dict = {}


def read_from_file(path: str, typ=None):
    """Typed read (utils.rs:178-188 read_from_file::<T>).  The reference
    names the type at each call site; here the standard CachePaths artifact
    filenames map to their types when `typ` is omitted."""
    from ..utils import ark

    if typ is None:
        typ = _artifact_type(path)
    if typ is ProverParams:
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        if _PARAMS_CACHE.get("key") == key:
            return _PARAMS_CACHE["value"]
    with open(path, "rb") as f:
        out = ark.deserialize(f.read(), typ)
    if typ is ProverParams:
        _PARAMS_CACHE["key"] = key
        _PARAMS_CACHE["value"] = out
    return out


def _artifact_type(path: str):
    from .groth16rand import ClientState
    from .rangeproof import RangeProofPK, RangeProofVK

    name = os.path.basename(path)
    table = {
        "range_pk.bin": RangeProofPK,
        "range_vk.bin": RangeProofVK,
        "groth16_vk.bin": groth16.VerifyingKey,
        "groth16_pvk.bin": groth16.PreparedVerifyingKey,
        "prover_params.bin": ProverParams,
        "client_state.bin": ClientState,
        "show_proof.bin": ShowProof,
    }
    if name not in table:
        raise ValueError(f"read_from_file: pass `typ` for non-standard path {path}")
    return table[name]


# ---------------------------------------------------------------------------
# Parameter bundles (lib.rs:59-106)
# ---------------------------------------------------------------------------

@dataclass
class ProverParams:
    groth16_params: groth16.ProvingKey
    groth16_pvk: groth16.PreparedVerifyingKey
    config_str: str


@dataclass
class ShowParams:
    range_pk: rp.RangeProofPK


@dataclass
class VerifierParams:
    vk: groth16.VerifyingKey
    pvk: groth16.PreparedVerifyingKey
    range_vk: rp.RangeProofVK
    io_locations_str: str
    issuer_pem: str
    config_str: str


@dataclass
class ShowProof:
    show_groth16: ShowGroth16
    show_range_exp: ShowRange
    show_range_attr: list
    revealed_inputs: list
    revealed_preimages: Optional[str]
    inputs_len: int
    cur_time: int
    device_proof: Optional[object]


# ---------------------------------------------------------------------------
# Circuit frontend abstraction
# ---------------------------------------------------------------------------

class CircuitFrontend:
    """Statement provider: shape for setup, shape+witness for proving.

    Implementations: credentials.circuits (native builder gadgets); a circom
    .r1cs + witness-graph loader can slot in here as well (r1cs/reader.py
    reads the files; witness generation for circom artifacts is tracked
    round-2 work)."""

    def setup(self, config: dict):
        """-> (R1CS, IOLocations)."""
        raise NotImplementedError

    def synthesize(self, config: dict, prover_inputs: dict):
        """-> (R1CS, assignment, IOLocations)."""
        raise NotImplementedError


# Per-config witness-program cache: (frontend class, config_str) ->
# (r1cs, io, program-or-None).  The R1CS shape is input-independent (builder
# invariant: gadget control flow is data-independent), so repeat proves of
# the same parameter set replay a compiled witness program natively instead
# of re-running Python gadget synthesis (~16 s at rs256@2048 -> ~0.3 s).
_WITNESS_CACHE: dict = {}


def _synthesize_cached(frontend, config: dict, config_str: str, synth_inputs: dict):
    """-> (r1cs, assignment, io) where assignment is a list of ints (full
    build) or an (nv, 4) u64 array (native replay)."""
    key = (type(frontend).__qualname__, config_str)
    ent = _WITNESS_CACHE.get(key)
    if ent is not None:
        r1cs, io, prog = ent
        if prog is not None:
            with timed("prove::witness replay (native)"):
                pip = frontend.replay_inputs(config, synth_inputs)
                return r1cs, prog.run_native(pip), io
    with timed("prove::frontend.synthesize (witness)"):
        r1cs, assignment, io = frontend.synthesize(config, synth_inputs)
    prog = None
    if getattr(r1cs, "_hints", None) is not None and hasattr(frontend, "replay_inputs"):
        from ..r1cs.witness_program import CompileError, compile_witness_program

        try:
            with timed("prove::witness-program compile"):
                prog = compile_witness_program(r1cs)
                prog.serialize()
        except CompileError:
            prog = None
    _WITNESS_CACHE[key] = (r1cs, io, prog)
    return r1cs, assignment, io


def _context_json(psi: ProofSpecInternal) -> bytes:
    """Serialize ProofSpecInternal exactly as serde_json does for the Rust
    struct (field declaration order, lib.rs:120-128) — this is transcript
    context, so byte layout matters."""
    d = {
        "revealed": psi.revealed,
        "range_over_year": [[k, v] for k, v in psi.range_over_year],
        "hashed": psi.hashed,
        "presentation_message": list(psi.presentation_message)
        if psi.presentation_message is not None
        else None,
        "device_bound": psi.device_bound,
        "config_str": psi.config_str,
        "claim_types": dict(sorted(psi.claim_types.items())),
    }
    return json.dumps(d, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# zksetup (lib.rs:212-249)
# ---------------------------------------------------------------------------

def run_zksetup(base_path: str, frontend: CircuitFrontend, rng: random.Random | None = None,
                *, device="cuda") -> int:
    paths = CachePaths(base_path)
    rng = rng or random.SystemRandom()
    with open(paths.config) as f:
        config_str = f.read()
    from .prep_inputs import parse_config

    config = parse_config(config_str)

    with timed("zksetup::frontend.setup (circuit synthesis)"):
        r1cs, io_locations = frontend.setup(config)
    with open(paths.io_locations, "w") as f:
        f.write(io_locations.to_str())

    with timed("zksetup::groth16.setup (SRS)"):
        params = groth16.setup(r1cs, rng, device=device)
    vk = params.vk
    pvk = vk.prepare()
    range_pk, range_vk = rp.setup(RANGE_PROOF_INTERVAL_BITS, rng, device=device)

    with timed("zksetup::write artifacts"):
        write_to_file(range_pk, paths.range_pk)
        write_to_file(range_vk, paths.range_vk)
        write_to_file(vk, paths.groth16_vk)
        write_to_file(pvk, paths.groth16_pvk)
        write_to_file(ProverParams(params, pvk, config_str), paths.prover_params)
    return 0


# ---------------------------------------------------------------------------
# prove -> ClientState (lib.rs:255-302)
# ---------------------------------------------------------------------------

def create_client_state(
    paths: CachePaths,
    prover_inputs: dict,
    frontend: CircuitFrontend,
    prover_aux: Optional[str] = None,
    credtype: str = "jwt",
    rng: random.Random | None = None,
    *,
    device="cuda",
) -> ClientState:
    rng = rng or random.SystemRandom()
    with timed("prove::read prover params"):
        pp: ProverParams = read_from_file(paths.prover_params, ProverParams)
    from .prep_inputs import parse_config

    config = parse_config(pp.config_str)
    # hashed-claim preimages live in prover_aux (prepare_prover_aux); merge
    # them into the synthesis inputs so frontends can derive {name}_digest
    synth_inputs = dict(prover_inputs)
    if prover_aux:
        for k, v in json.loads(prover_aux).items():
            synth_inputs.setdefault(k, v)
    r1cs, assignment, _io = _synthesize_cached(
        frontend, config, pp.config_str, synth_inputs
    )
    with timed("prove::r1cs.is_satisfied"):
        assert r1cs.is_satisfied(assignment), "witness does not satisfy the statement"

    with timed("prove::groth16.prove"):
        proof = groth16.prove(pp.groth16_params, r1cs, assignment, rng, device=device)
    import numpy as _np

    if isinstance(assignment, _np.ndarray):
        from ..native import backend as _nb

        inputs = _nb.u64_to_ints(assignment[1 : r1cs.num_instance])
    else:
        inputs = assignment[1 : r1cs.num_instance]

    # sanity verify, as the reference does (lib.rs:286-291)
    with timed("prove::sanity groth16.verify"):
        assert groth16.verify(pp.groth16_pvk, proof, inputs, device), \
            "fresh proof failed to verify"

    cs = ClientState(
        inputs=inputs,
        aux=prover_aux,
        proof=proof,
        vk=pp.groth16_params.vk,
        pvk=pp.groth16_pvk,
        config_str=pp.config_str,
        credtype=credtype,
    )
    return cs


# ---------------------------------------------------------------------------
# show (lib.rs:305-400)
# ---------------------------------------------------------------------------

def create_show_proof(
    client_state: ClientState,
    range_pk: rp.RangeProofPK,
    io_locations: IOLocations,
    proof_spec: ProofSpec,
    device_signature: Optional[bytes] = None,
    rng: random.Random | None = None,
    cur_time: Optional[int] = None,
) -> ShowProof:
    rng = rng or random.SystemRandom()
    exp_value_pos = io_locations.get_io_location("exp_value")
    io_types = [PublicIOType.HIDDEN] * len(client_state.inputs)
    io_types[exp_value_pos - 1] = PublicIOType.COMMITTED
    for i in io_locations.get_public_key_indices():
        io_types[i] = PublicIOType.REVEALED

    psi = create_proof_spec_internal(proof_spec, client_state.config_str)

    revealed_inputs = []
    for attr in psi.revealed:
        loc = io_locations.get_io_location(f"{attr}_value")
        io_types[loc - 1] = PublicIOType.REVEALED
        revealed_inputs.append(client_state.inputs[loc - 1])

    revealed_preimages = {}
    for attr in psi.hashed:
        loc = io_locations.get_io_location(f"{attr}_digest")
        io_types[loc - 1] = PublicIOType.REVEALED
        if client_state.aux is None:
            raise ValueError(
                f"Proof spec asked to reveal hashed attribute {attr}, but client state is missing aux data"
            )
        aux = json.loads(client_state.aux)
        # JSON-serialized form, quotes included for strings: this is what
        # the circuit hashes (the [value_l, value_r) JSON slice) and what
        # the reference ships (lib.rs:351 `aux[attr].to_string()`)
        revealed_preimages[attr] = json.dumps(aux[attr], separators=(",", ":"))

    if psi.device_bound:
        io_types[io_locations.get_io_location("device_key_0_value") - 1] = PublicIOType.COMMITTED
        io_types[io_locations.get_io_location("device_key_1_value") - 1] = PublicIOType.COMMITTED

    context = _context_json(psi)
    show = client_state.show_groth16(context, io_types, rng=rng)

    # range proof that exp - cur_time is a 32-bit value (not expired)
    time_sec = utc_now_seconds() if cur_time is None else cur_time
    com_exp = client_state.committed_input_openings[0]
    from .dlog import PedersenOpening

    shifted = PedersenOpening(
        bases=list(com_exp.bases),
        m=(com_exp.m - time_sec) % R,
        r=com_exp.r,
        c=G1.add(com_exp.c, G1.neg(G1.mul(time_sec, com_exp.bases[0]))),
    )
    show_range_exp = client_state.show_range(shifted, RANGE_PROOF_INTERVAL_BITS, range_pk, rng=rng)

    device_proof = None
    if psi.device_bound:
        from .device import DeviceProof, ECDSASig

        assert len(client_state.committed_input_openings) >= 3
        com0 = client_state.committed_input_openings[1]
        com1 = client_state.committed_input_openings[2]
        aux = json.loads(client_state.aux)
        sig = ECDSASig.from_bytes(psi.presentation_message, device_signature)
        with timed("show::device proof (Spartan, ECDSA proof of possession)"):
            device_proof = DeviceProof.prove(
                com0, com1, sig, int(aux["device_pub_x"]), int(aux["device_pub_y"])
            )

    return ShowProof(
        show_groth16=show,
        show_range_exp=show_range_exp,
        show_range_attr=[],
        revealed_inputs=revealed_inputs,
        revealed_preimages=json.dumps(revealed_preimages) if psi.hashed else None,
        inputs_len=len(client_state.inputs),
        cur_time=time_sec,
        device_proof=device_proof,
    )


# ---------------------------------------------------------------------------
# verify (lib.rs:531-720)
# ---------------------------------------------------------------------------

def bits_to_num(data: bytes) -> int:
    """circomlib Bits2Num over the first 248 bits, MSB-first per byte
    (utils.rs:78-95)."""
    bits = []
    for b in data:
        for i in range(7, -1, -1):
            bits.append((b >> i) & 1)
    return sum(bit << i for i, bit in enumerate(bits[:248]))


def _sort_by_io_location(attrs: list, io_locations: IOLocations, suffix: str) -> list:
    return sorted(attrs, key=lambda a: io_locations.get_io_location(f"{a}{suffix}"))


def verify_show(
    vp: VerifierParams,
    show_proof: ShowProof,
    proof_spec: ProofSpec,
    now_seconds: Optional[int] = None,
) -> tuple[bool, str]:
    io_locations = IOLocations.from_str(vp.io_locations_str)
    exp_value_pos = io_locations.get_io_location("exp_value")
    io_types = [PublicIOType.HIDDEN] * show_proof.inputs_len
    io_types[exp_value_pos - 1] = PublicIOType.COMMITTED
    for i in io_locations.get_public_key_indices():
        io_types[i] = PublicIOType.REVEALED

    try:
        psi = create_proof_spec_internal(proof_spec, vp.config_str)
    except Exception:
        return False, ""

    for attr in psi.revealed:
        try:
            loc = io_locations.get_io_location(f"{attr}_value")
        except KeyError:
            return False, ""
        io_types[loc - 1] = PublicIOType.REVEALED

    revealed_hashed = []
    preimages = {}
    if psi.hashed:
        if show_proof.revealed_preimages is None:
            return False, ""
        preimages = json.loads(show_proof.revealed_preimages)
        for attr in _sort_by_io_location(psi.hashed, io_locations, "_digest"):
            try:
                loc = io_locations.get_io_location(f"{attr}_digest")
            except KeyError:
                return False, ""
            io_types[loc - 1] = PublicIOType.REVEALED
            if attr not in preimages:
                return False, ""
            # first 31 digest bytes -> 248 bits, circom Bits2Num order
            digest = hashlib.sha256(preimages[attr].encode()).digest()
            revealed_hashed.append(bits_to_num(digest[:31]))

    if psi.device_bound:
        io_types[io_locations.get_io_location("device_key_0_value") - 1] = PublicIOType.COMMITTED
        io_types[io_locations.get_io_location("device_key_1_value") - 1] = PublicIOType.COMMITTED

    try:
        public_key_inputs = pem_to_inputs(vp.issuer_pem)
    except Exception:
        return False, ""

    inputs = list(revealed_hashed) + [x % R for x in public_key_inputs] + list(show_proof.revealed_inputs)

    context = _context_json(psi)
    if not show_proof.show_groth16.verify(vp.vk, vp.pvk, context, io_types, inputs):
        return False, ""

    now = utc_now_seconds() if now_seconds is None else now_seconds
    if max(0, now - show_proof.cur_time) > SHOW_PROOF_VALIDITY_SECONDS:
        return False, ""

    ped_com_exp = G1.add(
        show_proof.show_groth16.committed_inputs[0],
        G1.neg(G1.mul(show_proof.cur_time, vp.vk.gamma_abc_g1[exp_value_pos])),
    )
    if not show_proof.show_range_exp.verify(
        ped_com_exp, RANGE_PROOF_INTERVAL_BITS, vp.range_vk, io_locations, vp.vk, "exp_value"
    ):
        return False, ""

    if psi.device_bound:
        from .device import DeviceProof

        k0 = io_locations.get_io_location("device_key_0_value")
        k1 = io_locations.get_io_location("device_key_1_value")
        com0 = show_proof.show_groth16.committed_inputs[1]
        com1 = show_proof.show_groth16.committed_inputs[2]
        bases0 = [vp.vk.gamma_abc_g1[k0], vp.vk.delta_g1]
        bases1 = [vp.vk.gamma_abc_g1[k1], vp.vk.delta_g1]
        if show_proof.device_proof is None:
            return False, "Device proof missing in show_proof"
        with timed("verify::device proof (Spartan, ECDSA proof of possession)"):
            if not DeviceProof.verify(show_proof.device_proof, com0, com1, bases0, bases1):
                return False, ""

    # convert revealed field elements back to claim values (lib.rs:684-720)
    revealed = {}
    for idx, attr in enumerate(psi.revealed):
        claim_type = psi.claim_types.get(attr, "")
        v = show_proof.revealed_inputs[idx]
        if claim_type == "number":
            revealed[f"{attr}_value"] = str(v)
        else:
            try:
                revealed[f"{attr}_value"] = unpack_int_to_string_unquoted(v)
            except Exception:
                return False, ""
    for attr in psi.hashed:
        # preimages carry the JSON-serialized claim slice (quotes included
        # for strings — what the circuit hashes); decode for the caller
        try:
            revealed[attr] = json.loads(preimages.get(attr))
        except (TypeError, ValueError):
            revealed[attr] = preimages.get(attr)

    return True, json.dumps(revealed)


# ---------------------------------------------------------------------------
# mDL show / verify (lib.rs:403-530 create_show_proof_mdl,
# lib.rs:723-891 verify_show_mdl)
# ---------------------------------------------------------------------------

def create_show_proof_mdl(
    client_state: ClientState,
    range_pk: rp.RangeProofPK,
    proof_spec: ProofSpec,
    io_locations: IOLocations,
    device_signature: Optional[bytes] = None,
    rng: random.Random | None = None,
    cur_time: Optional[int] = None,
) -> ShowProof:
    rng = rng or random.SystemRandom()
    psi = create_proof_spec_internal(proof_spec, client_state.config_str)

    valid_until_pos = io_locations.get_io_location("valid_until_value")
    io_types = [PublicIOType.HIDDEN] * len(client_state.inputs)
    io_types[valid_until_pos - 1] = PublicIOType.COMMITTED
    for attr, _age in psi.range_over_year:
        loc = io_locations.get_io_location(f"{attr}_value")
        io_types[loc - 1] = PublicIOType.COMMITTED
    for i in io_locations.get_public_key_indices():
        io_types[i] = PublicIOType.REVEALED

    revealed_inputs = []
    for attr in psi.revealed:
        loc = io_locations.get_io_location(f"{attr}_value")
        io_types[loc - 1] = PublicIOType.REVEALED
        revealed_inputs.append(client_state.inputs[loc - 1])

    revealed_preimages = {}
    for attr in psi.hashed:
        loc = io_locations.get_io_location(f"{attr}_digest")
        io_types[loc - 1] = PublicIOType.REVEALED
        if client_state.aux is None:
            raise ValueError(f"missing aux data for hashed attribute {attr}")
        aux = json.loads(client_state.aux)
        # mdl preimages ship as-is (lib.rs:449), unlike the JWT path's
        # JSON-serialized slice
        revealed_preimages[attr] = aux[attr]

    if psi.device_bound:
        io_types[io_locations.get_io_location("device_key_0_value") - 1] = PublicIOType.COMMITTED
        io_types[io_locations.get_io_location("device_key_1_value") - 1] = PublicIOType.COMMITTED

    context = _context_json(psi)
    show = client_state.show_groth16(context, io_types, rng=rng)

    time_sec = utc_now_seconds() if cur_time is None else cur_time
    # range proof: valid_until - now is a 32-bit value (not expired)
    com_vu = client_state.committed_input_openings[0]
    from .dlog import PedersenOpening

    shifted = PedersenOpening(
        bases=list(com_vu.bases),
        m=(com_vu.m - time_sec) % R,
        r=com_vu.r,
        c=G1.add(com_vu.c, G1.neg(G1.mul(time_sec, com_vu.bases[0]))),
    )
    show_range_exp = client_state.show_range(shifted, RANGE_PROOF_INTERVAL_BITS, range_pk, rng=rng)

    device_proof = None
    if psi.device_bound:
        from .device import DeviceProof, ECDSASig

        assert len(client_state.committed_input_openings) >= 3
        com0 = client_state.committed_input_openings[1]
        com1 = client_state.committed_input_openings[2]
        aux = json.loads(client_state.aux)
        sig = ECDSASig.from_bytes(psi.presentation_message, device_signature)
        with timed("show::device proof (Spartan, ECDSA proof of possession)"):
            device_proof = DeviceProof.prove(
                com0, com1, sig, int(aux["device_pub_x"]), int(aux["device_pub_y"]), rng=rng
            )

    # per-attribute "over N years" range proofs (skip the first 3
    # commitments: validUntil, device_key_0, device_key_1 — lib.rs:505)
    from .daystamp import days_to_be_age

    show_range_attr = []
    commitment_index = 3
    for _attr, age in psi.range_over_year:
        days = days_to_be_age(age)
        com_attr = client_state.committed_input_openings[commitment_index]
        shifted_a = PedersenOpening(
            bases=list(com_attr.bases),
            m=(com_attr.m - days) % R,
            r=com_attr.r,
            c=G1.add(com_attr.c, G1.neg(G1.mul(days, com_attr.bases[0]))),
        )
        show_range_attr.append(
            client_state.show_range(shifted_a, RANGE_PROOF_INTERVAL_BITS, range_pk, rng=rng)
        )
        commitment_index += 1

    return ShowProof(
        show_groth16=show,
        show_range_exp=show_range_exp,
        show_range_attr=show_range_attr,
        revealed_inputs=revealed_inputs,
        revealed_preimages=json.dumps(revealed_preimages) if psi.hashed else None,
        inputs_len=len(client_state.inputs),
        cur_time=time_sec,
        device_proof=device_proof,
    )


def verify_show_mdl(
    vp: VerifierParams,
    show_proof: ShowProof,
    proof_spec: ProofSpec,
    now_seconds: Optional[int] = None,
) -> tuple[bool, str]:
    try:
        psi = create_proof_spec_internal(proof_spec, vp.config_str)
    except Exception:
        return False, "verify_show_mdl failed: proof_spec"
    io_locations = IOLocations.from_str(vp.io_locations_str)
    valid_until_pos = io_locations.get_io_location("valid_until_value")
    io_types = [PublicIOType.HIDDEN] * show_proof.inputs_len
    io_types[valid_until_pos - 1] = PublicIOType.COMMITTED
    for attr, _age in psi.range_over_year:
        try:
            loc = io_locations.get_io_location(f"{attr}_value")
        except KeyError:
            return False, "verify_show_mdl failed: range_attr_io"
        io_types[loc - 1] = PublicIOType.COMMITTED
    for i in io_locations.get_public_key_indices():
        io_types[i] = PublicIOType.REVEALED
    for attr in psi.revealed:
        try:
            loc = io_locations.get_io_location(f"{attr}_value")
        except KeyError:
            return False, "verify_show_mdl failed: revealed_io"
        io_types[loc - 1] = PublicIOType.REVEALED

    revealed_hashed = []
    preimages = {}
    if psi.hashed:
        if show_proof.revealed_preimages is None:
            return False, "verify_show_mdl failed: no_preimages"
        preimages = json.loads(show_proof.revealed_preimages)
        hashed_sorted = sorted(
            psi.hashed, key=lambda a: io_locations.get_io_location(f"{a}_digest")
        )
        for attr in hashed_sorted:
            loc = io_locations.get_io_location(f"{attr}_digest")
            io_types[loc - 1] = PublicIOType.REVEALED
            pre = preimages.get(attr)
            if not isinstance(pre, str):
                return False, "verify_show_mdl failed: preimage_type"
            digest = hashlib.sha256(pre.encode()).digest()
            revealed_hashed.append(bits_to_num(digest[:31]))

    if psi.device_bound:
        io_types[io_locations.get_io_location("device_key_0_value") - 1] = PublicIOType.COMMITTED
        io_types[io_locations.get_io_location("device_key_1_value") - 1] = PublicIOType.COMMITTED

    try:
        public_key_inputs = pem_to_inputs(vp.issuer_pem)
    except Exception:
        return False, "verify_show_mdl failed: pem"
    inputs = list(revealed_hashed) + [x % R for x in public_key_inputs] + list(show_proof.revealed_inputs)

    context = _context_json(psi)
    if not show_proof.show_groth16.verify(vp.vk, vp.pvk, context, io_types, inputs):
        return False, "verify_show_mdl failed: groth16_show"

    now = utc_now_seconds() if now_seconds is None else now_seconds
    if max(0, now - show_proof.cur_time) > SHOW_PROOF_VALIDITY_SECONDS:
        return False, "verify_show_mdl failed: freshness"

    ped_com_vu = G1.add(
        show_proof.show_groth16.committed_inputs[0],
        G1.neg(G1.mul(show_proof.cur_time, vp.vk.gamma_abc_g1[valid_until_pos])),
    )
    if not show_proof.show_range_exp.verify(
        ped_com_vu, RANGE_PROOF_INTERVAL_BITS, vp.range_vk, io_locations, vp.vk,
        "valid_until_value",
    ):
        return False, "verify_show_mdl failed: range_valid_until"

    from .daystamp import days_to_be_age

    if len(show_proof.show_range_attr) != len(psi.range_over_year):
        return False, "verify_show_mdl failed: range_attr_count"
    for i, show_range_a in enumerate(show_proof.show_range_attr):
        commitment_index = i + 3  # skip validUntil, device_key_0, device_key_1
        attr, age = psi.range_over_year[i]
        days = days_to_be_age(age)
        try:
            io_pos = io_locations.get_io_location(f"{attr}_value")
        except KeyError:
            return False, "verify_show_mdl failed: range_attr_io2"
        if commitment_index >= len(show_proof.show_groth16.committed_inputs):
            return False, "verify_show_mdl failed: range_attr_commit_idx"
        ped_com_attr = G1.add(
            show_proof.show_groth16.committed_inputs[commitment_index],
            G1.neg(G1.mul(days, vp.vk.gamma_abc_g1[io_pos])),
        )
        if not show_range_a.verify(
            ped_com_attr, RANGE_PROOF_INTERVAL_BITS, vp.range_vk, io_locations,
            vp.vk, f"{attr}_value",
        ):
            return False, "verify_show_mdl failed: range_attr_proof"

    if psi.device_bound:
        from .device import DeviceProof

        k0 = io_locations.get_io_location("device_key_0_value")
        k1 = io_locations.get_io_location("device_key_1_value")
        com0 = show_proof.show_groth16.committed_inputs[1]
        com1 = show_proof.show_groth16.committed_inputs[2]
        bases0 = [vp.vk.gamma_abc_g1[k0], vp.vk.delta_g1]
        bases1 = [vp.vk.gamma_abc_g1[k1], vp.vk.delta_g1]
        if show_proof.device_proof is None:
            return False, "Device proof missing in show_proof"
        with timed("verify::device proof (Spartan, ECDSA proof of possession)"):
            if not DeviceProof.verify(show_proof.device_proof, com0, com1, bases0, bases1):
                return False, "verify_show_mdl failed: device_missing_wait"

    # unpack revealed claim values (lib.rs:684-720 semantics for mdl types)
    revealed = {}
    for idx, attr in enumerate(psi.revealed):
        claim_type = psi.claim_types.get(attr, "")
        v = show_proof.revealed_inputs[idx]
        if claim_type in ("number", "integer", "date"):
            revealed[f"{attr}_value"] = str(v)
        else:
            try:
                revealed[f"{attr}_value"] = unpack_int_to_string_unquoted(v)
            except Exception:
                return False, "verify_show_mdl failed: unpack"
    for attr in psi.hashed:
        revealed[attr] = preimages.get(attr)

    return True, json.dumps(revealed)
