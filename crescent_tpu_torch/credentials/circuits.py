"""Statement circuits for the credential pipeline (native frontend).

Reference equivalents: circuit_setup/circuits/*.circom generated per
config.json by prepare_setup.py.  The full JWT statement is
   SHA-256(padded token) -> RSA-65537 verify -> base64 decode -> claim
   matching/packing (match_claim.circom) -> claim digests,
built from the gadget library in r1cs/builder.py and the sha256
gadget (r1cs/sha256.py).

Status: `StubJWTFrontend` below lays out the exact public-IO surface of the
rs256 parameter set (digests, modulus limbs, claim values — io_locations
names match structs.rs expectations) so the whole zksetup/prove/show/verify
pipeline runs end-to-end, but its constraints DO NOT yet enforce the
signature/hash statement — each public IO is only bound to the prover's
witness copy.  It is a scaffold for protocol/API testing, NOT a sound
credential statement; the sha256/rsa/base64/match_claim gadget circuits
replace it (tracked as the main round-2 item in PARITY.md).
"""

from __future__ import annotations

import hashlib
import json

from ..r1cs.builder import LC, ConstraintSystem
from .api import CircuitFrontend, bits_to_num
from .prep_inputs import CRESCENT_CONFIG_KEYS, CIRCOM_RS256_LIMB_BITS


class StubJWTFrontend(CircuitFrontend):
    """Public-IO-faithful placeholder statement for the rs256 family."""

    def _claim_names(self, config: dict):
        # Config insertion order, NOT sorted: prepare_setup.py's claim loop
        # iterates config.json in order, and parse_config appends the
        # device_key_0/1 claims last — the show path's hardcoded
        # committed_input_openings indices ([0]=exp, [1]=dk0, [2]=dk1,
        # lib.rs:372-383) depend on exp_value preceding device_key_*_value.
        revealed, hashed = [], []
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS:
                continue
            if entry.get("reveal_digest", False):
                hashed.append(name)
            elif entry.get("reveal", False):
                revealed.append(name)
        return hashed, revealed

    def _build(self, config: dict, prover_inputs: dict | None) -> ConstraintSystem:
        cs = ConstraintSystem()
        hashed, revealed = self._claim_names(config)
        pi = prover_inputs or {}

        def val(name, default=0):
            v = pi.get(name, default)
            return int(v) if not isinstance(v, list) else [int(x) for x in v]

        pub_vars = []
        # digests first, then modulus limbs, then claim values — mirroring
        # the reference circuit's output ordering (io_locations.sym).
        for name in hashed:
            pub_vars.append((f"{name}_digest", cs.alloc_public(val(f"{name}_digest"), f"{name}_digest")))
        n_limbs = -(-2048 // CIRCOM_RS256_LIMB_BITS)
        modulus = val("modulus", [0] * n_limbs)
        for i in range(n_limbs):
            pub_vars.append((f"modulus[{i}]", cs.alloc_public(modulus[i], f"modulus[{i}]")))
        for name in revealed:
            pub_vars.append((f"{name}_value", cs.alloc_public(val(f"{name}_value"), f"{name}_value")))

        # placeholder binding: pub == private witness copy (1 constraint each).
        for _, v in pub_vars:
            w = cs.alloc(cs.value(v))
            cs.assert_equal(w, v)
        return cs

    def setup(self, config: dict):
        cs = self._build(config, None)
        return cs.to_r1cs(), cs.io_locations()

    def synthesize(self, config: dict, prover_inputs: dict):
        pi = dict(prover_inputs)
        # digests of hashed claims are circuit outputs in the real statement;
        # the stub computes them host-side from aux-provided preimages.
        hashed, _ = self._claim_names(config)
        for name in hashed:
            if f"{name}_digest" not in pi and name in pi:
                # hash the JSON-serialized value (quotes included for
                # strings) — the slice the real circuit hashes
                pre = json.dumps(pi[name], separators=(",", ":"))
                digest = hashlib.sha256(pre.encode()).digest()
                pi[f"{name}_digest"] = bits_to_num(digest[:31])
        cs = self._build(config, pi)
        assert cs.is_satisfied()
        return cs.to_r1cs(), cs.assignment(), cs.io_locations()


class JWTFrontend(CircuitFrontend):
    """The REAL rs256 statement: SHA-256 + RSA-65537 + base64 decode + claim
    matching, built from r1cs/jwt_circuit.py (reference:
    main_header_rs256.circom.template + prepare_setup.py claim loop).

    Public IO layout is identical to StubJWTFrontend (digests, modulus
    limbs, claim values), so IOLocations / show / verify are unchanged —
    only the soundness of the statement differs (this one actually verifies
    the credential).
    """

    def __init__(self, key_bits: int = 2048):
        self.key_bits = key_bits

    def _sizes(self, config: dict) -> tuple[int, int]:
        max_msg = int(config.get("max_cred_len", 2048))
        assert max_msg % 64 == 0
        max_json = ((max_msg + 3) // 4) * 3  # base64_decoded_size
        return max_msg, max_json

    def _claims(self, config: dict):
        out = []
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS:
                continue
            out.append((name, entry))
        return out

    def _build(self, config: dict, prover_inputs: dict | None) -> ConstraintSystem:
        from ..r1cs import jwt_circuit as jc
        from ..r1cs.bigint import rsa65537_verify_gadget
        from ..r1cs.builder import LC
        from ..r1cs.sha256 import sha256_var_gadget
        from .prep_inputs import CIRCOM_RS256_LIMB_BITS

        cs = ConstraintSystem()
        M, J = self._sizes(config)
        claims = self._claims(config)
        pi = prover_inputs or {}

        def val(name, default=0):
            v = pi.get(name, default)
            if isinstance(v, list):
                return [int(x) for x in v]
            return int(v)

        # ---- public IO (same order as StubJWTFrontend) ----
        hashed = [n for n, e in claims if e.get("reveal_digest", False)]
        revealed = [
            n for n, e in claims
            if e.get("reveal", False) and not e.get("reveal_digest", False)
        ]
        pub_digest = {
            n: cs.alloc_public(val(f"{n}_digest"), f"{n}_digest") for n in hashed
        }
        n_limbs = -(-self.key_bits // CIRCOM_RS256_LIMB_BITS)
        modulus_vals = val("modulus", [0] * n_limbs)
        pub_modulus = [
            cs.alloc_public(modulus_vals[i], f"modulus[{i}]") for i in range(n_limbs)
        ]
        pub_value = {
            n: cs.alloc_public(val(f"{n}_value"), f"{n}_value") for n in revealed
        }
        for n in hashed:
            cs.mark_input(pub_digest[n], f"{n}_digest")
        cs.mark_input(pub_modulus, "modulus")
        for n in revealed:
            cs.mark_input(pub_value[n], f"{n}_value")

        # ---- witness: message / signature / framing ----
        msg_vals = val("message", [0] * M)
        message = [cs.alloc(b) for b in msg_vals[:M]]
        cs.mark_input(message, "message")
        sig_vals = val("signature", [0] * n_limbs)
        signature = []
        for i in range(n_limbs):
            v = cs.alloc(sig_vals[i] if i < len(sig_vals) else 0)
            cs.decompose_bits(v, CIRCOM_RS256_LIMB_BITS)
            signature.append(v)
        cs.mark_input(signature, "signature")
        for v in pub_modulus:
            cs.decompose_bits(v, CIRCOM_RS256_LIMB_BITS)
        mpb = cs.alloc(val("message_padded_bytes"))
        cs.mark_input(mpb, "message_padded_bytes")
        period_idx = cs.alloc(val("period_idx"))
        cs.mark_input(period_idx, "period_idx")

        # ---- SHA-256 + RSA-65537 (jwt.circom JWTVerify) ----
        nb = cs.alloc_shr(mpb, 6)
        cs.assert_equal(LC.of(nb, 64), LC.of(mpb))
        digest_bytes = sha256_var_gadget(cs, message, nb)
        expected = jc.digest_bytes_to_pkcs1_limbs(
            cs, digest_bytes, self.key_bits, CIRCOM_RS256_LIMB_BITS
        )
        n_int = 0
        for i, v in enumerate(modulus_vals[:n_limbs]):
            n_int |= int(v) << (i * CIRCOM_RS256_LIMB_BITS)
        rsa65537_verify_gadget(
            cs, signature, pub_modulus, expected, max(n_int, 1),
            limb_bits=CIRCOM_RS256_LIMB_BITS,
        )

        # ---- base64url decode + nesting levels ----
        jwt_bytes = jc.jwt_b64_decode(cs, message, period_idx, J)
        levels = jc.nesting_levels(cs, jwt_bytes)

        # ---- per-claim blocks (prepare_setup.py:50-205) ----
        for name, entry in claims:
            typ = {"string": 0, "number": 1, "date": 0, "integer": 1}[entry["type"]]
            l = cs.alloc(val(f"{name}_l"))
            cs.mark_input(l, f"{name}_l")
            r = cs.alloc(val(f"{name}_r"))
            cs.mark_input(r, f"{name}_r")
            tmpl = f'"{name}":'.encode()
            value_l, value_r = jc.match_claim_name(cs, jwt_bytes, tmpl, l, r, levels)
            mcbl = int(entry.get("max_claim_byte_len", 31))
            if entry.get("reveal_digest", False):
                digest = jc.hash_reveal_claim_value(
                    cs, jwt_bytes, value_l, value_r, mcbl, typ == 1
                )
                cs.assert_equal(pub_digest[name], digest)
            elif entry.get("reveal", False):
                if entry.get("reveal_domain_only", False):
                    v = jc.reveal_domain_only(cs, jwt_bytes, value_l, value_r, mcbl)
                else:
                    v = jc.reveal_claim_value(
                        cs, jwt_bytes, value_l, value_r, mcbl, typ == 1
                    )
                cs.assert_equal(pub_value[name], v)
            else:
                jc.validate_claim_value(cs, jwt_bytes, value_l, value_r, typ)
        return cs

    def setup(self, config: dict):
        cs = self._build(config, None)
        return cs.to_r1cs(), cs.io_locations()

    def replay_inputs(self, config: dict, prover_inputs: dict) -> dict:
        """Preprocess prover inputs exactly as synthesize does (hashed-claim
        digest derivation); the result feeds either _build or a compiled
        witness-program replay (r1cs/witness_program.py)."""
        pi = dict(prover_inputs)
        hashed = [
            n for n, e in self._claims(config) if e.get("reveal_digest", False)
        ]
        for name in hashed:
            if f"{name}_digest" not in pi and name in pi:
                pre = json.dumps(pi[name], separators=(",", ":"))
                digest = hashlib.sha256(pre.encode()).digest()
                pi[f"{name}_digest"] = bits_to_num(digest[:31])
        return pi

    def synthesize(self, config: dict, prover_inputs: dict):
        cs = self._build(config, self.replay_inputs(config, prover_inputs))
        # NOTE: no internal is_satisfied here — api.create_client_state
        # checks satisfaction on the returned R1CS (native COO path), and
        # the redundant check cost ~11 s at rs256@2048 because each
        # cs.is_satisfied() builds a throwaway R1CS + COO cache.
        return cs.to_r1cs(), cs.assignment(), cs.io_locations()
