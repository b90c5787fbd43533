"""JWT -> circuit-inputs pipeline (host; creds/src/prep_inputs.rs).

Every packing rule here must match the circom circuits bit-exactly
(SURVEY.md §2a "must match packing bit-exactly"):
  * UTF-8 code points of "header.payload", SHA-256 padded, zero-extended to
    max_cred_len (prep_inputs.rs:120-146).
  * RSA signature/modulus as 17x121-bit limbs (:25, to_circom_ints:463),
    P-256 keys as 2x6x43-bit limbs for mDL (:26).
  * per-claim byte intervals in the decoded JSON (find_value_interval:356),
    with the circom base64 quirk of NUL padding between header and payload
    (base_64_decoded_header_padding:432).
  * claim values packed little-endian base-256, quoted for strings
    (pack_string_to_int:315, matching RevealClaimValue in match_claim.circom).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_MAX_TOKEN_LENGTH = 2048
CIRCOM_RS256_LIMB_BITS = 121
CIRCOM_ES256_LIMB_BITS = 43
MAX_FIELD_BYTE_LEN = 31

CRESCENT_SUPPORTED_ALGS = {"RS256", "ES256"}
CRESCENT_CONFIG_KEYS = {"alg", "credtype", "max_cred_len", "device_bound"}


class PrepError(ValueError):
    pass


# ---------------------------------------------------------------------------
# base64url / PEM helpers
# ---------------------------------------------------------------------------

def b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def pem_key_type(pem: str) -> str:
    from cryptography.hazmat.primitives.asymmetric import ec, rsa
    from cryptography.hazmat.primitives.serialization import load_pem_public_key

    key = load_pem_public_key(pem.encode())
    if isinstance(key, rsa.RSAPublicKey):
        return "RS256"
    if isinstance(key, ec.EllipticCurvePublicKey):
        return "ES256"
    raise PrepError("Unsupported algorithm")


def pem_to_inputs(issuer_pem: str) -> list[int]:
    """Issuer public key -> field-element limb list (prep_inputs.rs:60-92).
    RS256: 17x121-bit limbs of the modulus; ES256: 6+6 43-bit limbs of x, y."""
    from cryptography.hazmat.primitives.serialization import load_pem_public_key

    kind = pem_key_type(issuer_pem)
    key = load_pem_public_key(issuer_pem.encode())
    if kind == "RS256":
        n = key.public_numbers().n
        return to_circom_ints_from_int(n, CIRCOM_RS256_LIMB_BITS)
    nums = key.public_numbers()
    return to_circom_ints_from_int(nums.x, CIRCOM_ES256_LIMB_BITS) + to_circom_ints_from_int(
        nums.y, CIRCOM_ES256_LIMB_BITS
    )


# ---------------------------------------------------------------------------
# packing primitives (bit-exact with circom)
# ---------------------------------------------------------------------------

def to_circom_ints(n_bytes: bytes, limb_size: int) -> list[int]:
    """Big-endian bytes -> little-endian limbs of limb_size bits
    (prep_inputs.rs:463-485; limb count = ceil(bitlen/limb_size))."""
    n = int.from_bytes(n_bytes, "big")
    return to_circom_ints_from_int(n, limb_size)


def to_circom_ints_from_int(n: int, limb_size: int) -> list[int]:
    # limb count derived from the value's bit length, matching the
    # reference's BigInt::bits().div_ceil(limb_size) (prep_inputs.rs:465)
    num_limbs = -(-n.bit_length() // limb_size) if n else 0
    mask = (1 << limb_size) - 1
    return [(n >> (i * limb_size)) & mask for i in range(num_limbs)]


def b64_to_circom_limbs(n_b64: str, limb_size: int) -> list[str]:
    return [str(x) for x in to_circom_ints(b64url_decode(n_b64), limb_size)]


def sha256_padding(prepad_m: list[int]) -> list[int]:
    """SHA-256 message padding over byte values (prep_inputs.rs:485-507)."""
    msg_length_bits = len(prepad_m) * 8
    padded = list(prepad_m)
    padded.append(0x80)
    while len(padded) % 64 != 56:
        padded.append(0)
    padded.extend(msg_length_bits.to_bytes(8, "big"))
    return padded


def to_utf8_integers(s: str) -> list[int]:
    return [ord(c) for c in s]


def base64_decoded_size(encoded_len: int) -> int:
    return -(-encoded_len // 4) * 3


def base_64_decoded_header_padding(header_len: int) -> str:
    """NUL padding the circom base64 decoder emits for '='-padded headers
    (prep_inputs.rs:432-451)."""
    m = header_len % 4
    if m == 0:
        return ""
    if m == 1:
        raise PrepError("Invalid period_idx, the base64 encoding of the header is invalid")
    return "\0\0" if m == 2 else "\0"


def pack_string_to_int_unquoted(s: str, n_bytes: int) -> int:
    """Base-256 little-endian packing, zero padded (matches RevealDomainOnly
    in match_claim.circom; prep_inputs.rs:322-343)."""
    raw = s.encode()
    if len(raw) > n_bytes:
        raise PrepError(f"String too large to convert to integer of n_bytes = {n_bytes}")
    return int.from_bytes(raw + b"\x00" * (n_bytes - len(raw)), "little")


def pack_string_to_int(s: str, n_bytes: int) -> int:
    """Adds quotes first (matches RevealClaimValue; prep_inputs.rs:315-320)."""
    return pack_string_to_int_unquoted(f'"{s}"', n_bytes)


def unpack_int_to_string_unquoted(v: int) -> str:
    """Inverse of the packing, stripping trailing NULs and outer quotes
    (prep_inputs.rs:345-355)."""
    raw = v.to_bytes(32, "little").rstrip(b"\x00")
    s = raw.decode()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        s = s[1:-1]
    return s


def get_domain(s: str) -> str:
    at = s.find("@")
    if at < 0:
        raise PrepError("No @ symbol found in input to get_domain()")
    return s[at + 1 :]


def is_minified(msg: str) -> bool:
    return '": ' not in msg


def find_value_interval(msg: str, claim_name: str, type_string: str) -> tuple[int, int]:
    """Byte interval [l, r) of `"name":value` in the decoded JSON
    (prep_inputs.rs:356-430)."""
    l = msg.find(claim_name)
    if l < 0:
        raise PrepError(f"Failed to find claim {claim_name} in token payload")
    value_start = l + len(claim_name)
    r = 0
    if type_string == "string":
        close = msg[value_start + 2 :].find('"')
        if close < 0:
            raise PrepError(f"Parse error, no closing quote, claim {claim_name}")
        r = close + value_start + 3
    elif type_string == "number":
        for i, ch in enumerate(msg[value_start + 1 :]):
            if ch not in "0123456789":
                r = value_start + 1 + i
                break
    elif type_string == "bool":
        for i, ch in enumerate(msg[value_start + 1 :]):
            if ch not in "truefalse":
                r = value_start + 1 + i
                break
    elif type_string == "null":
        r = value_start + 4
    elif type_string in ("array", "object"):
        op, cl = ("[", "]") if type_string == "array" else ("{", "}")
        nested = 0
        for i, ch in enumerate(msg[value_start:]):
            if ch == op:
                nested += 1
            elif ch == cl:
                nested -= 1
                if nested == 0:
                    r = value_start + i + 1
                    break
    else:
        raise PrepError(f"Unsupported claim type: {type_string}")
    return l, r


# ---------------------------------------------------------------------------
# config parsing (prep_inputs.rs:519-579)
# ---------------------------------------------------------------------------

def parse_config(config_str: str) -> dict:
    config = json.loads(config_str)
    if not isinstance(config, dict):
        raise PrepError("Invalid config")
    if "alg" not in config:
        raise PrepError("'alg' field is missing from config file")
    if config["alg"] not in CRESCENT_SUPPORTED_ALGS:
        raise PrepError(f"{config['alg']} algorithm is unsupported")

    if "max_cred_len" not in config:
        config["max_cred_len"] = DEFAULT_MAX_TOKEN_LENGTH
    else:
        mcl = config["max_cred_len"]
        if not isinstance(mcl, int):
            raise PrepError("max_cred_len must have integer type")
        if mcl % 64 != 0:
            config["max_cred_len"] = mcl + (64 - mcl % 64)

    if "device_bound" not in config:
        config["device_bound"] = False
    if config["device_bound"]:
        entry = {"type": "number", "reveal": True, "max_claim_byte_len": 2 * MAX_FIELD_BYTE_LEN}
        config["device_key_0"] = dict(entry)
        config["device_key_1"] = dict(entry)

    for key, val in list(config.items()):
        if key in CRESCENT_CONFIG_KEYS:
            continue
        if not isinstance(val, dict):
            raise PrepError(f"Config entry for claim {key} does not have object type")
        if val.get("reveal", False) and "max_claim_byte_len" not in val:
            raise PrepError(
                f"Config entry for claim {key} has reveal flag set but is missing 'max_claim_byte_len'"
            )
    return config


# ---------------------------------------------------------------------------
# ProofSpec (creds/src/lib.rs:108-114 + prep_inputs.rs:584-633)
# ---------------------------------------------------------------------------

@dataclass
class ProofSpec:
    revealed: list = field(default_factory=list)
    range_over_year: Optional[dict] = None
    presentation_message: Optional[bytes] = None
    device_bound: Optional[bool] = None

    @staticmethod
    def from_json(s: str) -> "ProofSpec":
        d = json.loads(s)
        pm = d.get("presentation_message")
        if isinstance(pm, list):
            pm = bytes(pm)
        elif isinstance(pm, str):
            pm = pm.encode()
        return ProofSpec(
            revealed=d.get("revealed", []),
            range_over_year=d.get("range_over_year"),
            presentation_message=pm,
            device_bound=d.get("device_bound"),
        )

    def to_json(self) -> str:
        d = {"revealed": self.revealed}
        if self.range_over_year is not None:
            d["range_over_year"] = self.range_over_year
        if self.presentation_message is not None:
            d["presentation_message"] = list(self.presentation_message)
        if self.device_bound is not None:
            d["device_bound"] = self.device_bound
        return json.dumps(d)


@dataclass
class ProofSpecInternal:
    revealed: list
    hashed: list
    range_over_year: list  # [(claim, age), ...]
    presentation_message: Optional[bytes]
    device_bound: bool
    config_str: str
    claim_types: dict


def create_proof_spec_internal(proof_spec: ProofSpec, config_str: str) -> ProofSpecInternal:
    config = parse_config(config_str)
    revealed, hashed = [], []
    claim_types = {}
    for key, val in config.items():
        if key in CRESCENT_CONFIG_KEYS:
            continue
        if isinstance(val, dict) and isinstance(val.get("type"), str):
            claim_types[key] = val["type"]

    for attr in proof_spec.revealed:
        if attr not in config:
            raise PrepError(f"Attribute {attr} not found in config")
        if config[attr].get("reveal_digest"):
            hashed.append(attr)
        else:
            revealed.append(attr)

    roy = list(proof_spec.range_over_year.items()) if proof_spec.range_over_year else []
    device_bound = bool(proof_spec.device_bound)
    if device_bound and proof_spec.presentation_message is None:
        raise PrepError(
            "Proof spec indicates the credential is device bound, but is missing the presentation message"
        )
    return ProofSpecInternal(
        revealed, hashed, roy, proof_spec.presentation_message, device_bound,
        config_str, claim_types,
    )


# ---------------------------------------------------------------------------
# main prover-input pipeline (prep_inputs.rs:96-189)
# ---------------------------------------------------------------------------

def verify_jwt_rs256(token: str, issuer_pem: str) -> None:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding
    from cryptography.hazmat.primitives.serialization import load_pem_public_key

    h, p, s = token.split(".")
    key = load_pem_public_key(issuer_pem.encode())
    key.verify(
        b64url_decode(s), f"{h}.{p}".encode(), padding.PKCS1v15(), hashes.SHA256()
    )


def prepare_prover_inputs(
    config: dict, token_str: str, issuer_pem: str, device_pub_pem: str | None = None
) -> tuple[dict, dict, dict]:
    """Returns (prover_inputs, prover_aux, public_ios) JSON maps, with every
    value stringified for circom (prep_inputs.rs:96-189)."""
    if config["alg"] != "RS256":
        raise PrepError("Unsupported algorithm")
    verify_jwt_rs256(token_str, issuer_pem)

    parts = token_str.split(".")
    if len(parts) != 3:
        raise PrepError("Malformed JWT")
    jwt_header_b64, claims_b64, signature_b64 = parts

    jwt_header_decoded = b64url_decode(jwt_header_b64).decode()
    claims_decoded = b64url_decode(claims_b64).decode()
    claims = json.loads(claims_decoded)

    header_utf8 = to_utf8_integers(jwt_header_b64) + [ord(".")]
    payload_utf8 = to_utf8_integers(claims_b64)
    prepad_m = header_utf8 + payload_utf8
    padded_m = sha256_padding(prepad_m)
    msg_len_after_sha2_padding = len(padded_m)

    if msg_len_after_sha2_padding > config["max_cred_len"]:
        raise PrepError(
            f"Error: JWT too large. Token is {len(prepad_m)} bytes "
            f"({msg_len_after_sha2_padding} after SHA256 padding), max supported "
            f"{config['max_cred_len']}"
        )
    padded_m = padded_m + [0] * (config["max_cred_len"] - len(padded_m))

    prover_inputs: dict = {"message": [str(c) for c in padded_m]}
    public_ios: dict = {}
    prover_aux: dict = {}

    prover_inputs["signature"] = b64_to_circom_limbs(signature_b64, CIRCOM_RS256_LIMB_BITS)

    from cryptography.hazmat.primitives.serialization import load_pem_public_key

    modulus = load_pem_public_key(issuer_pem.encode()).public_numbers().n
    limbs = [str(x) for x in to_circom_ints_from_int(modulus, CIRCOM_RS256_LIMB_BITS)]
    prover_inputs["modulus"] = limbs
    public_ios["modulus"] = limbs

    prover_inputs["message_padded_bytes"] = str(msg_len_after_sha2_padding)
    period_idx = len(header_utf8) - 1
    prover_inputs["period_idx"] = str(period_idx)

    header_pad = base_64_decoded_header_padding(period_idx)
    header_and_payload = f"{jwt_header_decoded}{header_pad}{claims_decoded}"
    prepare_prover_claim_inputs(header_and_payload, config, claims, prover_inputs)
    prepare_prover_aux(header_and_payload, config, claims, device_pub_pem, prover_aux)
    return prover_inputs, prover_aux, public_ios


def prepare_prover_claim_inputs(
    header_and_payload: str, config: dict, claims: dict, prover_inputs: dict
) -> None:
    """Per-claim l/r intervals + packed reveal values (prep_inputs.rs:193-251)."""
    msg = header_and_payload
    if not is_minified(msg):
        raise PrepError("JSON is not minified, Circom circuit will fail.")

    for name, entry in config.items():
        if name in CRESCENT_CONFIG_KEYS:
            continue
        type_string = entry["type"]
        claim_l, claim_r = find_value_interval(msg, f'"{name}"', type_string)
        prover_inputs[f"{name}_l"] = str(claim_l)
        prover_inputs[f"{name}_r"] = str(claim_r)

        if entry.get("reveal", False):
            if type_string == "number":
                prover_inputs[f"{name}_value"] = str(claims[name])
            elif type_string == "string":
                max_len = entry["max_claim_byte_len"]
                if entry.get("reveal_domain_only", False):
                    packed = pack_string_to_int_unquoted(get_domain(claims[name]), max_len)
                else:
                    packed = pack_string_to_int(claims[name], max_len)
                prover_inputs[f"{name}_value"] = str(packed)
            else:
                raise PrepError(
                    "Can only reveal number types and string types as a single field element for now."
                )


def prepare_prover_aux(
    header_and_payload: str,
    config: dict,
    claims: dict,
    device_key_pem: str | None,
    prover_aux: dict,
) -> None:
    """Hashed-claim preimages + device public key (prep_inputs.rs:257-306)."""
    for name, entry in config.items():
        if name in CRESCENT_CONFIG_KEYS:
            continue
        if entry.get("reveal_digest", False):
            type_string = entry["type"]
            if type_string == "number":
                prover_aux[name] = claims[name]
            elif type_string == "string":
                max_len = entry["max_claim_byte_len"]
                if len(claims[name]) > max_len:
                    raise PrepError(
                        f"Claim too large ({len(claims[name])} bytes), max {max_len}"
                    )
                prover_aux[name] = claims[name]
            else:
                raise PrepError("Can only reveal number and string digests")

    if device_key_pem is not None:
        from cryptography.hazmat.primitives.serialization import load_pem_public_key

        nums = load_pem_public_key(device_key_pem.encode()).public_numbers()
        prover_aux["device_pub_x"] = str(nums.x)
        prover_aux["device_pub_y"] = str(nums.y)
