"""mDL (ISO 18013-5 mobile driving licence) credential support — mdl1.

A copy of ``crescent_tpu/credentials/mdl.py``.

Reference: circuit_setup/circuits-mdl/ (main_header_es256.circom.template +
per-attribute IssuerSignedItem digest blocks from prepare_mdl_setup.py),
circuit_setup/mdl-tools/src/bin/{mdl-gen,prepare-prover-input}.rs,
creds/src/lib.rs create_show_proof_mdl:403 / verify_show_mdl:723.

This module provides:
  * `issue_mdl` — mdl-gen + prepare-prover-input equivalent: builds a real
    COSE Sign1 MSO (CBOR), signs it with the issuer's ES256 key, and
    extracts the full circuit prover inputs (message bytes, signature
    limbs, IssuerSignedItem preimages, substring positions).
  * `MDLFrontend` — the REAL mdl1 statement: SHA-256 over the padded COSE
    TBS message, in-circuit ES256 verification (non-native P-256,
    r1cs/p256.py), validUntil timestamp extraction, device-key-x prefix
    matching, and per-attribute IssuerSignedItem digest matching with
    date/string/integer value binding.  Same public-IO surface as the
    stub, so show/verify are unchanged.
  * `StubMDLFrontend` — the IO-faithful placeholder kept for fast
    protocol tests (like StubJWTFrontend).

Divergences from the reference, both deliberate:
  * the circuit is specialized to the issuer key at zksetup (pubkey limbs
    remain public IOs, additionally pinned to the issuer's constants) so
    both ECDSA scalar mults are fixed-base — see r1cs/p256.py.
  * integer claims are bound in-circuit to the CBOR value bytes
    (prepare_mdl_setup.py emits no binding for integer types — the
    reference's `{name}_value` public input is unconstrained there).
"""

from __future__ import annotations

import datetime
import hashlib
import random

from ..r1cs.builder import LC, ConstraintSystem
from ..utils import cbor
from .api import CircuitFrontend, bits_to_num
from .daystamp import ymd_to_ordinal
from .prep_inputs import (
    CIRCOM_ES256_LIMB_BITS,
    CRESCENT_CONFIG_KEYS,
    pack_string_to_int_unquoted,
    pem_to_inputs,
    to_circom_ints_from_int,
)

P256_PUBKEY_LIMBS = 6  # 43-bit limbs (crescent_helper.py:17-19)

ISO_NS = "org.iso.18013.5.1"
MDL_DOCTYPE = "org.iso.18013.5.1.mDL"
PREIMAGE_CONTENT = 95   # bytes before SHA padding; value ends at byte 95
PREIMAGE_LEN = 128      # after SHA-256 padding (circom hardcodes 128)

# main_header_es256.circom.template:67 — 0x6a 'validUntil' 0xc0 0x74
VALID_UNTIL_PREFIX = bytes([106, 118, 97, 108, 105, 100, 85, 110, 116, 105, 108, 192, 116])
# :137 — 'm' 'deviceKeyInfo' 0xa1 'i' 'deviceKey' 0xa4 01 02 20 01 21 5820
DEVICE_KEY_PREFIX = bytes([
    109, 100, 101, 118, 105, 99, 101, 75, 101, 121, 73, 110, 102, 111, 161,
    105, 100, 101, 118, 105, 99, 101, 75, 101, 121, 164, 1, 2, 32, 1, 33, 88, 32,
])
TIMESTAMP_LEN = 20
DIGEST_ENC_LEN = 35  # id byte + 0x58 0x20 + 32 digest bytes


def _ymd(d) -> tuple[int, int, int]:
    if isinstance(d, datetime.date):
        return d.year, d.month, d.day
    y, m, dd = str(d).split("T")[0].split("-")
    return int(y), int(m), int(dd)


def _parse_date(d) -> int:
    """ISO date (or datetime.date) -> circuit daystamp (ordinal days,
    strings.circom Daystamp:221)."""
    return ymd_to_ordinal(*_ymd(d))


def circuit_unix_timestamp(d) -> int:
    """strings.circom UnixTimestamp:149: the circuit's year table is
    `date --date=Y-01-01 +%s` evaluated in UTC-8, i.e. timegm + 28800;
    valid for 2024..2040 only."""
    import calendar

    y, m, dd = _ymd(d)
    assert 2024 <= y <= 2040, "UnixTimestamp table covers 2024..2040"
    year_ts = calendar.timegm((y, 1, 1, 0, 0, 0)) + 28800
    leap = 1 if (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)) else 0
    days_before = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334][m - 1]
    if m > 2:
        days_before += leap
    return year_ts + (days_before + dd - 1) * 86400


def mdl_attribute_digest(preimage: str) -> int:
    """Hashed-attribute field element: SHA-256 of the raw string, truncated
    to 248 bits (the mdl pipeline hashes the attribute value itself;
    verify_show_mdl lib.rs:793-806)."""
    return bits_to_num(hashlib.sha256(str(preimage).encode()).digest()[:31])


def generate_es256_issuer_keypair() -> tuple[str, str]:
    """P-256 issuer key pair (PEM private, PEM public) — mdl-gen's issuer."""
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat,
    )

    priv = ec.generate_private_key(ec.SECP256R1())
    return (
        priv.private_bytes(
            Encoding.PEM, PrivateFormat.PKCS8, NoEncryption()
        ).decode(),
        priv.public_key()
        .public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo)
        .decode(),
    )


# ---------------------------------------------------------------------------
# issuance (mdl-gen.rs + prepare-prover-input.rs equivalents)
# ---------------------------------------------------------------------------

def sha256_pad(data: bytes) -> bytes:
    out = data + b"\x80"
    out += b"\x00" * ((-(len(out) + 8)) % 64)
    return out + (len(data) * 8).to_bytes(8, "big")


def _claim_names(config: dict) -> list[str]:
    return [
        n for n in config
        if n not in CRESCENT_CONFIG_KEYS and not n.startswith("device_key_")
    ]


def _encode_attr_value(typ: str, value) -> bytes:
    if typ == "date":
        return cbor.encode(cbor.Tag(1004, str(value)[:10]))  # ends in YYYY-MM-DD
    if typ in ("number", "integer"):
        v = int(value)
        assert 0 <= v < 0x10000
        return bytes([0x19]) + v.to_bytes(2, "big")  # fixed 3-byte form
    return cbor.encode(str(value))


def _issuer_signed_item(digest_id: int, name: str, value_enc: bytes, rng) -> bytes:
    """IssuerSignedItem CBOR, exactly PREIMAGE_CONTENT bytes (salt-tuned so
    the elementValue ends at byte 95 — prepare-prover-input.rs:528 expects
    the sha-padded preimage to be exactly 128 bytes)."""
    head = b"\xa4" + cbor.encode("digestID") + cbor.encode(digest_id) + cbor.encode("random")
    tail = (
        cbor.encode("elementIdentifier") + cbor.encode(name)
        + cbor.encode("elementValue") + value_enc
    )
    salt_n = PREIMAGE_CONTENT - len(head) - 2 - len(tail)
    assert salt_n >= 1, f"claim {name}: name+value too long for 95-byte preimage"
    salt = bytes(rng.randrange(256) for _ in range(salt_n))
    out = head + cbor.bstr_head(salt_n) + salt + tail
    assert len(out) == PREIMAGE_CONTENT
    return out


def gen_x509_cert_chain(issuer_priv_pem: str | None = None) -> tuple[str, str, str]:
    """3-cert ECDSA chain — root -> CA -> issuer — with the reference's
    parameters (circuit_setup/scripts/gen_x509_cert_chain.sh): the leaf uses
    P-256 and is valid 1 year, the CA P-384 (5 years, signed by root with
    SHA-512), the root P-521 self-signed (10 years, SHA-512); the CA signs
    the leaf with SHA-384.  CN names match the script.

    Returns (issuer_priv_pem, issuer_pub_pem, chain_pem) with chain_pem
    leaf-first — the order mdl-gen consumes (`pem::parse_many`,
    mdl-tools/src/bin/mdl-gen.rs:135-142)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat,
        load_pem_private_key,
    )
    from cryptography.x509.oid import NameOID

    now = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)

    def make_cert(subject_cn, issuer_cn, pubkey, signing_key, days, halg, is_ca):
        subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, subject_cn)])
        issuer = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, issuer_cn)])
        b = (
            x509.CertificateBuilder()
            .subject_name(subject)
            .issuer_name(issuer)
            .public_key(pubkey)
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(
                x509.BasicConstraints(ca=is_ca, path_length=None), critical=True
            )
        )
        if is_ca:  # openssl_ca.cnf v3_ca: keyCertSign
            b = b.add_extension(
                x509.KeyUsage(False, False, False, False, False,
                              True, True, False, False),
                critical=True,
            )
        else:  # v3_signer: digitalSignature
            b = b.add_extension(
                x509.KeyUsage(True, False, False, False, False,
                              False, False, False, False),
                critical=True,
            )
        return b.sign(signing_key, halg)

    root_key = ec.generate_private_key(ec.SECP521R1())
    ca_key = ec.generate_private_key(ec.SECP384R1())
    if issuer_priv_pem is not None:
        leaf_key = load_pem_private_key(issuer_priv_pem.encode(), password=None)
    else:
        leaf_key = ec.generate_private_key(ec.SECP256R1())

    root_crt = make_cert("NY DMV Test Root CA", "NY DMV Test Root CA",
                         root_key.public_key(), root_key, 3650,
                         hashes.SHA512(), True)
    ca_crt = make_cert("NY DMV Test CA", "NY DMV Test Root CA",
                       ca_key.public_key(), root_key, 1825,
                       hashes.SHA512(), True)
    leaf_crt = make_cert("NY DMV Test Issuer", "NY DMV Test CA",
                         leaf_key.public_key(), ca_key, 365,
                         hashes.SHA384(), False)

    chain_pem = b"".join(
        c.public_bytes(Encoding.PEM) for c in (leaf_crt, ca_crt, root_crt)
    ).decode()
    priv_pem = leaf_key.private_bytes(
        Encoding.PEM, PrivateFormat.PKCS8, NoEncryption()
    ).decode()
    pub_pem = (
        leaf_key.public_key()
        .public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo)
        .decode()
    )
    return priv_pem, pub_pem, chain_pem


def x5chain_unprotected_header(chain_pem: str) -> dict:
    """COSE unprotected header {33: x5chain} (RFC 9360) from a PEM chain:
    a single bstr DER cert, or an array of bstrs leaf-first — the form
    isomdl's X5Chain builder emits into the IssuerAuth COSE_Sign1."""
    from cryptography import x509
    from cryptography.hazmat.primitives.serialization import Encoding

    certs = x509.load_pem_x509_certificates(chain_pem.encode())
    ders = [c.public_bytes(Encoding.DER) for c in certs]
    return {33: ders[0] if len(ders) == 1 else ders}


def issue_mdl(
    config: dict,
    attributes: dict,
    valid_until,
    issuer_priv_pem: str,
    device_pub_pem: str | None,
    rng: random.Random | None = None,
    x5chain_pem: str | None = None,
) -> tuple[dict, dict]:
    """Issue a signed MSO and derive circuit prover inputs + aux.

    Builds the COSE Sign1 TBS = ["Signature1", <<{1:-7}>>, '', payload]
    with payload = tag24(bstr MSO), signs SHA-256(tbs) with the issuer's
    ES256 key, and computes every substring position the circuit needs
    (prepare-prover-input.rs:396-640)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key, load_pem_public_key,
    )

    rng = rng or random.Random()
    names = _claim_names(config)
    pi: dict = {}
    aux: dict = {}

    # per-attribute IssuerSignedItems + valueDigests
    items: dict[str, bytes] = {}
    digests: dict[int, bytes] = {}
    for did, name in enumerate(names):
        typ = config[name]["type"]
        value_enc = _encode_attr_value(typ, attributes[name])
        item = _issuer_signed_item(did, name, value_enc, rng)
        items[name] = item
        digests[did] = hashlib.sha256(item).digest()

    vu_str = f"{str(valid_until)[:10]}T00:00:00Z"
    assert len(vu_str) == TIMESTAMP_LEN
    mso = {
        "version": "1.0",
        "digestAlgorithm": "SHA-256",
        "valueDigests": {ISO_NS: digests},
        "docType": MDL_DOCTYPE,
        "validityInfo": {
            "signed": cbor.Tag(0, "2024-01-01T00:00:00Z"),
            "validFrom": cbor.Tag(0, "2024-01-01T00:00:00Z"),
            "validUntil": cbor.Tag(0, vu_str),
        },
    }
    if device_pub_pem is not None:
        nums = load_pem_public_key(device_pub_pem.encode()).public_numbers()
        mso["deviceKeyInfo"] = {
            "deviceKey": {
                1: 2, -1: 1,
                -2: nums.x.to_bytes(32, "big"),
                -3: nums.y.to_bytes(32, "big"),
            }
        }
        aux["device_pub_x"] = str(nums.x)
        aux["device_pub_y"] = str(nums.y)

    payload = cbor.encode(cbor.Tag(24, cbor.encode(mso)))
    protected = bytes([0xA1, 0x01, 0x26])  # {1: -7} = ES256
    tbs = (
        b"\x84" + cbor.encode("Signature1") + cbor.encode(protected)
        + cbor.encode(b"") + cbor.encode(payload)
    )

    priv = load_pem_private_key(issuer_priv_pem.encode(), password=None)
    sig_r, sig_s = decode_dss_signature(priv.sign(tbs, ec.ECDSA(hashes.SHA256())))
    if x5chain_pem is not None:
        # full IssuerAuth COSE_Sign1 with the issuer's X.509 chain in the
        # unprotected header (RFC 9360 label 33), as mdl-gen emits it via
        # isomdl's X5Chain (mdl-gen.rs:135-150).  The Sig_structure (tbs)
        # covers only the protected header, so the signature is unchanged.
        import base64

        issuer_auth = cbor.encode(
            [
                protected,
                x5chain_unprotected_header(x5chain_pem),
                payload,
                sig_r.to_bytes(32, "big") + sig_s.to_bytes(32, "big"),
            ]
        )
        aux["issuer_auth"] = base64.urlsafe_b64encode(issuer_auth).decode()
    padded = sha256_pad(tbs)
    max_len = int(config.get("max_cred_len", 1792))
    assert len(padded) <= max_len, f"mDL too large: {len(padded)} > {max_len}"
    message = padded + b"\x00" * (max_len - len(padded))

    pi["message"] = list(message)
    pi["message_padded_bytes"] = len(padded)
    pi["signature_r"] = [str(x) for x in to_circom_ints_from_int(sig_r, CIRCOM_ES256_LIMB_BITS)]
    pi["signature_s"] = [str(x) for x in to_circom_ints_from_int(sig_s, CIRCOM_ES256_LIMB_BITS)]
    pub_nums = priv.public_key().public_numbers()
    pi["pubkey_x"] = [str(x) for x in to_circom_ints_from_int(pub_nums.x, CIRCOM_ES256_LIMB_BITS)]
    pi["pubkey_y"] = [str(x) for x in to_circom_ints_from_int(pub_nums.y, CIRCOM_ES256_LIMB_BITS)]

    vl = tbs.find(VALID_UNTIL_PREFIX)
    assert vl >= 0
    pi["valid_until_prefix_l"] = vl
    pi["valid_until_prefix_r"] = vl + len(VALID_UNTIL_PREFIX)
    pi["valid_until_value"] = str(circuit_unix_timestamp(valid_until))

    if device_pub_pem is not None:
        from .ecdsa_pop import split_public_key_x

        dl = tbs.find(DEVICE_KEY_PREFIX)
        assert dl >= 0
        pi["device_key_x_prefix_l"] = dl
        pi["device_key_x_prefix_r"] = dl + len(DEVICE_KEY_PREFIX)
        x_int = int(aux["device_pub_x"])
        pi["device_key_x"] = list(x_int.to_bytes(32, "big"))
        q0, q1 = split_public_key_x(x_int)
        pi["device_key_0_value"] = str(q0)
        pi["device_key_1_value"] = str(q1)

    for did, name in enumerate(names):
        entry = config[name]
        typ = entry["type"]
        item = items[name]
        enc = bytes([did, 0x58, 0x20]) + digests[did]
        el = tbs.find(enc)
        assert el >= 0
        pi[f"{name}_id"] = did
        pi[f"{name}_preimage"] = list(sha256_pad(item))
        pi[f"{name}_encoded_l"] = el
        pi[f"{name}_encoded_r"] = el + DIGEST_ENC_LEN
        ident = cbor.encode(name)
        il = item.find(ident)
        assert il >= 0
        pi[f"{name}_identifier_l"] = il

        if entry.get("reveal_digest", False):
            val_s = str(attributes[name])
            aux[name] = val_s
            pi[f"{name}_value_l"] = PREIMAGE_CONTENT - len(val_s)
            pi[f"{name}_value_r"] = PREIMAGE_CONTENT
            pi[f"{name}_digest"] = str(mdl_attribute_digest(val_s))
        elif typ == "date":
            pi[f"{name}_value"] = str(_parse_date(attributes[name]))
        elif typ in ("number", "integer"):
            pi[f"{name}_value"] = str(int(attributes[name]))
        else:  # revealed string: skip the CBOR text header byte
            val_s = str(attributes[name])
            pi[f"{name}_value_l"] = PREIMAGE_CONTENT - len(val_s)
            pi[f"{name}_value_r"] = PREIMAGE_CONTENT
            pi[f"{name}_value"] = str(
                pack_string_to_int_unquoted(val_s, 31)
            )
    return pi, aux


def prepare_mdl_prover_inputs(
    config: dict,
    attributes: dict,
    valid_until,
    issuer_pem: str,
    device_pub_pem: str | None = None,
    issuer_priv_pem: str | None = None,
    rng: random.Random | None = None,
    x5chain_pem: str | None = None,
) -> tuple[dict, dict]:
    """prepare-prover-input.rs equivalent.  With `issuer_priv_pem` this
    issues a real signed MSO and returns full circuit inputs (issue_mdl);
    without it, returns the value-only stub inputs for StubMDLFrontend."""
    if issuer_priv_pem is not None:
        return issue_mdl(config, attributes, valid_until, issuer_priv_pem,
                         device_pub_pem, rng, x5chain_pem=x5chain_pem)
    pi: dict = {}
    aux: dict = {}
    pubkey = pem_to_inputs(issuer_pem)
    assert len(pubkey) <= 2 * P256_PUBKEY_LIMBS
    pi["pubkey_x"] = [str(x) for x in pubkey[:P256_PUBKEY_LIMBS]]
    pi["pubkey_y"] = [str(x) for x in pubkey[P256_PUBKEY_LIMBS:]]
    pi["valid_until_value"] = str(circuit_unix_timestamp(valid_until))

    for name, entry in config.items():
        if name in CRESCENT_CONFIG_KEYS or name.startswith("device_key_"):
            continue
        typ = entry["type"]
        if entry.get("reveal_digest", False):
            aux[name] = str(attributes[name])
            pi[f"{name}_digest"] = str(mdl_attribute_digest(attributes[name]))
            continue
        if typ == "date":
            pi[f"{name}_value"] = str(_parse_date(attributes[name]))
        elif typ in ("number", "integer"):
            pi[f"{name}_value"] = str(int(attributes[name]))
        else:
            pi[f"{name}_value"] = str(
                pack_string_to_int_unquoted(str(attributes[name]), 31)
            )

    if device_pub_pem is not None:
        from cryptography.hazmat.primitives.serialization import load_pem_public_key

        from .ecdsa_pop import split_public_key_x

        nums = load_pem_public_key(device_pub_pem.encode()).public_numbers()
        aux["device_pub_x"] = str(nums.x)
        aux["device_pub_y"] = str(nums.y)
        q0, q1 = split_public_key_x(nums.x)
        pi["device_key_0_value"] = str(q0)
        pi["device_key_1_value"] = str(q1)
    return pi, aux


# ---------------------------------------------------------------------------
# statement frontends
# ---------------------------------------------------------------------------

class _MDLIOBase(CircuitFrontend):
    """Shared public-IO layout (drives the committed-opening indices assumed
    by create_show_proof_mdl — [0]=valid_until, [1]=dk0, [2]=dk1, then range
    attrs, lib.rs:505-516):
      digests (config order), pubkey_x[0..5], pubkey_y[0..5],
      valid_until_value, device_key_0_value, device_key_1_value,
      claim values (config order)."""

    def _alloc_publics(self, cs: ConstraintSystem, config: dict, val):
        pub = {}
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS or name.startswith("device_key_"):
                continue
            if entry.get("reveal_digest", False):
                pub[f"{name}_digest"] = cs.alloc_public(
                    val(f"{name}_digest"), f"{name}_digest")
        px = val("pubkey_x", [0] * P256_PUBKEY_LIMBS)
        py = val("pubkey_y", [0] * P256_PUBKEY_LIMBS)
        for i in range(P256_PUBKEY_LIMBS):
            pub[f"pubkey_x[{i}]"] = cs.alloc_public(px[i], f"pubkey_x[{i}]")
        for i in range(P256_PUBKEY_LIMBS):
            pub[f"pubkey_y[{i}]"] = cs.alloc_public(py[i], f"pubkey_y[{i}]")
        pub["valid_until_value"] = cs.alloc_public(
            val("valid_until_value"), "valid_until_value")
        if config.get("device_bound", False):
            pub["device_key_0_value"] = cs.alloc_public(
                val("device_key_0_value"), "device_key_0_value")
            pub["device_key_1_value"] = cs.alloc_public(
                val("device_key_1_value"), "device_key_1_value")
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS or name.startswith("device_key_"):
                continue
            if not entry.get("reveal_digest", False):
                pub[f"{name}_value"] = cs.alloc_public(
                    val(f"{name}_value"), f"{name}_value")
        return pub

    @staticmethod
    def _val_fn(prover_inputs: dict | None):
        pi = prover_inputs or {}

        def val(name, default=0):
            v = pi.get(name, default)
            if isinstance(v, list):
                return [int(x) for x in v]
            return int(v)

        return val

    def replay_inputs(self, config: dict, prover_inputs: dict) -> dict:
        """Preprocess prover inputs exactly as synthesize does (digest
        derivation) — feeds _build or a compiled witness-program replay."""
        pi = dict(prover_inputs)
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS or name.startswith("device_key_"):
                continue
            if entry.get("reveal_digest", False) and f"{name}_digest" not in pi and name in pi:
                pi[f"{name}_digest"] = mdl_attribute_digest(pi[name])
        return pi

    def synthesize(self, config: dict, prover_inputs: dict):
        cs = self._build(config, self.replay_inputs(config, prover_inputs))
        # satisfaction is checked by api.create_client_state on the returned
        # R1CS (native COO path) — an internal check here would rebuild the
        # COO cache on a throwaway R1CS (round-5 perf cleanup)
        return cs.to_r1cs(), cs.assignment(), cs.io_locations()

    def setup(self, config: dict):
        cs = self._build(config, None)
        return cs.to_r1cs(), cs.io_locations()


class StubMDLFrontend(_MDLIOBase):
    """IO-faithful placeholder statement (pub == witness copy), for fast
    protocol tests — NOT a sound credential statement."""

    def _build(self, config: dict, prover_inputs: dict | None) -> ConstraintSystem:
        cs = ConstraintSystem()
        pub = self._alloc_publics(cs, config, self._val_fn(prover_inputs))
        for v in pub.values():
            w = cs.alloc(cs.value(v))
            cs.assert_equal(w, v)
        return cs


class MDLFrontend(_MDLIOBase):
    """The REAL mdl1 statement (main_header_es256.circom.template +
    prepare_mdl_setup.py attribute blocks).  Requires the issuer public key
    PEM at construction: zksetup specializes the ECDSA fixed-base tables to
    the issuer (see module docstring)."""

    def __init__(self, issuer_pem: str | None = None):
        self.issuer_pem = issuer_pem

    def _issuer_point(self) -> tuple[int, int]:
        from cryptography.hazmat.primitives.serialization import load_pem_public_key

        assert self.issuer_pem, "MDLFrontend needs the issuer public key PEM"
        nums = load_pem_public_key(self.issuer_pem.encode()).public_numbers()
        return nums.x, nums.y

    def _build(self, config: dict, prover_inputs: dict | None) -> ConstraintSystem:
        from ..r1cs import dates, jwt_circuit as jc
        from ..r1cs import p256 as nn
        from ..r1cs.sha256 import sha256_gadget, sha256_var_gadget

        cs = ConstraintSystem()
        val = self._val_fn(prover_inputs)
        M = int(config.get("max_cred_len", 1792))
        assert M % 64 == 0
        pub = self._alloc_publics(cs, config, val)
        # mark every public as a replay input: scalar publics by name,
        # pubkey limbs vector-wise under their list keys
        for k, v in pub.items():
            if "[" not in k:
                cs.mark_input(v, k)
        for base_name in ("pubkey_x", "pubkey_y"):
            vars_ = [pub[f"{base_name}[{i}]"] for i in range(P256_PUBKEY_LIMBS)]
            cs.mark_input(vars_, base_name)
        Qx, Qy = self._issuer_point()

        # ---- witness: message + signature ----
        msg_vals = val("message", [0] * M)
        message = [cs.alloc(b) for b in msg_vals[:M]]
        cs.mark_input(message, "message")
        mpb = cs.alloc(val("message_padded_bytes"))
        cs.mark_input(mpb, "message_padded_bytes")
        sig = {}
        for part in ("signature_r", "signature_s"):
            limbs = val(part, [0] * nn.K)
            sig[part] = [cs.alloc(x) for x in limbs[: nn.K]]
            cs.mark_input(sig[part], part)
            for v in sig[part]:
                cs.decompose_bits(v, nn.LIMB)

        # ---- pin pubkey IOs to the issuer constants (circuit is
        # issuer-specialized; IO surface unchanged) ----
        qx_limbs = nn.to_limbs(Qx)
        qy_limbs = nn.to_limbs(Qy)
        for i in range(nn.K):
            cs.assert_equal(pub[f"pubkey_x[{i}]"], LC.of(qx_limbs[i]))
            cs.assert_equal(pub[f"pubkey_y[{i}]"], LC.of(qy_limbs[i]))

        # ---- SHA-256(message) -> 43-bit msghash limbs (template:20-46) ----
        nb = cs.alloc_shr(mpb, 6)
        cs.assert_equal(LC.of(nb, 64), LC.of(mpb))
        digest = sha256_var_gadget(cs, message, nb)
        # little-endian bit stream of the big-endian digest integer
        bits_le = [digest[31 - (i // 8)][i % 8] for i in range(256)]
        msghash = []
        for j in range(nn.K):
            acc = LC()
            for t in range(nn.LIMB):
                if 43 * j + t < 256:
                    acc = acc + LC.of(bits_le[43 * j + t], 1 << t)
            msghash.append(cs.add_const_mul(acc))

        # ---- ES256 verification (ECDSAVerifyNoPubkeyCheck) ----
        nn.ecdsa_verify_gadget(
            cs, sig["signature_r"], sig["signature_s"], msghash, (Qx, Qy)
        )

        # ---- validUntil (template:66-130) ----
        vl = cs.alloc(val("valid_until_prefix_l"))
        cs.mark_input(vl, "valid_until_prefix_l")
        vr = cs.alloc(val("valid_until_prefix_r"))
        cs.mark_input(vr, "valid_until_prefix_r")
        p_ind, _, _ = jc.interval_indicator(cs, vl, vr, M)
        jc.match_substring(cs, message, list(VALID_UNTIL_PREFIX), p_ind, vl, vr, 13)
        ts_l = cs.add_const_mul(LC.of(vl) + LC.of(len(VALID_UNTIL_PREFIX)))
        ts_r = cs.add_const_mul(LC.of(ts_l) + LC.of(TIMESTAMP_LEN))
        v_ind, _, _ = jc.interval_indicator(cs, ts_l, ts_r, M)
        lv = cs.value(ts_l)
        d = [
            cs.alloc(cs.value(message[lv + i]) if lv + i < M else 0)
            for i in range(TIMESTAMP_LEN)
        ]
        jc.match_substring(cs, message, d, v_ind, ts_l, ts_r, TIMESTAMP_LEN)
        year = (
            LC.of(d[0], 1000) + LC.of(d[1], 100) + LC.of(d[2], 10) + LC.of(d[3])
            - LC.of(48 * 1111)
        )
        month = LC.of(d[5], 10) + LC.of(d[6]) - LC.of(48 * 11)
        day = LC.of(d[8], 10) + LC.of(d[9]) - LC.of(48 * 11)
        ts = dates.unix_timestamp(cs, cs.add_const_mul(year),
                                  cs.add_const_mul(month), cs.add_const_mul(day))
        cs.assert_equal(ts, pub["valid_until_value"])

        # ---- device key extraction (template:132-186) ----
        if config.get("device_bound", False):
            dl = cs.alloc(val("device_key_x_prefix_l"))
            cs.mark_input(dl, "device_key_x_prefix_l")
            dr = cs.alloc(val("device_key_x_prefix_r"))
            cs.mark_input(dr, "device_key_x_prefix_r")
            dkx = [cs.alloc(b) for b in val("device_key_x", [0] * 32)[:32]]
            cs.mark_input(dkx, "device_key_x")
            full_r = cs.add_const_mul(LC.of(dr) + LC.of(32))
            dk_ind, _, _ = jc.interval_indicator(cs, dl, full_r, M)
            jc.match_substring(
                cs, message, list(DEVICE_KEY_PREFIX) + dkx, dk_ind, dl, full_r, 31
            )
            # split big-endian x into two little-endian 16-byte halves
            acc0, acc1 = LC(), LC()
            for i in range(16):
                acc0 = acc0 + LC.of(dkx[31 - i], 1 << (8 * i))
                acc1 = acc1 + LC.of(dkx[15 - i], 1 << (8 * i))
            cs.assert_equal(acc0, pub["device_key_0_value"])
            cs.assert_equal(acc1, pub["device_key_1_value"])

        # ---- per-attribute blocks (prepare_mdl_setup.py:72-160) ----
        for name, entry in config.items():
            if name in CRESCENT_CONFIG_KEYS or name.startswith("device_key_"):
                continue
            typ = entry["type"]
            mcbl = int(entry.get("max_claim_byte_len", 31))
            pre = [cs.alloc(b) for b in val(f"{name}_preimage", [0] * PREIMAGE_LEN)[:PREIMAGE_LEN]]
            cs.mark_input(pre, f"{name}_preimage")
            idv = cs.alloc(val(f"{name}_id"))
            cs.mark_input(idv, f"{name}_id")
            ident = list(cbor.encode(name))
            il = cs.alloc(val(f"{name}_identifier_l"))
            cs.mark_input(il, f"{name}_identifier_l")
            ir = cs.add_const_mul(LC.of(il) + LC.of(len(ident)))
            i_ind, _, _ = jc.interval_indicator(cs, il, ir, PREIMAGE_LEN)
            jc.match_substring(cs, pre, ident, i_ind, il, ir, 31)

            # SHA-256 of the (pre-padded) preimage, matched in the message
            pre_digest = sha256_gadget(cs, pre)
            dig_bytes = [cs.bits_to_num(bb) for bb in pre_digest]
            encoded = [idv, 0x58, 0x20] + dig_bytes
            el = cs.alloc(val(f"{name}_encoded_l"))
            cs.mark_input(el, f"{name}_encoded_l")
            er = cs.alloc(val(f"{name}_encoded_r"))
            cs.mark_input(er, f"{name}_encoded_r")
            cs.assert_equal(LC.of(er), LC.of(el) + LC.of(DIGEST_ENC_LEN))
            e_ind, _, _ = jc.interval_indicator(cs, el, er, M)
            jc.match_substring(cs, message, encoded, e_ind, el, er, 31)

            # Layout parity note: the fixed date byte positions below are the
            # REFERENCE's layout, not an extra constraint of ours —
            # prepare_mdl_setup.py:134 hardcodes "year starts at position
            # 85 = 127 - 32 - 10" in its generated circom, and
            # prepare-prover-input.rs:528-531 panics unless the padded
            # preimage is exactly 128 bytes (our salt-tuned 95 content
            # bytes).  Integer claims are a superset: the reference has
            # none ("FIXME: add support for numbers?", prepare_mdl_setup.py).
            if entry.get("reveal_digest", False):
                l = cs.alloc(val(f"{name}_value_l"))
                cs.mark_input(l, f"{name}_value_l")
                r = cs.alloc(val(f"{name}_value_r"))
                cs.mark_input(r, f"{name}_value_r")
                dg = jc.hash_reveal_claim_value(cs, pre, l, r, mcbl, typ in ("number", "integer"))
                cs.assert_equal(pub[f"{name}_digest"], dg)
            elif typ == "date":
                # value is tag1004 text at the end: YYYY-MM-DD at bytes 85..94
                y = (
                    LC.of(pre[85], 1000) + LC.of(pre[86], 100)
                    + LC.of(pre[87], 10) + LC.of(pre[88]) - LC.of(48 * 1111)
                )
                mo = LC.of(pre[90], 10) + LC.of(pre[91]) - LC.of(48 * 11)
                dy = LC.of(pre[93], 10) + LC.of(pre[94]) - LC.of(48 * 11)
                ds = dates.daystamp(cs, cs.add_const_mul(y),
                                    cs.add_const_mul(mo), cs.add_const_mul(dy))
                cs.assert_equal(ds, pub[f"{name}_value"])
            elif typ in ("number", "integer"):
                # fixed 3-byte CBOR 0x19 encoding at the content tail
                cs.assert_equal(pre[PREIMAGE_CONTENT - 3], LC.of(0x19))
                cs.assert_equal(
                    LC.of(pre[PREIMAGE_CONTENT - 2], 256) + LC.of(pre[PREIMAGE_CONTENT - 1]),
                    pub[f"{name}_value"],
                )
            else:  # revealed string
                l = cs.alloc(val(f"{name}_value_l"))
                cs.mark_input(l, f"{name}_value_l")
                r = cs.alloc(val(f"{name}_value_r"))
                cs.mark_input(r, f"{name}_value_r")
                v = jc.reveal_claim_value(cs, pre, l, r, mcbl, False)
                cs.assert_equal(pub[f"{name}_value"], v)
        return cs
