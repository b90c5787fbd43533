"""Minimal JWT issue/verify helpers (RS256), mirroring the reference's
circuit_setup/scripts/{jwk_gen.py,jwt_sign.py} and the sample issuer
(sample/issuer/src/main.rs:168-244).  Used by tests, the sample services,
and the CLI's fixture generation."""

from __future__ import annotations

import base64
import json


def b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode().rstrip("=")


def generate_rsa_keypair(bits: int = 2048):
    """Returns (private_pem, public_pem) strings."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=bits)
    priv = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ).decode()
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo
    ).decode()
    return priv, pub


def sign_jwt_rs256(claims: dict, private_pem: str, header: dict | None = None) -> str:
    """Minified-JSON RS256 JWT (circom circuits require minified payloads)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    header = header or {"alg": "RS256", "typ": "JWT"}
    h = b64url(json.dumps(header, separators=(",", ":")).encode())
    p = b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{h}.{p}".encode()
    key = serialization.load_pem_private_key(private_pem.encode(), password=None)
    sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    return f"{h}.{p}.{b64url(sig)}"


def decode_jwt(token: str) -> tuple[dict, dict]:
    """Returns (header, claims) without verification."""
    from ..credentials.prep_inputs import b64url_decode

    h, p, _ = token.split(".")
    return json.loads(b64url_decode(h)), json.loads(b64url_decode(p))
