"""Device binding in the port (core/poseidon.py, models/spartan.py,
models/spartan_ser.py, credentials/{ecdsa_pop,device}.py, utils/ark.py's
DeviceProof) against the reference on the CPU.

Poseidon's constants and hashes are compared directly.  A DeviceProof is
built in each package from the same seeded `random.Random` (the device
key, its signature, the commitments' and the sigma proofs' randomness)
with the Spartan prover's OS entropy (``RandomTape``, spartan.py:411-418)
patched to the same bytes in both, so the two proofs, the Spartan NIZK of
the ECDSA circuit among them, must be the same bytes; each package's
proof must pass the other's verifier, and a flipped byte of the NIZK must
be refused.  Spartan's T-256 device routes under CRESCENT_NATIVE=0 are
held in tests/test_torch_t256.py.  Comparisons are exact (tolerance 0).
"""

import hashlib
import random
import types
import zlib

import pytest

from crescent_tpu.core import poseidon as rpos
from crescent_tpu.core.curves import BN254_G1 as RG1
from crescent_tpu.credentials import device as rdev
from crescent_tpu.credentials import dlog as rdlog
from crescent_tpu.credentials import ecdsa_pop as rpop
from crescent_tpu.models import spartan as rsp
from crescent_tpu.utils import ark as rark
from crescent_tpu_torch.core import poseidon as ppos
from crescent_tpu_torch.core.curves import BN254_G1 as PG1
from crescent_tpu_torch.core.fields import BN254_FR, T256_FQ
from crescent_tpu_torch.credentials import device as pdev
from crescent_tpu_torch.credentials import dlog as pdlog
from crescent_tpu_torch.credentials import ecdsa_pop as ppop
from crescent_tpu_torch.models import spartan as psp
from crescent_tpu_torch.models import spartan_ser as pser
from crescent_tpu_torch.utils import ark as park


def test_poseidon_matches_reference():
    for p in (T256_FQ, BN254_FR):
        for t in (2, 3, 4, 5):
            assert ppos.round_numbers(t) == rpos.round_numbers(t)
            pp, rp = ppos.get_poseidon(p, t), rpos.get_poseidon(p, t)
            assert (pp.round_constants, pp.mds) == (rp.round_constants, rp.mds)
            rng = random.Random(p + t)
            state = [rng.randrange(p) for _ in range(t)]
            assert pp.permutation(list(state)) == rp.permutation(list(state))
            inputs = [rng.randrange(p) for _ in range(t - 1)]
            assert ppos.safe_hash(pp, inputs) == rpos.safe_hash(rp, inputs)
    ops = [("absorb", 3), ("squeeze", 1)]
    assert ppos.io_pattern_value(ops) == rpos.io_pattern_value(ops)
    assert ppop.compute_hQ(1, 2, 3) == rpop.compute_hQ(1, 2, 3)


def _device_proof(dev_mod, dlog_mod, pop_mod, sp_mod, G1):
    """A DeviceProof from one package: a device key and its signature on a
    digest, the split key committed under two base pairs (as the show's
    device_key_0/1), every draw from one seeded rng and the Spartan tape's
    entropy fixed."""
    sp_mod._os = types.SimpleNamespace(urandom=lambda n: bytes(range(7, 7 + n)))
    rng = random.Random(1717)
    dev = dev_mod.TestDevice(rng=rng)
    bases0 = [G1.mul(rng.randrange(1, BN254_FR), G1.generator) for _ in range(2)]
    bases1 = [G1.mul(rng.randrange(1, BN254_FR), G1.generator) for _ in range(2)]
    q0, q1 = pop_mod.split_public_key_x(dev.public[0])
    com0 = dlog_mod.pedersen_commit(q0, bases0, rng=rng)
    com1 = dlog_mod.pedersen_commit(q1, bases1, rng=rng)
    digest = hashlib.sha256(b"presentation message").digest()
    sig = dev_mod.ECDSASig.from_bytes(digest, dev.sign(digest))
    proof = dev_mod.DeviceProof.prove(com0, com1, sig, *dev.public, rng=rng)
    return proof, (com0.c, com1.c, bases0, bases1)


@pytest.fixture(scope="module")
def proofs():
    saved = psp._os, rsp._os
    try:
        port = _device_proof(pdev, pdlog, ppop, psp, PG1)
        ref = _device_proof(rdev, rdlog, rpop, rsp, RG1)
    finally:
        psp._os, rsp._os = saved
    return port, ref


def test_spartan_proof_bytes_match_reference(proofs):
    """pi2, the Spartan NIZK of the ECDSA circuit (zlib over the bincode
    bytes of models/spartan_ser.py), is the reference's byte for byte, and
    reads back to the same bytes."""
    (port, _), (ref, _) = proofs
    assert port.pi2 == ref.pi2
    raw = zlib.decompress(port.pi2)
    assert pser.ecdsa_proof_to_bytes(pser.ecdsa_proof_from_bytes(raw)) == raw
    assert (port.r_x, port.r_y, port.digest, port.h_Q, port.m) == (
        ref.r_x, ref.r_y, ref.digest, ref.h_Q, ref.m)


def test_ser_device_proof_matches_reference(proofs):
    (port, _), (ref, _) = proofs
    blob = park.ser_device_proof(port)
    assert blob == rark.ser_device_proof(ref) == park.serialize(port)
    back = park.deserialize(blob, pdev.DeviceProof)
    assert isinstance(back, pdev.DeviceProof)
    assert park.serialize(back) == blob


def test_device_proofs_cross_verify(proofs):
    """Each package's DeviceProof, read by the other's deserializer, passes
    the other's verifier; a flipped byte of the NIZK is refused."""
    (port, stmt), (ref, _) = proofs
    as_ref = rark.deserialize(park.serialize(port), rdev.DeviceProof)
    assert rdev.DeviceProof.verify(as_ref, *stmt)
    as_port = park.deserialize(rark.serialize(ref), pdev.DeviceProof)
    assert pdev.DeviceProof.verify(as_port, *stmt)
    pi2 = bytearray(as_port.pi2)
    pi2[len(pi2) // 2] ^= 1
    as_port.pi2 = bytes(pi2)
    assert not pdev.DeviceProof.verify(as_port, *stmt)
