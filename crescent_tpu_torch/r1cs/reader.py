"""circom .r1cs binary format reader/writer.

Format per iden3's r1cs spec (as parsed by the reference's
forks/circom-compat/src/circom/r1cs_reader.rs): little-endian,
  magic "r1cs" | version u32 | n_sections u32
  sections: type u32, size u64, payload
    type 1 = header: field_size u32, prime (field_size bytes LE), n_wires u32,
             n_pub_out u32, n_pub_in u32, n_prv_in u32, n_labels u64,
             n_constraints u32
    type 2 = constraints: per constraint 3 linear combinations (A, B, C);
             each LC: n_terms u32, then per term wire_id u32 + coeff
             (field_size bytes LE)
    type 3 = wire-to-label map: n_wires u64 entries... (u64 per wire)

We both read circom-produced files and write our own (the native statement
frontend emits the same format so artifacts stay interchangeable with the
reference pipeline).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

from ..core.fields import BN254_FR

MAGIC = b"r1cs"


@dataclass
class R1CSFile:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    constraints: list  # [(A, B, C)] with each LC = list[(wire_id, coeff)]
    wire_to_label: list

    @property
    def num_instance(self) -> int:
        """1 + public outputs + public inputs (circom wire convention)."""
        return 1 + self.n_pub_out + self.n_pub_in

    def to_r1cs(self):
        """Convert to the models.groth16.R1CS container."""
        from ..models.groth16 import R1CS

        return R1CS(
            num_instance=self.num_instance,
            num_witness=self.n_wires - self.num_instance,
            constraints=self.constraints,
            field=self.prime,
        )


def read_r1cs(path_or_bytes) -> R1CSFile:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    with f:
        magic = f.read(4)
        assert magic == MAGIC, f"not an r1cs file: {magic!r}"
        (version,) = struct.unpack("<I", f.read(4))
        assert version == 1, f"unsupported r1cs version {version}"
        (n_sections,) = struct.unpack("<I", f.read(4))

        sections = {}
        for _ in range(n_sections):
            (stype,) = struct.unpack("<I", f.read(4))
            (size,) = struct.unpack("<Q", f.read(8))
            sections[stype] = f.read(size)

        hdr = io.BytesIO(sections[1])
        (field_size,) = struct.unpack("<I", hdr.read(4))
        prime = int.from_bytes(hdr.read(field_size), "little")
        n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack("<IIII", hdr.read(16))
        (n_labels,) = struct.unpack("<Q", hdr.read(8))
        (n_constraints,) = struct.unpack("<I", hdr.read(4))

        constraints = []
        if 2 in sections:
            cs = io.BytesIO(sections[2])
            for _ in range(n_constraints):
                lcs = []
                for _ in range(3):
                    (n_terms,) = struct.unpack("<I", cs.read(4))
                    terms = []
                    for _ in range(n_terms):
                        (wire,) = struct.unpack("<I", cs.read(4))
                        coeff = int.from_bytes(cs.read(field_size), "little")
                        terms.append((wire, coeff))
                    lcs.append(terms)
                constraints.append(tuple(lcs))

        wire_to_label = []
        if 3 in sections:
            wl = io.BytesIO(sections[3])
            for _ in range(n_wires):
                data = wl.read(8)
                if len(data) < 8:
                    break
                wire_to_label.append(struct.unpack("<Q", data)[0])

    return R1CSFile(
        prime, n_wires, n_pub_out, n_pub_in, n_prv_in, n_labels, constraints, wire_to_label
    )


def write_r1cs(
    path: str,
    constraints: list,
    n_wires: int,
    n_pub_out: int,
    n_pub_in: int,
    n_prv_in: int,
    prime: int = BN254_FR,
) -> None:
    field_size = 32

    hdr = struct.pack("<I", field_size)
    hdr += prime.to_bytes(field_size, "little")
    hdr += struct.pack("<IIII", n_wires, n_pub_out, n_pub_in, n_prv_in)
    hdr += struct.pack("<Q", n_wires)  # n_labels
    hdr += struct.pack("<I", len(constraints))

    cs = b""
    parts = []
    for a, b, c in constraints:
        for lc in (a, b, c):
            parts.append(struct.pack("<I", len(lc)))
            for wire, coeff in lc:
                parts.append(struct.pack("<I", wire))
                parts.append(int(coeff % prime).to_bytes(field_size, "little"))
    cs = b"".join(parts)

    wl = b"".join(struct.pack("<Q", i) for i in range(n_wires))

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<I", 3))
        for stype, payload in ((1, hdr), (2, cs), (3, wl)):
            f.write(struct.pack("<I", stype))
            f.write(struct.pack("<Q", len(payload)))
            f.write(payload)
