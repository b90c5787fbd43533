"""Core data structures shared across the credential pipeline.

Equivalent of creds/src/structs.rs: IOLocations (parsed from the
circom-derived io_locations.sym), PublicIOType per-IO disposition, and the
generic prover-inputs JSON container that feeds witness generation.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field


class PublicIOType(enum.Enum):
    """Disposition of one public IO in a show proof (structs.rs:32-37)."""

    REVEALED = "revealed"
    HIDDEN = "hidden"
    COMMITTED = "committed"


@dataclass
class IOLocations:
    """name -> position of each public IO in the Groth16 instance
    (structs.rs:26-98; positions come from io_locations.sym, generated by
    circuit_setup/scripts/run_setup.sh:176-180 from circom's .sym file)."""

    public_io_locations: dict = field(default_factory=dict)

    @staticmethod
    def from_str(io_data: str) -> "IOLocations":
        locs = {}
        for line in io_data.strip().splitlines():
            if not line.strip():
                continue
            parts = line.split(",")
            assert len(parts) == 2, f"bad io_locations line: {line!r}"
            locs[parts[0]] = int(parts[1])
        return IOLocations(locs)

    @staticmethod
    def from_file(path: str) -> "IOLocations":
        with open(path) as f:
            return IOLocations.from_str(f.read())

    def to_str(self) -> str:
        return "\n".join(f"{k},{v}" for k, v in self.public_io_locations.items()) + "\n"

    def get_io_location(self, key: str) -> int:
        if key not in self.public_io_locations:
            raise KeyError(f"Key {key} not found in public_io_locations")
        return self.public_io_locations[key]

    def get_public_key_indices(self) -> list[int]:
        """Indices (0-based into the inputs vector) of issuer-key IOs:
        names starting with `modulus` (RSA) or `pubkey` (ECDSA)
        (structs.rs:78-88)."""
        out = [
            v - 1
            for k, v in sorted(self.public_io_locations.items())
            if k.startswith("modulus") or k.startswith("pubkey")
        ]
        return sorted(out)

    def get_all_names(self) -> list[str]:
        return sorted(self.public_io_locations.keys())

    def len(self) -> int:
        return len(self.public_io_locations)

    @staticmethod
    def from_circom_sym(sym_text: str, num_public_ios: int) -> "IOLocations":
        """Build io_locations from a raw circom `main.sym` file — the awk
        one-liner of circuit_setup/scripts/run_setup.sh:176 verbatim:
        rows are `#s,#w,#c,fullname` (docs.circom.io sym format); keep rows
        with witness index != -1 and <= num_public_ios, strip the component
        prefix from `fullname` (main.exp_value -> exp_value), and map
        name -> witness index."""
        locs = {}
        for line in sym_text.splitlines():
            parts = line.split(",")
            if len(parts) != 4:
                continue
            w = int(parts[1])
            if w == -1 or w > num_public_ios:
                continue
            name_parts = parts[3].split(".")
            name = name_parts[1] if len(name_parts) > 1 else name_parts[0]
            locs[name] = w
        return IOLocations(locs)


@dataclass
class GenericInputsJSON:
    """Prover inputs as parsed from prover_inputs.json (structs.rs:20-23,
    100-178): values are decimal strings, numbers, or (nested) arrays."""

    prover_inputs: dict

    @staticmethod
    def from_file(path: str) -> "GenericInputsJSON":
        with open(path) as f:
            return GenericInputsJSON(json.load(f))

    def flatten(self) -> dict[str, object]:
        """Normalize every value to int or (nested) list[int]."""

        def conv(v):
            if isinstance(v, str):
                return int(v)
            if isinstance(v, (int,)):
                return int(v)
            if isinstance(v, list):
                return [conv(x) for x in v]
            raise TypeError(f"unsupported prover input type: {type(v)}")

        return {k: conv(v) for k, v in self.prover_inputs.items()}
