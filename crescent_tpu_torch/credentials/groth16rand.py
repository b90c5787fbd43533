"""Rerandomized Groth16 "show" protocol (ClientState) — creds/src/groth16rand.rs.

Counterpart of ``crescent_tpu/credentials/groth16rand.py``, on the port's
``models/groth16.py``; every step is host group arithmetic and the small
MSMs of ``dlog.msm_select``.

The unlinkability core of the framework: a stored Groth16 proof is
rerandomized per presentation, each public IO is Revealed / Hidden /
Committed, committed IOs get Pedersen commitments under
(gamma_abc_g1[i+1], delta_g1), the hidden-IO aggregate is committed with
fresh randomness z, proof.c is corrected by -(sum r + z)*G (sound because
the generator fixes gamma = 1), and a DLogPoK ties it all together
(groth16rand.rs:100-187).  Verification reassembles the prepared-inputs
point and runs the split Groth16 pairing check (groth16rand.rs:232-307).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..core.curves import AffinePoint, BN254_G1
from ..core.fields import BN254_FR as R
from ..models import groth16
from ..models.groth16 import PreparedVerifyingKey, Proof, VerifyingKey
from .dlog import DLogPoK, PedersenOpening, msm_select
from .rangeproof import RangeProof, RangeProofPK, RangeProofVK, prove_n_bits, verify_n_bits
from .structs import IOLocations, PublicIOType

G1 = BN254_G1


@dataclass
class ClientState:
    """Holder-side state for one credential (groth16rand.rs:26-36)."""

    inputs: list[int]               # public inputs as field elements
    aux: Optional[str]
    proof: Proof
    vk: VerifyingKey
    pvk: PreparedVerifyingKey
    config_str: str = ""
    credtype: str = "jwt"
    input_com_randomness: Optional[int] = None
    committed_input_openings: list = field(default_factory=list)

    # -- show ---------------------------------------------------------------
    def show_groth16(
        self,
        context: Optional[bytes],
        io_types: list[PublicIOType],
        rng: random.Random | None = None,
    ) -> "ShowGroth16":
        assert len(self.inputs) == len(io_types)
        rng = rng or random.SystemRandom()

        rand_proof = groth16.rerandomize_proof(self.vk, self.proof, rng)

        committed_openings = []
        y, bases, scalars = [], [], []
        hidden_bases, hidden_scalars = [], []
        acc_r = 0
        for i, io_t in enumerate(io_types):
            if io_t == PublicIOType.REVEALED:
                continue
            if io_t == PublicIOType.HIDDEN:
                hidden_bases.append(self.vk.gamma_abc_g1[i + 1])
                hidden_scalars.append(self.inputs[i])
            else:  # COMMITTED
                r = rng.randrange(R)
                acc_r = (acc_r + r) % R
                ped_bases = [self.vk.gamma_abc_g1[i + 1], self.vk.delta_g1]
                c = msm_select([self.vk.delta_g1, self.vk.gamma_abc_g1[i + 1]], [r, self.inputs[i]])
                bases.append(list(ped_bases))
                scalars.append([self.inputs[i], r])
                y.append(c)
                committed_openings.append(PedersenOpening(ped_bases, self.inputs[i], r, c))

        self.committed_input_openings = committed_openings

        z = rng.randrange(R)
        hidden_scalars.append(z)
        hidden_bases.append(self.vk.delta_g1)
        com_hidden = msm_select(hidden_bases, hidden_scalars)
        self.input_com_randomness = z

        scalars.append(hidden_scalars)
        bases.append(hidden_bases)
        y.append(com_hidden)

        # proof.c -= (acc_r + z) * G   (gamma == 1 makes this cancel)
        c_adj = G1.add(rand_proof.c, G1.neg(G1.mul((acc_r + z) % R, G1.generator)))
        rand_proof = Proof(rand_proof.a, rand_proof.b, c_adj)

        pok_inputs = DLogPoK.prove(context, y, bases, scalars, rng=rng)

        return ShowGroth16(
            rand_proof=rand_proof,
            com_hidden_inputs=com_hidden,
            pok_inputs=pok_inputs,
            committed_inputs=[o.c for o in committed_openings],
        )

    def show_range(
        self,
        ped_open: PedersenOpening,
        n: int,
        range_pk: RangeProofPK,
        rng: random.Random | None = None,
    ) -> "ShowRange":
        """Range proof over a committed input (groth16rand.rs:193-225; the
        reference forces 1 thread for wasm-parity — determinism here comes
        from the caller-supplied rng instead)."""
        assert n < 64
        assert ped_open.m < (1 << n), "value out of range"
        return ShowRange(prove_n_bits(ped_open, n, range_pk.powers, rng=rng))


@dataclass
class ShowGroth16:
    rand_proof: Proof
    com_hidden_inputs: AffinePoint
    pok_inputs: DLogPoK
    committed_inputs: list

    def verify(
        self,
        vk: VerifyingKey,
        pvk: PreparedVerifyingKey,
        context: Optional[bytes],
        io_types: list[PublicIOType],
        public_inputs: list[int],
    ) -> bool:
        """groth16rand.rs:232-307."""
        com_inputs = G1.add(self.com_hidden_inputs, vk.gamma_abc_g1[0])
        pub_idx = 0
        com_idx = 0
        hidden_bases = []
        bases = []
        y = list(self.committed_inputs)
        revealed_bases, revealed_scalars = [], []

        for i, io_t in enumerate(io_types):
            if io_t == PublicIOType.REVEALED:
                revealed_bases.append(vk.gamma_abc_g1[i + 1])
                revealed_scalars.append(public_inputs[pub_idx])
                pub_idx += 1
            elif io_t == PublicIOType.HIDDEN:
                hidden_bases.append(vk.gamma_abc_g1[i + 1])
            else:
                if com_idx >= len(self.committed_inputs):
                    return False
                com_inputs = G1.add(com_inputs, self.committed_inputs[com_idx])
                com_idx += 1
                bases.append([vk.gamma_abc_g1[i + 1], vk.delta_g1])

        if revealed_bases:
            com_inputs = G1.add(com_inputs, msm_select(revealed_bases, revealed_scalars))
        hidden_bases.append(vk.delta_g1)
        bases.append(hidden_bases)
        y.append(self.com_hidden_inputs)

        groth16_valid = groth16.verify_with_prepared_inputs(pvk, self.rand_proof, com_inputs)
        dlog_valid = self.pok_inputs.verify(context, bases, y)
        return groth16_valid and dlog_valid


@dataclass
class ShowRange:
    range_proof: RangeProof

    def verify(
        self,
        ped_com: AffinePoint,
        n: int,
        range_vk: RangeProofVK,
        io_locations: IOLocations,
        vk: VerifyingKey,
        input_label: str,
        rng: random.Random | None = None,
    ) -> bool:
        """groth16rand.rs:309-327: rebind the Pedersen bases from the IO
        location of `input_label` and check the range proof."""
        input_pos = io_locations.get_io_location(input_label)
        bases = [vk.gamma_abc_g1[input_pos], vk.delta_g1]
        return verify_n_bits(self.range_proof, ped_com, bases, n, range_vk, rng=rng)
