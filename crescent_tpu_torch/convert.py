"""Carries state from the JAX package into the port, so the two can run on
identical keys, tables and show state.  Takes the reference's objects as
they are and imports nothing of JAX: device arrays are read with
``np.asarray``, everything else is rebuilt from its ints."""

from __future__ import annotations

import numpy as np
import torch

from .core.fields import Fq2, Fq6, Fq12
from .credentials import dlog, groth16rand, rangeproof
from .models import groth16, kzg
from .ops import limb
from .utils.pointvec import ArrayPointVec


def _g1(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _g2(p):
    if p is None:
        return None
    x, y = p
    return (Fq2(int(x.c0), int(x.c1)), Fq2(int(y.c0), int(y.c1)))


def _table(pts, g2: bool):
    """A reference SRS table (list of affine points, or its ArrayPointVec:
    anything with xs / ys / inf limb arrays) as the port's."""
    if hasattr(pts, "xs") and hasattr(pts, "inf"):
        return ArrayPointVec(np.asarray(pts.xs), np.asarray(pts.ys),
                             np.asarray(pts.inf), bool(pts.g2))
    return [(_g2 if g2 else _g1)(p) for p in pts]


def _fq12(f) -> Fq12:
    def fq6(x):
        return Fq6(*(Fq2(int(c.c0), int(c.c1)) for c in (x.c0, x.c1, x.c2)))

    return Fq12(fq6(f.c0), fq6(f.c1))


def verifying_key_from_reference(vk) -> groth16.VerifyingKey:
    """The reference's ``VerifyingKey`` as the port's."""
    return groth16.VerifyingKey(
        _g1(vk.alpha_g1), _g2(vk.beta_g2), _g2(vk.gamma_g2), _g1(vk.delta_g1),
        _g2(vk.delta_g2), [_g1(p) for p in vk.gamma_abc_g1],
    )


def proof_from_reference(proof) -> groth16.Proof:
    """The reference's Groth16 ``Proof`` as the port's."""
    return groth16.Proof(_g1(proof.a), _g2(proof.b), _g1(proof.c))


def proving_key_from_reference(pk) -> groth16.ProvingKey:
    """The reference's ``ProvingKey`` as the port's.  The two packages
    define their own point and field classes, so every G2 coordinate, ``vk``
    element and point vector is rebuilt from plain ints and numpy arrays
    (the arrays themselves are shared, not copied)."""
    pvk = verifying_key_from_reference(pk.vk)
    return groth16.ProvingKey(
        pvk, _g1(pk.beta_g1), _g1(pk.delta_g1), _table(pk.a_query, False),
        _table(pk.b_g1_query, False), _table(pk.b_g2_query, True),
        _table(pk.h_query, False), _table(pk.l_query, False),
    )


def client_state_from_reference(cs) -> groth16rand.ClientState:
    """The reference's show ``ClientState`` as the port's: inputs, proof,
    keys (the prepared key's e(alpha, beta) carried, not recomputed) and
    the last show's openings."""
    vk = verifying_key_from_reference(cs.vk)
    pvk = groth16.PreparedVerifyingKey(vk, _fq12(cs.pvk.alpha_beta))
    openings = [dlog.PedersenOpening([_g1(b) for b in o.bases], int(o.m), int(o.r),
                                     _g1(o.c))
                for o in cs.committed_input_openings]
    rand = cs.input_com_randomness
    return groth16rand.ClientState(
        [int(x) for x in cs.inputs], cs.aux, proof_from_reference(cs.proof), vk, pvk,
        cs.config_str, cs.credtype, None if rand is None else int(rand), openings,
    )


def kzg_powers_from_reference(powers) -> kzg.Powers:
    return kzg.Powers([_g1(p) for p in powers.powers_of_g],
                      [_g1(p) for p in powers.powers_of_gamma_g])


def kzg_verifier_key_from_reference(vk) -> kzg.VerifierKey:
    return kzg.VerifierKey(_g1(vk.g), _g1(vk.gamma_g), _g2(vk.h), _g2(vk.beta_h))


def range_keys_from_reference(pk, vk):
    """The reference's (``RangeProofPK``, ``RangeProofVK``) as the port's."""
    return (rangeproof.RangeProofPK(kzg_powers_from_reference(pk.powers)),
            rangeproof.RangeProofVK(kzg_verifier_key_from_reference(vk.kzg_vk),
                                    [_g1(p) for p in vk.com_f_basis]))


def device_table_from_reference(planes, device="cpu"):
    """The reference's ``ProvingKey.device_table`` planes (x and y limbs,
    (N, 16) over Fq or (N, 2, 16) over Fq2, and (N,) valid; Montgomery
    form) as the port's ((N, 8) or (N, 16) int32 words, and (N,) int32) on
    `device`."""
    x, y, valid = (np.asarray(a) for a in planes)
    n = valid.shape[0]

    def words(a):
        return limb.limbs_to_words(a.reshape(-1, limb.NLIMB), device).reshape(n, -1)

    return (words(x), words(y), torch.from_numpy(valid.astype(np.int32)).to(device))


def domain_tables_from_reference(dom, device="cpu") -> dict:
    """The reference ``NTTDomain``'s tables in the port's layout:
    {'perm', 'tw_fwd', 'tw_inv', 'n_inv_mont', 'coset', 'coset_inv'}, with
    the per-stage (half, 16) twiddle planes concatenated to one (n-1, 8)
    word plane per direction and the coset powers for the field's
    multiplicative generator g and for g^-1."""
    g = groth16.Fr.multiplicative_generator
    p = dom.ctx.modulus

    def words(planes) -> torch.Tensor:
        a = np.concatenate([np.asarray(x) for x in planes], axis=0)
        return limb.limbs_to_words(a, device)

    return {
        "perm": torch.from_numpy(np.asarray(dom.perm).astype(np.int64)).to(device),
        "tw_fwd": words(dom.tw_fwd),
        "tw_inv": words(dom.tw_inv),
        "n_inv_mont": words([np.asarray(dom.n_inv_mont)[None]]),
        "coset": words([dom._coset_powers(g)]),
        "coset_inv": words([dom._coset_powers(pow(g, -1, p))]),
    }
