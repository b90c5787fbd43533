"""Carries state from the JAX package into the port, so the two can run on
identical keys and tables.  Takes the reference's objects as they are and
imports nothing of JAX: device arrays are read with ``np.asarray``."""

from __future__ import annotations

import numpy as np
import torch

from .core.fields import Fq2
from .models import groth16
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


def proving_key_from_reference(pk) -> groth16.ProvingKey:
    """The reference's ``ProvingKey`` as the port's.  The two packages
    define their own point and field classes, so every G2 coordinate, ``vk``
    element and point vector is rebuilt from plain ints and numpy arrays
    (the arrays themselves are shared, not copied)."""
    vk = pk.vk
    pvk = groth16.VerifyingKey(
        _g1(vk.alpha_g1), _g2(vk.beta_g2), _g2(vk.gamma_g2), _g1(vk.delta_g1),
        _g2(vk.delta_g2), [_g1(p) for p in vk.gamma_abc_g1],
    )
    return groth16.ProvingKey(
        pvk, _g1(pk.beta_g1), _g1(pk.delta_g1), _table(pk.a_query, False),
        _table(pk.b_g1_query, False), _table(pk.b_g2_query, True),
        _table(pk.h_query, False), _table(pk.l_query, False),
    )


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
