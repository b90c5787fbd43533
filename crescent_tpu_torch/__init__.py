"""crescent-tpu on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``crescent_tpu`` beside it.  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a hand-written CUDA C++
kernel for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use.  Host
crypto (``core``: fields, curves, pairings; ``native``: the C++ backend;
``utils``) is the port's own copy of the JAX package's; the port imports
nothing of that package and nothing of jax.

Ported so far: Groth16 ``setup`` -> ``prove`` -> ``verify``
(``models.groth16``) with the QAP witness map h(x) on the device (``mul``,
``butterfly``) and the four G1 MSMs as a chunk fold of sorted-segment affine
MSMs there (``inv``, ``affine_denom``, ``affine_add``, ``jadd``, ``jdbl_n``;
``jdbl`` beside them); the G2 MSM runs on the native host backend, or
under ``CRESCENT_NATIVE=0`` on the device too.  The show path
(``credentials``: the rerandomized Groth16 show with Pedersen commitments
and DLog proofs, the KZG range proof of ``models.kzg``) runs on the host;
its KZG powers come from ``models.groth16.fixed_base_mul``.  The credential
pipeline (``credentials.api``, the JWT statement of ``r1cs`` and its native
witness replay, the ark artifacts of ``utils.ark``) runs end to end for the
rs256 parameter sets through the port's CLI, ``python -m
crescent_tpu_torch.cli``.
"""

__version__ = "0.1.0"
