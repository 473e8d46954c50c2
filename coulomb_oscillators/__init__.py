"""coulomb_oscillators — N-body Coulomb-oscillator framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
CUDA simulator ``locuoco/coulomb_oscillators`` (see SURVEY.md): charged
particles in an external harmonic trap, with direct O(N^2) and Fast Multipole
Method force engines, symplectic integrators, deterministic initial
distributions, an accuracy/timing harness, and byte-compatible binary state
snapshots.

Design stance (not a CUDA translation):
  * state is a pytree of ``f32[N, DIM]`` arrays,
  * force engines are pure functions ``pos -> acc`` (jit/vmap/shard_map-able),
  * integrators are coefficient-table compositions fused under one jit,
  * the FMM is a fixed-shape, padded, batched pipeline; only the near
    field has a hand-written kernel (ops/fmm/p2p_triton.py).
"""

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.state import ParticleState

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "__version__"]
