"""Cartesian multipole algebra for the FMM, as batched table-driven ops.

Replacement for the reference's recursive per-element tensor
kernels (Simulation/fmm_cart_base.cuh, fmm_cart_base3.cuh): every operator
(P2M, M2M, M2L, L2L, L2P, M2P) becomes a precomputed coefficient/gather
table applied as batched jnp gathers + matmuls, so the hot loops run with
static shapes.
"""

