"""External harmonic-trap (elastic) force.

Reference: Simulation/kernel.cuh:119-226 (`add_elastic` / `elastic`): the trap
contributes a = -k (.) p component-wise, with k = omega0^2 per axis
(main3.cu:689-691).  These are trivially fused by XLA into
whatever force pipeline surrounds them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def elastic(pos: jax.Array, omega0_sq) -> jax.Array:
    """a = -omega0^2 (.) pos  (kernel.cuh:175-196)."""
    k = jnp.asarray(omega0_sq, dtype=pos.dtype)
    return -pos * k


def add_elastic(pos: jax.Array, acc: jax.Array, omega0_sq) -> jax.Array:
    """acc - omega0^2 (.) pos  (kernel.cuh:119-152)."""
    k = jnp.asarray(omega0_sq, dtype=pos.dtype)
    return acc - pos * k
