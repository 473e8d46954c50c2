"""Error metrics and reductions.

Replacement for Simulation/reductions.cuh: the CUB/hand-rolled tree
reductions become plain jnp reductions (XLA emits the reduction trees);
only the metric semantics are preserved.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rel_diff1(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-row relative difference sqrt(|a-b|^2 / (|b|^2 + 1e-18)).

    Exact semantics of rel_diff1 (reductions.cuh:37-42).
    """
    d = a - b
    dist2 = jnp.sum(d * d, axis=-1)
    ref2 = jnp.sum(b * b, axis=-1) + 1e-18
    return jnp.sqrt(jnp.maximum(dist2 / ref2, 0.0))


def rel_diff2(a: jax.Array, b: jax.Array) -> jax.Array:
    """Symmetric relative difference 2*sqrt(|a-b|^2/|a+b|^2) (reductions.cuh:44-49)."""
    d = a - b
    s = a + b
    dist2 = jnp.sum(d * d, axis=-1)
    div2 = jnp.sum(s * s, axis=-1) + 1e-18
    return 2.0 * jnp.sqrt(dist2 / div2)


def mean_rel_err(test: jax.Array, ref: jax.Array) -> jax.Array:
    """Mean of per-particle relative errors (relerrReduce2, reductions.cuh:82-104)."""
    return jnp.mean(rel_diff1(test, ref))


def rel_err_l2(test: jax.Array, ref: jax.Array) -> jax.Array:
    """L2-norm-ratio error ||test-ref|| / ||ref|| (relerrReduce3, reductions.cuh:106-153)."""
    return jnp.linalg.norm(test - ref) / jnp.linalg.norm(ref)


def minmax(pos: jax.Array):
    """Componentwise (min, max) over particles (minmaxReduce2, reductions.cuh:52-80)."""
    return jnp.min(pos, axis=0), jnp.max(pos, axis=0)


def pow_reduce(x: jax.Array, expo: float) -> jax.Array:
    """Sum of |x|^expo over all elements (powReduce, reductions.cuh:497-653)."""
    return jnp.sum(jnp.abs(x) ** expo)
