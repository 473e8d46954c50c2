"""Direct O(N^2) softened-Coulomb force.

The pairwise force law matches the reference (Simulation/direct.cuh:23-35):
for displacement d = p_i - p_j and dist2 = |d|^2 + eps2,

    2D:  a_i += d / dist2            (log potential)
    3D:  a_i += d / dist2^(3/2)      (1/r potential)
    4D:  a_i += d / dist2^2          (1/r^2 potential; jnp paths only —
                                      direct.cuh:32-35)

and the result is scaled by kappa = xi/N (param[0], direct.cuh:59-61).
The j == i self term contributes exactly 0 (d = 0), as in the reference.

Implementations:

  * :func:`direct_jnp` — chunked jnp broadcast that XLA fuses into one
    elementwise + row-reduction pass per chunk (the analogue of direct2,
    direct.cuh:140-190; the reference's fast path is the shared-memory
    tile kernel direct.cuh:51-138).
  * :func:`direct_kahan` — Kahan-compensated accuracy oracle, the analogue
    of ``direct3`` (direct.cuh:192-245); used as the test/auto-tune
    reference engine.  :func:`direct_kahan_targets` is its subsampled form.

Every contraction is written as a multiply and a ``sum``, never as an
einsum or dot: a float32 dot may run in TF32 on the GPU, and the oracle
that every error bound rests on must not.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp


def _pair_weight(dist2: jax.Array, dim: int) -> jax.Array:
    """w(d) such that the force contribution is d * w (direct.cuh:23-35):
    2D 1/dist2, 3D dist2^(-3/2), 4D 1/dist2^2 (the reference's 4D force
    profile, direct.cuh:32-35)."""
    inv = 1.0 / dist2
    if dim == 2:
        return inv
    if dim == 3:
        return inv * jax.lax.rsqrt(dist2)
    if dim == 4:
        return inv * inv
    raise ValueError(f"unsupported dim {dim}")


# --------------------------------------------------------------------------- #
# jnp reference paths
# --------------------------------------------------------------------------- #


def _acc_rows(pos_rows: jax.Array, pos_all: jax.Array, eps2, dim: int) -> jax.Array:
    """Accelerations on a chunk of target rows against all sources."""
    d = pos_rows[:, None, :] - pos_all[None, :, :]          # [R, N, D]
    dist2 = jnp.sum(d * d, axis=-1) + eps2                  # [R, N]
    w = _pair_weight(dist2, dim)
    return jnp.sum(w[:, :, None] * d, axis=1)


@functools.partial(jax.jit, static_argnames=("row_chunk",))
def direct_jnp(pos: jax.Array, eps2: float, kappa: float, row_chunk: int = 1024):
    """Chunked O(N^2) pairwise force; [N, D] -> [N, D].

    Rows are processed in chunks of `row_chunk` targets via lax.map to bound
    the [R, N] intermediate, mirroring the grid-stride structure of
    direct2 (direct.cuh:140-190) without materialising N^2 memory.
    """
    n, dim = pos.shape
    npad = -(-n // row_chunk) * row_chunk
    padded = jnp.pad(pos, ((0, npad - n), (0, 0)))
    chunks = padded.reshape(npad // row_chunk, row_chunk, dim)
    acc = jax.lax.map(lambda rows: _acc_rows(rows, pos, eps2, dim), chunks)
    return kappa * acc.reshape(npad, dim)[:n]


@functools.partial(jax.jit, static_argnames=("src_chunk",))
def direct_kahan_targets(targets: jax.Array, pos: jax.Array, eps2: float,
                         kappa: float, src_chunk: int = 2048):
    """Kahan-compensated forces of ALL `pos` sources on `targets` rows only.

    The subsampled oracle for large N: at N=1M the plain f32 direct kernel's
    own accumulation noise reaches ~1e-3 mean-relative for beam-core
    particles (large cancelling near-neighbor contributions), which
    saturates any error measurement made against it.  Self-pairs are
    excluded by distance identity (a target coincides with exactly one
    source, contributing d = 0).
    """
    nt, dim = targets.shape
    n = pos.shape[0]
    npad = -(-n // src_chunk) * src_chunk
    src = jnp.pad(pos, ((0, npad - n), (0, 0)))
    valid = (jnp.arange(npad) < n).astype(pos.dtype)
    src_chunks = src.reshape(npad // src_chunk, src_chunk, dim)
    mask_chunks = valid.reshape(npad // src_chunk, src_chunk)

    def body(carry, xs):
        acc, comp = carry
        s, m = xs
        d = targets[:, None, :] - s[None, :, :]
        dist2 = jnp.sum(d * d, axis=-1) + eps2
        w = _pair_weight(dist2, dim) * m[None, :]
        contrib = jnp.sum(w[:, :, None] * d, axis=1)
        y = contrib - comp
        t = acc + y
        comp = (t - acc) - y
        return (t, comp), None

    init = (jnp.zeros_like(targets), jnp.zeros_like(targets))
    (acc, _), _ = jax.lax.scan(body, init, (src_chunks, mask_chunks))
    return kappa * acc


@functools.partial(jax.jit, static_argnames=("src_chunk",))
def direct_kahan(pos: jax.Array, eps2: float, kappa: float, src_chunk: int = 512):
    """Kahan-compensated direct sum — the accuracy oracle.

    Mirrors ``direct3`` (direct.cuh:192-245): the per-target accumulation over
    source chunks carries a compensation term, so the summation error stays
    O(eps) independent of N even in float32.
    """
    n, dim = pos.shape
    npad = -(-n // src_chunk) * src_chunk
    src = jnp.pad(pos, ((0, npad - n), (0, 0)))
    # Padded (zero) sources must not contribute: mask them out.
    valid = (jnp.arange(npad) < n).astype(pos.dtype)
    src_chunks = src.reshape(npad // src_chunk, src_chunk, dim)
    mask_chunks = valid.reshape(npad // src_chunk, src_chunk)

    def body(carry, xs):
        acc, comp = carry
        s, m = xs
        d = pos[:, None, :] - s[None, :, :]                 # [N, C, D]
        dist2 = jnp.sum(d * d, axis=-1) + eps2
        w = _pair_weight(dist2, dim) * m[None, :]
        contrib = jnp.sum(w[:, :, None] * d, axis=1)
        # Kahan update (direct.cuh:213-221)
        y = contrib - comp
        t = acc + y
        comp = (t - acc) - y
        return (t, comp), None

    init = (jnp.zeros_like(pos), jnp.zeros_like(pos))
    (acc, _), _ = jax.lax.scan(body, init, (src_chunks, mask_chunks))
    return kappa * acc
