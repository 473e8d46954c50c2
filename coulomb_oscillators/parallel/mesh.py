"""Particle sharding over a device mesh.

The reference is single-GPU (SURVEY.md §2.7 item 8); the scale-out
axis is particle count N, sharded over a 1D mesh ("dp").  Two schemes:

  * all-gather: each shard computes the force of ALL sources on ITS targets;
    one all_gather of positions per evaluation crosses the links.  Simple, and
    optimal when N/shard is compute-bound (O(N^2/P) flops vs O(N) comms).
  * ring: systolic ppermute pipeline that overlaps source-block exchange with
    the pairwise compute (classic n-body ring).  Preferred at large P.

Both are pure shard_map functions; integrators compose on top unchanged.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from coulomb_oscillators.ops.direct import _pair_weight


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    import numpy as np
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _local_direct(tgt: jax.Array, src: jax.Array, eps2: float, dim: int,
                  row_chunk: int = 1024) -> jax.Array:
    """Force of all `src` on `tgt` rows, chunked (unscaled)."""
    nt = tgt.shape[0]
    nc = min(row_chunk, nt)
    npad = -(-nt // nc) * nc
    padded = jnp.pad(tgt, ((0, npad - nt), (0, 0)))
    chunks = padded.reshape(npad // nc, nc, dim)

    def body(rows):
        d = rows[:, None, :] - src[None, :, :]
        dist2 = jnp.sum(d * d, axis=-1) + eps2
        w = _pair_weight(dist2, dim)
        return jnp.sum(w[:, :, None] * d, axis=1)

    acc = jax.lax.map(body, chunks)
    return acc.reshape(npad, dim)[:nt]


def make_sharded_direct(mesh: Mesh, eps2: float, kappa: float, dim: int = 3,
                        scheme: str = "ring", axis: str = "dp") -> Callable:
    """Sharded direct force: pos [N, D] (sharded on rows) -> acc [N, D].

    N must be divisible by the mesh size (pad upstream).  Padded slots must
    be parked far from the origin by the caller, or masked; see
    `pad_positions`.
    """

    def allgather_impl(pos_local):
        src = jax.lax.all_gather(pos_local, axis, tiled=True)
        return kappa * _local_direct(pos_local, src, eps2, dim)

    def ring_impl(pos_local):
        p = jax.lax.axis_size(axis)
        perm = [(i, (i + 1) % p) for i in range(p)]

        def body(i, carry):
            block, acc = carry
            acc = acc + _local_direct(pos_local, block, eps2, dim)
            # rotate source block around the ring (skip last rotation's use)
            block = jax.lax.ppermute(block, axis, perm)
            return (block, acc)

        init = (pos_local, jnp.zeros_like(pos_local))
        _, acc = jax.lax.fori_loop(0, p, body, init)
        return kappa * acc

    impl = ring_impl if scheme == "ring" else allgather_impl
    return shard_map(impl, mesh=mesh, in_specs=P(axis, None),
                     out_specs=P(axis, None), check_vma=False)


def pad_to_multiple(pos: jax.Array, multiple: int, far: float = 1e18):
    """Pad rows to a multiple, parking padded particles at `far` so their
    pair weights underflow to zero (same trick as ops.direct)."""
    n = pos.shape[0]
    npad = -(-n // multiple) * multiple
    if npad == n:
        return pos, n
    pad = jnp.full((npad - n, pos.shape[1]), far, dtype=pos.dtype)
    return jnp.concatenate([pos, pad], axis=0), n
