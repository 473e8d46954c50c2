"""Particle state pytree.

Analogue of the reference's flat device buffer split into
pos/vel/acc views (``ParticleSystem``, Simulation/kernel.cuh:67 and
integrator.cuh:24).  Here it is an explicit pytree of ``[N, DIM]`` arrays so
it can flow through jit/scan/shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ParticleState(NamedTuple):
    """Positions, velocities and cached accelerations of N particles."""

    pos: jax.Array  # [N, DIM]
    vel: jax.Array  # [N, DIM]
    acc: jax.Array  # [N, DIM] — cached force from the last evaluation

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @classmethod
    def create(cls, pos, vel, acc=None) -> "ParticleState":
        pos = jnp.asarray(pos)
        vel = jnp.asarray(vel)
        if acc is None:
            acc = jnp.zeros_like(pos)
        return cls(pos=pos, vel=vel, acc=acc)
