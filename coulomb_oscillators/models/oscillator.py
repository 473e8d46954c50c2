"""The Coulomb-oscillator system: force composition and simulation API.

Reference: Simulation/main3.cu:47-69 — `coulombOscillator*` composes an
interchangeable Coulomb engine with the external harmonic trap
(`add_elastic`).  Here the composition is functional: an engine is a pure
function pos -> acc, and the oscillator force adds the trap term (XLA fuses
it into the engine's epilogue).

Engine registry mirrors the reference's engine set (SURVEY.md §2.2); entries
are filled in as the FMM stack lands.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.models import integrators as integ
from coulomb_oscillators.ops import direct as direct_ops
from coulomb_oscillators.ops import energy as energy_ops
from coulomb_oscillators.ops.elastic import add_elastic
from coulomb_oscillators.state import ParticleState

ForceFn = Callable[[jax.Array], jax.Array]


def make_coulomb_force(config: SimConfig, n: int, engine: str = "direct") -> ForceFn:
    """Pure Coulomb force pos -> acc for the given engine (no trap term).

    Engines (reference equivalents):
      * "direct"       — chunked jnp pairwise sum (direct2, direct.cuh).
      * "direct_ref"   — Kahan-compensated oracle (direct3, direct.cuh:192-245).
      * FMM engines are registered by coulomb_oscillators.ops.fmm*.
    """
    eps2 = config.eps2
    kappa = config.kappa(n)

    if engine == "direct":
        return lambda pos: direct_ops.direct_jnp(pos, eps2, kappa)
    if engine == "direct_ref":
        return lambda pos: direct_ops.direct_kahan(pos, eps2, kappa)
    from coulomb_oscillators.ops import fmm  # deferred: heavy tables
    return fmm.make_engine(config, n, engine)


def make_oscillator_force(config: SimConfig, n: int, engine: str = "direct") -> ForceFn:
    """Coulomb engine + harmonic trap (coulombOscillator*, main3.cu:47-69)."""
    coulomb = make_coulomb_force(config, n, engine)
    omega0_sq = config.omega0_sq()

    def force(pos: jax.Array) -> jax.Array:
        return add_elastic(pos, coulomb(pos), omega0_sq)

    return force


def make_step_fn(config: SimConfig, n: int, engine: str = "direct",
                 integrator: Optional[str] = None):
    """Jitted single integration step ParticleState -> ParticleState."""
    force = make_oscillator_force(config, n, engine)
    table = integrator or config.integrator
    return jax.jit(integ.make_step(force, table, config.dt))


def init_accelerations(config: SimConfig, state: ParticleState,
                       engine: str = "direct") -> ParticleState:
    """Precompute a0 = f(x0) before the first step (main3.cu:835-839)."""
    force = make_oscillator_force(config, state.n, engine)
    return state._replace(acc=force(state.pos))


def total_energy(config: SimConfig, state: ParticleState) -> jax.Array:
    """Conserved Hamiltonian of the oscillator system (O(N^2) Coulomb sum)."""
    return energy_ops.total_energy(
        state.pos, state.vel, config.eps2, config.kappa(state.n),
        config.omega0_sq())


def total_energy_fmm(config: SimConfig, state: ParticleState,
                     engine, fstate) -> jax.Array:
    """Hamiltonian with the Coulomb term from the FMM potential — O(N),
    usable at scales where the pairwise sum is impractical."""
    ke = 0.5 * jnp.sum(jnp.square(state.vel).astype(jnp.float32))
    k = jnp.asarray(config.omega0_sq(), dtype=jnp.float32)
    trap = 0.5 * jnp.sum(jnp.square(state.pos).astype(jnp.float32) * k)
    phi = engine.potential(state.pos, fstate)
    return ke + trap + 0.5 * jnp.sum(phi.astype(jnp.float32))
