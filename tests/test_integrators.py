"""Integrator order, reversibility, and energy behavior.

Covers SURVEY.md §4 implications: (c) energy drift bound, (f) time
reversibility of symplectic integrators; plus convergence-order checks
against the exact harmonic-oscillator solution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coulomb_oscillators.models import integrators as I
from coulomb_oscillators.state import ParticleState

OMEGA2 = (1.095**2, 1.0, 1.0)


def trap_force(pos):
    return -pos * jnp.asarray(OMEGA2, dtype=pos.dtype)


def exact_harmonic(pos0, vel0, t):
    w = np.sqrt(np.asarray(OMEGA2))
    return (pos0 * np.cos(w * t) + vel0 * np.sin(w * t) / w,
            vel0 * np.cos(w * t) - pos0 * w * np.sin(w * t))


def _run(table, dt, steps, dtype=jnp.float64):
    pos0 = jnp.asarray([[0.3, -0.2, 0.5]], dtype=dtype)
    vel0 = jnp.asarray([[0.1, 0.4, -0.3]], dtype=dtype)
    state = ParticleState(pos0, vel0, trap_force(pos0))
    step = I.make_step(trap_force, table, dt)
    state = I.nsteps(step, state, steps)
    return state


@pytest.mark.parametrize("name,order", [
    ("euler", 1), ("leapfrog", 2), ("forestruth", 4), ("pefrl", 4),
])
def test_convergence_order(name, order):
    jax.config.update("jax_enable_x64", True)
    try:
        t_end = 1.0
        errs = []
        for steps in (64, 128):
            dt = t_end / steps
            st = _run(I.INTEGRATORS[name], dt, steps)
            ep, _ = exact_harmonic(np.asarray(st.pos) * 0 + [[0.3, -0.2, 0.5]],
                                   np.asarray([[0.1, 0.4, -0.3]]), t_end)
            errs.append(float(np.max(np.abs(np.asarray(st.pos) - ep))))
        rate = np.log2(errs[0] / errs[1])
        assert rate > order - 0.5, (name, errs, rate)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["leapfrog", "forestruth", "pefrl"])
def test_time_reversibility(name):
    # Run forward n steps, negate velocities, run n steps: must return
    # (to rounding) to the start. Valid for the self-starting tables that
    # don't rely on a stale cached acc asymmetrically.
    jax.config.update("jax_enable_x64", True)
    try:
        dt = 1e-2
        steps = 100
        st = _run(I.INTEGRATORS[name], dt, steps)
        back = ParticleState(st.pos, -st.vel, st.acc)
        step = I.make_step(trap_force, I.INTEGRATORS[name], dt)
        back = I.nsteps(step, back, steps)
        assert float(jnp.max(jnp.abs(back.pos - jnp.asarray([[0.3, -0.2, 0.5]])))) < 1e-10
    finally:
        jax.config.update("jax_enable_x64", False)


def test_leapfrog_energy_bounded_f32():
    # Harmonic trap, f32, 10k steps: leapfrog energy error stays bounded.
    dt = 5e-4
    pos0 = jnp.asarray(np.random.default_rng(0).normal(size=(64, 3)) * 0.01,
                       dtype=jnp.float32)
    vel0 = jnp.zeros_like(pos0)
    state = ParticleState(pos0, vel0, trap_force(pos0))
    step = I.make_step(trap_force, "leapfrog", dt)

    def energy(s):
        k = jnp.asarray(OMEGA2, dtype=jnp.float32)
        return 0.5 * jnp.sum(s.vel**2) + 0.5 * jnp.sum(s.pos**2 * k)

    e0 = float(energy(state))
    state = I.nsteps(jax.jit(step), state, 10_000)
    e1 = float(energy(state))
    assert abs(e1 - e0) / abs(e0) < 1e-4


def test_euler_uses_cached_acceleration():
    # symplectic_euler kicks with the *cached* acc before drifting
    # (integrator.cuh:32-48).
    pos0 = jnp.ones((1, 3), dtype=jnp.float32)
    vel0 = jnp.zeros_like(pos0)
    acc0 = jnp.full_like(pos0, 2.0)
    state = ParticleState(pos0, vel0, acc0)
    dt = 0.5
    step = I.make_step(trap_force, "euler", dt)
    out = step(state)
    np.testing.assert_allclose(np.asarray(out.vel), 2.0 * dt)
    np.testing.assert_allclose(np.asarray(out.pos), 1.0 + 2.0 * dt * dt)
