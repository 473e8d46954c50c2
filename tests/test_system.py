"""End-to-end system tests: config ladder step 1 (direct N small, leapfrog,
3D, energy conservation) on CPU."""

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators import SimConfig, ParticleState
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.models import integrators as I
from coulomb_oscillators.models import oscillator as M


def _make_state(config, n):
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(config.omega0, x))
    pos, vel = ID.init_gaussian(n, x, u, dtype=np.float32)
    state = ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                          jnp.zeros_like(jnp.asarray(pos)))
    return M.init_accelerations(config, state)


def test_energy_drift_direct_512():
    config = SimConfig()
    n = 512
    state = _make_state(config, n)
    e0 = float(M.total_energy(config, state))
    step = M.make_step_fn(config, n, engine="direct", integrator="leapfrog")
    state = I.nsteps(step, state, 500)
    e1 = float(M.total_energy(config, state))
    drift = abs(e1 - e0) / abs(e0)
    assert drift < 1e-4, drift


def test_engines_agree():
    config = SimConfig()
    n = 300
    state = _make_state(config, n)
    f_fast = M.make_oscillator_force(config, n, "direct")
    f_ref = M.make_oscillator_force(config, n, "direct_ref")
    a1, a2 = f_fast(state.pos), f_ref(state.pos)
    from coulomb_oscillators.ops.reductions import mean_rel_err
    assert float(mean_rel_err(a1, a2)) < 1e-5


def test_trap_only_oscillation_period():
    # With xi=0 the system is a pure anisotropic harmonic oscillator.
    config = SimConfig(xi=0.0, dt=1e-3)
    n = 4
    rngp = np.random.default_rng(7)
    pos = jnp.asarray(rngp.normal(size=(n, 3)) * 0.01, dtype=jnp.float32)
    state = ParticleState(pos, jnp.zeros_like(pos), jnp.zeros_like(pos))
    state = M.init_accelerations(config, state)
    # integrate one full period of the y/z oscillators (omega=1): T = 2*pi
    steps = int(round(2 * np.pi / config.dt))
    step = M.make_step_fn(config, n)
    out = I.nsteps(step, state, steps)
    np.testing.assert_allclose(np.asarray(out.pos)[:, 1:], np.asarray(pos)[:, 1:],
                               atol=2e-4)


def test_simulator_plain_engine():
    from coulomb_oscillators.simulate import Simulator
    config = SimConfig(dt=1e-3)
    n = 128
    state = _make_state(config, n)
    sim = Simulator(config, n, engine="direct")
    out = sim.run(state, 7)
    assert out.pos.shape == (n, 3)
    assert bool(jnp.all(jnp.isfinite(out.pos)))
