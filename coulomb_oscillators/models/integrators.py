"""Symplectic integrators as coefficient-table compositions.

Reference: Simulation/integrator.cuh.  Each integrator there is a host
function sequencing kick (v += a*c*dt*scale), drift (x += v*c*dt) and force
(a = f(x)) stages.  Here the same stage sequences are declarative tables; a
step function is built by unrolling the table at trace time, so the whole
step (including every force evaluation) fuses under one jit.

Coefficients are computed in Python float (binary64) then cast to the state
dtype, matching the reference's long-double-then-cast convention
(integrator.cuh:112-127).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax

from coulomb_oscillators.state import ParticleState

# Stage encodings: ("D", c) drift, ("K", c) kick, ("F",) force eval.
Stage = Tuple

# 1/(2 - cbrt(2)) — Forest-Ruth parameter (integrator.cuh:98)
_FR = 1.3512071919596576340476878089715

# PEFRL parameters (integrator.cuh:130-132)
_PEFRL_X = +0.1786178958448091
_PEFRL_L = -0.2123418310626054
_PEFRL_C = -0.06626458266981849

# symplectic_euler (integrator.cuh:32-48): kick with cached acc, drift, force.
SYMPLECTIC_EULER: Sequence[Stage] = (("K", 1.0), ("D", 1.0), ("F",))

# pre_symplectic_euler (integrator.cuh:50-66): force first.
PRE_SYMPLECTIC_EULER: Sequence[Stage] = (("F",), ("K", 1.0), ("D", 1.0))

# leapfrog KDK (integrator.cuh:68-96)
LEAPFROG: Sequence[Stage] = (("K", 0.5), ("D", 1.0), ("F",), ("K", 0.5))

# forestruth (integrator.cuh:100-128)
FORESTRUTH: Sequence[Stage] = (
    ("D", _FR / 2), ("F",), ("K", _FR),
    ("D", (1 - _FR) / 2), ("F",), ("K", 1 - 2 * _FR),
    ("D", (1 - _FR) / 2), ("F",), ("K", _FR),
    ("D", _FR / 2),
)

# pefrl (integrator.cuh:134-167)
PEFRL: Sequence[Stage] = (
    ("D", _PEFRL_X), ("F",), ("K", (1 - 2 * _PEFRL_L) / 2),
    ("D", _PEFRL_C), ("F",), ("K", _PEFRL_L),
    ("D", 1 - 2 * (_PEFRL_C + _PEFRL_X)), ("F",), ("K", _PEFRL_L),
    ("D", _PEFRL_C), ("F",), ("K", (1 - 2 * _PEFRL_L) / 2),
    ("D", _PEFRL_X),
)

INTEGRATORS = {
    "euler": SYMPLECTIC_EULER,
    "pre_euler": PRE_SYMPLECTIC_EULER,
    "leapfrog": LEAPFROG,
    "forestruth": FORESTRUTH,
    "fr": FORESTRUTH,
    "pefrl": PEFRL,
}

# Number of force evaluations per step, for throughput accounting.
FORCE_EVALS = {name: sum(1 for s in tab if s[0] == "F")
               for name, tab in INTEGRATORS.items()}


def make_step(
    force_fn: Callable[[jax.Array], jax.Array],
    table: Sequence[Stage] | str,
    dt: float,
    scale: float = 1.0,
) -> Callable[[ParticleState], ParticleState]:
    """Build a single-step function state -> state from a stage table.

    `force_fn`: pos [N,D] -> acc [N,D] (already includes the trap term).
    The returned function is pure; wrap in jax.jit (or lax.scan) as needed.
    """
    if isinstance(table, str):
        table = INTEGRATORS[table]
    dt = float(dt)
    scale = float(scale)

    def step(state: ParticleState, dt_on=1) -> ParticleState:
        """One step; a traced dt_on=0 makes it a step of length zero, whose
        only effect is acc = force(pos)."""
        pos, vel, acc = state
        dtype = pos.dtype
        for stage in table:
            if stage[0] == "D":
                pos = pos + vel * (dtype.type(dt * stage[1]) * dt_on)
            elif stage[0] == "K":
                vel = vel + acc * (dtype.type(dt * scale * stage[1]) * dt_on)
            else:  # "F"
                acc = force_fn(pos)
        return ParticleState(pos, vel, acc)

    return step


def nsteps(step_fn, state: ParticleState, n: int) -> ParticleState:
    """Run `n` steps under lax.scan (single compiled loop)."""
    def body(s, _):
        return step_fn(s), None
    out, _ = jax.lax.scan(body, state, None, length=n)
    return out
