"""BASELINE.json config ladder — one JSON line per config.

  1. direct O(N^2) P2P + trap, N=4096, leapfrog, 3D
  2. 2D quadtree FMM, N=100k, p=4, leapfrog
  3. 3D traceless-multipole FMM, N=1M
  4. 3D symmetric FMM at p=8 + Forest-Ruth (4th order)
  5. 3D kd-tree FMM, N=10M, per-step tree rebuild

Usage: python scripts/ladder.py [config_numbers...]   (default: 1 2 3 4)
Rows are printed and written to out/ladder.json (gitignored).
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

from coulomb_oscillators.utils.cache import enable_compile_cache
enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp


def _state(config, n, uniform=False):
    from coulomb_oscillators import ParticleState
    from coulomb_oscillators.models import init_dist as ID

    dim = config.dim
    if uniform:
        pos = ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim, dim=dim)
        vel = np.zeros_like(pos)
    else:
        x = (0.003, 0.001, 0.01)[:dim]
        u = tuple(w * xs for w, xs in zip(config.omega0, x))
        pos, vel = ID.init_gaussian(n, x, u, dim=dim, dtype=np.float32)
    return ParticleState(jnp.asarray(pos, jnp.float32),
                         jnp.asarray(vel, jnp.float32),
                         jnp.zeros((n, dim), jnp.float32))


def _run(tag, config, n, engine, steps=12, uniform=False, integ=None):
    from coulomb_oscillators.simulate import Simulator

    if os.environ.get("CO_GEOM_REFRESH") == "0":
        config = config.replace(geom_refresh=False)
    t_setup = time.time()
    state = _state(config, n, uniform)
    sim = Simulator(config, n, engine=engine)
    state = sim.init_acc(state)
    # two warm-up calls: the first compiles for init_acc-layout inputs,
    # the second for scan-output-layout inputs (the steady state)
    state = sim.run(state, 2)
    state = sim.run(state, 2)
    jax.block_until_ready(state.pos)
    # min over repeats
    dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        state = sim.run(state, steps)
        jax.block_until_ready(state.pos)
        dt = min(dt, (time.time() - t0) / steps)
    row = {
        "config": tag, "engine": engine, "n": n,
        "sec_per_step": round(dt, 5),
        "particle_steps_per_s": round(n / dt, 1),
        "integrator": config.integrator,
        "p": config.fmm_order, "r": config.tree_radius,
        "setup_s": round(time.time() - t_setup, 1),
    }
    print(json.dumps(row), flush=True)
    ROWS.append(row)
    _write_artifact()


ROWS = []
ARTIFACT = os.path.join("out", "ladder.json")


def _write_artifact():
    """Rewrite the ladder artifact after every config so a crashed or
    timed-out run still leaves the completed rows on disk."""
    os.makedirs(os.path.dirname(ARTIFACT), exist_ok=True)
    with open(ARTIFACT, "w") as f:
        json.dump({
            "note": "BASELINE.json config ladder (scripts/ladder.py); "
                    "sec_per_step is min over 2 timed repeats after "
                    "warm-up",
            "device": _device_kind(),
            "rows": ROWS,
        }, f, indent=1)


def _device_kind():
    try:
        return jax.devices()[0].device_kind
    except Exception:
        return "unknown"


def main():
    from coulomb_oscillators import SimConfig

    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4]
    if 1 in which:
        _run("1_direct_N4096", SimConfig(), 4096, "direct", steps=500)
    if 2 in which:
        cfg = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                        tree_radius=2.0)
        _run("2_fmm2d_N100k_p4", cfg, 100_000, "fmm2_kd")
    if 3 in which:
        # 3a: production kd engine on the gaussian beam
        cfg = SimConfig(fmm_order=3, tree_radius=1.7)
        _run("3a_kd_N1M_beam", cfg, 1_000_000, "fmm3_kd")
        # 3b: literal traceless-multipole octree on a uniform box
        try:
            cfg = SimConfig(fmm_order=3)
            _run("3b_octree_traceless_N1M_uniform", cfg, 1_000_000,
                 "fmm3_traceless", steps=6, uniform=True)
        except Exception as ex:  # octree needs quasi-uniform occupancy
            row = {"config": "3b_octree_traceless_N1M_uniform",
                   "error": repr(ex)[:200]}
            print(json.dumps(row), flush=True)
            ROWS.append(row)
            _write_artifact()
    if 4 in which:
        cfg = SimConfig(fmm_order=8, tree_radius=2.0, integrator="forestruth")
        _run("4_p8_forestruth_N100k", cfg, 100_000, "fmm3_kd")
    if 5 in which:
        cfg = SimConfig(fmm_order=3, tree_radius=1.7, tree_steps=1)
        _run("5_kd_N10M_rebuild_every_step", cfg, 10_000_000, "fmm3_kd",
             steps=3)


if __name__ == "__main__":
    main()
