"""North-star metric: relative energy drift over 10k leapfrog steps
(BASELINE.md: target <= 1e-6).

The Hamiltonian is measured on host in float64 (ops/energy.py
total_energy_f64): an f32 accumulator's own noise (~1e-7 scale) cannot
certify a 1e-6 bound.  For n > 200k the O(N^2) f64 host sum is impractical
and the O(N) FMM potential is used instead (diagnostic-grade).

Usage: python scripts/energy_drift.py [n] [steps] [engine] [p] [r] [dt]
       python scripts/energy_drift.py sweep          # config sweep
"""

import os
import sys
import time

sys.path.insert(0, ".")

from coulomb_oscillators.utils.cache import enable_compile_cache
enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp


def run_one(n, steps, engine, p_order, radius, dt=5e-4, block=1000,
            integrator="leapfrog", quiet=False, **config_kw):
    from coulomb_oscillators import SimConfig, ParticleState
    from coulomb_oscillators.models import init_dist as ID
    from coulomb_oscillators.models import oscillator as M
    from coulomb_oscillators.ops import energy as E
    from coulomb_oscillators.simulate import Simulator

    config = SimConfig(fmm_order=p_order, tree_radius=radius, dt=dt,
                       integrator=integrator, **config_kw)
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(config.omega0, x))
    pos, vel = ID.init_gaussian(n, x, u, dtype=np.float32)
    state = ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                          jnp.zeros((n, 3), jnp.float32))

    sim = Simulator(config, n, engine=engine)
    state = sim.init_acc(state)

    kappa = config.kappa(n)
    om2 = config.omega0_sq()

    def energy(st):
        if n > 200_000 and sim._fmm is not None:
            return float(M.total_energy_fmm(config, st, sim._fmm,
                                            sim._fmm.build(st.pos)))
        return E.total_energy_kahan(st.pos, st.vel, config.eps2, kappa, om2)

    e0 = energy(state)
    if not quiet:
        print(f"n={n} engine={engine} p={p_order} r={radius} dt={dt} "
              f"integ={integrator} E0={e0:.12e}", flush=True)

    t0 = time.time()
    done = 0
    drift = 0.0
    max_drift = 0.0
    while done < steps:
        k = min(block, steps - done)
        state = sim.run(state, k)
        done += k
        e = energy(state)
        drift = abs(e - e0) / abs(e0)
        max_drift = max(max_drift, drift)
        if not quiet:
            wall = time.time() - t0
            print(f"step {done:6d}  E={e:.12e}  drift={drift:.3e}  "
                  f"({done * n / wall / 1e6:.2f} M psteps/s)", flush=True)

    wall = time.time() - t0
    psteps = steps * n / wall / 1e6
    print(f"RESULT n={n} engine={engine} p={p_order} r={radius} dt={dt} "
          f"integ={integrator}: final_drift={drift:.3e} "
          f"max_drift={max_drift:.3e} ({psteps:.2f} M psteps/s)", flush=True)
    return drift, max_drift, psteps


def sweep(steps=10_000):
    """The decisive drift ladder (north star: <=1e-6 @10k steps).

    Round-2 finding: at the reference default dt=5e-4 drift is dominated by
    unresolved close encounters (eps=1e-9 is effectively unsoftened) — the
    exact-force rows drift as badly as any FMM config.  Once dt resolves
    encounters (2e-5), the production engine holds 4e-8.
    """
    n = 30001
    configs = [
        ("direct", 3, 2.0, 5e-4, "leapfrog"),   # exact forces, default dt
        ("fmm3_kd", 4, 2.0, 5e-4, "leapfrog"),  # engine accuracy irrelevant
        ("direct", 3, 2.0, 2e-5, "leapfrog"),   # exact forces, resolved dt
        ("fmm3_kd", 6, 2.5, 2e-5, "leapfrog"),  # north-star config: 4e-8
    ]
    for engine, p, r, dt, integ in configs:
        run_one(n, steps, engine, p, r, dt, integrator=integ, quiet=True)


def emit_artifact(path="out/energy.json", steps=10_000):
    """Driver-checkable north-star artifact: N=30001, p=6, r=2.5, dt=2e-5,
    leapfrog, f64-certified Hamiltonian.

    The config carries accuracy=1e-6, which makes the kd engine stiffen its
    sub-leaf MAC automatically (boost 2.0 — the block-granularity error
    plateau; the throughput-tuned 1.5 default costs ~4% more force error,
    enough to push the drift past 1e-6).  If the bound still fails, fall
    back to block-granularity geometry outright (sub-leaf MAC off via
    mac_sub_boost pinned huge)."""
    import json
    n, p, r, dt = 30001, 6, 2.5, 2e-5
    ladder = [
        {"accuracy": 1e-6},                       # auto-stiffened boost=2.0
        {"accuracy": 1e-6, "mac_sub_boost": 4.0},  # ~block-granularity MAC
    ]
    for i, kw in enumerate(ladder):
        drift, max_drift, psteps = run_one(n, steps, "fmm3_kd", p, r, dt,
                                           quiet=True, **kw)
        if max_drift <= 1e-6 or i == len(ladder) - 1:
            break
        print(f"drift {max_drift:.3e} > 1e-6 at {kw}; stiffening",
              flush=True)
    out = {
        "metric": "rel_energy_drift",
        "value": drift,
        "max_drift": max_drift,
        "steps": steps,
        "config": {"n": n, "engine": "fmm3_kd", "p": p, "r": r, "dt": dt,
                   "integrator": "leapfrog", **kw},
        "measurement": "ops/energy.py total_energy_kahan (device Kahan rows"
                       " + f64 host reduce, ~2e-10 accurate)",
        "note": "north star <=1e-6 @10k steps; at the reference default "
                "dt=5e-4 drift is encounter-dominated for ANY engine "
                "(see README drift ladder)",
        "psteps_per_s": psteps * 1e6,
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


def midscale(path="out/energy_midscale.json", steps=2000):
    """Mid-scale regression twin of the north star: n=16384 at the REAL
    rebuild cadence (tree_steps=8 -> 250 rebuilds over 2000 steps) and
    realistic leaf geometry, unlike the CPU CI twin (n=2048,
    tree_steps=64).  The bound is the full north-star 1e-6."""
    import json
    n, p, r, dt = 16384, 6, 2.5, 2e-5
    drift, max_drift, psteps = run_one(n, steps, "fmm3_kd", p, r, dt,
                                       quiet=True, accuracy=1e-6,
                                       tree_steps=8)
    out = {
        "metric": "rel_energy_drift_midscale",
        "value": drift, "max_drift": max_drift, "steps": steps,
        "bound": 1e-6, "pass": bool(max_drift <= 1e-6),
        "config": {"n": n, "engine": "fmm3_kd", "p": p, "r": r, "dt": dt,
                   "tree_steps": 8, "accuracy": 1e-6,
                   "integrator": "leapfrog"},
        "psteps_per_s": psteps * 1e6,
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out["pass"]


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "midscale":
        ok = midscale(steps=int(sys.argv[2]) if len(sys.argv) > 2 else 2000)
        sys.exit(0 if ok else 1)
    if len(sys.argv) > 1 and sys.argv[1] == "sweep":
        sweep(int(sys.argv[2]) if len(sys.argv) > 2 else 10_000)
        return
    if len(sys.argv) > 1 and sys.argv[1] == "artifact":
        emit_artifact(steps=int(sys.argv[2]) if len(sys.argv) > 2
                      else 10_000)
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30001
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    engine = sys.argv[3] if len(sys.argv) > 3 else "fmm3_kd"
    p_order = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    radius = float(sys.argv[5]) if len(sys.argv) > 5 else 2.0
    dt = float(sys.argv[6]) if len(sys.argv) > 6 else 5e-4
    run_one(n, steps, engine, p_order, radius, dt)


if __name__ == "__main__":
    main()
