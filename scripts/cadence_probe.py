"""Production rebuild-cadence probe: tree_steps x tree_resort_every x
tree_pipeline at the tuned headline config.

With a FULL re-sort submitted every boundary (K=1) the background job
(position fetch + host kd + traversal) can exceed the scan window, and
the device then stalls at the boundary.  Knobs already in the engine:

  * tree_steps (ts): window length — longer windows hide more rebuild,
    cost window-end staleness error,
  * tree_resort_every (K): FULL re-sorts every K boundaries with cheap
    exact-bounds refreshes between (refresh fetches 1.2 MB of on-device
    leaf stats instead of 12 MB of positions),
  * tree_pipeline (D): boundaries between a full job's position snapshot
    and its adoption.

For each combo: median s/step over `windows` timed windows, plus the force
error at the END of the last window (maximally stale tree) against a fresh
2048-target Kahan oracle.  Rows go to out/cadence.json (gitignored).

Usage: python scripts/cadence_probe.py [n] [p] [r] [boost]
       (combos hard-coded below; edit COMBOS to taste)
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, ".")

from coulomb_oscillators.utils.cache import enable_compile_cache
enable_compile_cache()

COMBOS = [
    # (tree_steps, resort_every, pipeline[, geom_refresh, builder])
    # builder: "host" = native kd quickselect (build_host_padded),
    #          "kd_device" = exact equal-count kd on device (2-key
    #          lax.sort/level, _build_device) + host traversal on fetched
    #          bounds,
    #          "morton" = device Morton (loose leaves on beams)
    (16, 2, 2, 1, "host"),    # shipped cadence + in-scan geometry refresh
    (16, 2, 2, 0, "host"),    # shipped cadence, no geometry refresh
    (16, 1, 2, 1, "kd_device"),
    (8, 1, 2, 1, "kd_device"),
    (8, 1, 1, 1, "kd_device"),
]
# env override, e.g. CO_CADENCE_COMBOS="8,4,2,1,host;16,4,2,0,kd_device"
if os.environ.get("CO_CADENCE_COMBOS"):
    def _parse(c):
        v = c.split(",")
        return (int(v[0]), int(v[1]), int(v[2]),
                int(v[3]) if len(v) > 3 else 1,
                v[4] if len(v) > 4 else "host")
    COMBOS = [_parse(c) for c in os.environ["CO_CADENCE_COMBOS"].split(";")]
COMBOS = [c if len(c) == 5 else (*c, 1, "host") for c in COMBOS]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    p = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    r = float(sys.argv[3]) if len(sys.argv) > 3 else 1.43
    boost = float(sys.argv[4]) if len(sys.argv) > 4 else 1.5
    os.environ["CO_SUB_BOOST"] = str(boost)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from coulomb_oscillators import SimConfig, ParticleState
    from coulomb_oscillators.models import init_dist as ID
    from coulomb_oscillators.ops import direct as D
    from coulomb_oscillators.ops.reductions import mean_rel_err
    from coulomb_oscillators.simulate import Simulator

    cfg0 = SimConfig()
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(cfg0.omega0, x))
    pos, vel = ID.init_gaussian(n, x, u, dtype=np.float32)
    state0 = ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.zeros((n, 3), jnp.float32))
    sub = jnp.asarray(np.random.default_rng(0).choice(n, 2048,
                                                      replace=False))

    rows = []
    for ts, K, Dp, geo, builder in COMBOS:
        os.environ["CO_SORT_MODE"] = (
            "kd_device" if builder == "kd_device" else "auto")
        cfg = cfg0.replace(fmm_order=p, tree_radius=r, tree_steps=ts,
                           tree_resort_every=K, tree_pipeline=Dp,
                           geom_refresh=bool(geo),
                           tree_async_build=(
                               "device" if builder != "host" else "host"))
        sim = Simulator(cfg, n, engine="fmm3_kd")
        st = sim.init_acc(state0)
        st = sim.run(st, 2)
        st = sim.run(st, 2)
        # cross enough boundaries to absorb cap growth recompiles
        for _ in range(3):
            sim.advance_padded(2 * ts)
            jax.block_until_ready(sim._padded.pos)
        times = []
        for w in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(sim.advance_padded(2 * ts))
            times.append((time.perf_counter() - t0) / (2 * ts))
            print(f"  ts={ts} K={K} D={Dp} window {w}: {times[-1]:.4f} "
                  f"s/step rebuild_wait="
                  f"{getattr(sim, 'last_rebuild_wait', -1):.3f}", flush=True)
        med = statistics.median(times)
        # window-end stale force error — measure the force the production
        # scan actually computes (geometry refreshed when geo is on)
        cur = sim.current_state()
        fs = sim._fstate
        if geo and hasattr(sim._fmm, "refresh_geometry_device"):
            fs = sim._fmm.refresh_geometry_device(
                sim._fmm._pad_jit(cur.pos, fs), fs)
        acc = sim._fmm.force(cur.pos, fs)
        ref = D.direct_kahan_targets(cur.pos[sub], cur.pos, cfg.eps2,
                                     cfg.kappa(n))
        err = float(mean_rel_err(acc[sub], ref))
        row = {"ts": ts, "resort_every": K, "pipeline": Dp, "geom": geo,
               "builder": builder, "median_s_per_step": round(med, 4),
               "psteps_per_s": round(n / med, 0),
               "stale_err": err, "times": [round(t, 4) for t in times]}
        rows.append(row)
        print("@@ " + json.dumps(row), flush=True)
        os.makedirs("out", exist_ok=True)
        with open("out/cadence.json", "w") as f:
            json.dump({"config": {"n": n, "p": p, "r": r, "boost": boost,
                                  "stale_margin":
                                      os.environ.get("CO_STALE_MARGIN")},
                       "rows": rows}, f, indent=1)
    print("wrote out/cadence.json", flush=True)


if __name__ == "__main__":
    main()
