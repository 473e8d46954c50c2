"""Stage-level profiling of the kd-FMM force eval + tree build at scale.

Times (host clock around completed, chained calls):
  * the full force eval,
  * the gather-only path (perm -> pad -> unpad -> inv_perm),
  * each pipeline stage in isolation (P2M+M2M, M2L, L2L+L2P, P2P),
and prints the host-side build breakdown (kd sort / traversal / list prep /
upload).

    python scripts/profile_force.py [N] [p] [r]
    python scripts/profile_force.py artifact [N] [p] [r]   # also write
        out/breakdown.json (per-stage record)
    python scripts/profile_force.py trace [N] [p] [r]      # XLA trace of
        the padded force program + per-op histogram (the isolated-stage
        wall timings above carry per-call dispatch overhead; the trace is
        the ground truth for where the fused program's time goes)
    python scripts/profile_force.py prodtrace [N] [p] [r]  # trace of one
        production reuse window -> out/prodtrace.json

Traces are written under out/ (gitignored).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coulomb_oscillators.utils.cache import enable_compile_cache
enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators import SimConfig
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.ops.fmm import KdFmmEngine
from coulomb_oscillators.utils.timing import test_time_chained


def prod_trace(argv):
    """XLA-trace one full production reuse window: device ms/step measured
    INSIDE a production window, not in isolated per-call rows that carry
    dispatch overhead.  Runs the Simulator at the tuned cadence, primes
    the pipeline, traces one tree_steps-long advance_padded, and writes the
    per-step device op histogram to out/prodtrace.json."""
    import json
    import os

    from coulomb_oscillators import ParticleState
    from coulomb_oscillators.simulate import Simulator
    from coulomb_oscillators.utils import profiling as prof

    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    p = int(argv[1]) if len(argv) > 1 else 6
    r = float(argv[2]) if len(argv) > 2 else 1.43
    ts = int(os.environ.get("CO_TS", "16"))
    K = int(os.environ.get("CO_RESORT", "2"))
    Dp = int(os.environ.get("CO_PIPE", "2"))
    cfg = SimConfig(fmm_order=p, tree_radius=r, tree_steps=ts,
                    tree_resort_every=K, tree_pipeline=Dp)
    x0 = (0.003, 0.001, 0.01)
    u0 = tuple(w * xs for w, xs in zip(cfg.omega0, x0))
    pos_h, vel_h = ID.init_gaussian(n, x0, u0)
    sim = Simulator(cfg, n, engine="fmm3_kd")
    st = sim.init_acc(ParticleState(jnp.asarray(pos_h), jnp.asarray(vel_h),
                                    jnp.zeros((n, 3), jnp.float32)))
    st = sim.run(st, 2)
    st = sim.run(st, 2)
    for _ in range(3):
        sim.advance_padded(2 * ts)
        jax.block_until_ready(sim._padded.pos)
    logdir = f"out/xtrace_prod_n{n}_p{p}"
    t0 = time.perf_counter()
    with prof.trace(logdir):
        jax.block_until_ready(sim.advance_padded(ts))
    wall = time.perf_counter() - t0
    hist = prof.op_histogram(logdir, top=40)
    tot = sum(hist.values())
    print(f"\n--- production window trace: {ts} steps, wall "
          f"{wall:.3f}s ({wall / ts:.4f} s/step), device "
          f"{tot / 1e3:.3f}s ({tot / ts:.1f} ms/step) ---")
    for name, ms in hist.items():
        print(f"{ms / ts:9.2f}  {100 * ms / max(tot, 1e-9):5.1f}%  "
              f"{name[:100]}")
    out = {"config": {"n": n, "p": p, "r": r, "ts": ts, "resort_every": K,
                      "pipeline": Dp,
                      "stale_margin": np.asarray(
                          getattr(sim._fmm, "stale_margin_abs", 0.0)
                      ).tolist()},
           "window_wall_s": round(wall, 3),
           "wall_ms_per_step": round(wall / ts * 1e3, 1),
           "device_ms_per_step": round(tot / ts, 1),
           "top_ops_ms_per_step": {k: round(v / ts, 2)
                                   for k, v in hist.items()}}
    with open("out/prodtrace.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote out/prodtrace.json")


def main():
    argv = sys.argv[1:]
    artifact = bool(argv) and argv[0] == "artifact"
    tracemode = bool(argv) and argv[0] == "trace"
    prodtrace = bool(argv) and argv[0] == "prodtrace"
    if artifact or tracemode or prodtrace:
        argv = argv[1:]
    if prodtrace:
        return prod_trace(argv)
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    p = int(argv[1]) if len(argv) > 1 else 3
    r = float(argv[2]) if len(argv) > 2 else 1.7
    record = {}
    cfg = SimConfig(fmm_order=p, tree_radius=r)
    x0 = (0.003, 0.001, 0.01)
    u0 = tuple(w * xs for w, xs in zip(cfg.omega0, x0))
    pos_h, _ = ID.init_gaussian(n, x0, u0)
    pos = jnp.asarray(pos_h)

    eng = KdFmmEngine(cfg, n)
    print(f"n={n} p={p} r={r} L={eng.L} C={eng.st.C} G={1 << eng.L} "
          f"backend={jax.default_backend()}")

    t0 = time.perf_counter()
    fs = eng.build(pos)
    print(f"build total {time.perf_counter() - t0:.3f}s  "
          f"breakdown={ {k: round(v, 3) for k, v in eng.last_build_times.items()} }")
    print(f"counts={eng.last_counts} caps={eng.caps}")

    st = eng.st
    G = 1 << eng.L
    C = st.C
    dim = eng.dim

    # --- full force, chained on pos (scale output back into a position) ---
    def full(x):
        a = eng._force_jit(x, fs)
        return x + a * 1e-30
    t = test_time_chained(full, pos, min_loop=3.0)
    record["force_full_ms"] = round(t * 1e3, 2)
    print(f"force full       : {t * 1e3:8.2f} ms")

    # --- padded production step (what the inter-rebuild scan runs) ---
    pad_mask0 = jnp.asarray(st.pad_mask)
    pos_s0 = jnp.take(pos, fs.perm, axis=0)
    ppad_prod = jnp.where(
        pad_mask0[:, None],
        jnp.take(pos_s0, jnp.asarray(st.pad_gather), axis=0),
        jnp.float32(1e18)).reshape(G, C, dim)

    # chain through the engine's ALREADY-COMPILED padded program (a fresh
    # wrapper jit would recompile the whole force); the eager add still
    # creates the data dependency
    def fpad(x):
        a = eng._padded_force_jit(x, fs)
        return x + a * 1e-30
    t = test_time_chained(fpad, ppad_prod, min_loop=3.0)
    record["force_padded_ms"] = round(t * 1e3, 2)
    print(f"force padded     : {t * 1e3:8.2f} ms "
          f"({n / t / 1e6:.2f}M psteps/s equiv)")

    if tracemode:
        from coulomb_oscillators.utils import profiling as prof
        logdir = f"out/xtrace_n{n}_p{p}"
        x = ppad_prod
        with prof.trace(logdir):
            for _ in range(3):
                x = fpad(x)
            jax.block_until_ready(x)
        hist = prof.op_histogram(logdir, top=40)
        tot = sum(hist.values())
        print(f"\n--- device op histogram (3 padded force calls, ms) ---")
        for name, ms in hist.items():
            print(f"{ms / 3:9.2f}  {100 * ms / max(tot, 1e-9):5.1f}%  "
                  f"{name[:100]}")
        return

    # --- gathers only ---
    @jax.jit
    def gathers(x):
        pos_s = jnp.take(x, fs.perm, axis=0)
        flat = jnp.take(pos_s, jnp.asarray(st.pad_gather), axis=0)
        acc_s = jnp.take(flat, jnp.asarray(st.unpad_gather), axis=0)
        out = jnp.take(acc_s, fs.inv_perm, axis=0)
        return x + out * 1e-30
    t = test_time_chained(gathers, pos, min_loop=2.0)
    record["gathers_ms"] = round(t * 1e3, 2)
    print(f"4 gathers only   : {t * 1e3:8.2f} ms")

    # --- stage isolation on padded blocks ---
    pad_mask = jnp.asarray(st.pad_mask)
    pos_s = jnp.take(pos, fs.perm, axis=0)
    flat = jnp.where(pad_mask[:, None],
                     jnp.take(pos_s, jnp.asarray(st.pad_gather), axis=0),
                     jnp.float32(1e18))
    ppad0 = flat.reshape(G, C, dim)
    mask3 = pad_mask.reshape(G, C)

    # Every stage jit takes fs (and any other big array) as an ARGUMENT:
    # a closed-over FmmState bakes fs.m2l_h2 (~1 GB at N=1M) into the
    # program as a literal, which the remote-compile endpoint cannot digest
    # (pitfall: captured-constant jit artifacts)
    mpoles_j = jax.jit(lambda ppad, m3, s: eng._stage_multipoles(ppad, m3, s))

    def mpoles(ppad):
        h = mpoles_j(ppad, mask3, fs)
        return ppad + jnp.mean(h) * 1e-30
    t = test_time_chained(mpoles, ppad0, min_loop=2.0)
    record["p2m_m2m_ms"] = round(t * 1e3, 2)
    print(f"P2M+M2M          : {t * 1e3:8.2f} ms")

    mh = mpoles_j(ppad0, mask3, fs)

    m2l_j = jax.jit(lambda h, s: eng._stage_m2l(h, s))

    def m2l(h):
        lh = m2l_j(h, fs)
        return h + jnp.mean(lh) * 1e-30
    t = test_time_chained(m2l, mh, min_loop=2.0)
    record["m2l_ms"] = round(t * 1e3, 2)
    print(f"M2L              : {t * 1e3:8.2f} ms")

    lh0 = m2l_j(mh, fs)

    local_j = jax.jit(
        lambda ppad, m3, lh, s: eng._stage_local(ppad, m3, lh, s))

    def local(ppad):
        f = local_j(ppad, mask3, lh0, fs)
        return ppad + f * 1e-30
    t = test_time_chained(local, ppad0, min_loop=2.0)
    record["l2l_l2p_ms"] = round(t * 1e3, 2)
    print(f"L2L+L2P          : {t * 1e3:8.2f} ms")

    p2p_j = jax.jit(lambda ppad, s: eng._stage_p2p(ppad, s))

    def p2p(ppad):
        f = p2p_j(ppad, fs)
        return ppad + f.reshape(ppad.shape) * 1e-30
    t = test_time_chained(p2p, ppad0, min_loop=3.0)
    # tile lane-interactions: each (sub-leaf, block) tile is C x C_blk
    q = int(np.sum(np.asarray(fs.p2p_valid)))
    gint = q * C * eng.C_blk / t / 1e9
    kind = "kernel" if eng.use_pallas else "jnp scan"
    record["p2p_ms"] = round(t * 1e3, 2)
    record["p2p_kind"] = kind
    record["p2p_tiles"] = q
    record["p2p_G_lane_int_per_s"] = round(gint, 1)
    print(f"P2P ({kind:8s}) : {t * 1e3:8.2f} ms   "
          f"({q} tiles, {gint:.1f} G lane-int/s)")

    # --- rebuild, repeated (steady-state cost) ---
    for _ in range(2):
        t0 = time.perf_counter()
        fs = eng.build(pos)
        tt = time.perf_counter() - t0
    print(f"rebuild steady   : {tt * 1e3:8.2f} ms  "
          f"breakdown={ {k: round(v * 1e3, 1) for k, v in eng.last_build_times.items()} } (ms)")

    if artifact:
        import json
        out = {
            "metric": "force_eval_stage_breakdown",
            "config": {"n": n, "p": p, "r": r, "L": eng.L, "C": st.C,
                       "device": jax.devices()[0].device_kind},
            "stages_ms": record,
            "rebuild_steady_ms": round(tt * 1e3, 1),
            "rebuild_breakdown_ms": {k: round(v * 1e3, 1)
                                     for k, v in eng.last_build_times.items()},
            "note": "stage jits isolated (P2M+M2M / M2L / L2L+L2P / P2P); "
                    "sums can exceed force_padded_ms because XLA fuses "
                    "stages in the production program",
        }
        os.makedirs("out", exist_ok=True)
        with open("out/breakdown.json", "w") as f:
            json.dump(out, f, indent=1)
        print("wrote out/breakdown.json")


if __name__ == "__main__":
    main()
