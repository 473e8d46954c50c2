"""Benchmark: prints ONE JSON line with the flagship metric.

Headline (BASELINE.json): N=1M 3D kd-tree FMM particle-steps/s on one chip,
tree rebuilt every `tree_steps` steps (reference temporal amortization,
fmm_cart3_kdtree.cuh:1619-1642), leapfrog stepping — at matched accuracy
(mean relative force error vs the Kahan-targets direct oracle <= 1e-3, the
reference default bound, main3.cu:236-237).

Structure:

  1. The shipped configuration (TUNED below) is error-probed and
     production-timed first, so a complete headline exists early.
  2. Everything after that is refinement under an explicit wall-clock
     budget (env CO_BENCH_BUDGET_S, default 2400 s): a short list of
     candidate configs near the tuned one is error/cost-probed, and only a
     candidate that beats the tuned production cost gets a real production
     timing.
  3. Every phase runs in its OWN subprocess with a hard timeout, and the
     parent never initializes a JAX backend, so exactly one process holds
     the card at a time.  A child that dies is retried once, then skipped.
  4. The Kahan-oracle forces for the 2048-target subsample are computed
     once per run directory and cached on disk (.bench_oracle_n*.npz,
     gitignored): children load ~24 KB instead of re-running the
     O(2048 x N) oracle per phase.

The full reference autotune grid (p in 1..6 x r in {1.11..3},
main3.cu:739-741) remains available: `python bench.py fullgrid` (manual,
unbudgeted) — the driver path no longer depends on it finishing.

Reproducibility: production timing is median of 7
16-step windows with per-window times in `extra`; warmups cross enough
rebuild boundaries that pair-list cap growth (a scan recompile) never
lands inside a timed window.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

ERR_BOUND = 1e-3           # reference default (main3.cu:236-237)
N_HEAD = 1_000_000
SEARCH_P = [1, 2, 3, 4, 5, 6]
SEARCH_R = [1.11, 1.25, 1.43, 1.67, 2.0, 2.5, 3.0]
# third grid axis (no reference analogue): the sub-block MAC
# acceptance-radius boost.  Lower boost = looser sub-leaf MAC = much less
# near-field work but more error (err falls ~boost^(p+1)); descending from
# the accuracy-safe default stops at the first over-bound value.
SEARCH_BOOST = [1.5, 1.3, 1.15, 1.0]

# shipped configuration at N=1M: expansion order, MAC radius, sub-leaf
# MAC boost, and the production rebuild cadence (scripts/cadence_probe.py):
# window length, FULL re-sorts every K boundaries (exact geometry
# refreshes between), adoption pipeline depth
TUNED = {"p": 6, "r": 1.43, "boost": 1.5,
         "tree_steps": 16, "resort_every": 2, "pipeline": 2}
# refinement candidates probed after the tuned headline exists, in order
REFINE = [
    {"p": 6, "r": 1.67, "boost": 1.5},
    {"p": 5, "r": 1.43, "boost": 1.5},
    {"p": 6, "r": 1.67, "boost": 1.3},
    {"p": 5, "r": 2.0, "boost": 1.5},
    {"p": 4, "r": 2.0, "boost": 1.3},
]


def _budget_s() -> float:
    return float(os.environ.get("CO_BENCH_BUDGET_S", "2400"))


def _oracle_path(n: int) -> str:
    return os.path.join(REPO, f".bench_oracle_n{n}.npz")


def _init_host(n):
    """Deterministic initial (pos, vel) on HOST (numpy) — children keep the
    host copy so no phase needs to fetch positions back off the device."""
    import numpy as np
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.models import init_dist as ID

    config = SimConfig()
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(config.omega0, x))
    pos, vel = ID.init_gaussian(n, x, u, dtype=np.float32)
    return pos, vel


def _init_state(n):
    import jax.numpy as jnp
    from coulomb_oscillators import ParticleState
    pos, vel = _init_host(n)
    return ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.zeros((n, 3), jnp.float32))


def _load_oracle(n):
    """(sub_idx, acc_ref) from the disk cache, or None."""
    import numpy as np
    path = _oracle_path(n)
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        if int(z["n"]) != n:
            return None
        return z["sub"], z["acc_ref"]
    except Exception:
        return None


# --------------------------------------------------------------------------
# child: compute + cache the subsampled Kahan oracle
# --------------------------------------------------------------------------

def oracle(n=N_HEAD):
    import numpy as np
    import jax

    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.ops import direct as D

    if _load_oracle(n) is not None:
        print("@@ " + json.dumps({"oracle": "cached"}), flush=True)
        return
    base = SimConfig()
    pos_h, _ = _init_host(n)
    sub = np.random.default_rng(0).choice(n, 2048, replace=False)
    import jax.numpy as jnp
    pos_sub_d = jnp.asarray(pos_h[sub])
    acc_ref = D.direct_kahan_targets(pos_sub_d,
                                     jnp.asarray(pos_h),
                                     base.eps2, base.kappa(n))
    acc_h = np.asarray(jax.block_until_ready(acc_ref))
    np.savez(_oracle_path(n), n=n, sub=sub, acc_ref=acc_h)
    print("@@ " + json.dumps({"oracle": "computed"}), flush=True)


def _bench_margin(vel_h, base):
    """Auto per-axis stale margin at the shipped production cadence (the
    cadence is env-published by _cadence_env; an explicit CO_STALE_MARGIN
    env still overrides at traversal time)."""
    from coulomb_oscillators.simulate import auto_stale_margin

    cfg = base.replace(
        tree_steps=int(os.environ.get("CO_BENCH_TS", "8")),
        tree_resort_every=int(os.environ.get("CO_BENCH_RESORT", "1")),
        tree_pipeline=int(os.environ.get("CO_BENCH_PIPE", "2")))
    return auto_stale_margin(vel_h, cfg)


# --------------------------------------------------------------------------
# child: error + cost probe of ONE config (cheap; no production scan)
# --------------------------------------------------------------------------

def probe(p, r, boost, n=N_HEAD):
    """Error vs the cached oracle + isolated padded-force / rebuild cost of
    one (p, r, boost) config.  Prints one @@ row; exit 3 when over-bound."""
    import time as _time
    import numpy as np
    import jax
    import jax.numpy as jnp

    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.ops.fmm import KdFmmEngine
    from coulomb_oscillators.ops.reductions import mean_rel_err
    from coulomb_oscillators.utils.timing import test_time_chained
    from coulomb_oscillators import native as conative

    ora = _load_oracle(n)
    if ora is None:
        print("@@ " + json.dumps({"error": "no oracle cache"}), flush=True)
        sys.exit(4)
    sub, acc_ref_h = ora
    acc_ref = jnp.asarray(acc_ref_h)

    base = SimConfig()
    pos_h, vel_h = _init_host(n)
    pos_d = jnp.asarray(pos_h)

    os.environ["CO_SUB_BOOST"] = str(boost)
    eng = KdFmmEngine(base.replace(fmm_order=p, tree_radius=r), n)
    eng.mac_sub_boost = boost if eng.sub_depth else 1.0
    # same traversal-time stale margin the production Simulator applies
    # (auto per-axis slack at the shipped cadence): the probe's pair
    # lists, error, and force cost then match what final_timing runs, so
    # scores and the published interaction counts are consistent
    eng.stale_margin_abs = _bench_margin(vel_h, base)
    # host-side build ingredients (native kd + geometry), reused for the
    # rebuild timing below
    perm = conative.kdtree_build(pos_h, eng.L)
    pos_s = pos_h[perm]
    c_h, lb_h, rb_h, lam_h = conative.node_geometry(pos_s, eng.L)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)

    t0 = _time.perf_counter()
    m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
    t_trav = _time.perf_counter() - t0
    fs = eng._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p, {})
    err = float(mean_rel_err(eng.force(pos_d, fs)[jnp.asarray(sub)],
                             acc_ref))
    row = {"p": p, "r": r, "boost": boost, "err": err}
    # interaction counts per force eval (BASELINE.md Ginteractions/s
    # metric): physical P2P particle pairs (sum mult_t*mult_s over the
    # directed near list, sub-leaf masks unpacked), padded lane pairs the
    # device actually runs, and directed M2L translations
    from coulomb_oscillators.ops.fmm.kdtree import _heap_off
    Ls, S = eng.L, eng.sub_depth
    mult_leaf = eng.st.mult[_heap_off(Ls):].astype(np.int64)
    # near rows: [tgt sub-leaf id, src block | sub-leaf mask << shift]
    tb = p2p[:, 0].astype(np.int64)
    pk = p2p[:, 1].astype(np.int64) & 0xFFFFFFFF   # unsigned view
    sb = pk & ((1 << eng.mask_shift) - 1)
    mask = pk >> eng.mask_shift
    src_m = np.zeros(p2p.shape[0], dtype=np.int64)
    for k in range(1 << S):
        src_m += ((mask >> k) & 1) * mult_leaf[(sb << S) + k]
    row["p2p_phys_int"] = int(np.sum(mult_leaf[tb] * src_m))
    row["p2p_lane_int"] = int(np.sum(np.asarray(fs.p2p_valid))
                              * eng.st.C * eng.C_blk)
    row["m2l_entries"] = int(m2l.shape[0])
    if err >= ERR_BOUND:
        print("@@ " + json.dumps(row), flush=True)
        sys.exit(3)

    # padded force timing (the program the production scan dispatches)
    ppad = eng._pad_jit(pos_d, fs)

    def fpad(x, eng=eng, fs=fs):
        return x + eng._padded_force_jit(x, fs) * 1e-30

    row["force_s"] = round(test_time_chained(fpad, ppad, min_loop=1.5), 4)
    # steady-state rebuild cost: seeded re-traversal + list prep + upload
    jax.block_until_ready(fs.m2l_tgt)
    t0 = _time.perf_counter()
    m2l2, p2p2 = eng._traverse(c_h, lb_h, rb_h)
    fs2 = eng._lists_to_state(perm, inv, c_h, lam_h, m2l2, p2p2, {})
    jax.block_until_ready(fs2.m2l_tgt)
    row["rebuild_s"] = round(_time.perf_counter() - t0, 4)
    row["first_traverse_s"] = round(t_trav, 4)
    print("@@ " + json.dumps(row), flush=True)


# --------------------------------------------------------------------------
# child phase: grid sweep for ONE expansion order (fullgrid mode)
# --------------------------------------------------------------------------

def grid_for_p(p, n=N_HEAD, r_skip=0):
    """Sweep radii DESCENDING at fixed p; print one `@@ {...}` row per
    config.  Error is monotone decreasing in r at fixed p, so the descent
    stops once the error clears the bound.

    On device-memory exhaustion the child EXITS (code 17) after printing
    the oom row; the parent respawns the sweep at the next smaller
    radius in a fresh process."""
    import gc
    import time as _time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.ops.fmm import KdFmmEngine
    from coulomb_oscillators.ops.reductions import mean_rel_err
    from coulomb_oscillators.utils.timing import test_time_chained
    from coulomb_oscillators import native as conative

    ora = _load_oracle(n)
    if ora is None:
        print("@@ " + json.dumps({"error": "no oracle cache"}), flush=True)
        sys.exit(4)
    sub, acc_ref_h = ora
    acc_ref = jnp.asarray(acc_ref_h)
    sub_d = jnp.asarray(sub)

    base = SimConfig()
    pos_h, vel_h = _init_host(n)      # host copy: no device fetch needed
    pos_d = jnp.asarray(pos_h)

    def fresh_engine():
        e = KdFmmEngine(base.replace(fmm_order=p, tree_radius=SEARCH_R[-1]),
                        n)
        # production-matching traversal-time stale margin (see probe())
        e.stale_margin_abs = _bench_margin(vel_h, base)
        return e

    eng = fresh_engine()
    perm = conative.kdtree_build(pos_h, eng.L)
    pos_s = pos_h[perm]
    c_h, lb_h, rb_h, lam_h = conative.node_geometry(pos_s, eng.L)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)

    over_bound = 0
    for r in list(reversed(SEARCH_R))[r_skip:]:
        eng.config = base.replace(fmm_order=p, tree_radius=r)
        first_err = None
        boosts = SEARCH_BOOST if eng.sub_depth else [1.0]
        for b in boosts:
            eng.mac_sub_boost = b if eng.sub_depth else 1.0
            t0 = _time.perf_counter()
            m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
            t_trav = _time.perf_counter() - t0
            fs = None
            try:
                fs = eng._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p, {})
                err = float(mean_rel_err(eng.force(pos_d, fs)[sub_d],
                                         acc_ref))
            except Exception as e:  # noqa: BLE001 — only HBM exhaustion
                if "RESOURCE_EXHAUSTED" not in str(e):
                    raise
                print("@@ " + json.dumps({"p": p, "r": r, "boost": b,
                                          "err": None, "oom": True}),
                      flush=True)
                sys.exit(17)  # parent respawns at the next r
            if first_err is None:
                first_err = err
            row = {"p": p, "r": r, "boost": b, "err": err}
            if err < ERR_BOUND:
                ppad = eng._pad_jit(pos_d, fs)

                def fpad(x, eng=eng, fs=fs):
                    return x + eng._padded_force_jit(x, fs) * 1e-30
                t = test_time_chained(fpad, ppad, min_loop=1.5)
                row["force_s"] = round(t, 4)
                jax.block_until_ready(fs.m2l_tgt)
                t0 = _time.perf_counter()
                m2l2, p2p2 = eng._traverse(c_h, lb_h, rb_h)
                fs2 = eng._lists_to_state(perm, inv, c_h, lam_h,
                                          m2l2, p2p2, {})
                jax.block_until_ready(fs2.m2l_tgt)
                row["rebuild_s"] = round(_time.perf_counter() - t0, 4)
                row["first_traverse_s"] = round(t_trav, 4)
                del fs2, m2l2, p2p2
            print("@@ " + json.dumps(row), flush=True)
            del fs
            gc.collect()
            if err >= ERR_BOUND:
                break  # boost descent only loosens further
        if first_err >= ERR_BOUND:
            # monotone in r; allow one extra probe near the bound in case
            # of f32 noise, then stop the descent
            over_bound += 1
            if first_err >= 2 * ERR_BOUND or over_bound >= 2:
                break


# --------------------------------------------------------------------------
# child phase: production timing for one config
# --------------------------------------------------------------------------

def final_timing(p, r, err, n=N_HEAD, early_stop_s=0.0, boost=None):
    """Production timing (padded scan, async rebuilds amortized over
    tree_steps).  If early_stop_s > 0 and after >= 2 windows even the BEST
    window is slower than it, this candidate cannot win — stop."""
    if boost is not None:
        os.environ["CO_SUB_BOOST"] = str(boost)
    import numpy as np
    import jax

    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.simulate import Simulator

    # Production cadence from TUNED via env (parent publishes through
    # _cadence_env).  pipeline>=2: adopt each rebuild two window
    # boundaries after its snapshot, so the background rebuild (position
    # fetch + host kd + traversal) gets a multi-window wall budget.
    # resort_every=K runs the FULL host re-sort only every K boundaries
    # with exact geometry/list refreshes between
    # (scripts/cadence_probe.py measures the cadence grid).
    ts = int(os.environ.get("CO_BENCH_TS", "8"))
    resort = int(os.environ.get("CO_BENCH_RESORT", "1"))
    pipe = int(os.environ.get("CO_BENCH_PIPE", "2"))
    builder = os.environ.get("CO_BENCH_BUILDER", "host")
    if builder == "kd_device":
        os.environ["CO_SORT_MODE"] = "kd_device"
    config = SimConfig().replace(fmm_order=p, tree_radius=r,
                                 tree_steps=ts,
                                 tree_resort_every=resort,
                                 tree_pipeline=pipe,
                                 tree_async_build=(
                                     "device" if builder == "kd_device"
                                     else "host"))
    # surface recompiles in the timing log: a cap growth reshapes the scan
    # and a compile landing inside a timed window is the #1 source of
    # outlier windows
    import logging
    jax.config.update("jax_log_compiles", True)
    logging.getLogger("jax._src.dispatch").setLevel(logging.ERROR)
    state = _init_state(n)
    sim = Simulator(config, n, engine="fmm3_kd")
    state = sim.init_acc(state)
    # warm-ups: compile both input layouts, then cross SIX rebuild
    # boundaries so the pair-list caps absorb the staleness swell (cap
    # growth reshapes the scan and costs a full recompile)
    state = sim.run(state, 2)
    state = sim.run(state, 2)
    for _ in range(3):
        sim.advance_padded(2 * max(config.tree_steps, 1))
        jax.block_until_ready(sim._padded.pos)
    steps, repeats = 16, 7
    times = []
    for w in range(repeats):
        t0 = time.perf_counter()
        handle = sim.advance_padded(steps)
        jax.block_until_ready(handle)
        times.append((time.perf_counter() - t0) / steps)
        bt = {k: round(v, 3)
              for k, v in getattr(sim._fmm, "last_build_times", {}).items()}
        print(f"window {w}: {times[-1]:.4f} s/step  caps={sim._fmm.caps}  "
              f"rebuild_wait={getattr(sim, 'last_rebuild_wait', -1):.3f}  "
              f"counts={getattr(sim._fmm, 'last_counts', {})}  bt={bt}",
              flush=True)
        if early_stop_s > 0 and len(times) >= 2 and min(times) > early_stop_s:
            break
    print("@@ " + json.dumps({"times": times}), flush=True)


# --------------------------------------------------------------------------
# parent: orchestrate subprocess phases (the parent stays off JAX)
# --------------------------------------------------------------------------

def _run_child(args, timeout_s=None, retries=0):
    """Run a child phase, stream its output, return (rows, rc).  rc=None
    means the child hit its timeout and was killed.  `retries` extra
    attempts are made when the child dies abnormally."""
    for attempt in range(retries + 1):
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "bench.py")]
            + [str(a) for a in args],
            cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        rows = []
        deadline = time.monotonic() + timeout_s if timeout_s else None
        import selectors
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        timed_out = False
        while True:
            if deadline and time.monotonic() > deadline:
                proc.kill()
                timed_out = True
                break
            if not sel.select(timeout=1.0):
                if proc.poll() is not None:
                    break
                continue
            chunk = proc.stdout.readline()
            if not chunk:
                break
            line = chunk.rstrip("\n")
            if line.startswith("@@ "):
                rows.append(json.loads(line[3:]))
                print("# " + line[3:], flush=True)
            elif line:
                print("## " + line, flush=True)
        proc.wait()
        sel.close()
        rc = None if timed_out else proc.returncode
        if timed_out:
            print(f"## child {args[0]} timed out after {timeout_s:.0f}s",
                  flush=True)
        # rc 0 = done, 3 = over-bound (a RESULT, don't retry), 4 = missing
        # oracle (retrying won't help), 17 = oom (grid protocol)
        if rc in (0, 3, 4, 17):
            return rows, rc
        if attempt < retries:
            print(f"## child {args[0]} rc={rc}; retrying "
                  f"({attempt + 1}/{retries})", flush=True)
    return rows, rc


def _cadence_env(tuned) -> None:
    """Publish the tuned production cadence to child phases (env survives
    the subprocess boundary; final_timing reads it)."""
    os.environ["CO_BENCH_TS"] = str(tuned.get("tree_steps", 8))
    os.environ["CO_BENCH_RESORT"] = str(tuned.get("resort_every", 1))
    os.environ["CO_BENCH_PIPE"] = str(tuned.get("pipeline", 2))
    os.environ["CO_BENCH_BUILDER"] = "host"


def _score(row, tree_steps):
    """Production cost proxy: frozen-tree force + amortized rebuild."""
    return row["force_s"] + row.get("rebuild_s", 0.0) / max(tree_steps, 1)


def _emit(best, cfg, probes, finals, note=""):
    med = best["median"]
    # interaction rates (BASELINE.md:22): counts from the winning config's
    # probe row, rate over the production median s/step (1 force eval/step)
    prow = next((q for q in probes
                 if q.get("p") == best["p"] and q.get("r") == best["r"]
                 and q.get("boost") == best.get("boost")
                 and "p2p_phys_int" in q), None)
    rates = {}
    if prow:
        rates = {
            "p2p_phys_Gint_per_s": round(prow["p2p_phys_int"] / med / 1e9, 2),
            "p2p_lane_Gint_per_s": round(prow["p2p_lane_int"] / med / 1e9, 2),
            "m2l_Mtrans_per_s": round(prow["m2l_entries"] / med / 1e6, 2),
            "p2p_phys_int_per_eval": prow["p2p_phys_int"],
            "p2p_lane_int_per_eval": prow["p2p_lane_int"],
            "m2l_entries_per_eval": prow["m2l_entries"],
        }
    out = {
        "metric": "particle_steps_per_s",
        "value": round(N_HEAD / med, 0),
        "unit": "psteps/s",
        # the reference publishes no numbers (BASELINE.md) and this card
        # has no earlier headline to compare with
        "vs_baseline": None,
        "extra": {
            "n": N_HEAD, "p": best["p"], "r": best["r"],
            "sub_boost": best.get("boost", 1.5),
            "force_rel_err": round(best["err"], 6),
            "err_bound": ERR_BOUND,
            "sec_per_step_median": round(med, 4),
            "sec_per_step_all": [round(t, 4) for t in best["times"]],
            "tree_steps": cfg.tree_steps, "integrator": cfg.integrator,
            "resort_every": cfg.tree_resort_every,
            "pipeline": cfg.tree_pipeline,
            "builder": os.environ.get("CO_BENCH_BUILDER", "host"),
            "interaction_rates": rates,
            "probes": probes,
            "final_candidates": finals,
            "note": note,
        },
    }
    print(json.dumps(out))


def main():
    from coulomb_oscillators import SimConfig  # no device client needed
    cfg = SimConfig()
    t_begin = time.monotonic()
    budget = _budget_s()

    def left():
        return budget - (time.monotonic() - t_begin)

    probes = []
    finals = []
    best = None

    # ---- phase 0: oracle cache (needed by every error probe) ----
    rows, rc = _run_child(["oracle"], timeout_s=min(900, left() * 0.4),
                          retries=1)
    have_oracle = rc == 0
    if not have_oracle:
        print("## oracle phase failed; proceeding with cached-error configs "
              "only", flush=True)

    # ---- phase 1: tuned headline ----
    tuned = dict(TUNED)
    _cadence_env(tuned)
    cfg = cfg.replace(tree_steps=tuned["tree_steps"],
                      tree_resort_every=tuned["resort_every"],
                      tree_pipeline=tuned["pipeline"])
    tried_cfgs = [tuned]
    # over-bound fallback ladder: stiffen the sub-leaf MAC, then shrink r
    for fb in ({"p": tuned["p"], "r": tuned["r"], "boost": 2.0},
               {"p": 6, "r": 2.5, "boost": 2.0}):
        if fb not in tried_cfgs:
            tried_cfgs.append(fb)
    for cand in tried_cfgs:
        if have_oracle:
            rows, rc = _run_child(
                ["probe", cand["p"], cand["r"], cand["boost"]],
                timeout_s=min(900, max(240, left() - 900)), retries=1)
            prow = next((r for r in rows if "err" in r), None)
            if prow:
                probes.append(prow)
            if rc == 3:
                print(f"## tuned config {cand} over bound; stiffening",
                      flush=True)
                continue
            if rc != 0 or not prow:
                print(f"## probe failed rc={rc}; timing anyway with cached "
                      "err", flush=True)
                prow = {"err": float("nan"), **cand}
        else:
            prow = {"err": float("nan"), **cand}
        rows, rc = _run_child(
            ["final", cand["p"], cand["r"], prow.get("err", -1.0), 0.0,
             cand["boost"]],
            timeout_s=max(300, left() - 60), retries=1)
        times = rows[-1].get("times", []) if rows else []
        if times:
            med = statistics.median(times)
            best = {"p": cand["p"], "r": cand["r"], "boost": cand["boost"],
                    "err": prow.get("err", float("nan")), "median": med,
                    "times": times}
            finals.append({k: best[k] for k in
                           ("p", "r", "boost", "err", "median")})
            print(f"## provisional headline: "
                  f"{N_HEAD / med:.0f} psteps/s @ {cand}", flush=True)
            break
        print(f"## final timing failed for {cand} rc={rc}", flush=True)
    if best is None:
        print(json.dumps({"metric": "error", "value": -1,
                          "unit": "headline_failed", "vs_baseline": None}))
        return

    # ---- phase 2: budget-gated refinement ----
    # keep a reserve able to absorb one more final timing (~the tuned one's
    # wall time + compile margin)
    final_cost = sum(best["times"]) * 16 + 240
    tuned_score = None
    for cand in REFINE:
        if not have_oracle:
            break
        if left() < final_cost + 360:
            print("## refinement skipped: budget reserve reached", flush=True)
            break
        rows, rc = _run_child(["probe", cand["p"], cand["r"], cand["boost"]],
                              timeout_s=min(600, left() - final_cost - 60))
        prow = next((r for r in rows if "err" in r), None)
        if prow:
            probes.append(prow)
        if rc != 0 or not prow or "force_s" not in prow:
            continue
        # refinement winners are not window-ladder-certified, so require
        # headroom for within-window error growth (gate at 1.5x the fresh
        # error)
        if prow["err"] * 1.5 > ERR_BOUND:
            print(f"## refine {cand}: err {prow['err']:.2e} leaves no "
                  "window headroom; skipping", flush=True)
            continue
        if tuned_score is None:
            tp = next((r for r in probes
                       if r.get("p") == best["p"] and r.get("r") == best["r"]
                       and r.get("boost") == best["boost"]
                       and "force_s" in r), None)
            tuned_score = _score(tp, cfg.tree_steps) if tp else None
        sc = _score(prow, cfg.tree_steps)
        ref_score = (tuned_score if tuned_score is not None
                     else best["median"])
        if sc < 0.95 * ref_score and left() > final_cost:
            rows, rc = _run_child(
                ["final", cand["p"], cand["r"], prow["err"],
                 1.5 * best["median"], cand["boost"]],
                timeout_s=max(300, left() - 120))
            times = rows[-1].get("times", []) if rows else []
            if times:
                med = statistics.median(times)
                finals.append({"p": cand["p"], "r": cand["r"],
                               "boost": cand["boost"], "err": prow["err"],
                               "median": med})
                if med < best["median"]:
                    best = {"p": cand["p"], "r": cand["r"],
                            "boost": cand["boost"], "err": prow["err"],
                            "median": med, "times": times}

    _emit(best, cfg, probes, finals,
          note=f"budget {budget:.0f}s, used {time.monotonic() - t_begin:.0f}s")


def fullgrid():
    """Manual full reference-grid autotune (p in 1..6 x r descending x
    boost descending) — unbudgeted; use for offline rigor, not the driver
    path."""
    _run_child(["oracle"], retries=1)
    tried = []
    for p in SEARCH_P:
        r_skip = 0
        while r_skip < len(SEARCH_R):
            rows, rc = _run_child(["gridp", p, r_skip], retries=1)
            if rc not in (0, 17):
                print(f"## gridp {p} exited {rc}", flush=True)
            tried.extend(rows)
            if rc != 17:
                break
            r_skip += max(len(rows), 1)
    print(json.dumps({"grid": tried}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "oracle":
        oracle(int(sys.argv[2]) if len(sys.argv) > 2 else N_HEAD)
    elif len(sys.argv) > 1 and sys.argv[1] == "probe":
        probe(int(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4]))
    elif len(sys.argv) > 1 and sys.argv[1] == "gridp":
        grid_for_p(int(sys.argv[2]),
                   r_skip=int(sys.argv[3]) if len(sys.argv) > 3 else 0)
    elif len(sys.argv) > 1 and sys.argv[1] == "final":
        final_timing(int(sys.argv[2]), float(sys.argv[3]),
                     float(sys.argv[4]),
                     early_stop_s=float(sys.argv[5])
                     if len(sys.argv) > 5 else 0.0,
                     boost=float(sys.argv[6]) if len(sys.argv) > 6 else None)
    elif len(sys.argv) > 1 and sys.argv[1] == "fullgrid":
        fullgrid()
    else:
        main()
