"""Smoke run of the simulator on NVIDIA GPUs.

Drives the main path through the entry points a user calls (`Simulator`,
the `nbco3` CLI) at the size users run, checks every result against the
Kahan direct oracle computed on the card, and prints one line per phase
with its numbers, tolerance and seconds.  Any failure raises: nothing is
caught and carried on past.

    python chip_smoke.py             # phases 0-5 on one GPU
    python chip_smoke.py --chips 4   # only the particle-sharded kd FMM on
                                     # four GPUs, against the one-GPU force

The last line of standard output is one JSON object naming the device.
With no GPU (or outside a checkout of the repository) it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# 3D Gaussian beam of the reference driver (main3.cu:230-245)
X_STD = (0.003, 0.001, 0.01)
# shipped kd-FMM configuration at N=1M: p, r, sub-leaf MAC boost, and the
# rebuild cadence (window length, full re-sort every 2 windows, adoption
# 2 windows late); the stale margin stays on auto
KD = dict(fmm_order=6, tree_radius=1.43, mac_sub_boost=1.5, tree_steps=16,
          tree_resort_every=2, tree_pipeline=2)
# four cards: p=5, r=2.0 holds the same error bound with a force program
# that compiles in a fraction of p=6's time (each second on four cards
# costs four)
KD4 = dict(KD, fmm_order=5, tree_radius=2.0)
N_SUB = 2048            # oracle targets (subsample seeded as bench.py)

# Tolerances, each with its reason:
# direct engine vs Kahan: both sum every pair in f32, in another order
TOL_DIRECT = 1e-5
# FMM vs Kahan oracle: the reference's default -accuracy bound
# (main3.cu:236-237)
TOL_FMM = 1e-3
# P2P kernel vs jnp scan on the same state: the same f32 pair terms summed
# in another order (max |d| / max |ref| over particles)
TOL_NEAR = 1e-5
# sharded vs one-card force on the same state: f32 sums in another order
TOL_SHARD = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class CompileClock:
    """Sums XLA backend compile seconds (jax.monitoring events)."""

    def __init__(self):
        import jax
        self.total = 0.0

        def listen(event, secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.total += secs

        jax.monitoring.register_event_duration_secs_listener(listen)

    def since(self, mark: float) -> float:
        return self.total - mark


def beam(n: int, dim: int = 3, dtype=None):
    """Initial (pos, vel) of the reference Gaussian beam, as bench.py."""
    import numpy as np
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.models import init_dist as ID

    omega0 = SimConfig().omega0 if dim == 3 else (1.095, 1.0)
    x = X_STD[:dim]
    u = tuple(w * xs for w, xs in zip(omega0, x))
    return ID.init_gaussian(n, x, u, dim=dim, dtype=dtype or np.float32)


def oracle_err(pos, coul, config, n: int) -> float:
    """Mean relative error of Coulomb accelerations `coul` on the seeded
    subsample, against the Kahan oracle of all n sources (on the card)."""
    import numpy as np
    import jax.numpy as jnp
    from coulomb_oscillators.ops import direct as D
    from coulomb_oscillators.ops.reductions import mean_rel_err

    sub = jnp.asarray(np.random.default_rng(0).choice(n, N_SUB,
                                                      replace=False))
    ref = D.direct_kahan_targets(pos[sub], pos, config.eps2,
                                 config.kappa(n))
    return float(mean_rel_err(coul[sub], ref))


def coulomb_part(state, config):
    """Coulomb accelerations: the state's total minus the trap term."""
    import jax.numpy as jnp
    k = jnp.asarray(config.omega0_sq(), state.pos.dtype)
    return state.acc + state.pos * k


def check(name: str, value: float, tol: float) -> None:
    if not value <= tol:   # also catches NaN
        raise AssertionError(f"{name}: {value!r} exceeds {tol!r}")


# --------------------------------------------------------------------------- #


def phase_device(card: str) -> None:
    import jax
    from coulomb_oscillators import native

    t0 = time.perf_counter()
    dev = jax.devices()[0]
    if native.get_lib() is None:
        raise RuntimeError("native host library did not build or load")
    log(f"phase 0 device: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())} [{card}]; native library "
        f"{native._so_path}; {time.perf_counter() - t0:.1f} s")


def phase_direct(card: str, n: int = 4096, steps: int = 300) -> None:
    import jax
    import jax.numpy as jnp
    from coulomb_oscillators import ParticleState, SimConfig
    from coulomb_oscillators.ops import direct as D
    from coulomb_oscillators.ops.reductions import mean_rel_err
    from coulomb_oscillators.simulate import Simulator

    t0 = time.perf_counter()
    config = SimConfig()
    pos, vel = beam(n)
    sim = Simulator(config, n, engine="direct")
    state = sim.init_acc(ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                                       jnp.zeros((n, 3), jnp.float32)))
    jax.block_until_ready(sim.run(state, 2))     # compile
    t1 = time.perf_counter()
    state = jax.block_until_ready(sim.run(state, steps))
    dt = (time.perf_counter() - t1) / steps
    if bool(jnp.any(jnp.isnan(state.pos))):
        raise AssertionError("direct: NaN positions")
    acc = D.direct_jnp(state.pos, config.eps2, config.kappa(n))
    ref = D.direct_kahan(state.pos, config.eps2, config.kappa(n))
    err = float(mean_rel_err(acc, ref))
    check("direct mean rel err", err, TOL_DIRECT)
    log(f"phase 1 direct: N={n} leapfrog {steps} steps, "
        f"{dt * 1e3:.4f} ms/step = {n / dt:.1f} particle-steps/s "
        f"[{card}]; err vs Kahan {err:.3e} (tol {TOL_DIRECT:g}); "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kd(card: str, clock: CompileClock, n: int = 1_000_000):
    """N=1M beam through Simulator at the shipped configuration; returns
    the Simulator for the kernel check."""
    import jax
    import jax.numpy as jnp
    from coulomb_oscillators import ParticleState, SimConfig
    from coulomb_oscillators.simulate import Simulator

    t0 = time.perf_counter()
    c0 = clock.total
    config = SimConfig(**KD)
    ts = config.tree_steps
    pos, vel = beam(n)
    sim = Simulator(config, n, engine="fmm3_kd")
    eng = sim._fmm
    if not eng.use_pallas:
        raise AssertionError("kd engine did not select the P2P kernel")
    state = sim.init_acc(ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                                       jnp.zeros((n, 3), jnp.float32)))
    state = sim.run(state, ts)            # compiles the window scan
    jax.block_until_ready(state.pos)
    for _ in range(3):                    # prime the rebuild pipeline
        jax.block_until_ready(sim.advance_padded(ts))
    setup = time.perf_counter() - t0
    compile_s = clock.since(c0)
    log(f"phase 2 kd setup: N={n} L={eng.L} C={eng.st.C} "
        f"p={config.fmm_order} r={config.tree_radius} "
        f"boost={eng.mac_sub_boost} ts={ts} K={config.tree_resort_every} "
        f"D={config.tree_pipeline} margin="
        f"{[float(m) for m in eng.stale_margin_abs]}; "
        f"setup {setup:.1f} s incl. compile {compile_s:.1f} s [{card}]")

    c1 = clock.total
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        jax.block_until_ready(sim.advance_padded(ts))
        times.append(time.perf_counter() - t1)
    tot = sum(times)
    log(f"phase 2 kd windows: 3 x {ts} steps, s/window "
        f"{[round(t, 4) for t in times]}, {3 * ts * n / tot:.1f} "
        f"particle-steps/s [{card}]; rebuild wait "
        f"{getattr(sim, 'last_rebuild_wait', float('nan')):.4f} s; "
        f"counts {eng.last_counts}; caps {eng.caps}; compile inside "
        f"windows {clock.since(c1):.1f} s")

    # error at the last step of a reuse window (lists at their oldest)
    state = sim.current_state()
    if bool(jnp.any(jnp.isnan(state.pos))):
        raise AssertionError("kd: NaN positions")
    err_end = oracle_err(state.pos, coulomb_part(state, config), config, n)
    check("kd window-end err", err_end, TOL_FMM)
    # error right after a rebuild: one step into the next window
    state = sim.run(state, 1)
    err_new = oracle_err(state.pos, coulomb_part(state, config), config, n)
    check("kd post-rebuild err", err_new, TOL_FMM)
    log(f"phase 2 kd error vs Kahan ({N_SUB} targets): window end "
        f"{err_end:.3e}, after rebuild {err_new:.3e} (tol {TOL_FMM:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    return sim


def phase_near(card: str, sim) -> None:
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    eng, fs, ppad = sim._fmm, sim._fstate, sim._padded.pos
    kern = jax.jit(eng._p2p_kernel)
    scan = jax.jit(eng._p2p_scan)
    got = jax.block_until_ready(kern(ppad, fs))
    ref = jax.block_until_ready(scan(ppad, fs))
    mag = jnp.linalg.norm(ref, axis=-1)
    dev = float(jnp.max(jnp.linalg.norm(got - ref, axis=-1))
                / jnp.max(mag))
    check("P2P kernel vs scan", dev, TOL_NEAR)
    t_k = _time_call(kern, ppad, fs)
    t_s = _time_call(scan, ppad, fs)
    log(f"phase 3 near field: kernel vs scan max|d|/max|ref| {dev:.3e} "
        f"(tol {TOL_NEAR:g}); kernel {t_k * 1e3:.3f} ms, scan "
        f"{t_s * 1e3:.3f} ms per eval [{card}]; "
        f"{time.perf_counter() - t0:.1f} s")


def _time_call(fn, *args, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_cli(card: str, n: int = 30001, iters: int = 400,
              every: int = 200) -> None:
    from coulomb_oscillators import cli

    t0 = time.perf_counter()
    out = os.path.join(REPO, "out", "chip_smoke_cli")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    rc = cli.main(["-n", str(n), "-iters", str(iters), "-steps",
                   str(every), "-o", out])
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    want = 2 * n * 3 * 4
    snaps = sorted(f for f in os.listdir(out) if f.endswith(".bin"))
    if len(snaps) != iters // every + 1:
        raise AssertionError(f"cli snapshots {snaps}")
    for f in snaps:
        size = os.path.getsize(os.path.join(out, f))
        if size != want:
            raise AssertionError(f"{f}: {size} bytes, want {want}")
    if not os.path.exists(os.path.join(out, "args.txt")):
        raise AssertionError("cli wrote no args.txt")
    log(f"phase 4 cli: N={n} {iters} iterations, {len(snaps)} snapshots "
        f"of {want} bytes + args.txt [{card}]; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_2d(card: str, n: int = 100_000) -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    from coulomb_oscillators import SimConfig
    from coulomb_oscillators.ops.fmm import KdFmmEngine

    t0 = time.perf_counter()
    config = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                       tree_radius=2.0, precision="float64")
    pos_h, _ = beam(n, dim=2, dtype=np.float64)
    pos = jnp.asarray(pos_h)
    eng = KdFmmEngine(config, n)
    acc = eng.force(pos, eng.build(pos))
    if acc.dtype != jnp.float64:
        raise AssertionError(f"2D result dtype {acc.dtype}")
    err = oracle_err(pos, acc, config, n)
    check("2D f64 err", err, TOL_FMM)
    log(f"phase 5 2D f64: fmm2_kd N={n} p=4 r=2.0, dtype {acc.dtype}, "
        f"err vs f64 Kahan {err:.3e} (tol {TOL_FMM:g}) [{card}]; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_four(card: str, clock: CompileClock, n: int = 4_000_000,
               ndev: int = 4) -> None:
    """Particle-sharded kd FMM on four cards, against the one-card force
    on the same state, then the mesh Simulator across two rebuilds."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from coulomb_oscillators import ParticleState, SimConfig
    from coulomb_oscillators.ops.fmm import KdFmmEngine
    from coulomb_oscillators.ops.fmm.kdtree import FAR
    from coulomb_oscillators.parallel import mesh as PM
    from coulomb_oscillators.parallel.fmm_pshard import (PShardedKdFmm,
                                                        shard_pair_lists)
    from coulomb_oscillators.simulate import Simulator, auto_stale_margin

    t0 = time.perf_counter()
    config = SimConfig(**KD4)
    mesh = PM.make_mesh(ndev)
    pos_h, vel_h = beam(n)
    pos = jnp.asarray(pos_h)
    eng = KdFmmEngine(config, n)
    eng.stale_margin_abs = auto_stale_margin(vel_h, config, mesh=True)
    fs = eng.build(pos)
    ppad = eng._pad_jit(pos, fs)
    one = jax.block_until_ready(eng._padded_force_jit(ppad, fs))
    ps = PShardedKdFmm(eng, mesh)
    lists, hops = shard_pair_lists(eng, fs, ndev)
    spad = ps.shard_padded(ppad)
    G, C = 1 << eng.L, eng.st.C
    shapes = {s.data.shape for s in spad.addressable_shards}
    devs = {s.device for s in spad.addressable_shards}
    if shapes != {(G // ndev, C, 3)} or len(devs) != ndev:
        raise AssertionError(f"shards {shapes} on {len(devs)} devices")
    shard = jax.block_until_ready(ps.force_padded(spad, fs, lists, hops))
    mask = eng.mask3[..., None]
    a, b = jnp.where(mask, np.asarray(shard), 0.0), jnp.where(mask, one, 0.0)
    dev = float(jnp.max(jnp.linalg.norm(a - b, axis=-1))
                / jnp.max(jnp.linalg.norm(b, axis=-1)))
    check("sharded vs one-card force", dev, TOL_SHARD)
    log(f"phase 4x force: N={n} p={config.fmm_order} "
        f"r={config.tree_radius} over {ndev} cards, {G // ndev} leaf blocks "
        f"each; max|d|/max|ref| vs one card {dev:.3e} "
        f"(tol {TOL_SHARD:g}); {time.perf_counter() - t0:.1f} s")
    del one, shard, spad, ppad, fs

    t1 = time.perf_counter()
    c0 = clock.total
    ts = config.tree_steps
    sim = Simulator(config, n, engine="fmm3_kd", mesh=mesh)
    state = sim.init_acc(ParticleState(pos, jnp.asarray(vel_h),
                                       jnp.zeros((n, 3), jnp.float32)))
    state = jax.block_until_ready(sim.run(state, ts))
    setup = time.perf_counter() - t1
    t2 = time.perf_counter()
    state = jax.block_until_ready(sim.run(state, ts + 1))   # 2 rebuilds
    run_s = time.perf_counter() - t2
    if bool(jnp.any(jnp.isnan(state.pos))):
        raise AssertionError("mesh run: NaN positions")
    err = oracle_err(state.pos, coulomb_part(state, config), config, n)
    check("mesh Simulator err", err, TOL_FMM)
    log(f"phase 4x simulator: N={n} on {ndev} cards, {2 * ts + 1} steps "
        f"across 2 rebuilds; setup {setup:.1f} s incl. compile "
        f"{clock.since(c0):.1f} s; {ts + 1} steps in {run_s:.2f} s = "
        f"{(ts + 1) * n / run_s:.1f} particle-steps/s [{card}]; err vs "
        f"Kahan {err:.3e} (tol {TOL_FMM:g})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4])
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but {len(devs)} GPUs",
              file=sys.stderr)
        return 1
    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()

    cards = card_info()
    for c in cards:
        log(f"card: {c}")
    card = cards[0]
    clock = CompileClock()
    t0 = time.perf_counter()
    phase_device(card)
    if args.chips == 4:
        phase_four(card, clock)
    else:
        phase_direct(card)
        sim = phase_kd(card, clock)
        phase_near(card, sim)
        del sim
        phase_cli(card)
        phase_2d(card)
    log(f"total {time.perf_counter() - t0:.1f} s, compile "
        f"{clock.total:.1f} s")
    for c in cards:
        log(c)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
