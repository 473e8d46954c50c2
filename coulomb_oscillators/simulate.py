"""Simulation driver: integrator x force-engine orchestration.

Mirrors the reference sim loop (main3.cu:832-874) with the kd-tree temporal
amortization (tree rebuilt every `tree_steps` iterations,
fmm_cart3_kdtree.cuh:1619-1642): between rebuilds the integrator runs as one
jitted lax.scan with the frozen FmmState as a captured input; the rebuild
(device sort + host traversal) happens at the jit boundary.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.models import integrators as I
from coulomb_oscillators.ops.elastic import add_elastic
from coulomb_oscillators.state import ParticleState


def list_age_windows(config: SimConfig, mesh: bool = False) -> int:
    """Largest age, in windows, of the pair lists in use at a window's end
    under the rebuild cadence of :meth:`Simulator._rebuild_padded` (or of
    the mesh path, which adopts each background rebuild one boundary
    late).  Found by replaying the schedule: at boundary i a due job is
    adopted (lists snapshotted at its submission boundary), or, with
    nothing queued, a synchronous refresh snapshots boundary i; then a full
    re-sort is submitted when i % K == 0 (due i + D) and otherwise a
    refresh (due i + 1) unless a full adoption lands there."""
    if not config.tree_async:
        return 1
    if mesh or config.tree_async_build == "device":
        return 2
    K = max(1, int(config.tree_resort_every))
    D = max(1, int(config.tree_pipeline))
    queue, snap, age = [], -1, 1     # queue: (due, snapshot) in order
    for i in range(4 * K * D + 4):
        if queue and queue[0][0] <= i:
            snap = queue.pop(0)[1]
            while queue and queue[0][0] <= i:
                queue.pop(0)
        elif not queue:
            snap = i
        if i % K == 0:
            queue.append((i + D, i))
        elif (i + 1 - D) % K != 0:
            queue.append((i + 1, i))
        age = max(age, i + 1 - snap)
    return age


def auto_stale_margin(vel, config: SimConfig, mesh: bool = False):
    """Per-axis traversal-time MAC slack for frozen pair lists.

    Pair lists are frozen for up to `max_list_age` steps, so a node's
    content can drift ~|v|*dt*age before the next traversal sees it;
    inflating bounds by that drift keeps every accepted M2L pair
    admissible and every truly near pair inside the P2P list for the
    whole window (the frozen acceptance set dominates the stale-window
    error).  Per-AXIS rms speed: drift is
    anisotropic (the default beam's v_z rms is ~10x v_y) and bounds
    inflate per axis, so a flat scalar would buy x/y slack the physics
    never uses while paying its near-field pair cost.  The 2x safety
    factor covers the gaussian drift tail (the window-error ladder
    flattens to fresh-grade once the dominant-axis margin reaches
    ~2x rms*dt*age).  In the harmonic trap
    rms|v| is bounded (energy conservation), so the init-time value holds
    for the run.  The reference freezes lists with no slack and eats the
    drift (fmm_cart3_kdtree.cuh:1619-1642).

    Returns a [dim] float64 vector (zeros when lists never go stale).
    """
    ts = max(config.tree_steps, 1)
    if ts <= 1:
        return np.zeros(config.dim)
    age = ts * list_age_windows(config, mesh)
    if isinstance(vel, np.ndarray):
        vrms_ax = np.sqrt(np.mean(vel.astype(np.float64) ** 2, axis=0))
    else:
        vrms_ax = np.sqrt(np.asarray(
            jnp.mean(vel * vel, axis=0), np.float64))
    fac = float(os.environ.get("CO_STALE_MARGIN_FACTOR", "2.0"))
    return vrms_ax * config.dt * age * fac


class Simulator:
    """Runs the Coulomb-oscillator system with any force engine."""

    def __init__(self, config: SimConfig, n: int, engine: str = "direct",
                 mesh=None):
        """mesh: optional jax.sharding.Mesh — runs the kd-FMM padded scan
        particle-sharded over the mesh (parallel/fmm_pshard.py); each device
        owns n/P particles.  Only supported for the kd engines."""
        self.config = config
        self.n = n
        self.engine_name = engine
        self.omega0_sq = config.omega0_sq()
        self._fmm = None
        self._fstate = None
        self._steps_since_build = 0
        # padded-state stepping (see KdFmmEngine.force_padded_in_jit): the
        # integrator state lives as [G, C, dim] leaf blocks between rebuilds
        self._padded = None
        self._last_out = None
        self._use_padded = False
        self._pending = None      # in-flight background re-sort
        # host-async rebuild pipeline: queue of (due_boundary, kind, future)
        # rebuild jobs — full re-sorts adopted `tree_pipeline` boundaries
        # after submission, refreshes one boundary after
        import collections
        self._pqueue = collections.deque()
        self._boundary_i = 0
        self._last_full = None
        self._pool = None
        self._mesh = mesh
        self._ps = None           # PShardedKdFmm when mesh is set

        if engine.startswith("fmm") or engine == "appel":
            from coulomb_oscillators.ops import fmm as fmm_mod
            self._fmm = fmm_mod.make_engine_object(config, n, engine)
            self._use_padded = hasattr(self._fmm, "force_padded_in_jit")
            if mesh is not None:
                if not self._use_padded:
                    raise ValueError(
                        f"mesh mode needs a kd engine, got {engine!r}")
                from coulomb_oscillators.parallel.fmm_pshard import (
                    make_psharded_scan)
                self._ps, self._psharded_scan = make_psharded_scan(
                    self._fmm, mesh, config, self.omega0_sq)
                self._plists = None
                self._phops = None
            elif self._use_padded:
                self._scan_step = self._make_fmm_scan_padded()
            else:
                self._scan_step = self._make_fmm_scan()
        else:
            from coulomb_oscillators.models.oscillator import (
                make_oscillator_force)
            force = make_oscillator_force(config, n, engine)
            step = I.make_step(force, config.integrator, config.dt)
            self._plain_step = jax.jit(step)

            @jax.jit
            def scan_k(state, k):
                return jax.lax.fori_loop(0, k, lambda _, s: step(s), state)

            self._plain_scan = lambda state, k: scan_k(state, jnp.int32(k))

    # ------------------------------------------------------------------ #
    def _make_fmm_scan(self):
        eng = self._fmm
        cfg = self.config
        omega0_sq = self.omega0_sq

        def force(pos, fstate):
            acc = eng.force_in_jit(pos, fstate)
            return add_elastic(pos, acc, omega0_sq)

        @jax.jit
        def scan_k(state, fstate, k):
            # k is traced: ONE compile covers every inter-rebuild stride
            step = I.make_step(lambda p: force(p, fstate),
                               cfg.integrator, cfg.dt)
            return jax.lax.fori_loop(0, k, lambda _, s: step(s), state)

        return lambda state, fstate, k: scan_k(state, fstate, jnp.int32(k))

    # ------------------------------------------------------------------ #
    def _make_fmm_scan_padded(self):
        """Inter-rebuild scan on padded [G, C, dim] leaf blocks: zero
        per-step N-row gathers (the padded-state b_unsort=false,
        fmm_cart3_kdtree.cuh:1746-1760).

        With config.geom_refresh (default), every force eval first
        recomputes expansion geometry from the live positions on device
        (KdFmmEngine.geom_refresh_in_jit) — lists stay frozen, but node
        centers/scales and the folded M2L harmonics track the particles, so
        the within-window stale force error stays near the fresh-tree bound
        instead of growing with particle drift."""
        eng = self._fmm
        cfg = self.config
        omega0_sq = self.omega0_sq
        mask3 = eng.mask3[..., None]
        # refresh only pays when lists are REUSED: at tree_steps<=1 every
        # step rebuilds exact geometry anyway, and the refresh sweep's
        # in-scan buffers cost HBM (N=10M per-step-rebuild config OOMs
        # with it on)
        geo = bool(getattr(cfg, "geom_refresh", False)) and \
            hasattr(eng, "geom_refresh_in_jit") and cfg.tree_steps > 1

        def force(ppad, fstate):
            if geo:
                fstate = eng.geom_refresh_in_jit(ppad, fstate)
            acc = eng.force_padded_in_jit(ppad, fstate)
            acc = add_elastic(ppad, acc, omega0_sq)
            # pad slots park at FAR: their trap term is huge — zero it so
            # pad velocities stay 0 and pad positions stay put
            return jnp.where(mask3, acc, 0.0)

        @jax.jit
        def scan_k(pstate, fstate, k, dt_on):
            step = I.make_step(lambda p: force(p, fstate),
                               cfg.integrator, cfg.dt)
            return jax.lax.fori_loop(0, k, lambda _, s: step(s, dt_on),
                                     pstate)

        # init: one step of length zero computes a0 = force(pos) with the
        # window program itself, so the force compiles once
        return lambda pstate, fstate, k, init=False: scan_k(
            pstate, fstate, jnp.int32(1 if init else k),
            jnp.float32(0.0 if init else 1.0))

    def _pad_state(self, state: ParticleState) -> ParticleState:
        from coulomb_oscillators.ops.fmm.kdtree import FAR
        eng = self._fmm
        fs = self._fstate
        out = ParticleState(eng.pad_array(state.pos, fs, fill=FAR),
                            eng.pad_array(state.vel, fs),
                            eng.pad_array(state.acc, fs))
        if self._ps is not None:
            out = ParticleState(*(self._ps.shard_padded(x) for x in out))
        return out

    def _reshard_lists(self) -> None:
        from coulomb_oscillators.parallel.fmm_pshard import (
            shard_pair_lists)
        self._plists, self._phops = shard_pair_lists(
            self._fmm, self._fstate, self._ps.ndev)

    def _unpad_state(self, pstate: ParticleState) -> ParticleState:
        eng = self._fmm
        fs = self._fstate
        return ParticleState(eng.unpad_array(pstate.pos, fs),
                             eng.unpad_array(pstate.vel, fs),
                             eng.unpad_array(pstate.acc, fs))

    # ------------------------------------------------------------------ #
    def init_acc(self, state: ParticleState) -> ParticleState:
        """Precompute a0 (main3.cu:835-839)."""
        if self._fmm is None:
            from coulomb_oscillators.models.oscillator import (
                make_oscillator_force)
            acc = make_oscillator_force(self.config, self.n,
                                        self.engine_name)(state.pos)
            return state._replace(acc=acc)
        self._set_stale_margin(state)
        self._fstate = self._fmm.build(state.pos)
        self._steps_since_build = 0
        if not self._use_padded:
            acc = self._fmm.force(state.pos, self._fstate)
            return state._replace(
                acc=add_elastic(state.pos, acc, self.omega0_sq))
        # padded engines: a0 from the window scan's own force (0 steps)
        if self._ps is not None:
            self._reshard_lists()
            self._padded = self._psharded_scan(
                self._pad_state(state), self._fstate, self._plists,
                self._phops, 0, init=True)
        else:
            self._padded = self._scan_step(self._pad_state(state),
                                           self._fstate, 0, init=True)
        return self.current_state()

    def _set_stale_margin(self, state: ParticleState) -> None:
        """Temporal MAC slack (config.stale_margin; auto_stale_margin
        derives the per-axis vector when config says auto/<0)."""
        sm = float(getattr(self.config, "stale_margin", 0.0))
        if sm >= 0.0:
            self._fmm.stale_margin_abs = sm
            return
        self._fmm.stale_margin_abs = auto_stale_margin(
            state.vel, self.config, mesh=self._ps is not None)

    def run(self, state: ParticleState, steps: int) -> ParticleState:
        """Advance `steps` iterations, rebuilding the tree as configured."""
        if self._fmm is None:
            return self._plain_scan(state, steps)
        if self._ps is not None:
            return self._run_psharded(state, steps)
        if self._use_padded:
            return self._run_padded(state, steps)

        ts = max(self.config.tree_steps, 1)
        done = 0
        while done < steps:
            if self._fstate is None or self._steps_since_build >= ts:
                self._fstate = self._fmm.build(state.pos)
                self._steps_since_build = 0
            k = min(ts - self._steps_since_build, steps - done)
            state = self._scan_step(state, self._fstate, k)
            self._steps_since_build += k
            done += k
        return state

    def _run_psharded(self, state: ParticleState, steps: int) -> ParticleState:
        """Multi-device run: the padded scan executes particle-sharded over
        the mesh (parallel/fmm_pshard.py).  Window-boundary rebuilds use
        the same async pipeline as the single-chip path (_rebuild_padded):
        the host rebuild of window w is computed in the background while
        window w+1 scans, and adoption costs only the upload + reshard."""
        ts = max(self.config.tree_steps, 1)
        if (self._padded is None or self._fstate is None
                or state is not self._last_out):
            self._drop_pending()
            self._fstate = self._fmm.build(state.pos)
            self._reshard_lists()
            self._steps_since_build = 0
            self._padded = self._pad_state(state)
        done = 0
        while done < steps:
            if self._steps_since_build >= ts:
                self._rebuild_psharded()
                self._steps_since_build = 0
            k = min(ts - self._steps_since_build, steps - done)
            self._padded = self._psharded_scan(
                self._padded, self._fstate, self._plists, self._phops, k)
            self._steps_since_build += k
            done += k
        out = self._unpad_state(self._padded)
        self._last_out = out
        return out

    def _rebuild_psharded(self) -> None:
        """Mesh-mode twin of :meth:`_rebuild_padded`: adopt the background
        rebuild (one window stale, exactly like single-chip async), refresh
        geometry/lists synchronously while the pipeline primes, and hand
        the next rebuild to the worker."""
        from coulomb_oscillators import native as conative
        eng = self._fmm
        can_async = (self.config.tree_async
                     and hasattr(eng, "build_host")
                     and conative.get_lib() is not None)
        cur = self._unpad_state(self._padded)
        if not can_async:
            self._fstate = eng.build(cur.pos)
            self._reshard_lists()
            self._padded = self._pad_state(cur)
            return
        if self._pending is not None:
            self._fstate = self._pending.result()
        else:
            # pipeline priming: exact geometry/list refresh on the current
            # permutation (bounds exact; only leaf tightness is stale)
            self._fstate = eng.refresh(self._padded.pos, self._fstate)
        self._reshard_lists()
        self._padded = self._pad_state(cur)
        self._pending = self._executor().submit(
            lambda p=cur.pos: eng.adopt(eng.build_host(p)))

    def _run_padded(self, state: ParticleState, steps: int) -> ParticleState:
        # a state we did not hand out (or a cold start) must enter padded form
        if (self._padded is None or self._fstate is None
                or state is not self._last_out):
            self._drop_pending()
            self._fstate = self._fmm.build(state.pos)
            self._steps_since_build = 0
            self._padded = self._pad_state(state)
        self.advance_padded(steps)
        return self.current_state()

    def advance_padded(self, steps: int):
        """Advance on the padded fast path WITHOUT materializing the
        unpadded state at the end (the benchmark hot loop — a full unpad is
        3 N-row gather programs, ~0.4 s at N=1M).  Requires an active
        padded run (init_acc + run established it).  Returns the padded
        position array as a synchronization handle; use
        :meth:`current_state` to get the unpadded state."""
        if self._padded is None or self._fstate is None:
            raise RuntimeError("advance_padded requires an active padded "
                               "run (call init_acc + run first)")
        ts = max(self.config.tree_steps, 1)
        done = 0
        while done < steps:
            if self._steps_since_build >= ts:
                self._rebuild_padded()
                self._steps_since_build = 0
            k = min(ts - self._steps_since_build, steps - done)
            self._padded = self._scan_step(self._padded, self._fstate, k)
            self._steps_since_build += k
            done += k
        self._last_out = None     # handed-out states are now stale
        return self._padded.pos

    def current_state(self) -> ParticleState:
        """Unpad and return the current state (resumable via run())."""
        out = self._unpad_state(self._padded)
        self._last_out = out
        return out

    def _rebuild_padded(self) -> None:
        """Window-boundary tree rebuild of the padded state.

        Async mode (config.tree_async): adopt the FULL rebuild (kd sort,
        geometry, MAC traversal, lists) the background thread computed from
        last window's positions — then kick off the next background rebuild.
        The adopted tree is one window stale: the same within-window
        freezing the reference accepts when reusing lists across tree_steps
        iterations (fmm_cart3_kdtree.cuh:1619-1642).

        The padded state never leaves padded form: adoption applies a
        composed old-layout -> new-layout gather (KdFmmEngine.repad_triple,
        one gather per array) instead of unpad + repad (4 N-row gathers per
        array); the builder fetches and unpads the positions itself in the
        background thread (build_host_padded).  Sync mode: the reference's
        blocking rebuild.
        """
        from coulomb_oscillators import native as conative
        eng = self._fmm
        use_device = (self.config.tree_async_build == "device"
                      and hasattr(eng, "build_device_async"))
        have_host = (hasattr(eng, "build_host_padded")
                     and conative.get_lib() is not None)
        can_async = self.config.tree_async and (use_device or have_host)
        if not can_async:
            cur = self._unpad_state(self._padded)
            self._fstate = eng.build(cur.pos)
            self._padded = self._pad_state(cur)
            return

        if use_device:
            # device-Morton builder: the job sorts on device from the
            # original-order positions (unpad here, repad after)
            cur = self._unpad_state(self._padded)
            if self._pending is not None:
                self._fstate = self._pending.result()
                self._padded = self._pad_state(cur)
            else:
                self._fstate = eng.refresh(self._padded.pos, self._fstate)
            self._pending = self._executor().submit(
                lambda p=cur.pos: eng.adopt(eng.build_device_async(p)))
            return

        # Hybrid pipelined rebuild cadence (deterministic):
        #
        # * FULL re-sort (position fetch + host kd + traversal) every
        #   `tree_resort_every` (K) window boundaries, adopted
        #   `tree_pipeline` (D) boundaries after its position snapshot.
        #   D=2 gives the background rebuild a 2-window wall budget, so a
        #   rebuild slower than one window does not stall the device at
        #   the boundary.
        # * REFRESH (exact node bounds from 1.2 MB of on-device leaf stats
        #   + MAC re-traversal + list re-upload; permutation unchanged) at
        #   every other boundary, adopted one boundary after its snapshot.
        #   Bounds are therefore at most one window old at adoption — the
        #   same staleness contract the D=1 pipeline had — regardless of
        #   how long ago the last re-sort ran; re-sort staleness only
        #   loosens leaf PARTITION quality (slightly more pairs, never
        #   wrong ones), and the beam's pair counts drift ~0.5%/window.
        import time as _time
        D = max(1, int(getattr(self.config, "tree_pipeline", 1)))
        K = max(1, int(getattr(self.config, "tree_resort_every", 1)))
        i = self._boundary_i
        self._boundary_i += 1

        if self._pqueue and self._pqueue[0][0] <= i:
            due, kind, fut = self._pqueue.popleft()
            t0 = _time.perf_counter()
            res = fut.result()
            # boundary stall diagnostic: how long the device sat idle
            # waiting for the background rebuild (bench.py reports it)
            self.last_rebuild_wait = _time.perf_counter() - t0
            if kind == "full":
                fs_new, remap = res
                self._padded = ParticleState(*eng.repad_triple(
                    self._padded.pos, self._padded.vel, self._padded.acc,
                    remap))
                self._fstate = fs_new
            else:
                self._fstate = res
            # collision safety: drop any other job due at this boundary
            while self._pqueue and self._pqueue[0][0] <= i:
                _, _, f2 = self._pqueue.popleft()
                try:
                    f2.result()
                except Exception:
                    pass
        elif not self._pqueue:
            # pipeline priming: exact geometry/list refresh on the current
            # permutation (bounds are exact; only leaf tightness is stale;
            # the padded layout is untouched)
            self._fstate = eng.refresh(self._padded.pos, self._fstate)

        fs_cur = self._fstate
        ppad = self._padded.pos
        if i % K == 0:
            # submit the next FULL re-sort from this boundary's positions.
            # Its repad must map from the layout current at ITS adoption —
            # the previous full job's result (refreshes preserve the
            # permutation; the single-worker executor runs jobs in order,
            # so prev.result() inside the job is already done and free).
            prev = self._last_full

            def job(ppad=ppad, prev=prev, fs_cur=fs_cur):
                fs_new = eng.adopt(eng.build_host_padded(
                    ppad, fs_cur.inv_perm))
                fs_old = prev.result()[0] if prev is not None else fs_cur
                return fs_new, eng.make_repad(fs_old, fs_new)

            fut = self._executor().submit(job)
            self._last_full = fut
            self._pqueue.append((i + D, "full", fut))
        elif (i + 1 - D) % K != 0:
            # background refresh, adopted next boundary.  Skipped when a
            # full adoption lands there (the refresh would straddle the
            # layout change and be discarded anyway).
            def rjob(ppad=ppad, fs_cur=fs_cur):
                return eng.refresh(ppad, fs_cur)

            self._pqueue.append((i + 1, "refresh",
                                 self._executor().submit(rjob)))

    def _executor(self):
        if self._pool is None:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tree-build")
        return self._pool

    def _drop_pending(self) -> None:
        if self._pending is not None:
            self._pending.cancel()
            try:
                self._pending.result()
            except Exception:
                pass
            self._pending = None
        while self._pqueue:
            _, _, f = self._pqueue.popleft()
            f.cancel()
            try:
                f.result()
            except Exception:
                pass
        self._boundary_i = 0
        self._last_full = None
