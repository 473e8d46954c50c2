"""Near field on the GPU: the P2P kernel against the jnp scan, at the
shipped N=1M kd-FMM configuration (the shapes of chip_smoke.py phase 2).

    python scripts/p2p_bench.py        # isolated near-field pass: agreement
                                       # and ms per eval, kernel at several
                                       # warp counts
    python scripts/p2p_bench.py e2e    # end to end: Simulator windows with
                                       # the kernel and with the scan, in
                                       # turns (kernel, scan, scan, kernel)

Needs a GPU.  Every time is printed with the card's name and power limit.
"""

import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _setup(n):
    import jax.numpy as jnp
    from coulomb_oscillators import ParticleState, SimConfig
    from coulomb_oscillators.simulate import Simulator

    config = SimConfig(**cs.KD)
    pos, vel = cs.beam(n)
    sim = Simulator(config, n, engine="fmm3_kd")
    return sim, ParticleState(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.zeros((n, 3), jnp.float32))


def isolated(card, n):
    import functools
    import jax
    import jax.numpy as jnp
    from coulomb_oscillators.ops.fmm.p2p_triton import p2p_near

    sim, state = _setup(n)
    sim.init_acc(state)
    eng, fs = sim._fmm, sim._fstate
    ppad = sim._padded.pos
    ref = jax.block_until_ready(jax.jit(eng._p2p_scan)(ppad, fs))
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=-1)))
    pairs = int(fs.p2p_row_ptr[-1]) * eng.st.C * eng.C_blk
    t = cs._time_call(jax.jit(eng._p2p_scan), ppad, fs)
    print(f"scan: {t * 1e3:.3f} ms/eval, {pairs / t / 1e9:.1f} G pair "
          f"evals/s [{card}]", flush=True)
    for warps in (4, 8, 16):
        fn = jax.jit(functools.partial(
            p2p_near, nsub=1 << eng.sub_depth, eps2=float(eng.config.eps2),
            mask_shift=eng.mask_shift, num_warps=warps))
        got = jax.block_until_ready(fn(ppad, fs.p2p_row_ptr, fs.p2p_src))
        dev = float(jnp.max(jnp.linalg.norm(got - ref, axis=-1))) / scale
        t = cs._time_call(fn, ppad, fs.p2p_row_ptr, fs.p2p_src)
        print(f"kernel num_warps={warps}: {t * 1e3:.3f} ms/eval, "
              f"{pairs / t / 1e9:.1f} G pair evals/s, max|d|/max|ref| "
              f"{dev:.2e} [{card}]", flush=True)
        assert dev < cs.TOL_NEAR, dev


def e2e(card, n, windows=3):
    import jax

    for use_kernel in (True, False, False, True):
        sim, state = _setup(n)
        sim._fmm.use_pallas = use_kernel     # read when the scan traces
        ts = sim.config.tree_steps
        state = sim.init_acc(state)
        jax.block_until_ready(sim.run(state, ts).pos)
        jax.block_until_ready(sim.advance_padded(ts))   # prime the rebuilds
        t0 = time.perf_counter()
        for _ in range(windows):
            jax.block_until_ready(sim.advance_padded(ts))
        dt = time.perf_counter() - t0
        print(f"e2e {'kernel' if use_kernel else 'scan'}: {windows} x {ts} "
              f"steps in {dt:.3f} s = {windows * ts * n / dt:.1f} "
              f"particle-steps/s [{card}]", flush=True)
        del sim, state
        gc.collect()


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("p2p_bench: needs a GPU")
    from coulomb_oscillators.utils.cache import enable_compile_cache
    enable_compile_cache()
    card = cs.card_info()[0]
    n = 1_000_000
    if sys.argv[1:] == ["e2e"]:
        e2e(card, n)
    else:
        isolated(card, n)


if __name__ == "__main__":
    main()
