"""Multi-chip kd-FMM: pair-sharded force on the virtual 8-device mesh must
match the single-device engine bit-for-bit (same math, psum-reduced)."""

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators import SimConfig
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators.ops.reductions import mean_rel_err
from coulomb_oscillators.parallel import mesh as PM
from coulomb_oscillators.parallel.fmm_shard import make_sharded_force


def test_sharded_force_matches_single_device():
    n = 1200
    cfg = SimConfig(fmm_order=3, tree_radius=2.0)
    pos, _ = ID.init_gaussian(n, (0.003, 0.001, 0.01), (0.003, 0.001, 0.01))
    pos = jnp.asarray(pos)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(pos)
    ref = eng.force(pos, fs)

    m = PM.make_mesh(8)
    force = make_sharded_force(eng, m)
    acc = jax.jit(force)(pos, fs)
    err = float(mean_rel_err(acc, ref))
    assert err < 1e-6, err
