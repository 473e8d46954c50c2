"""Every float32 contraction on the force and oracle paths is pinned.

On the GPU an unpinned f32 dot may run in TF32 (about three decimal
digits).  The direct engine and the Kahan oracles are written without dots;
the multipole operators pin theirs at HIGHEST.  A jaxpr walk catches a
regression without a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coulomb_oscillators import SimConfig
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.ops import direct as D
from coulomb_oscillators.ops.fmm import KdFmmEngine
from coulomb_oscillators.ops.fmm.kdtree import FAR

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """All dot_general equations of a closed jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dots(sub))
    return out


def _unpinned(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    bad = []
    for eqn in _dots(jaxpr):
        prec = eqn.params.get("precision")
        if not (isinstance(prec, tuple)
                and all(p == HIGHEST for p in prec)):
            bad.append(str(eqn)[:200])
    return bad


@pytest.fixture(scope="module")
def pos():
    p = np.random.default_rng(0).normal(size=(300, 3)) * 0.01
    return jnp.asarray(p, jnp.float32)


@pytest.mark.parametrize("name", ["direct_jnp", "direct_kahan",
                                  "direct_kahan_targets"])
def test_direct_paths_pinned(name, pos):
    fn = {
        "direct_jnp": lambda p: D.direct_jnp(p, 1e-18, 1e-9, row_chunk=128),
        "direct_kahan": lambda p: D.direct_kahan(p, 1e-18, 1e-9,
                                                 src_chunk=128),
        "direct_kahan_targets": lambda p: D.direct_kahan_targets(
            p[:17], p, 1e-18, 1e-9, src_chunk=128),
    }[name]
    assert _unpinned(fn, pos) == []


@pytest.mark.parametrize("use_pallas", [False, True])
def test_kd_force_padded_pinned(use_pallas):
    n = 2000
    cfg = SimConfig(fmm_order=4, tree_radius=1.7)
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(cfg.omega0, x))
    p, _ = ID.init_gaussian(n, x, u, dtype=np.float32)
    p = jnp.asarray(p)
    eng = KdFmmEngine(cfg, n, use_pallas=use_pallas)
    fs = eng.build(p)
    ppad = eng.pad_array(p, fs, fill=FAR)
    assert _unpinned(eng.force_padded_in_jit, ppad, fs) == []
    # and the walk does see the multipole operators' (pinned) dots
    jaxpr = jax.make_jaxpr(eng.force_padded_in_jit)(ppad, fs).jaxpr
    assert len(_dots(jaxpr)) > 0


def test_walk_flags_an_unpinned_dot(pos):
    assert _unpinned(lambda p: jnp.einsum("nd,md->nm", p, p), pos)
