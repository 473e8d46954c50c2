"""FMM operator validation against direct summation (float64).

Strategy per SURVEY.md §7 stage 3: each operator checked independently —
P2M+M2P far-field vs direct, M2M shift invariance, M2L+L2P vs direct,
L2L recentering invariance — in 2D and 3D.  All chains are jitted once per
(dim, p) to keep CI time sane on a single-core CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coulomb_oscillators.ops.multipole import operators as op
from coulomb_oscillators.ops.multipole.tables import build_tables

@pytest.fixture(autouse=True)
def _x64():
    """These math-validation tests need float64 (other modules may toggle
    the global flag; re-assert per test)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def direct_ref(src, q, pts, dim):
    d = pts[:, None, :] - src[None, :, :]
    r2 = np.sum(d * d, axis=-1)
    if dim == 3:
        pot = np.sum(q[None, :] * r2 ** -0.5, axis=1)
        w = q[None, :] * r2 ** -1.5
    else:
        pot = np.sum(-q[None, :] * 0.5 * np.log(r2), axis=1)
        w = q[None, :] / r2
    return pot, np.einsum("pn,pnd->pd", w, d)


@functools.partial(jax.jit, static_argnums=0)
def _chain_m2l(t, src, q, c_s, lam_s, c_t, lam_t, tgt):
    M = jnp.sum(op.p2m_contrib(t, (src - c_s) / lam_s, q), axis=0,
                keepdims=True)
    Lt = op.m2l(t, M, (c_t - c_s)[None], lam_s[None], lam_t[None])
    B = tgt.shape[0]
    w = (tgt - c_t) / lam_t
    Ltb = jnp.broadcast_to(Lt, (B, Lt.shape[1]))
    return (op.l2p_potential(t, Ltb, w),
            op.l2p_field(t, Ltb, w, jnp.full((B,), lam_t)))


@functools.partial(jax.jit, static_argnums=0)
def _chain_m2p(t, src, q, c_s, lam_s, tgt):
    M = jnp.sum(op.p2m_contrib(t, (src - c_s) / lam_s, q), axis=0,
                keepdims=True)
    B = tgt.shape[0]
    Mb = jnp.broadcast_to(M, (B, M.shape[1]))
    R = tgt - c_s
    lamb = jnp.full((B,), lam_s)
    return op.m2p_potential(t, Mb, R, lamb), op.m2p_field(t, Mb, R, lamb)


def _setup(dim, seed=3, n=40):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, size=(n, dim))
    q = rng.uniform(0.5, 1.5, size=n)
    c_s = src.mean(axis=0)
    lam_s = np.max(np.linalg.norm(src - c_s, axis=1))
    return rng, src, q, c_s, lam_s


@pytest.mark.parametrize("dim", [2, 3])
def test_m2l_l2p_and_m2p_converge(dim):
    rng, src, q, c_s, lam_s = _setup(dim)
    c_t = c_s + np.array([5.0] + [2.0] * (dim - 1))
    lam_t = 0.8
    tgt = c_t[None, :] + rng.uniform(-1, 1, size=(10, dim)) * 0.4
    pot_ref, f_ref = direct_ref(src, q, tgt, dim)

    errs_l, errs_m = [], []
    for p in (2, 4, 6):
        t = build_tables(dim, p)
        args = (jnp.asarray(src), jnp.asarray(q), jnp.asarray(c_s),
                jnp.asarray(lam_s), jnp.asarray(c_t), jnp.asarray(lam_t),
                jnp.asarray(tgt))
        pot, fld = _chain_m2l(t, *args)
        errs_l.append(np.max(np.linalg.norm(np.asarray(fld) - f_ref, axis=1)
                             / np.linalg.norm(f_ref, axis=1)))
        pot_m, fld_m = _chain_m2p(t, *(args[:4] + (args[6],)))
        errs_m.append((
            np.max(np.abs(np.asarray(pot_m) - pot_ref) / np.abs(pot_ref)),
            np.max(np.linalg.norm(np.asarray(fld_m) - f_ref, axis=1)
                   / np.linalg.norm(f_ref, axis=1))))
    # convergence with order
    assert errs_l[1] < errs_l[0] * 0.5 and errs_l[2] < errs_l[1] * 0.7, errs_l
    assert errs_l[2] < 1e-4
    assert errs_m[2][0] < 1e-5 and errs_m[2][1] < 1e-4, errs_m


@pytest.mark.parametrize("dim", [2, 3])
def test_m2m_shift_exact(dim):
    _, src, q, c1, lam1 = _setup(dim, seed=1, n=30)
    rng = np.random.default_rng(7)
    c2 = c1 + rng.uniform(-0.5, 0.5, size=dim)
    lam2 = lam1 * 1.8
    t = build_tables(dim, 6)

    @functools.partial(jax.jit, static_argnums=0)
    def chain(t, src, q, c1, lam1, c2, lam2):
        M1 = jnp.sum(op.p2m_contrib(t, (src - c1) / lam1, q), axis=0,
                     keepdims=True)
        M2d = jnp.sum(op.p2m_contrib(t, (src - c2) / lam2, q), axis=0,
                      keepdims=True)
        M2s = op.m2m(t, M1, ((c1 - c2) / lam2)[None], (lam1 / lam2)[None])
        return M2d, M2s

    M2d, M2s = chain(t, jnp.asarray(src), jnp.asarray(q), jnp.asarray(c1),
                     jnp.asarray(lam1), jnp.asarray(c2), jnp.asarray(lam2))
    np.testing.assert_allclose(np.asarray(M2s), np.asarray(M2d),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_l2l_recenter(dim):
    rng, src, q, c_s, lam_s = _setup(dim, seed=5, n=25)
    c_t = c_s + np.array([6.0] * dim)
    c_t2 = c_t + rng.uniform(-0.3, 0.3, size=dim)
    pts = c_t2[None, :] + rng.uniform(-0.2, 0.2, size=(8, dim))
    _, f_ref = direct_ref(src, q, pts, dim)
    t = build_tables(dim, 6)

    @functools.partial(jax.jit, static_argnums=0)
    def chain(t, src, q, c_s, lam_s, c_t, c_t2, pts):
        lam_t = jnp.asarray(1.0, src.dtype)
        lam_t2 = jnp.asarray(0.5, src.dtype)
        M = jnp.sum(op.p2m_contrib(t, (src - c_s) / lam_s, q), axis=0,
                    keepdims=True)
        Lt = op.m2l(t, M, (c_t - c_s)[None], lam_s[None], lam_t[None])
        Ltd = op.m2l(t, M, (c_t2 - c_s)[None], lam_s[None], lam_t2[None])
        Lts = op.l2l(t, Lt, ((c_t2 - c_t) / lam_t)[None],
                     (lam_t2 / lam_t)[None])
        w = (pts - c_t2) / lam_t2
        B = pts.shape[0]
        lamb = jnp.full((B,), lam_t2)
        f_s = op.l2p_field(t, jnp.broadcast_to(Lts, (B, t.S_Lt)), w, lamb)
        f_d = op.l2p_field(t, jnp.broadcast_to(Ltd, (B, t.S_Lt)), w, lamb)
        return f_s, f_d

    f_s, f_d = chain(t, jnp.asarray(src), jnp.asarray(q), jnp.asarray(c_s),
                     jnp.asarray(lam_s), jnp.asarray(c_t), jnp.asarray(c_t2),
                     jnp.asarray(pts))
    e_s = np.max(np.linalg.norm(np.asarray(f_s) - f_ref, axis=1)
                 / np.linalg.norm(f_ref, axis=1))
    e_d = np.max(np.linalg.norm(np.asarray(f_d) - f_ref, axis=1)
                 / np.linalg.norm(f_ref, axis=1))
    assert e_s < max(3 * e_d, 1e-6), (e_s, e_d)
