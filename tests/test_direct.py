"""Direct O(N^2) force: cross-implementation consistency and physics checks.

Mirrors the reference's oracle strategy (SURVEY.md §4): every engine is
checked against the Kahan-summed direct reference (direct3 semantics).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coulomb_oscillators.ops import direct as D
from coulomb_oscillators.ops.reductions import mean_rel_err

EPS2 = 1e-18
KAPPA = 2e-6 / 1000


def _numpy_direct(pos, eps2, kappa, dim):
    """Independent float64 transliteration of the force law (direct.cuh:23-35)."""
    pos = np.asarray(pos, dtype=np.float64)
    d = pos[:, None, :] - pos[None, :, :]
    dist2 = np.sum(d * d, axis=-1) + eps2
    if dim == 3:
        w = dist2 ** -1.5
    elif dim == 4:
        w = dist2 ** -2.0          # 4D profile (direct.cuh:32-35)
    else:
        w = 1.0 / dist2
    return kappa * np.einsum("ij,ijd->id", w, d)


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("n", [17, 256, 1000])
def test_direct_jnp_matches_numpy_f64(dim, n, rng):
    pos = rng.normal(size=(n, dim)).astype(np.float32) * 0.01
    ref = _numpy_direct(pos, EPS2, KAPPA, dim)
    out = D.direct_jnp(jnp.asarray(pos), EPS2, KAPPA, row_chunk=128)
    err = float(mean_rel_err(out, jnp.asarray(ref, dtype=jnp.float32)))
    assert err < 5e-5, err


@pytest.mark.parametrize("dim", [2, 3])
def test_direct_kahan_matches_numpy_f64(dim, rng):
    n = 777
    pos = rng.normal(size=(n, dim)).astype(np.float32) * 0.01
    ref = _numpy_direct(pos, EPS2, KAPPA, dim)
    out = D.direct_kahan(jnp.asarray(pos), EPS2, KAPPA, src_chunk=256)
    err = float(mean_rel_err(out, jnp.asarray(ref, dtype=jnp.float32)))
    assert err < 2e-5, err


def test_kahan_beats_naive_on_large_n(rng):
    # Kahan compensation should not be worse than plain summation.
    n = 4096
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.003
    ref = jnp.asarray(_numpy_direct(pos, EPS2, KAPPA, 3), dtype=jnp.float32)
    err_kahan = float(mean_rel_err(D.direct_kahan(jnp.asarray(pos), EPS2, KAPPA), ref))
    err_naive = float(mean_rel_err(D.direct_jnp(jnp.asarray(pos), EPS2, KAPPA), ref))
    assert err_kahan <= err_naive * 1.5
    assert err_kahan < 1e-5


def test_momentum_conservation(rng):
    # Newton's 3rd law: total internal force sums to ~0.
    n = 512
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    acc = D.direct_kahan(jnp.asarray(pos), EPS2, KAPPA)
    total = np.abs(np.asarray(jnp.sum(acc, axis=0)))
    typical = float(jnp.mean(jnp.abs(acc)))
    assert np.all(total < 1e-3 * typical * n)
