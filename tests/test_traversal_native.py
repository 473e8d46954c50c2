"""Native C++ vs numpy dual-granularity traversal/list equivalence.

The C++ single-pass builder (co_traverse_fine) and the numpy fallback
(_traverse_raw + _fine_lists) implement the same MAC and split-larger
rules (reference kd_admissible fmm_cart3_kdtree.cuh:395-414, CPU
traversal :569-611) and must emit identical directed M2L entries and
identical packed near lists.
"""

import numpy as np
import pytest

from coulomb_oscillators import SimConfig
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.ops.fmm.kdtree import KdFmmEngine, _traverse_raw
from coulomb_oscillators import native as conative


@pytest.mark.parametrize("radius,p", [(2.0, 5), (1.43, 3)])
def test_fine_lists_native_matches_numpy(radius, p):
    lib = conative.get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    n = 20000
    cfg = SimConfig(fmm_order=p, tree_radius=radius)
    x0 = (0.003, 0.001, 0.01)
    u0 = tuple(w * xs for w, xs in zip(cfg.omega0, x0))
    ph, _ = ID.init_gaussian(n, x0, u0)
    eng = KdFmmEngine(cfg, n, use_pallas=False)
    perm = conative.kdtree_build(ph, eng.L)
    c, lb, rb, lam = conative.node_geometry(ph[perm], eng.L)
    m2l_n, near_n = conative.traverse_fine(
        c, lb, rb, eng.st.mult, eng.L, eng.sub_depth, n, 3, p, radius, True)
    m2l_u, p2p_u = _traverse_raw(c, lb, rb, eng.st.mult, eng.L, n, p, radius)
    near_f, m2l_f = eng._fine_lists(m2l_u, p2p_u)

    def keyset(a):
        return set(map(tuple, np.asarray(a, np.int64)))

    assert keyset(m2l_n) == keyset(m2l_f)
    assert keyset(near_n) == keyset(near_f)
