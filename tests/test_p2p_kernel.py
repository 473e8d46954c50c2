"""The near-field P2P kernel (ops/fmm/p2p_triton.py) on the CPU: Pallas
interpret mode against an independent float64 sum and against the jnp
scan, the wrapper's shape rules, and the engine's choice of path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from coulomb_oscillators import SimConfig
from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.ops.fmm import KdFmmEngine
from coulomb_oscillators.ops.fmm.kdtree import FAR
from coulomb_oscillators.ops.fmm.p2p_triton import p2p_near

EPS2 = 1e-18


def _packed(blk, mask, shift):
    return int(np.array((blk | (mask << shift)) & 0xFFFFFFFF,
                        np.uint32).view(np.int32))


def _numpy_near(ppad, entries, nsub, shift):
    """float64 transliteration: every (target, packed source) entry adds the
    masked source block's softened 3D force on the target sub-leaf."""
    G, C, _ = ppad.shape
    src = ppad.reshape(G // nsub, C * nsub, 3).astype(np.float64)
    out = np.zeros((G, C, 3))
    for t, v in entries:
        v = int(np.array(v, np.int32).view(np.uint32))
        blk, mask = v & ((1 << shift) - 1), v >> shift
        for j in range(C * nsub):
            if not (mask >> (j // C)) & 1:
                continue
            d = ppad[t].astype(np.float64) - src[blk, j]
            dist2 = np.sum(d * d, axis=1) + EPS2
            w = np.where(dist2 > 1e30, 0.0, dist2 ** -1.5)
            out[t] += d * w[:, None]
    return out


@pytest.mark.parametrize("nsub,C", [(4, 8), (2, 16), (1, 8)])
def test_kernel_matches_numpy_on_synthetic_csr(nsub, C, rng):
    G = 8 * nsub
    Gb, shift = G // nsub, 32 - nsub
    ppad = (rng.normal(size=(G, C, 3)) * 0.01).astype(np.float32)
    ppad[3, C // 2:] = FAR                     # padded slots
    entries = []
    for t in range(G):
        if t == 5:
            continue                           # a target with no partners
        for b in sorted(rng.choice(Gb, size=rng.integers(1, Gb + 1),
                                   replace=False)):
            mask = int(rng.integers(1, 1 << nsub))
            entries.append((t, _packed(int(b), mask, shift)))
    tgt = np.array([e[0] for e in entries])
    part = np.array([e[1] for e in entries], np.int32)
    row_ptr = np.searchsorted(tgt, np.arange(G + 1)).astype(np.int32)
    # entries past row_ptr[G] (list padding) must never be read
    part = np.concatenate([part, np.full(11, Gb, np.int32)])
    got = p2p_near(jnp.asarray(ppad), jnp.asarray(row_ptr),
                   jnp.asarray(part), nsub=nsub, eps2=EPS2,
                   mask_shift=shift, interpret=True)
    ref = _numpy_near(ppad, entries, nsub, shift)
    assert got.shape == (G, C, 3) and got.dtype == jnp.float32
    assert np.all(np.asarray(got)[5] == 0.0)
    dev = np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref))
    assert dev < 1e-5, dev


@pytest.mark.parametrize("shape,nsub", [((8, 6, 3), 2), ((6, 8, 3), 4),
                                        ((8, 8, 2), 2)])
def test_kernel_rejects_bad_shapes(shape, nsub):
    with pytest.raises(ValueError):
        p2p_near(jnp.zeros(shape, jnp.float32), jnp.zeros(9, jnp.int32),
                 jnp.zeros(4, jnp.int32), nsub=nsub, eps2=EPS2,
                 mask_shift=32 - nsub, interpret=True)


def _beam(n, cfg):
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(cfg.omega0, x))
    pos, _ = ID.init_gaussian(n, x, u, dtype=np.float32)
    return jnp.asarray(pos)


@pytest.mark.parametrize("n,tree_L", [(3000, 0), (1500, 4)])
def test_kernel_matches_scan_on_engine_state(n, tree_L):
    """Same FmmState, same padded positions: kernel == scan up to f32
    summation order (sub-leaf masks and the sub_depth=0 fallback)."""
    cfg = SimConfig(fmm_order=3, tree_radius=1.7, tree_L=tree_L)
    eng = KdFmmEngine(cfg, n, use_pallas=True)
    assert eng.p2p_interpret and eng.st.C & (eng.st.C - 1) == 0
    pos = _beam(n, cfg)
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    got = eng._p2p_kernel(ppad, fs)
    ref = eng._p2p_scan(ppad, fs)
    scale = float(jnp.max(jnp.linalg.norm(ref, axis=-1)))
    dev = float(jnp.max(jnp.linalg.norm(got - ref, axis=-1))) / scale
    assert dev < 1e-5, dev


def test_engine_force_kernel_vs_scan():
    n = 2500
    cfg = SimConfig(fmm_order=3, tree_radius=1.7)
    pos = _beam(n, cfg)
    a = KdFmmEngine(cfg, n, use_pallas=True)
    b = KdFmmEngine(cfg, n, use_pallas=False)
    fa = a.force(pos, a.build(pos))
    fb = b.force(pos, b.build(pos))
    scale = float(jnp.max(jnp.linalg.norm(fb, axis=-1)))
    assert float(jnp.max(jnp.linalg.norm(fa - fb, axis=-1))) / scale < 1e-5


@pytest.mark.parametrize("backend,dim,prec,want", [
    ("gpu", 3, "float32", True),
    ("cpu", 3, "float32", False),
    ("gpu", 2, "float32", False),
    ("gpu", 3, "float64", False),
])
def test_near_field_path_choice(monkeypatch, backend, dim, prec, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    omega0 = (1.095, 1.0, 1.0)[:dim]
    cfg = SimConfig(dim=dim, omega0=omega0, precision=prec)
    n = 5000
    eng = KdFmmEngine(cfg, n)
    assert eng.use_pallas is want
    assert eng.p2p_interpret is (backend != "gpu")
    C = eng.st.C
    plain = -(-n // (1 << eng.L))
    if want:       # the kernel's tiles are powers of two
        assert C & (C - 1) == 0 and plain <= C < 2 * plain
    else:
        assert C == plain


def test_kernel_is_3d_only():
    with pytest.raises(ValueError):
        KdFmmEngine(SimConfig(dim=2, omega0=(1.0, 1.0)), 1000,
                    use_pallas=True)


def test_row_ptr_is_csr_of_near_list():
    n = 3000
    cfg = SimConfig(fmm_order=3, tree_radius=1.7)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(_beam(n, cfg))
    rp = np.asarray(fs.p2p_row_ptr)
    tgt = np.asarray(fs.p2p_tgt)[:rp[-1]]
    assert rp.shape == (eng.G_sub + 1,) and rp[0] == 0
    assert np.all(np.diff(rp) >= 0)
    assert rp[-1] == int(np.sum(np.asarray(fs.p2p_valid)))
    np.testing.assert_array_equal(np.repeat(np.arange(eng.G_sub),
                                            np.diff(rp)), tgt)
