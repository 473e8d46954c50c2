"""Uniform-grid octree/quadtree FMM engines (2D and 3D).

Reference capability: fmm_cart.cuh (2D quadtree FMM), fmm_cart3_symmetric /
fmm_cart3_traceless.cuh (3D octree FMM), and appel.cuh (monopole tree = the
p=1 degenerate case).  Everything about the uniform grid
is STATIC, so there is no traversal at all:

  * cells are Morton-indexed (parent = id >> dim) over a bounding cube;
    particles bin with one device sort per rebuild;
  * M2M/L2L use 2^dim constant sibling matrices (one matmul each);
  * M2L is the classic parent-neighbourhood-minus-own-neighbourhood stencil
    (fmm_cart.cuh:214-286): per offset class o in [-3,3]^dim a constant
    [S_M, S_Lt] matrix applied as a masked grid-shift matmul; the per-axis
    parity masks (child-of-neighbour-parent condition) are precomputed
    host-side per level;
  * P2P runs over the 3^dim neighbour shifts on fixed-capacity padded cell
    blocks (capacity = next pow2 of the observed max occupancy).

Variants:
  * multipole storage "symmetric" (default — like the kd engine), and the
    level heuristic L = round(log2(dens_inhom * n / p^2) / dim) mirroring
    fmm_cart3_symmetric.cuh:435.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.ops.multipole import operators as mop
from coulomb_oscillators.ops.multipole.operators import PREC
from coulomb_oscillators.ops.multipole.tables import build_tables

FAR = 1e18


def auto_level_octree(n: int, p: int, dim: int, dens_inhom: float = 1.0,
                      tree_L: int = 0) -> int:
    """L = round(log2(dens*n/p^2)/dim) (fmm_cart3_symmetric.cuh:435),
    clamped so the grid stays moderate."""
    if tree_L > 0:
        return max(1, tree_L)
    L = int(round(math.log2(max(dens_inhom * n / (p * p), 1.0)) / dim))
    return max(2, min(L, 8 if dim == 3 else 11))


# --------------------------------------------------------------------------- #
# static structure
# --------------------------------------------------------------------------- #


def _morton_decode(ids: np.ndarray, bits: int, dim: int) -> np.ndarray:
    out = np.zeros((ids.shape[0], dim), dtype=np.int64)
    for b in range(bits):
        for a in range(dim):
            out[:, a] |= ((ids >> (b * dim + a)) & 1) << b
    return out


@functools.lru_cache(maxsize=16)
def _grid_static(dim: int, L: int, R: int = 1):
    """Per-level static maps: morton<->row-major grid, M2L masks/offsets,
    P2P neighbour maps (built at leaf level).

    R is the integer interaction radius (the reference's `tree_radius`,
    appel.cuh:260-381, 420-467: cells within Chebyshev distance R are near
    neighbours; the M2L window is children-of-parent-neighbours minus own
    neighbours, i.e. offsets in [-(2R+1), 2R+1]^dim with |o|_inf > R)."""
    levels = []
    for l in range(L + 1):
        side = 1 << l
        cells = side ** dim
        ids = np.arange(cells, dtype=np.int64)
        coords = _morton_decode(ids, l, dim) if l else np.zeros((1, dim), np.int64)
        # row-major flat index of each morton cell
        flat = np.zeros(cells, dtype=np.int64)
        for a in range(dim):
            flat = flat * side + coords[:, a]
        # inverse: morton id of each row-major slot
        inv = np.empty(cells, dtype=np.int64)
        inv[flat] = ids
        levels.append({"coords": coords, "to_grid": flat, "from_grid": inv})
    # M2L offset classes: o in [-(2R+1), 2R+1]^dim, |o|_inf > R
    offsets = []
    rng = range(-(2 * R + 1), 2 * R + 2)
    import itertools
    for o in itertools.product(*([rng] * dim)):
        if max(abs(x) for x in o) > R:
            offsets.append(o)
    # P2P neighbour offsets (incl. self)
    nbrs = [o for o in itertools.product(*([range(-R, R + 1)] * dim))]
    return levels, tuple(offsets), tuple(nbrs)


def _axis_mask(side: int, o: int, R: int = 1) -> np.ndarray:
    """valid(i) = |floor((i+o)/2) - floor(i/2)| <= R and 0 <= i+o < side
    (the per-axis children-of-parent-neighbours condition)."""
    i = np.arange(side)
    j = i + o
    ok = (j >= 0) & (j < side) & (np.abs(j // 2 - i // 2) <= R)
    return ok.astype(np.float32)


class OctState(NamedTuple):
    """Frozen between rebuilds."""
    perm: jax.Array          # [n] sorted order
    key: jax.Array           # [n] leaf morton id per sorted particle
    origin: jax.Array        # [dim] box origin
    cw: jax.Array            # [] leaf cell width
    rank: jax.Array          # [n] rank of particle within its cell
    counts: jax.Array        # [cells_L] occupancy


class OctreeFmmEngine:
    """Uniform-grid FMM engine for quasi-uniform distributions.

    Engine names: "fmm2" (dim=2 quadtree), "fmm3" (3D octree, symmetric
    multipoles), "fmm3_traceless" (harmonic-projected multipole storage,
    2m+1 coefficients per order — numerically identical far field, smaller
    multipole arrays), "appel" (monopole-grade, p=2).
    """

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 cell_cap: int = 0, multipole_storage: str = "symmetric"):
        self.config = config
        self.n = n
        self.dim = config.dim
        self.p = max(config.fmm_order, 2)
        self.L = L or auto_level_octree(n, self.p, self.dim,
                                        config.dens_inhom, config.tree_L)
        self.tables = build_tables(self.dim, self.p)
        # integer interaction radius (the -r flag, appel.cuh:260-381): any
        # integer R >= 1, as in the reference's neighbourhood loops.  R=2
        # doubles the near neighbourhood and pushes the M2L window out to
        # |o| in (2, 5], roughly halving the worst-case opening ratio —
        # measurably more accurate at the same p (tests/test_octree.py,
        # monotone through R=3).  Cost: (4R+3)^dim - (2R+1)^dim stencil
        # classes in the M2L lax.scan, so compile time grows ~R^dim.
        self.R = max(int(round(config.tree_radius)), 1)
        self.levels, self.offsets, self.nbrs = _grid_static(self.dim, self.L,
                                                            self.R)
        self.cell_cap = cell_cap  # 0 = choose at build
        # "traceless": store multipoles as harmonic projections with 2m+1
        # (3D) coefficients per order — the fmm_cart3_traceless.cuh variant.
        # Lossless for M2L (contractions against traceless harmonics) and
        # for M2M (projection commutes with shifts modulo trace terms).
        self.multipole_storage = multipole_storage
        self._k_m2m = None
        self._k_m2l = None
        self._k_l2l = None
        self._p2m_proj = None
        self._force_jit = {}

    # ---------- constant operator matrices ----------
    def _sibling_geometry(self):
        """Normalized sibling shift vectors and rho for M2M/L2L."""
        dim = self.dim
        sib = self.levels[1]["coords"]                     # [2^dim, dim]
        # child center offset from parent center, in parent cell widths:
        # (+-1/4 per axis); lam_parent = sqrt(dim)/2 * cw_parent
        off = (sib.astype(np.float64) - 0.5) / 2.0         # +-1/4
        lam_parent = math.sqrt(dim) / 2.0
        s = off / lam_parent
        rho = 0.5
        return jnp.asarray(s, jnp.float32), rho

    def _build_matrices(self):
        t = self.tables
        dim = self.dim
        nsib = 1 << dim
        s, rho = self._sibling_geometry()
        eyeM = jnp.eye(t.S_M, dtype=jnp.float32)
        # op(eye) rows are images of basis vectors, i.e. K is [in, out]:
        # apply as  out = vec @ K.
        Ks = []
        for c in range(nsib):
            K = mop.m2m(t, eyeM, jnp.broadcast_to(s[c], (t.S_M, dim)),
                        jnp.full((t.S_M,), rho))
            Ks.append(K)                                    # [in, out]
        self._k_m2m = jnp.stack(Ks)                        # [nsib, S_M, S_M]
        # L2L: parent->child with shift s_c (in parent units), rho=1/2
        eyeL = jnp.eye(t.S_Lt, dtype=jnp.float32)
        Ks = []
        for c in range(nsib):
            K = mop.l2l(t, eyeL, jnp.broadcast_to(s[c], (t.S_Lt, dim)),
                        jnp.full((t.S_Lt,), rho))
            Ks.append(K)
        self._k_l2l = jnp.stack(Ks)                        # [nsib, S_Lt, S_Lt]
        # M2L: per offset class, at unit cell width; lam = sqrt(dim)/2
        lam = math.sqrt(dim) / 2.0
        O = jnp.asarray(np.array(self.offsets, np.float64), jnp.float32)
        nO = O.shape[0]
        Ks = []
        for c in range(nO):
            # R = x_tgt - x_src = -offset (offset points source-ward).
            # 2D note: the -log r monopole correction in m2l is evaluated at
            # unit cell width; the per-level -log(cw) shift affects only the
            # potential constant, not fields.
            K = mop.m2l(t, eyeM, jnp.broadcast_to(-O[c], (t.S_M, dim)),
                        jnp.full((t.S_M,), lam), jnp.full((t.S_M,), lam))
            Ks.append(K)                                    # [S_M, S_Lt]
        self._k_m2l = jnp.stack(Ks)                        # [nO, S_M, S_Lt]

        if self.multipole_storage == "traceless":
            from coulomb_oscillators.ops.multipole import packing as pk
            R = jnp.asarray(pk.traceless_extend_layout(t.PM, dim),
                            jnp.float32)                    # [S_Mf, S_Mt]
            P = jnp.asarray(pk.traceless_project_layout(t.PM, dim),
                            jnp.float32)                    # [S_Mt, S_Mf]
            self._p2m_proj = P.T                            # fold after p2m
            # row-vector composition: out = vec_trc @ (R^T K P^T)
            self._k_m2m = jnp.einsum("fa,cfj,bj->cab", R, self._k_m2m, P,
                                     precision=PREC)
            self._k_m2l = jnp.einsum("fa,cfl->cal", R, self._k_m2l,
                                     precision=PREC)

    # ---------- build ----------
    def build(self, pos: jax.Array) -> OctState:
        if self._k_m2m is None:
            self._build_matrices()
        n, dim, L = self.n, self.dim, self.L
        key, perm, origin, cw = _bin_particles(pos, n, L, dim)
        counts = jnp.zeros((1 << (dim * L),), jnp.int32).at[key].add(1)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(n, dtype=jnp.int32) - starts[key].astype(jnp.int32)
        maxocc = int(jnp.max(counts))
        cap = self.cell_cap
        if cap == 0 or maxocc > cap:
            cap = 1 << int(math.ceil(math.log2(max(maxocc, 4))))
            self.cell_cap = cap
        return OctState(perm=perm, key=key, origin=origin, cw=cw,
                        rank=rank, counts=counts)

    # ---------- force ----------
    def force(self, pos: jax.Array, st: OctState) -> jax.Array:
        cap = self.cell_cap
        fn = self._force_jit.get(cap)
        if fn is None:
            fn = jax.jit(functools.partial(self._force_impl, cap=cap))
            self._force_jit[cap] = fn
        return fn(pos, st)

    def force_in_jit(self, pos: jax.Array, st: OctState) -> jax.Array:
        """Traceable force (for composition inside an outer jit)."""
        return self._force_impl(pos, st, cap=self.cell_cap)

    def _force_impl(self, pos: jax.Array, st: OctState, cap: int):
        t = self.tables
        n, dim, L = self.n, self.dim, self.L
        dtype = pos.dtype
        eps2 = dtype.type(self.config.eps2)
        kappa = dtype.type(self.config.kappa(n))
        cellsL = 1 << (dim * L)
        sqrt_dim = math.sqrt(dim)

        pos_s = pos[st.perm]
        coordsL = jnp.asarray(self.levels[L]["coords"], jnp.float32)
        center_of = st.origin[None, :] + (coordsL + 0.5) * st.cw
        lam_L = 0.5 * sqrt_dim * st.cw

        # ---- P2M at leaves ----
        e = (pos_s - jnp.take(center_of, st.key, axis=0)) / lam_L
        contrib = mop.p2m_contrib(t, e)
        if self._p2m_proj is not None:
            contrib = jnp.matmul(contrib, self._p2m_proj, precision=PREC)
        M_lvl = [None] * (L + 1)
        M_lvl[L] = jax.ops.segment_sum(contrib, st.key, num_segments=cellsL,
                                       indices_are_sorted=True)

        # ---- M2M up ----
        nsib = 1 << dim
        SM = self._k_m2m.shape[1]  # stored multipole width
        for l in range(L - 1, -1, -1):
            child = M_lvl[l + 1].reshape(-1, nsib, SM)
            acc = None
            for c in range(nsib):
                part = jnp.matmul(child[:, c, :], self._k_m2m[c], precision=PREC)
                acc = part if acc is None else acc + part
            M_lvl[l] = acc

        # ---- M2L per level: lax.scan over the ~316 stencil classes so the
        # program stays small (an unrolled version exceeded the compiler's
        # size limits at deep levels) ----
        nO = len(self.offsets)
        offs = jnp.asarray(np.array(self.offsets, np.int32))   # [nO, dim]
        L_lvl = [jnp.zeros((1 << (dim * l), t.S_Lt), dtype)
                 for l in range(L + 1)]
        for l in range(2, L + 1):
            side = 1 << l
            lv = self.levels[l]
            cw_l = st.cw * (1 << (L - l))
            Mg = jnp.take(M_lvl[l], jnp.asarray(lv["from_grid"]), axis=0)
            Mg = Mg.reshape((side,) * dim + (SM,))
            # zero-pad by 2R+1 on each side: class windows slice the pad
            pad = 2 * self.R + 1
            Mp = jnp.pad(Mg, [(pad, pad)] * dim + [(0, 0)])
            masks = np.stack(
                [np.stack([_axis_mask(side, o[a], self.R)
                           for a in range(dim)])
                 for o in self.offsets])                       # [nO, dim, side]
            masks_j = jnp.asarray(masks)

            def m2l_class(Lg, args):
                o, K, mk = args
                starts = tuple(o[a] + pad for a in range(dim)) + (0,)
                src = jax.lax.dynamic_slice(
                    Mp, starts, (side,) * dim + (SM,))
                contrib = jnp.matmul(src, K, precision=PREC)
                m = mk[0]
                for a in range(1, dim):
                    m = m[..., None] * mk[a]
                return Lg + contrib * m[..., None], None

            Lg0 = jnp.zeros((side,) * dim + (t.S_Lt,), dtype)
            Lg, _ = jax.lax.scan(m2l_class, Lg0,
                                 (offs, self._k_m2l, masks_j))
            scale = (1.0 / cw_l) if dim == 3 else 1.0
            L_lvl[l] = L_lvl[l] + scale * jnp.take(
                Lg.reshape(-1, t.S_Lt), jnp.asarray(lv["to_grid"]), axis=0)

        # ---- L2L down ----
        for l in range(1, L + 1):
            parent = L_lvl[l - 1]
            out = []
            for c in range(nsib):
                out.append(jnp.matmul(parent, self._k_l2l[c], precision=PREC))
            shifted = jnp.stack(out, axis=1).reshape(-1, t.S_Lt)
            L_lvl[l] = L_lvl[l] + shifted

        # ---- L2P ----
        w = e  # same normalized offsets
        Lt_part = jnp.take(L_lvl[L], st.key, axis=0)
        lam_vec = jnp.full((n,), lam_L, dtype)
        acc_far = mop.l2p_field(t, Lt_part, w, lam_vec)

        # ---- P2P over neighbour shifts ----
        pad_slot = st.key.astype(jnp.int64) * cap + st.rank
        pos_pad = jnp.full((cellsL * cap, dim), dtype.type(FAR))
        pos_pad = pos_pad.at[pad_slot].set(pos_s).reshape(cellsL, cap, dim)
        lvL = self.levels[L]
        sideL = 1 << L
        grid_of = jnp.asarray(lvL["to_grid"])       # morton -> rowmajor
        acc_near_pad = jnp.zeros((cellsL, cap, dim), dtype)
        # neighbour morton id per offset (precomputed static maps)
        coords = self.levels[L]["coords"]
        flat = np.zeros(cellsL, dtype=np.int64)
        for o in self.nbrs:
            nb = coords + np.asarray(o)
            ok = np.all((nb >= 0) & (nb < sideL), axis=1)
            fl = np.zeros(cellsL, dtype=np.int64)
            for a in range(dim):
                fl = fl * sideL + np.clip(nb[:, a], 0, sideL - 1)
            nb_m = np.asarray(self.levels[L]["from_grid"])[fl]
            nb_m = np.where(ok, nb_m, cellsL)  # dummy
            src_idx = jnp.asarray(np.minimum(nb_m, cellsL - 1))
            valid = jnp.asarray(ok.astype(np.float32))
            P_s = pos_pad[src_idx]                          # [cells, cap, d]
            dist2 = eps2
            ds = []
            for a in range(dim):
                da = pos_pad[:, :, None, a] - P_s[:, None, :, a]
                ds.append(da)
                dist2 = dist2 + da * da
            inv = 1.0 / dist2
            wgt = inv * jax.lax.rsqrt(dist2) if dim == 3 else inv
            wgt = wgt * valid[:, None, None]
            f = jnp.stack([jnp.sum(ds[a] * wgt, axis=2) for a in range(dim)],
                          axis=-1)
            acc_near_pad = acc_near_pad + f
        acc_near = acc_near_pad.reshape(cellsL * cap, dim)[pad_slot]

        acc_s = (acc_far + acc_near) * kappa
        return jnp.zeros_like(acc_s).at[st.perm].set(acc_s)


@functools.partial(jax.jit, static_argnames=("n", "L", "dim"))
def _bin_particles(pos, n, L, dim):
    mn = jnp.min(pos, axis=0)
    mx = jnp.max(pos, axis=0)
    extent = jnp.max(mx - mn) * 1.0001
    origin = 0.5 * (mn + mx) - 0.5 * extent
    cw = extent / (1 << L)
    # int32 keys: dim*L <= 24 bits by the level clamp in auto_level_octree
    q = jnp.clip(((pos - origin) / cw).astype(jnp.int32), 0, (1 << L) - 1)
    key = jnp.zeros(n, dtype=jnp.int32)
    for b in range(L):
        for a in range(dim):
            key = key | (((q[:, a] >> b) & 1) << (b * dim + a))
    perm = jnp.argsort(key).astype(jnp.int32)
    return key[perm], perm, origin, cw
