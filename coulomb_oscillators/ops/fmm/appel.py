"""Appel monopole tree engine (2D and 3D).

Reference capability: appel.cuh:529-673 — a uniform-grid tree with a
monopole-only far field: per-cell charge + center of charge (centerLeaves,
appel.cuh:226-258), cell-cell interactions over the parent-neighbourhood
stencil accumulating a *constant field* per cell (c2c2, appel.cuh:420-467),
pushed down by plain addition (pushl, :469-489) and applied to particles
(pushLeaves, :491-504); near field over the (2R+1)^dim neighbour cells where
R is the integer interaction radius, the -radius flag (p2p2/p2p3, :260-381).

Design differences from the octree FMM engine (octree.py):
  * the far-field interaction uses the actual centers of charge, not cell
    centers, exactly like the reference — the monopole-about-COC expansion
    has no dipole error term, which is what makes a pure monopole tree
    usable at all;
  * because COC geometry varies per pair, M2L-class matrices don't apply;
    each stencil class is instead a masked grid-shift + elementwise
    field evaluation F += q_src * R / |R|^(dim) (3D: R/|R|^3; 2D: R/|R|^2),
    vectorized over the whole level grid;
  * locals are a constant field [dim] per cell: L2L is a gather-add down
    the levels, L2P is a broadcast add.

Shares the Morton binning, neighbour maps and P2P structure of octree.py.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.ops.fmm import octree as oc
from coulomb_oscillators.ops.fmm.octree import (OctState, _bin_particles,
                                                    _grid_static, _axis_mask,
                                                    FAR)


class AppelEngine:
    """Monopole tree-code engine (engine name: "appel").

    The near-field neighbourhood and the c2c exclusion window scale with
    the integer interaction radius R = round(config.tree_radius), any
    R >= 1 — the reference's ``-radius`` knob (appel.cuh:260-381 passes
    it into p2p2/p2p3 and c2c2 as the neighbourhood half-width).  R=2
    roughly halves the worst-case opening ratio of the monopole stencil,
    trading a (2R+1)^dim near field for measurably lower force error
    (tests/test_octree.py, monotone through R=3)."""

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 cell_cap: int = 0):
        self.config = config
        self.n = n
        self.dim = config.dim
        # level heuristic as the octree engine at p=2 (appel.cuh:560 uses
        # a similar density-based choice)
        self.L = L or oc.auto_level_octree(n, 2, self.dim,
                                           config.dens_inhom, config.tree_L)
        self.R = max(int(round(config.tree_radius)), 1)
        self.levels, self.offsets, self.nbrs = _grid_static(self.dim, self.L,
                                                            self.R)
        self.cell_cap = cell_cap
        self._force_jit = {}

    # ---------- build ----------
    def build(self, pos: jax.Array) -> OctState:
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
        return self._force_impl(pos, st, cap=self.cell_cap)

    def _force_impl(self, pos: jax.Array, st: OctState, cap: int):
        n, dim, L = self.n, self.dim, self.L
        dtype = pos.dtype
        eps2 = dtype.type(self.config.eps2)
        kappa = dtype.type(self.config.kappa(n))
        cellsL = 1 << (dim * L)
        nsib = 1 << dim
        pos_s = pos[st.perm]

        # ---- per-level monopoles: charge count q and center of charge ----
        # (monopoleLeaves + centerLeaves, appel.cuh:214-258, then the same
        # reduction applied up the levels like buildTree2, :383-418)
        ones = jnp.ones((n,), dtype)
        q_lvl = [None] * (L + 1)
        s_lvl = [None] * (L + 1)              # charge-weighted position sums
        q_lvl[L] = jax.ops.segment_sum(ones, st.key, num_segments=cellsL,
                                       indices_are_sorted=True)
        s_lvl[L] = jax.ops.segment_sum(pos_s, st.key, num_segments=cellsL,
                                       indices_are_sorted=True)
        for l in range(L - 1, -1, -1):
            q_lvl[l] = q_lvl[l + 1].reshape(-1, nsib).sum(axis=1)
            s_lvl[l] = s_lvl[l + 1].reshape(-1, nsib, dim).sum(axis=1)
        coc_lvl = [s / jnp.maximum(q, 1.0)[:, None]
                   for q, s in zip(q_lvl, s_lvl)]

        # ---- c2c: per level, per stencil class, field from source
        # monopole at target COC (c2c2, appel.cuh:420-467) ----
        F_lvl = [jnp.zeros((1 << (dim * l), dim), dtype)
                 for l in range(L + 1)]
        for l in range(2, L + 1):
            side = 1 << l
            lv = self.levels[l]
            from_grid = jnp.asarray(lv["from_grid"])
            to_grid = jnp.asarray(lv["to_grid"])
            qg = jnp.take(q_lvl[l], from_grid, axis=0)
            cg = jnp.take(coc_lvl[l], from_grid, axis=0)
            qg = qg.reshape((side,) * dim)
            cg = cg.reshape((side,) * dim + (dim,))
            pad = 2 * self.R + 1
            qp = jnp.pad(qg, [(pad, pad)] * dim)
            cp = jnp.pad(cg, [(pad, pad)] * dim + [(0, 0)])
            offs = jnp.asarray(np.array(self.offsets, np.int32))
            masks = np.stack(
                [np.stack([_axis_mask(side, o[a], self.R)
                           for a in range(dim)])
                 for o in self.offsets])
            masks_j = jnp.asarray(masks)

            def c2c_class(Fg, args):
                o, mk = args
                starts = tuple(o[a] + pad for a in range(dim))
                q_src = jax.lax.dynamic_slice(qp, starts, (side,) * dim)
                c_src = jax.lax.dynamic_slice(cp, starts + (0,),
                                              (side,) * dim + (dim,))
                R = cg - c_src
                dist2 = jnp.sum(R * R, axis=-1) + eps2
                r = jax.lax.rsqrt(dist2)
                w = (r * r * r if dim == 3 else r * r) * q_src
                m = mk[0]
                for a in range(1, dim):
                    m = m[..., None] * mk[a]
                return Fg + R * (w * m)[..., None], None

            Fg0 = jnp.zeros((side,) * dim + (dim,), dtype)
            Fg, _ = jax.lax.scan(c2c_class, Fg0, (offs, masks_j))
            F_lvl[l] = F_lvl[l] + jnp.take(Fg.reshape(-1, dim), to_grid,
                                           axis=0)

        # ---- push the constant field down (pushl, appel.cuh:469-489) ----
        for l in range(3, L + 1):
            parent = jnp.repeat(F_lvl[l - 1], nsib, axis=0)
            F_lvl[l] = F_lvl[l] + parent

        # ---- L2P: apply leaf field to particles (pushLeaves, :491-504) ----
        acc_far = jnp.take(F_lvl[L], st.key, axis=0)

        # ---- P2P over neighbour shifts (p2p2/p2p3, :260-381) ----
        # int32 slot arithmetic: int64 is unavailable without jax_enable_x64
        # and would silently truncate; build() asserts cellsL*cap < 2^31
        assert cellsL * cap < 2 ** 31, (
            f"padded slot space {cellsL}*{cap} overflows int32; lower "
            f"tree_L or cell_cap")
        pad_slot = st.key.astype(jnp.int32) * np.int32(cap) + st.rank
        pos_pad = jnp.full((cellsL * cap, dim), dtype.type(FAR))
        pos_pad = pos_pad.at[pad_slot].set(pos_s).reshape(cellsL, cap, dim)
        sideL = 1 << L
        coords = self.levels[L]["coords"]
        acc_near_pad = jnp.zeros((cellsL, cap, dim), dtype)
        for o in self.nbrs:
            nb = coords + np.asarray(o)
            ok = np.all((nb >= 0) & (nb < sideL), axis=1)
            fl = np.zeros(cellsL, dtype=np.int64)
            for a in range(dim):
                fl = fl * sideL + np.clip(nb[:, a], 0, sideL - 1)
            nb_m = np.asarray(self.levels[L]["from_grid"])[fl]
            src_idx = jnp.asarray(np.minimum(np.where(ok, nb_m, cellsL),
                                             cellsL - 1))
            valid = jnp.asarray(ok.astype(np.float32))
            P_s = pos_pad[src_idx]
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
