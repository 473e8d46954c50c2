"""Particle-sharded multi-chip kd-FMM: leaf blocks distributed over the mesh.

Round-1's `fmm_shard` replicated positions and sharded only the pair loops;
it could not reach larger N than one chip holds.  This module shards the
*state*: the padded leaf blocks [G, C, dim] (= the particles, in tree order)
live sharded along the mesh axis, device d owning the contiguous leaf run
[d*G/P, (d+1)*G/P) — which is exactly n/P particles because the kd tree is
equal-count.  Per force evaluation the collectives are:

  * one `all_gather` of the leaf multipoles [G/P, S_M] (tiny — multipoles,
    not positions) feeding a replicated M2M/M2L/L2L upper tree, with one
    `psum` of the local heap to combine the sharded M2L pair loop;
  * a systolic near-field: P2P pair lists are grouped at build time by
    source-device offset ("hop"); the local position blocks rotate around
    the ring via `ppermute` and each hop's pairs are processed against the
    visiting block.  kd order is spatial, so almost all pairs are hop 0
    and the halo traffic is one or two neighbor blocks over the device links.

Reference analogue: none (single GPU, SURVEY.md §2.7 item 8); this is the
scale-out axis demanded by SURVEY.md §5 (distributed comm:
particle sharding for P2P, shared tree via collectives for M2L).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from coulomb_oscillators.ops.fmm.kdtree import (FmmState, KdFmmEngine,
                                                    _heap_off)


class PShardLists(NamedTuple):
    """Device arrays of the sharded pair lists (leading axis = mesh)."""
    # near-field, per hop h: targets/sources as LOCAL leaf ids in [0, Gl)
    p2p_tgt: Tuple[jax.Array, ...]   # each [ndev, Kh]
    p2p_src: Tuple[jax.Array, ...]
    p2p_val: Tuple[jax.Array, ...]
    # far-field: even split of the global DIRECTED M2L list (psum-combined)
    m2l_tgt: jax.Array               # [ndev, Km]
    m2l_src: jax.Array
    m2l_val: jax.Array
    m2l_h2: jax.Array                # [ndev, Km, S_H] folded geometry
    m2l_w: jax.Array                 # [ndev, Km]
    m2l_logc: jax.Array              # [ndev, Km]
    m2l_gtgt: jax.Array              # [ndev, Km/g] grouped-M2L targets
                                     # (group runs never straddle the even
                                     # split: Km is a chunk multiple)


def _signed_hop(dev_src: np.ndarray, dev_tgt: np.ndarray, ndev: int):
    """Shortest-way-around device offset in [-ndev/2, ndev/2)."""
    return ((dev_src - dev_tgt + ndev // 2) % ndev) - ndev // 2


def shard_pair_lists(eng: KdFmmEngine, fs: FmmState, ndev: int,
                     ) -> Tuple[PShardLists, Tuple[int, ...]]:
    """Host-side regrouping of fs's pair lists for an ndev-way mesh.

    Returns (lists, hops) where hops is the sorted tuple of signed source
    offsets present in the near field (always includes 0).  Rebuild-time
    only — O(pairs) numpy work.
    """
    G = 1 << eng.L
    assert G % ndev == 0, f"sub-leaf count {G} not divisible by mesh {ndev}"
    Gl = G // ndev
    Gb = eng.G_blk
    assert Gb % ndev == 0, f"block count {Gb} not divisible by mesh {ndev}"
    Glb = Gb // ndev

    shift = eng.mask_shift
    blkmask = (1 << shift) - 1
    p2p_t = np.asarray(fs.p2p_tgt)
    p2p_s = np.asarray(fs.p2p_src)
    p2p_v = np.asarray(fs.p2p_valid)
    t = p2p_t[p2p_v]
    s_u = p2p_s[p2p_v].view(np.uint32).astype(np.int64)  # packed blk|mask
    s = s_u & blkmask                  # source BLOCK ids
    mbits = s_u >> shift
    dev_t = t // Gl
    hop = _signed_hop(s // Glb, dev_t, ndev)
    hops = sorted(set(np.unique(hop).tolist()) | {0})

    # monotone per-hop capacities: pair-list shapes must not shrink across
    # rebuilds or the jitted scan retraces every window (advisor round 2)
    caps = getattr(eng, "_pshard_caps", None)
    if caps is None:
        caps = eng._pshard_caps = {}

    tgt_h, src_h, val_h = [], [], []
    for h in hops:
        sel = hop == h
        th, sh, dh = t[sel], s[sel], dev_t[sel]
        mh = mbits[sel]
        counts = np.bincount(dh, minlength=ndev)
        Kh = max(int(counts.max()) if counts.size else 0, 1)
        Kh = -(-Kh // 8) * 8
        Kh = caps[h] = max(Kh, caps.get(h, 0))
        tt = np.full((ndev, Kh), Gl, np.int32)     # Gl = dummy row
        ss = np.zeros((ndev, Kh), np.int32)
        vv = np.zeros((ndev, Kh), bool)
        order = np.argsort(dh, kind="stable")
        th, sh, dh, mh = th[order], sh[order], dh[order], mh[order]
        starts = np.searchsorted(dh, np.arange(ndev))
        ranks = np.arange(th.size) - starts[dh]
        tt[dh, ranks] = th % Gl
        ss[dh, ranks] = ((sh % Glb) | (mh << shift)).astype(
            np.uint32).view(np.int32)
        vv[dh, ranks] = True
        # sort each device's row by local target for segment_sum locality
        rowo = np.argsort(tt + (~vv) * G, axis=1, kind="stable")
        tgt_h.append(jnp.asarray(np.take_along_axis(tt, rowo, 1)))
        src_h.append(jnp.asarray(np.take_along_axis(ss, rowo, 1)))
        val_h.append(jnp.asarray(np.take_along_axis(vv, rowo, 1)))

    # M2L split: the fs arrays are cap-padded on device (incl. the big
    # precomputed geometry) — reshape-split them WITHOUT a host round-trip
    Km = fs.m2l_tgt.shape[0]
    assert Km % ndev == 0, f"m2l cap {Km} not divisible by mesh {ndev}"
    Kml = Km // ndev

    # fly-mode M2L (eng.m2l_fly) stores geometry placeholders — replicate
    # tiny zeros per device; the scan body recomputes from center/lam
    folded = fs.m2l_h2.shape[0] == Km
    lists = PShardLists(
        p2p_tgt=tuple(tgt_h), p2p_src=tuple(src_h), p2p_val=tuple(val_h),
        m2l_tgt=fs.m2l_tgt.reshape(ndev, Kml),
        m2l_src=fs.m2l_src.reshape(ndev, Kml),
        m2l_val=fs.m2l_valid.reshape(ndev, Kml),
        m2l_h2=(fs.m2l_h2.reshape(ndev, Kml, -1) if folded
                else jnp.zeros((ndev, 1, 1), jnp.float32)),
        m2l_w=(fs.m2l_w.reshape(ndev, Kml) if folded
               else jnp.zeros((ndev, 1), jnp.float32)),
        m2l_logc=(fs.m2l_logc.reshape(ndev, Kml) if folded
                  else jnp.zeros((ndev, 1), jnp.float32)),
        m2l_gtgt=fs.m2l_gtgt.reshape(ndev, -1)
        if fs.m2l_gtgt.shape[0] % ndev == 0 and fs.m2l_gtgt.shape[0] > 1
        else jnp.zeros((ndev, 1), jnp.int32))
    return lists, tuple(hops)


class PShardedKdFmm:
    """Particle-sharded force on padded leaf blocks.

    Usage:
        ps = PShardedKdFmm(eng, mesh)
        ppad = ps.shard_padded(eng.pad_array(pos, fs, fill=FAR))
        lists, hops = shard_pair_lists(eng, fs, ps.ndev)
        acc_pad = ps.force_padded(ppad, fs, lists, hops)   # sharded [G,C,dim]
    """

    def __init__(self, eng: KdFmmEngine, mesh: Mesh, axis: str = "dp"):
        self.eng = eng
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        G = 1 << eng.L
        assert G % self.ndev == 0
        self.Gl = G // self.ndev
        self._forces = {}    # hops signature -> jitted shard_map fn
        self.block_sharding = NamedSharding(mesh, P(axis, None, None))

    def shard_padded(self, xpad: jax.Array) -> jax.Array:
        """Place a padded [G, C, k] array sharded over leaf blocks."""
        return jax.device_put(xpad, self.block_sharding)

    def force_padded(self, ppad: jax.Array, fs: FmmState,
                     lists: PShardLists, hops: Tuple[int, ...]) -> jax.Array:
        return self._force_for(hops)(ppad, fs, lists)

    # ------------------------------------------------------------------ #
    def _force_for(self, hops: Tuple[int, ...]):
        fn = self._forces.get(hops)
        if fn is None:
            fn = self._build_force(hops)
            self._forces[hops] = fn
        return fn

    def _build_force(self, hops: Tuple[int, ...]):
        eng = self.eng
        axis = self.axis
        ndev = self.ndev
        Gl = self.Gl
        L = eng.L
        G = 1 << L
        dim = eng.dim
        C = eng.st.C
        ps_Glb = self.Gl >> eng.sub_depth
        leaf0 = _heap_off(L)
        mask_full = np.asarray(eng.st.pad_mask).reshape(G, C)
        kappa = float(eng.config.kappa(eng.n))
        eps2 = float(eng.config.eps2)
        hpos = sorted(h for h in hops if h > 0)
        hneg = sorted((-h for h in hops if h < 0))

        Glb = ps_Glb
        CB = C << eng.sub_depth

        def p2p_hop(acc, ppad_tgt, blk, tgt, src, val, dtype):
            """One hop's pair list against the visiting source shard
            (reshaped to 128-lane blocks)."""
            blk = blk.reshape(Glb, CB, dim)
            Q = tgt.shape[0]
            pchunk = min(eng.p2p_chunk, Q)
            qpad = -(-Q // pchunk) * pchunk
            tgt_c = jnp.pad(tgt, (0, qpad - Q),
                            constant_values=Gl).reshape(-1, pchunk)
            src_c = jnp.pad(src, (0, qpad - Q)).reshape(-1, pchunk)
            val_c = jnp.pad(val, (0, qpad - Q)).reshape(-1, pchunk)

            shift = eng.mask_shift
            bmask = (1 << shift) - 1
            group = jnp.arange(CB, dtype=jnp.int32) // C

            def body(a, args):
                ti, si, vv = args
                mb = ((si[:, None] >> (shift + group[None, :])) & 1)
                P_t = jnp.take(ppad_tgt, jnp.minimum(ti, Gl - 1), axis=0)
                P_s = jnp.take(blk, si & bmask, axis=0)
                dist2 = dtype.type(eps2)
                ds = []
                for ax in range(dim):
                    da = P_t[:, :, None, ax] - P_s[:, None, :, ax]
                    ds.append(da)
                    dist2 = dist2 + da * da
                r = jax.lax.rsqrt(dist2)
                wgt = (r * r * r if dim == 3 else r * r)
                wgt = wgt * (vv[:, None, None] & (mb[:, None, :] > 0))
                f = jnp.stack([jnp.sum(ds[ax] * wgt, axis=2)
                               for ax in range(dim)], axis=-1)
                part = jax.ops.segment_sum(f, ti, num_segments=Gl + 1,
                                           indices_are_sorted=True)
                return a + part, None

            out, _ = jax.lax.scan(body, acc, (tgt_c, src_c, val_c))
            return out

        def impl(ppad_l, mask_l, fs, lists):
            dtype = ppad_l.dtype
            d = jax.lax.axis_index(axis)
            lo = d * Gl
            leafc_l = jax.lax.dynamic_slice_in_dim(
                fs.center, leaf0, G, 0)
            leafl_l = jax.lax.dynamic_slice_in_dim(fs.lam, leaf0, G, 0)
            myc = jax.lax.dynamic_slice_in_dim(leafc_l, lo, Gl, 0)
            myl = jax.lax.dynamic_slice_in_dim(leafl_l, lo, Gl, 0)

            # ---- far field: gathered multipoles, replicated upper tree ----
            mp_leaf_l = eng.p2m_blocks(ppad_l, mask_l, myc, myl)  # [Gl, S_M]
            mp_leaf = jax.lax.all_gather(mp_leaf_l, axis, tiled=True)
            mpole_heap = eng.m2m_up(mp_leaf, fs)
            fs_m2l = fs._replace(m2l_tgt=lists.m2l_tgt[0],
                                 m2l_src=lists.m2l_src[0],
                                 m2l_valid=lists.m2l_val[0],
                                 m2l_h2=lists.m2l_h2[0],
                                 m2l_w=lists.m2l_w[0],
                                 m2l_logc=lists.m2l_logc[0],
                                 m2l_gtgt=lists.m2l_gtgt[0])
            local_heap = jax.lax.psum(eng._stage_m2l(mpole_heap, fs_m2l),
                                      axis)
            leaf_local = eng.l2l_down(local_heap, fs)             # [G, S_Lt]
            my_local = jax.lax.dynamic_slice_in_dim(leaf_local, lo, Gl, 0)
            far = eng.l2p_blocks(ppad_l, mask_l, my_local, myc, myl)

            # ---- near field: systolic hop processing ----
            acc = jnp.zeros((Gl + 1, C, dim), dtype)
            h0 = hops.index(0)
            acc = p2p_hop(acc, ppad_l, ppad_l, lists.p2p_tgt[h0][0],
                          lists.p2p_src[h0][0], lists.p2p_val[h0][0], dtype)
            fwd = [(i, (i - 1) % ndev) for i in range(ndev)]   # blk of d+k
            bwd = [(i, (i + 1) % ndev) for i in range(ndev)]   # blk of d-k
            blk = ppad_l
            for h in range(1, (hpos[-1] if hpos else 0) + 1):
                blk = jax.lax.ppermute(blk, axis, fwd)
                if h in hops:
                    i = hops.index(h)
                    acc = p2p_hop(acc, ppad_l, blk, lists.p2p_tgt[i][0],
                                  lists.p2p_src[i][0], lists.p2p_val[i][0],
                                  dtype)
            blk = ppad_l
            for h in range(1, (hneg[-1] if hneg else 0) + 1):
                blk = jax.lax.ppermute(blk, axis, bwd)
                if -h in hops:
                    i = hops.index(-h)
                    acc = p2p_hop(acc, ppad_l, blk, lists.p2p_tgt[i][0],
                                  lists.p2p_src[i][0], lists.p2p_val[i][0],
                                  dtype)
            near = acc[:Gl]

            return (far + near) * dtype.type(kappa)

        pspec = PShardLists(
            p2p_tgt=tuple(P(axis, None) for _ in hops),
            p2p_src=tuple(P(axis, None) for _ in hops),
            p2p_val=tuple(P(axis, None) for _ in hops),
            m2l_tgt=P(axis, None), m2l_src=P(axis, None),
            m2l_val=P(axis, None), m2l_h2=P(axis, None, None),
            m2l_w=P(axis, None), m2l_logc=P(axis, None),
            m2l_gtgt=P(axis, None))
        fs_spec = FmmState(**{f: P() for f in FmmState._fields})
        sharded = shard_map(
            impl, mesh=self.mesh,
            in_specs=(P(axis, None, None), P(axis, None), fs_spec, pspec),
            out_specs=P(axis, None, None), check_vma=False)
        mask_dev = jax.device_put(
            jnp.asarray(mask_full), NamedSharding(self.mesh, P(axis, None)))

        def fn(ppad, fs, lists):
            return sharded(ppad, mask_dev, fs, lists)

        return fn


def make_psharded_scan(eng: KdFmmEngine, mesh: Mesh, config, omega0_sq,
                       axis: str = "dp"):
    """(ps, scan_fn): inter-rebuild scan on the SHARDED padded state.

    scan_fn(pstate, fs, lists, hops, k, init=False) advances k integrator
    steps (after computing the state's acceleration when init) as one
    jitted fori_loop; the shard_map'd force (with its all_gather / psum /
    ppermute collectives) sits inside the loop body, so the whole window is
    a single XLA program per device — the multi-chip twin of
    Simulator._make_fmm_scan_padded.
    """
    from coulomb_oscillators.models import integrators as I

    ps = PShardedKdFmm(eng, mesh, axis)
    mask3 = jax.device_put(
        eng.mask3[..., None],
        NamedSharding(mesh, P(axis, None, None)))
    om2 = jnp.asarray(omega0_sq, jnp.float32)
    cache = {}

    def scan_fn(pstate, fs, lists, hops, k, init=False):
        fn = cache.get(hops)
        if fn is None:
            force_p = ps._force_for(hops)

            @jax.jit
            def scan_k(pstate, fs, lists, kk, dt_on):
                def force(ppad):
                    acc = force_p(ppad, fs, lists)
                    acc = acc - ppad * om2[None, None, :]
                    return jnp.where(mask3, acc, 0.0)

                step = I.make_step(force, config.integrator, config.dt)
                return jax.lax.fori_loop(0, kk, lambda _, s: step(s, dt_on),
                                         pstate)

            fn = cache[hops] = scan_k
        # init: one zero-length step computes the state's acceleration
        return fn(pstate, fs, lists, jnp.int32(1 if init else k),
                  jnp.float32(0.0 if init else 1.0))

    return ps, scan_fn


def make_psharded_step(eng: KdFmmEngine, mesh: Mesh, config, omega0_sq,
                       axis: str = "dp"):
    """Full jittable training step on sharded padded state.

    Returns (ps, step_fn) where step_fn(pstate, fs, lists) advances one
    leapfrog (or configured) step; pstate is a ParticleState of sharded
    padded blocks.  The trap force is applied in-register on the shards;
    pad slots (parked at FAR) are masked so they stay put.
    """
    from coulomb_oscillators.models import integrators as I

    ps = PShardedKdFmm(eng, mesh, axis)
    mask3 = jax.device_put(
        eng.mask3[..., None],
        NamedSharding(mesh, P(axis, None, None)))
    om2 = jnp.asarray(omega0_sq, jnp.float32)

    def make_step(hops):
        force_p = ps._force_for(hops)

        def step(pstate, fs, lists):
            def force(ppad):
                acc = force_p(ppad, fs, lists)
                acc = acc - ppad * om2[None, None, :]
                return jnp.where(mask3, acc, 0.0)

            return I.make_step(force, config.integrator, config.dt)(pstate)

        return jax.jit(step)

    cache = {}

    def step_fn(pstate, fs, lists, hops):
        fn = cache.get(hops)
        if fn is None:
            fn = cache[hops] = make_step(hops)
        return fn(pstate, fs, lists)

    return ps, step_fn
