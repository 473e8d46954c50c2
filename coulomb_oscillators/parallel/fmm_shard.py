"""Multi-chip kd-FMM force: pair-sharded hot loops over a device mesh.

Scheme (round 1): positions and the (small) tree are replicated; the two
hot, embarrassingly-parallel loops — near-field P2P leaf pairs and far-field
M2L pairs — are sharded across the mesh, and their contributions reduced
with one `psum` each (the [G, C, dim] near-field block accumulator and the
[Mheap, S_Lt] local heap cross the device links).  Upper-tree work (P2M, M2M, L2L,
L2P) is replicated — it is a few percent of the flops.

This scales the reference's two hot loops (SURVEY.md §3.2: fmm_p2p3 and
fmm_c2c3) across chips without any dynamic communication pattern: the pair
lists are static between rebuilds, so the only collectives are two psums
per force evaluation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from coulomb_oscillators.ops.fmm.kdtree import (FmmState, KdFmmEngine,
                                                    _heap_off)


def pad_pairs_for_mesh(fs: FmmState, ndev: int) -> FmmState:
    """Pad the pair-list axes to multiples of the mesh size (the engine's
    power-of-two caps already satisfy this for power-of-two meshes)."""
    def padlen(k):
        return (-(-k // ndev)) * ndev

    def pad1(x, fill):
        k = x.shape[0]
        if k % ndev == 0:
            return x
        return jnp.concatenate(
            [x, jnp.full((padlen(k) - k,) + x.shape[1:], fill, x.dtype)])

    Mheap = fs.center.shape[0]
    G = fs.p2p_row_ptr.shape[0] - 1
    return fs._replace(
        p2p_tgt=pad1(fs.p2p_tgt, G), p2p_src=pad1(fs.p2p_src, 0),
        p2p_valid=pad1(fs.p2p_valid, False),
        m2l_tgt=pad1(fs.m2l_tgt, Mheap), m2l_src=pad1(fs.m2l_src, 0),
        m2l_valid=pad1(fs.m2l_valid, False),
        m2l_h2=pad1(fs.m2l_h2, 0.0), m2l_w=pad1(fs.m2l_w, 1.0),
        m2l_logc=pad1(fs.m2l_logc, 0.0),
        # grouped-M2L targets shard alongside the entries when the even
        # split keeps g-runs intact; otherwise a dummy forces the
        # per-entry fallback inside _stage_m2l
        m2l_gtgt=(pad1(fs.m2l_gtgt, Mheap)
                  if fs.m2l_gtgt.shape[0] % ndev == 0
                  and fs.m2l_gtgt.shape[0] > 1
                  and fs.m2l_tgt.shape[0] % ndev == 0
                  else jnp.zeros(ndev, jnp.int32)),
    )


def make_sharded_force(eng: KdFmmEngine, mesh: Mesh, axis: str = "dp"):
    """pos [n, dim] (replicated) x FmmState -> acc [n, dim] (replicated).

    The returned function is jittable; pair-list members of FmmState are
    sharded along `axis`, everything else replicated.
    """
    ndev = mesh.shape[axis]

    pair_fields = {"p2p_tgt", "p2p_src", "p2p_valid",
                   "m2l_tgt", "m2l_src", "m2l_valid",
                   "m2l_h2", "m2l_w", "m2l_logc", "m2l_gtgt"}
    fs_specs = FmmState(**{
        f: P(axis) if f in pair_fields else P()
        for f in FmmState._fields})

    def impl(pos, fs):
        st = eng.st
        n, L, dim, C = eng.n, eng.L, eng.dim, st.C
        G = 1 << L
        dtype = pos.dtype
        kappa = dtype.type(eng.config.kappa(n))

        pos_s = jnp.take(pos, fs.perm, axis=0)
        pad_mask = jnp.asarray(st.pad_mask)
        import numpy as np
        flat = jnp.where(pad_mask[:, None],
                         jnp.take(pos_s, jnp.asarray(st.pad_gather), axis=0),
                         dtype.type(1e18))
        ppad = flat.reshape(G, C, dim)
        mask3 = pad_mask.reshape(G, C)

        # replicated upper tree
        mpole_heap = eng._stage_multipoles(ppad, mask3, fs)
        # sharded far-field pair loop + psum of the local heap
        local_heap = eng._stage_m2l(mpole_heap, fs)
        local_heap = jax.lax.psum(local_heap, axis)
        far_pad = eng._stage_local(ppad, mask3, local_heap, fs)
        # sharded near-field pair loop + psum of the block accumulator
        near_pad = jax.lax.psum(eng._stage_p2p(ppad, fs), axis)

        acc_pad = (far_pad + near_pad).reshape(G * C, dim)
        acc_s = jnp.take(acc_pad, jnp.asarray(st.unpad_gather), axis=0)
        return jnp.take(acc_s * kappa, fs.inv_perm, axis=0)

    sharded = shard_map(impl, mesh=mesh,
                        in_specs=(P(), fs_specs), out_specs=P(),
                        check_vma=False)

    def force(pos, fs: FmmState):
        return sharded(pos, pad_pairs_for_mesh(fs, ndev))

    return force
