"""kd-tree FMM force engine.

Reference capability: fmm_cart3_kdtree.cuh (the production engine).  The
design here is a from-scratch JAX formulation:

  * Equal-count median splits (reference evalBox:109-156) make ALL segment
    boundaries compile-time constants: node i at level l covers sorted slots
    [floor(n*i/2^l), floor(n*(i+1)/2^l)).  Leaf occupancy differs by at most
    one slot, so leaves pad to a fixed capacity C with a single static
    gather — no CSR, no dynamic shapes anywhere on device.
  * The per-level segmented sort (reference: bb_segsort) is one
    `jax.lax.sort` with a static segment-id key — lexicographic
    (segment, coordinate) sort IS a segmented sort when segments are
    contiguous.
  * P2M/M2M/M2L/L2L/L2P are the batched table ops of ops.multipole, applied
    per level (python loop at trace time -> one fused XLA program).
  * The dual-tree MAC traversal (reference: persistent-kernel stack,
    :416-567) runs vectorized on host at tree-rebuild time only; its output
    pair lists are padded device arrays reused for `tree_steps` steps
    (temporal amortization, reference :1619-1642; we also freeze centers
    and scales, which is valid because expansion centers are arbitrary and
    we keep dipole terms).
  * Near field at DUAL GRANULARITY: the tree descends to
    sub-leaves of ~32 particles (`sub_depth` levels below the 128-wide
    block level), the MAC runs at sub-leaf granularity, and the P2P pass
    computes directed (target sub-leaf) x (source 128-block) tiles.  The
    physical near-field footprint scales with leaf diameter, so sub-leaf
    MAC resolution cuts exact-kernel work several-fold vs 128-particle
    leaves — strictly more than the reference's
    Newton-3 accumulation (2x; fmm_cart3_kdtree.cuh:797-1046) while
    keeping single-writer 128-wide tiles.  M2L entries become DIRECTED;
    entries whose source lies below block level and whose source block is
    already covered by the target's exact near tile are dropped
    (the tile computes those interactions exactly).

MAC (kd_admissible, reference :395-414): pairs (A, B) are far when
(par*Mf)^2 * max(diag2_A, diag2_B) < dist(center_A, center_B)^2 with
Mf = (max(mult_A, mult_B)/n)^(1/(3p+6)).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_oscillators.config import SimConfig
from coulomb_oscillators.ops.multipole import operators as mop
from coulomb_oscillators.ops.multipole.tables import FmmTables, build_tables

FAR = 1e18


def auto_level(n: int, p: int, dens_inhom: float = 1.0,
               tree_L: int = 0, leaf_target: int = 0) -> int:
    """Level heuristic.

    Reference formula (fmm_cart3_kdtree.cuh:1502-1515) targets leaves of
    ~p^2 particles, sized for its subwarp P2P.  The near-field tiles here
    are (sub-leaf) x (128-wide block), so the engine passes `leaf_target`
    (KdFmmEngine passes 32: sub-leaves of ~32 below 128-wide blocks) and we
    aim for that occupancy instead; `tree_L` still overrides.
    """
    if tree_L > 0:
        L = tree_L
    else:
        tgt = leaf_target if leaf_target > 0 else p * p
        L = int(round(math.log2(max(dens_inhom * n / tgt, 1.0))))
    L = max(2, min(L, 30))
    while (1 << L) > max(n, 2):
        L -= 1
    return max(L, 1)


class FmmState(NamedTuple):
    """Device state frozen between tree rebuilds.

    Near-field lists are directed (target sub-leaf, source block): targets
    index the 2^L sub-leaves, sources index the 2^(L-sub_depth) 128-wide
    blocks.  M2L entries are directed (t <- s) heap-index pairs."""
    perm: jax.Array        # [n] sorted slot -> original particle index
    inv_perm: jax.Array    # [n] original particle index -> sorted slot
    center: jax.Array      # [Mheap, dim] expansion centers (frozen COC)
    lam: jax.Array         # [Mheap] node length scales (half-diagonal)
    p2p_tgt: jax.Array     # [Kp] sub-leaf index of target
    p2p_src: jax.Array     # [Kp] BLOCK index of source
    p2p_valid: jax.Array   # [Kp] bool
    m2l_tgt: jax.Array     # [Km] heap index of target (directed)
    m2l_src: jax.Array     # [Km] heap index of source (directed)
    m2l_valid: jax.Array   # [Km] bool
    m2l_h2: jax.Array      # [Km, S_H] folded per-entry harmonics (frozen
                           # geometry, precomputed at rebuild — m2l_fold_geo)
    m2l_w: jax.Array       # [Km] lam_src/lam_tgt scale ratio
    m2l_logc: jax.Array    # [Km] 2D monopole log correction (zeros in 3D)
    p2p_row_ptr: jax.Array  # [Gsub+1] CSR over the valid prefix of p2p_src
    m2l_gtgt: jax.Array     # [Km/g] target heap index per GROUP of g
                            # consecutive entries (every group is
                            # single-target; per-target runs padded to a
                            # multiple of g at list prep).  The M2L scan
                            # dense-reduces each group before the
                            # segment_sum, shrinking the scatter g-fold.
                            # Shape [1] when grouping is off (g=1).


@dataclasses.dataclass
class _Static:
    """Host-side static structure for a given (n, L)."""
    n: int
    L: int
    beg: List[np.ndarray]          # beg[l][i], len 2^l + 1
    seg: List[np.ndarray]          # seg[l][slot] -> segment id (int32)
    C: int                         # leaf capacity
    pad_gather: np.ndarray         # [2^L * C] -> slot (clamped)
    pad_mask: np.ndarray           # [2^L * C] bool
    unpad_gather: np.ndarray       # [n] -> padded slot
    mult: np.ndarray               # [Mheap] node particle counts


@functools.lru_cache(maxsize=32)
def _static_structure(n: int, L: int, pow2: bool = False) -> _Static:
    beg = []
    seg = []
    for l in range(L + 1):
        m = 1 << l
        b = (np.arange(m + 1, dtype=np.int64) * n) // m
        beg.append(b)
        s = np.repeat(np.arange(m, dtype=np.int32), np.diff(b))
        seg.append(s)
    C = -(-n // (1 << L))
    if pow2:  # the P2P kernel's tiles are powers of two
        C = 1 << (C - 1).bit_length()
    G = 1 << L
    slot = beg[L][:-1][:, None] + np.arange(C)[None, :]      # [G, C]
    mask = slot < beg[L][1:][:, None]
    pad_gather = np.minimum(slot, n - 1).reshape(-1).astype(np.int32)
    pad_mask = mask.reshape(-1)
    # inverse: sorted slot -> its padded slot
    unpad = np.zeros(n, dtype=np.int32)
    padded_ids = np.arange(G * C)[pad_mask.reshape(-1)]
    unpad[slot.reshape(-1)[pad_mask.reshape(-1)]] = padded_ids
    mult = np.concatenate([np.diff(beg[l]) for l in range(L + 1)]).astype(np.int32)
    return _Static(n=n, L=L, beg=beg, seg=seg, C=C,
                   pad_gather=pad_gather, pad_mask=pad_mask,
                   unpad_gather=unpad, mult=mult)


def _heap_off(l: int) -> int:
    return (1 << l) - 1


# --------------------------------------------------------------------------- #
# Device tree build (sorting + geometry)
# --------------------------------------------------------------------------- #


def _morton_key(pos: jax.Array, bits: int, dim: int) -> jax.Array:
    """Morton (Z-order) keys from box-normalized coordinates, uint32."""
    mn = jnp.min(pos, axis=0)
    mx = jnp.max(pos, axis=0)
    extent = jnp.maximum(mx - mn, 1e-30)
    q = jnp.clip(((pos - mn) / extent * (1 << bits)).astype(jnp.uint32),
                 0, (1 << bits) - 1)                       # [n, dim]
    key = jnp.zeros(pos.shape[0], dtype=jnp.uint32)
    for b in range(bits):
        for a in range(dim):
            bit = (q[:, a] >> b) & 1
            key = key | (bit << (b * dim + a)).astype(jnp.uint32)
    return key


@functools.partial(jax.jit, static_argnames=("n", "L", "dim"))
def _build_device_morton(pos: jax.Array, n: int, L: int, dim: int):
    """One Morton sort; tree = equal-count splits of the sorted order.

    Replaces the reference's per-level segmented sorts (bb_segsort) with a
    single space-filling-curve sort — the MAC uses the true per-node bounds
    computed afterwards, so correctness is unaffected; only pair counts
    change marginally.
    """
    st = _static_structure(n, L)
    bits = 10 if dim == 3 else 16
    key = _morton_key(pos, bits, dim)
    perm = jnp.argsort(key).astype(jnp.int32)
    pos_s = pos[perm]

    centers, lams, lbs, rbs = [], [], [], []
    for l in range(L + 1):
        m = 1 << l
        seg = jnp.asarray(st.seg[l])
        mn = jax.ops.segment_min(pos_s, seg, num_segments=m,
                                 indices_are_sorted=True)
        mx = jax.ops.segment_max(pos_s, seg, num_segments=m,
                                 indices_are_sorted=True)
        cnt = jnp.asarray(np.diff(st.beg[l]).astype(np.float32))[:, None]
        mean = jax.ops.segment_sum(pos_s, seg, num_segments=m,
                                   indices_are_sorted=True) / cnt
        centers.append(mean)
        lams.append(jnp.maximum(0.5 * jnp.linalg.norm(mx - mn, axis=1), 1e-30))
        lbs.append(mn)
        rbs.append(mx)
    return (perm, jnp.concatenate(centers, axis=0),
            jnp.concatenate(lams, axis=0), jnp.concatenate(lbs, axis=0),
            jnp.concatenate(rbs, axis=0))


@functools.partial(jax.jit, static_argnames=("n", "L", "dim"))
def _build_device(pos: jax.Array, n: int, L: int, dim: int):
    """Sort particles into the kd order; return perm + heap geometry."""
    st = _static_structure(n, L)
    pos_s = pos
    perm = jnp.arange(n, dtype=jnp.int32)

    centers, lams, lbs, rbs = [], [], [], []
    for l in range(L + 1):
        m = 1 << l
        seg = jnp.asarray(st.seg[l])
        mn = jax.ops.segment_min(pos_s, seg, num_segments=m,
                                 indices_are_sorted=True)
        mx = jax.ops.segment_max(pos_s, seg, num_segments=m,
                                 indices_are_sorted=True)
        cnt = jnp.asarray(np.diff(st.beg[l]).astype(np.float32))[:, None]
        mean = jax.ops.segment_sum(pos_s, seg, num_segments=m,
                                   indices_are_sorted=True) / cnt
        centers.append(mean)
        lams.append(jnp.maximum(0.5 * jnp.linalg.norm(mx - mn, axis=1), 1e-30))
        lbs.append(mn)
        rbs.append(mx)
        if l == L:
            break
        splitdim = jnp.argmax(mx - mn, axis=1)               # [m]
        key = jnp.take_along_axis(
            pos_s, splitdim[seg][:, None], axis=1)[:, 0]     # [n]
        ops = [seg, key] + [pos_s[:, a] for a in range(dim)] + [perm]
        out = jax.lax.sort(tuple(ops), num_keys=2)
        pos_s = jnp.stack(out[2:2 + dim], axis=1)
        perm = out[2 + dim]

    center = jnp.concatenate(centers, axis=0)
    lam = jnp.concatenate(lams, axis=0)
    lb = jnp.concatenate(lbs, axis=0)
    rb = jnp.concatenate(rbs, axis=0)
    return perm, center, lam, lb, rb


# --------------------------------------------------------------------------- #
# Host dual-tree traversal
# --------------------------------------------------------------------------- #


def _traverse_raw(center: np.ndarray, lb: np.ndarray, rb: np.ndarray,
                  mult: np.ndarray, L: int, n: int, p: int,
                  radius: float, mult_floor: int = 1,
                  boost_from: Optional[int] = None, sub_boost: float = 1.0):
    """Vectorized dual-tree traversal (reference :569-611 semantics).

    Returns (m2l [K,2] unordered heap pairs, p2p [Q,2] unordered
    LEAF-RELATIVE pairs incl. self pairs) — the same format as the native
    co_traverse.

    mult_floor: Mf uses max(mult, mult_floor), so acceptance below
    mult_floor-sized cells is never LOOSER than at that granularity (the
    engine floors at the 128-wide block occupancy; see KdFmmEngine).
    boost_from/sub_boost: nodes at heap index >= boost_from accept with
    radius*sub_boost (stricter) — sub-block M2L acceptances replace
    interactions block granularity computed EXACTLY, so they must carry
    negligible error (falls ~sub_boost^(p+1)); see KdFmmEngine.
    """
    leaf0 = _heap_off(L)
    M = center.shape[0]
    sz = np.sum((rb - lb) ** 2, axis=1)                      # squared diagonal
    mult = np.maximum(mult, np.int32(mult_floor))
    # per-node pair value (rad_i * (mult_i/n)^expo)^2; the pair acceptance
    # takes the max over the two nodes (same as the native pm2 table)
    expo = 1.0 / (3 * p + 6)
    rad = np.full(M, radius, dtype=np.float64)
    if boost_from is not None and sub_boost != 1.0:
        rad[boost_from:] = radius * sub_boost
    pm2 = (rad * (mult[:M] / float(n)) ** expo) ** 2

    frontier = np.array([[0, 0]], dtype=np.int64)
    m2l = []
    p2p = []
    while frontier.size:
        i, j = frontier[:, 0], frontier[:, 1]
        d = center[i] - center[j]
        dist2 = np.sum(d * d, axis=1)
        parM2 = np.maximum(pm2[i], pm2[j])
        adm = (parM2 * np.maximum(sz[i], sz[j]) < dist2) & (i != j)
        if np.any(adm):
            m2l.append(frontier[adm])
        rest = frontier[~adm]
        if rest.size == 0:
            break
        i, j = rest[:, 0], rest[:, 1]
        leaf_i = i >= leaf0
        leaf_j = j >= leaf0
        both = leaf_i & leaf_j
        if np.any(both):
            p2p.append(rest[both])
        rest = rest[~both]
        if rest.size == 0:
            break
        i, j = rest[:, 0], rest[:, 1]
        leaf_i = i >= leaf0
        leaf_j = j >= leaf0
        # self pairs split into (l,l), (l,r), (r,r) so each unordered pair
        # is emitted exactly once; non-self pairs split the larger non-leaf
        # side only.
        selfp = i == j
        sp = rest[selfp]
        rest = rest[~selfp]
        i, j = rest[:, 0], rest[:, 1]
        leaf_i = i >= leaf0
        leaf_j = j >= leaf0
        split_i = (~leaf_i) & (leaf_j | (sz[i] >= sz[j]))
        si = rest[split_i]
        sj = rest[~split_i]
        nxt = []
        if sp.size:
            a = sp[:, 0]
            l, r = 2 * a + 1, 2 * a + 2
            nxt.append(np.stack([l, l], axis=1))
            nxt.append(np.stack([l, r], axis=1))
            nxt.append(np.stack([r, r], axis=1))
        if si.size:
            a, b = si[:, 0], si[:, 1]
            nxt.append(np.stack([2 * a + 1, b], axis=1))
            nxt.append(np.stack([2 * a + 2, b], axis=1))
        if sj.size:
            a, b = sj[:, 0], sj[:, 1]
            nxt.append(np.stack([a, 2 * b + 1], axis=1))
            nxt.append(np.stack([a, 2 * b + 2], axis=1))
        frontier = np.concatenate(nxt, axis=0) if nxt else np.zeros((0, 2), np.int64)

    m2l = np.concatenate(m2l, axis=0) if m2l else np.zeros((0, 2), np.int64)
    p2p = np.concatenate(p2p, axis=0) if p2p else np.zeros((0, 2), np.int64)
    return m2l, p2p - leaf0


def _pad_pairs(pairs: np.ndarray, cap: int, dummy_tgt: int):
    k = pairs.shape[0]
    tgt = np.full(cap, dummy_tgt, dtype=np.int32)
    src = np.zeros(cap, dtype=np.int32)
    valid = np.zeros(cap, dtype=bool)
    tgt[:k] = pairs[:, 0]
    src[:k] = pairs[:, 1]
    valid[:k] = True
    return tgt, src, valid


def _round_cap(k: int, quantum: int = 8192, headroom: float = 1.25) -> int:
    """Padded list capacity: headroom rounded to `quantum`.  Steady-state
    counts under the async re-sort pipeline run above a fresh sort
    (one-window-stale leaf partition), so this absorbs them without a
    recompile, while padding waste stays far below the old power-of-two
    policy's up-to-2x."""
    return max(quantum, -(-int(k * headroom) // quantum) * quantum)


def _pick_chunk(K: int, target: int, mult: int = 1) -> int:
    """Largest divisor-of-K chunk size near `target` (scan tiling).
    `mult` constrains the chunk to a multiple (grouped-M2L run size)."""
    if K <= target:
        return max(K, 1)
    nch = max(1, -(-K // target))
    while K % nch or (K // nch) % mult:
        nch += 1
    return K // nch


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #


class KdFmmEngine:
    """kd-tree FMM engine for a fixed particle count.

    Usage:
        eng = KdFmmEngine(config, n)
        fstate = eng.build(pos)          # at t=0 and every tree_steps steps
        acc = eng.force(pos, fstate)     # pure & jitted
    """

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 leaf_target: int = 32, m2l_chunk: int = 65536,
                 p2p_chunk: int = 256, sort_mode: str = "auto",
                 use_pallas: Optional[bool] = None, sub_depth: int = 2):
        self.config = config
        self.n = n
        self.dim = config.dim
        # p=1 is monopole-only (PM=0), matching the reference's fmm_order=1
        # row in the -test sweep (main3.cu:799)
        self.p = max(config.fmm_order, 1)
        self.L = L or auto_level(n, self.p, config.dens_inhom,
                                 config.tree_L, leaf_target)
        # block level: 128-wide near-field tiles live `sub_depth` levels
        # above the sub-leaves the MAC resolves.  The dual-granularity MAC's
        # whole premise is the auto-level geometry (~32-particle sub-leaves,
        # 128-wide blocks); when -maxlevel / an explicit L forces a COARSER
        # tree, the "block occupancy" floor would be looser than the
        # reference's own leaves and the sub-boost would strangle the far
        # field (e.g. n=800 @ L=4: blocks of 200 -> zero M2L acceptances,
        # every -test order ties at the exact-P2P floor) — fall back to the
        # reference's plain leaf-granularity MAC there.
        auto_L = auto_level(n, self.p, config.dens_inhom, 0, leaf_target)
        self.sub_depth = max(0, min(sub_depth, self.L)) \
            if self.L >= auto_L else 0
        # MAC multiplicity floor: Mf = (max(mult, floor)/n)^(1/(3p+6)) keeps
        # the acceptance bound max(sz)/dist2 at sub-leaf granularity exactly
        # as strict as at the 128-wide block (reference-leaf) granularity.
        # Without it the multiplicity-dependent MAC opens ~32-particle cells
        # much more aggressively at fixed (p, r): north-star energy drift
        # regressed 4.0e-8 -> 2.5e-6.  The sub-leaf refinement still trims
        # the near field because smaller cells pass the SAME bound at
        # shorter distances.
        self.mac_mult_floor = (-(-n // (1 << (self.L - self.sub_depth)))
                               if self.sub_depth else 1)
        # Sub-block acceptance-radius boost: even floored, a sub-leaf M2L
        # acceptance REPLACES an interaction the block-granularity MAC
        # computed exactly (P2P), so its per-pair error must be negligible
        # next to the block-level far field.  Boosting the radius by b for
        # nodes below the block level cuts that error ~b^(p+1) while keeping
        # most of the near-field footprint cut (smaller cells still pass the
        # boosted bound at shorter distances).  Measured at the north-star
        # config (N=30001, p=6, r=2.5): mean force error 1.21e-5 at boost=1
        # vs the 3.83e-6 block-granularity plateau; boost=1.5 reaches
        # 3.98e-6 (4% above plateau) at 12% less near-field work than the
        # plateau-exact boost=2.0.
        # Resolution: explicit config > env override > accuracy-grade auto
        # (a requested force-error bound < 1e-4 selects the plateau-exact
        # 2.0 — north-star energy runs must not pay the throughput boost's
        # extra error) > throughput default 1.5.
        if not self.sub_depth:
            self.mac_sub_boost = 1.0
        elif getattr(config, "mac_sub_boost", 0.0) > 0.0:
            self.mac_sub_boost = float(config.mac_sub_boost)
        elif os.environ.get("CO_SUB_BOOST"):
            self.mac_sub_boost = float(os.environ["CO_SUB_BOOST"])
        elif 0.0 < getattr(config, "accuracy", 0.0) < 1e-4:
            self.mac_sub_boost = 2.0
        else:
            self.mac_sub_boost = 1.5
        # COC centers make the dipole identically zero -> drop the order-1
        # multipole slots everywhere (reference's P2M-from-order-2 +
        # no_dipole M2L skip, fmm_cart3_kdtree.cuh:231-269)
        self.tables = build_tables(self.dim, self.p, no_dipole=True)
        # M2L group size g: per-target entry runs are padded to multiples
        # of g at list prep so the scan can dense-reduce g consecutive
        # entries (a reshape-sum) before the segment_sum, shrinking the
        # scatter g-fold for ~(g-1)/2 extra pad entries per target.  g=1
        # disables grouping (per-entry scatter).
        self.m2l_group = int(os.environ.get("CO_M2L_GROUP", "8"))
        # On-the-fly M2L geometry: compute each entry's harmonics H2/w/logc
        # INSIDE the scan body from fs.center/fs.lam instead of streaming a
        # precomputed [Km, S_H] fold.  The stored fold is a large array
        # read every force eval; the in-body recompute is a few hundred
        # flops and 8 gathered words per entry, and makes the M2L geometry
        # follow geom_refresh'd centers with NO per-step re-fold.  Same
        # numerics (identical m2l_fold_geo -> m2l_sparse_pre composition).
        self.m2l_fly = os.environ.get("CO_M2L_FLY", "1") != "0"
        # Near field: the Pallas kernel (p2p_triton.py) on the GPU, the
        # chunked jnp scan on the CPU.  dim=2 stays on the scan (the FAR
        # padding's 1/r^2 weight does not underflow exactly in 2D).
        # Forcing the kernel off the GPU runs it in interpret mode.
        if use_pallas is None:
            use_pallas = (jax.default_backend() == "gpu"
                          and config.dim == 3
                          and config.precision == "float32")
        self.use_pallas = bool(use_pallas)
        if self.use_pallas and config.dim != 3:
            raise ValueError("the P2P kernel is 3D only")
        self.p2p_interpret = jax.default_backend() != "gpu"
        self.st = _static_structure(n, self.L, pow2=self.use_pallas)
        self.caps = {"p2p": 8192, "m2l": m2l_chunk}

        @jax.jit
        def m2l_geo(center, lam, m2l_t, m2l_s, m2l_v):
            Mheap = _heap_off(self.L + 1)
            a_cl = jnp.minimum(m2l_t, Mheap - 1)
            R = tuple(
                jnp.where(m2l_v,
                          jnp.take(center[:, d], a_cl)
                          - jnp.take(center[:, d], m2l_s),
                          jnp.float32(1.0))
                for d in range(center.shape[1]))
            la = jnp.take(lam, a_cl, axis=0)
            lb = jnp.take(lam, m2l_s, axis=0)
            return mop.m2l_fold_geo(self.tables, R, la, lb)

        self._m2l_geo_jit = m2l_geo
        self.m2l_chunk = m2l_chunk
        self.p2p_chunk = p2p_chunk
        # env override for cadence probing (scripts/cadence_probe.py):
        # "auto" | "kd_native" | "morton" | "kd_device"
        self.sort_mode = os.environ.get("CO_SORT_MODE", sort_mode)
        self._force_jit = jax.jit(self._force_impl)
        self._pad_jit = jax.jit(
            functools.partial(self.pad_array, fill=FAR))
        self._padded_force_jit = jax.jit(self.force_padded_in_jit)
        self._potential_jit = jax.jit(self._potential_impl)

    @property
    def G_sub(self) -> int:
        return 1 << self.L

    @property
    def G_blk(self) -> int:
        return 1 << (self.L - self.sub_depth)

    @property
    def C_blk(self) -> int:
        return self.st.C << self.sub_depth

    @property
    def mask_shift(self) -> int:
        """Bit position of the sub-leaf group mask inside packed source
        block ids (top 2^sub_depth bits of the int32)."""
        return 32 - (1 << self.sub_depth)

    def _fine_lists(self, m2l_u: np.ndarray, p2p_dir: np.ndarray):
        """Dual-granularity list construction from the sub-leaf-level
        traversal output.

        Input: m2l_u [K, 2] unordered admissible heap-index pairs (any
        levels); p2p_dir [Q, 2] unordered near sub-leaf pairs
        (leaf-relative, self included).  Output:
          * near [Qb, 2] directed (target sub-leaf, PACKED source block)
            pairs, target-sorted.  The packed value is
            blk | (mask << mask_shift): `mask` has one bit per sub-leaf
            group of the 128-wide source block, set iff that sub-leaf is a
            near partner of the target.  The kernel zeroes masked-out
            groups, so the tile computes EXACTLY the near sub-pairs —
            admissible sub-pairs inside a near block stay with M2L, and no
            M2L entry ever needs splitting or absorption.
          * m2l [Kd, 2] DIRECTED (t <- s) entries (both directions of every
            unordered pair), target-sorted.
        """
        S = self.sub_depth
        G_blk = self.G_blk
        ngroups = 1 << S
        shift = self.mask_shift

        # --- near (t, packed block) pairs: group sub-leaf partners by
        # source block, OR their group bits ---
        if p2p_dir.size and self.config.coll:
            a = p2p_dir[:, 0].astype(np.int64)
            b = p2p_dir[:, 1].astype(np.int64)
            t = np.concatenate([a, b])
            s = np.concatenate([b, a])
            key = t * G_blk + (s >> S)
            bit = np.int64(1) << (s & (ngroups - 1))
            order = np.argsort(key, kind="stable")
            key, bit = key[order], bit[order]
            uniq, start = np.unique(key, return_index=True)
            mask = np.bitwise_or.reduceat(bit, start)
            packed = ((uniq % G_blk) | (mask << shift))
            # int32 wrap-around semantics (mask may occupy the sign bit)
            packed = packed.astype(np.uint32).view(np.int32).astype(np.int64)
            near = np.stack([uniq // G_blk, packed], axis=1)
        else:
            near = np.zeros((0, 2), np.int64)

        # --- directed M2L: both directions of every unordered pair ---
        if m2l_u.size == 0:
            return near, np.zeros((0, 2), np.int64)
        m2l_d = np.concatenate([m2l_u, m2l_u[:, ::-1]], axis=0)
        m2l_d = m2l_d[np.argsort(m2l_d[:, 0], kind="stable")]
        return near, m2l_d

    # ---------------- build ----------------
    def build(self, pos: jax.Array) -> FmmState:
        """Tree (re)build.

        sort_mode:
          * "auto" (default): exact kd via the native C++ builder when
            available (host round-trip; quickselect per level — the
            parasort/bb_segsort replacement), else device Morton.
          * "kd_native", "morton", "kd_device": forced choices.
        """
        import time as _time
        bt = {}
        t0 = _time.perf_counter()
        mode = self.sort_mode
        from coulomb_oscillators import native as conative
        use_native = (mode in ("auto", "kd_native")
                      and conative.get_lib() is not None)
        if use_native:
            pos_h = np.asarray(pos, dtype=np.float32)
            bt["fetch"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
            perm_h = conative.kdtree_build(pos_h, self.L)
            bt["kd"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
            pos_s_h = pos_h[perm_h]
            c_h, lb_h, rb_h, lam_h = conative.node_geometry(pos_s_h, self.L)
            bt["geom"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
            perm = jnp.asarray(perm_h)
            center = jnp.asarray(c_h)
            lam = jnp.asarray(lam_h)
        else:
            build_fn = (_build_device if mode == "kd_device"
                        else _build_device_morton)
            perm, center, lam, lb, rb = build_fn(pos, self.n, self.L,
                                                 self.dim)
            c_h = np.asarray(center)
            lb_h, rb_h = np.asarray(lb), np.asarray(rb)
            bt["device_build"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
        m2l, p2p = self._traverse(c_h, lb_h, rb_h)
        bt["traverse"] = _time.perf_counter() - t0
        perm_h2 = np.asarray(perm)
        inv_perm = np.empty_like(perm_h2)
        inv_perm[perm_h2] = np.arange(self.n, dtype=perm_h2.dtype)
        return self._lists_to_state(perm, inv_perm, center, lam,
                                    m2l, p2p, bt)

    def _lists_to_state(self, perm, inv_perm, center, lam, m2l, p2p,
                        bt) -> FmmState:
        """Shared tail of build()/refresh(): pad pair lists to caps, build
        the near-list CSR, upload, assemble FmmState."""
        import time as _time
        t0 = _time.perf_counter()
        self.last_counts = {"m2l": int(m2l.shape[0]), "p2p": int(p2p.shape[0])}
        Mheap_g = _heap_off(self.L + 1)
        g = self.m2l_group
        if g > 1:
            # grouped layout: pad each target's (sorted, contiguous) entry
            # run to a multiple of g; the device scan dense-reduces each
            # g-run before a g-fold-smaller segment_sum.  m2l stays
            # target-sorted; caps["m2l"] tracks the GROUPED length.
            tgt = m2l[:, 0].astype(np.int64)
            deg = np.bincount(tgt, minlength=Mheap_g)
            pdeg = -(-deg // g) * g
            off = np.zeros(Mheap_g + 1, np.int64)
            np.cumsum(pdeg, out=off[1:])
            rp = np.zeros(Mheap_g + 1, np.int64)
            np.cumsum(deg, out=rp[1:])
            posn = np.arange(m2l.shape[0], dtype=np.int64)
            posn += np.repeat(off[:-1] - rp[:-1], deg)
            k2 = int(off[-1])
        else:
            posn = None
            k2 = int(m2l.shape[0])
        # m2l caps quantized to the scan chunk so the streamed geometry
        # reshapes exactly into scan tiles
        # m2l padding is pure waste in the hot loop (the scan runs over the
        # cap) -> tight 8% headroom; p2p keeps 25% (tiles are cheaper).
        # OVERFLOW growth is geometric (>=25% past the old cap): every cap
        # change reshapes the jitted scan and costs a full recompile, and
        # the beam's pair counts drift a few percent per rebuild window as
        # it breathes in the trap — tight re-rounding would recompile every
        # other window.
        for name, klen, q, hr in (("m2l", k2, self.m2l_chunk, 1.08),
                                  ("p2p", p2p.shape[0], 8192, 1.25)):
            if klen > self.caps[name]:
                grown = -(-(self.caps[name] * 5 // 4) // q) * q
                self.caps[name] = max(_round_cap(klen, q, hr),
                                      grown if self.caps[name] else 0)
        Mheap = Mheap_g
        G = self.G_sub
        if g > 1:
            cap = self.caps["m2l"]
            m2l_t = np.full(cap, Mheap, dtype=np.int32)
            m2l_s = np.zeros(cap, dtype=np.int32)
            m2l_v = np.zeros(cap, dtype=bool)
            m2l_t[posn] = m2l[:, 0]
            m2l_s[posn] = m2l[:, 1]
            m2l_v[posn] = True
            # group target = min over the group (pad slots carry the Mheap
            # sentinel; every group inside the grouped length has >=1 real
            # entry, so min() is its target; all-pad cap-tail groups stay
            # at the sentinel -> still ascending for segment_sum)
            m2l_gt = m2l_t.reshape(-1, g).min(axis=1)
        else:
            m2l_t, m2l_s, m2l_v = _pad_pairs(m2l, self.caps["m2l"], Mheap)
            m2l_gt = np.zeros(1, dtype=np.int32)
        p2p_t, p2p_s, p2p_v = _pad_pairs(p2p, self.caps["p2p"], G)
        # CSR over the target-sorted valid prefix (the P2P kernel's rows)
        row_ptr = np.searchsorted(p2p[:, 0], np.arange(G + 1),
                                  side="left").astype(np.int32)
        bt["lists"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        m2l_t_d = jnp.asarray(m2l_t)
        m2l_s_d = jnp.asarray(m2l_s)
        m2l_v_d = jnp.asarray(m2l_v)
        center_d = jnp.asarray(center)
        lam_d = jnp.asarray(lam)
        if self.m2l_fly:
            # geometry recomputed in the scan body (see m2l_fly) — store
            # placeholders so FmmState keeps its shape contract
            h2 = jnp.zeros((1, 1), jnp.float32)
            w = jnp.zeros((1,), jnp.float32)
            logc = jnp.zeros((1,), jnp.float32)
        else:
            # fold the frozen per-entry M2L geometry out of the per-step
            # loop (harmonics + scale powers are constants between rebuilds;
            # only the multipole gather stays live) — device compute at
            # adoption
            h2, w, logc = self._m2l_geo_jit(center_d, lam_d, m2l_t_d,
                                            m2l_s_d, m2l_v_d)
        out = FmmState(
            perm=jnp.asarray(perm), inv_perm=jnp.asarray(inv_perm),
            center=center_d, lam=lam_d,
            p2p_tgt=jnp.asarray(p2p_t), p2p_src=jnp.asarray(p2p_s),
            p2p_valid=jnp.asarray(p2p_v),
            m2l_tgt=m2l_t_d, m2l_src=m2l_s_d,
            m2l_valid=m2l_v_d,
            m2l_h2=h2, m2l_w=w, m2l_logc=logc,
            p2p_row_ptr=jnp.asarray(row_ptr),
            m2l_gtgt=jnp.asarray(m2l_gt),
        )
        bt["upload"] = _time.perf_counter() - t0
        self.last_build_times = bt
        return out

    def build_host(self, pos):
        """The ENTIRE host side of a rebuild — kd sort, node geometry, MAC
        traversal, pair lists — as one background-threadable unit (native
        calls release the GIL).  Returns the ingredient tuple for
        :meth:`adopt`; requires the native library.

        Used by the async pipeline: the whole rebuild is computed from the
        window-start positions while the device scans the window, and
        adoption only uploads.  The resulting tree/lists are one window
        stale — the same within-window freezing the reference accepts
        (fmm_cart3_kdtree.cuh:1619: lists are reused unrefreshed for
        tree_steps iterations)."""
        import time as _time
        bt = {}
        t0 = _time.perf_counter()
        pos_h = np.asarray(pos, dtype=np.float32)
        bt["fetch"] = _time.perf_counter() - t0
        return self._build_host_from(pos_h, bt)

    def build_host_padded(self, ppad, inv_perm_old):
        """:meth:`build_host` fed from the PADDED device state: the fetch
        and the unpadding both happen here (background thread), so a window
        boundary never pays a device unpad for the builder's sake.
        inv_perm_old: device or host [n] inverse permutation of the layout
        `ppad` is padded under."""
        import time as _time
        bt = {}
        t0 = _time.perf_counter()
        flat = np.asarray(ppad, dtype=np.float32).reshape(-1, self.dim)
        inv_h = np.asarray(inv_perm_old)
        bt["fetch"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        # original order: particle o sits at sorted slot inv[o], padded slot
        # unpad_gather[inv[o]]
        pos_h = flat[self.st.unpad_gather[inv_h]]
        bt["unpad_host"] = _time.perf_counter() - t0
        return self._build_host_from(pos_h, bt)

    def _build_host_from(self, pos_h, bt):
        import time as _time
        from coulomb_oscillators import native as conative
        t0 = _time.perf_counter()
        perm = conative.kdtree_build(pos_h, self.L)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n, dtype=perm.dtype)
        bt["kd"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        pos_s = pos_h[perm]
        c_h, lb_h, rb_h, lam_h = conative.node_geometry(pos_s, self.L)
        bt["geom"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        m2l, p2p = self._traverse(c_h, lb_h, rb_h)
        bt["traverse"] = _time.perf_counter() - t0
        return (perm, inv, c_h, lam_h, m2l, p2p, bt)

    def adopt(self, built) -> FmmState:
        """Upload a :meth:`build_host` result (device work only)."""
        perm, inv, c_h, lam_h, m2l, p2p, bt = built
        return self._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p,
                                    dict(bt))

    def build_device_async(self, pos):
        """Async rebuild unit with the DEVICE Morton sort: the O(N) work
        (argsort + per-level segment geometry) runs on chip, only the node
        geometry ([Mheap, dim], ~600 KB at N=1M) crosses to host for the
        MAC traversal, and perm/inv never leave the device.

        Replaces build_host when the host round-trip (position fetch +
        quickselect) exceeds the scan window; the Morton equal-count tree
        is slightly looser than the exact kd (a few % more pairs) but the
        MAC uses true node bounds, so accuracy is unaffected.

        sort_mode="kd_device" uses the EXACT equal-count kd build instead
        (one 2-key lax.sort per level: segment id + the node's split-axis
        coordinate — the device formulation of the reference CPU path's
        (segid<<p)|flipped-float-bits packing, fmm_cart3_kdtree.cuh:167-187);
        costlier than the Morton single sort but immune to its loose-leaf
        penalty on concentrated beams (13x pair count, commit 6d6594c)."""
        import time as _time
        bt = {}
        t0 = _time.perf_counter()
        build_fn = (_build_device if self.sort_mode == "kd_device"
                    else _build_device_morton)
        perm, center, lam, lb, rb = build_fn(
            pos, self.n, self.L, self.dim)
        c_h = np.asarray(center)
        lb_h = np.asarray(lb)
        rb_h = np.asarray(rb)
        bt["device_build"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        m2l, p2p = self._traverse(c_h, lb_h, rb_h)
        bt["traverse"] = _time.perf_counter() - t0
        inv = jnp.zeros(self.n, jnp.int32).at[perm].set(
            jnp.arange(self.n, dtype=jnp.int32))
        return (perm, inv, center, lam, m2l, p2p, bt)

    def refresh(self, ppad: jax.Array, fs: FmmState,
                perm=None, inv_perm=None) -> FmmState:
        """Exact geometry + pair-list rebuild for an existing padded layout.

        Recomputes exact node bounds/centers from the padded blocks on
        device (no O(N) host fetch), then re-runs the MAC traversal and
        re-uploads the pair lists.  The traversal sees the true *current*
        bounds, so the MAC error bound is preserved regardless of how stale
        the permutation is — staleness only swells leaf bounds (more pairs,
        never wrong ones).  Pass perm/inv_perm when ppad was padded under a
        new permutation (async re-sort pipeline); defaults keep fs's.
        This splits the reference's monolithic rebuild
        (fmm_cart3_kdtree.cuh:1619-1642) into an overlappable host re-sort
        and a cheap synchronous geometry/list refresh.
        """
        import time as _time
        bt = {}
        t0 = _time.perf_counter()
        h = np.asarray(self._leaf_stats_jit(ppad))          # [3, G, dim]
        bt["geom_dev"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        L, dim = self.L, self.dim
        G = 1 << L
        M = (1 << (L + 1)) - 1
        mn = np.empty((M, dim), np.float32)
        mx = np.empty((M, dim), np.float32)
        sm = np.empty((M, dim), np.float64)
        mn[G - 1:] = h[0]
        mx[G - 1:] = h[1]
        sm[G - 1:] = h[2]
        for l in range(L - 1, -1, -1):
            off, offc, m = (1 << l) - 1, (1 << (l + 1)) - 1, 1 << l
            mn[off:off + m] = np.minimum(mn[offc:offc + 2 * m:2],
                                         mn[offc + 1:offc + 2 * m:2])
            mx[off:off + m] = np.maximum(mx[offc:offc + 2 * m:2],
                                         mx[offc + 1:offc + 2 * m:2])
            sm[off:off + m] = (sm[offc:offc + 2 * m:2]
                               + sm[offc + 1:offc + 2 * m:2])
        cnt = self.st.mult.astype(np.float64)[:, None]
        center = (sm / cnt).astype(np.float32)
        lam = np.maximum(0.5 * np.linalg.norm(mx - mn, axis=1),
                         1e-30).astype(np.float32)
        bt["geom_host"] = _time.perf_counter() - t0; t0 = _time.perf_counter()
        m2l, p2p = self._traverse(center, mn, mx)
        bt["traverse"] = _time.perf_counter() - t0
        return self._lists_to_state(
            fs.perm if perm is None else perm,
            fs.inv_perm if inv_perm is None else inv_perm,
            center, lam, m2l, p2p, bt)

    def refresh_geometry_device(self, ppad: jax.Array,
                                fs: FmmState) -> FmmState:
        """Device-only geometry refresh: recompute node centers / length
        scales from the CURRENT padded positions and re-fold the per-entry
        M2L geometry, keeping the permutation AND the pair lists frozen.

        Rationale (staleness anatomy): the within-window force
        error at the production cadence comes overwhelmingly from frozen
        expansion GEOMETRY — multipoles are re-P2M'd from live positions
        every step, but about centers (and with M2L harmonics) computed at
        the last host rebuild, so the expansion convergence degrades as
        particles drift.  The pair lists themselves are robust: a stale
        acceptance set only mis-budgets the MAC margin (boost probe:
        2.78e-2 vs 2.87e-2 at 2x margin).  Refreshing geometry needs no
        host round-trip and no list change, so it can run between scan
        segments INSIDE a reuse window (cost: one [G, C] reduce + heap
        sweep + h2 re-fold over the entry cap).

        The reference has no analogue — its tree reuse freezes everything
        (fmm_cart3_kdtree.cuh:1619-1642); this is the upgrade that makes
        long reuse windows hold a production error bound.
        """
        fn = getattr(self, "_geom_refresh_cached", None)
        if fn is None:
            fn = self._geom_refresh_cached = jax.jit(self.geom_refresh_in_jit)
        return fn(ppad, fs)

    def geom_refresh_in_jit(self, ppad: jax.Array, fs: FmmState) -> FmmState:
        """Traceable body of :meth:`refresh_geometry_device` — usable
        inside the production window scan (Simulator's geom_refresh knob)
        so every force eval sees expansion geometry computed from CURRENT
        positions while lists/permutation stay frozen."""
        mask = self.mask3[..., None]
        multf = jnp.asarray(np.maximum(self.st.mult, 1).astype(np.float32))
        mn = jnp.min(jnp.where(mask, ppad, jnp.float32(3e38)), axis=1)
        mx = jnp.max(jnp.where(mask, ppad, jnp.float32(-3e38)), axis=1)
        sm = jnp.sum(jnp.where(mask, ppad, 0.0), axis=1)
        lmn, lmx, lsm = [mn], [mx], [sm]
        for _ in range(self.L):
            a, b, c = lmn[-1], lmx[-1], lsm[-1]
            lmn.append(jnp.minimum(a[0::2], a[1::2]))
            lmx.append(jnp.maximum(b[0::2], b[1::2]))
            lsm.append(c[0::2] + c[1::2])
        mnh = jnp.concatenate(lmn[::-1])
        mxh = jnp.concatenate(lmx[::-1])
        smh = jnp.concatenate(lsm[::-1])
        center = smh / multf[:, None]
        lam = jnp.maximum(
            0.5 * jnp.linalg.norm(mxh - mnh, axis=1), 1e-30)
        if self.m2l_fly:
            # the scan body reads geometry straight from center/lam —
            # nothing else to refresh (the refresh is just this heap sweep)
            return fs._replace(center=center, lam=lam)
        h2, w, logc = self._m2l_geo_jit(
            center, lam, fs.m2l_tgt, fs.m2l_src, fs.m2l_valid)
        return fs._replace(center=center, lam=lam, m2l_h2=h2,
                           m2l_w=w, m2l_logc=logc)

    @property
    def _leaf_stats_jit(self):
        fn = getattr(self, "_leaf_stats_cached", None)
        if fn is None:
            mask = self.mask3[..., None]
            big = jnp.float32(3e38)

            @jax.jit
            def leaf_stats(ppad):
                mn = jnp.min(jnp.where(mask, ppad, big), axis=1)
                mx = jnp.max(jnp.where(mask, ppad, -big), axis=1)
                sm = jnp.sum(jnp.where(mask, ppad, 0.0), axis=1)
                return jnp.stack([mn, mx, sm])

            fn = self._leaf_stats_cached = leaf_stats
        return fn

    def _traverse(self, c_h, lb_h, rb_h):
        """Dual-tree traversal + dual-granularity list construction.

        Hybrid: the (single-core) native C++ dual traversal runs only down
        to the BLOCK level
        and the 2 extra sub-leaf levels are refined by a vectorized,
        level-synchronous numpy pass over the block-level near pairs
        (bounded depth => fixed-shape array ops, no per-pair recursion).
        Falls back to a full numpy traversal without the native lib.
        Returns (m2l_directed, near) target-sorted, see :meth:`_fine_lists`.
        """
        from coulomb_oscillators import native as conative
        L, S = self.L, self.sub_depth
        # Temporal MAC slack: inflate node bounds by the expected
        # within-reuse-window particle drift before the acceptance test, so
        # no accepted M2L pair can become inadmissible (divergent expansion)
        # and no truly-near pair can be missing from the P2P list while the
        # lists are frozen.  The frozen ACCEPTANCE SET dominates the
        # stale-window error: a few pairs drift past their convergence
        # radius and blow up.  Inflation only
        # affects list construction; expansion geometry stays exact.  Set by
        # the Simulator from max|v|*dt*max_list_age (auto) or explicitly.
        # The reference freezes lists with no slack and eats the drift
        # (fmm_cart3_kdtree.cuh:1619-1642).
        sm_env = os.environ.get("CO_STALE_MARGIN")
        sm = (float(sm_env) if sm_env is not None
              else getattr(self, "stale_margin_abs", 0.0))
        # scalar (env/explicit) or per-axis [dim] vector (auto: per-axis
        # rms drift — bounds inflate per axis, broadcast handles both)
        if np.any(np.asarray(sm) > 0.0):
            lb_h = (lb_h - sm).astype(lb_h.dtype)
            rb_h = (rb_h + sm).astype(rb_h.dtype)
        # seed capacities from the previous traversal so growth never costs
        # a full re-traversal (the native path re-runs on overflow)
        last = getattr(self, "last_raw_counts", None) or {}
        caps = {k: max(1 << 20, int(last.get(k, 0) * 1.3))
                for k in ("m2l", "near")}
        out = conative.traverse_fine(
            c_h, lb_h, rb_h, self.st.mult, L, S, self.n, self.dim,
            self.p, float(self.config.tree_radius), self.config.coll,
            mult_floor=self.mac_mult_floor, sub_boost=self.mac_sub_boost,
            m2l_cap=caps["m2l"], near_cap=caps["near"])
        if out is None:
            m2l_u, p2p_u = _traverse_raw(
                c_h, lb_h, rb_h, self.st.mult, L, self.n, self.p,
                float(self.config.tree_radius),
                mult_floor=self.mac_mult_floor,
                boost_from=_heap_off(L - S + 1) if S else None,
                sub_boost=self.mac_sub_boost)
            self.last_raw_counts = {"m2l": int(m2l_u.shape[0]) * 2,
                                    "near": int(p2p_u.shape[0])}
            near, m2l_d = self._fine_lists(m2l_u, p2p_u)
            return m2l_d, near
        m2l_d, near = out
        self.last_raw_counts = {"m2l": int(m2l_d.shape[0]),
                                "near": int(near.shape[0])}
        return m2l_d, near

    # ---------------- force ----------------
    def force(self, pos: jax.Array, fstate: FmmState) -> jax.Array:
        """Coulomb acceleration (kappa-scaled) in the ORIGINAL particle
        order."""
        return self._force_jit(pos, fstate)

    def force_in_jit(self, pos: jax.Array, fs: FmmState) -> jax.Array:
        """Traceable force (for composition inside an outer jit)."""
        return self._force_impl(pos, fs)

    def _force_impl(self, pos: jax.Array, fs: FmmState) -> jax.Array:
        """Padded-leaf-block pipeline: after the one permutation gather, all
        per-particle work happens on [G, C, dim] blocks."""
        ppad = self.pad_array(pos, fs, fill=FAR)
        acc_pad = self.force_padded_in_jit(ppad, fs)
        return self.unpad_array(acc_pad, fs)

    # ---------------- padded persistent state ----------------
    # The Simulator can keep the whole integrator state as padded [G, C, dim]
    # blocks between rebuilds, which removes every per-step N-row gather
    # (perm / pad / unpad / inv_perm).  This strengthens the reference's
    # sorted-state mode (`b_unsort=false`, fmm_cart3_kdtree.cuh:1746-1760),
    # which keeps particles in tree order and permutes velocities at rebuild.

    def pad_array(self, x: jax.Array, fs: FmmState,
                  fill: float = 0.0) -> jax.Array:
        """Original-order [n, k] -> padded leaf blocks [G, C, k]."""
        st = self.st
        G, C = 1 << self.L, st.C
        x_s = jnp.take(x, fs.perm, axis=0)
        flat = jnp.where(jnp.asarray(st.pad_mask)[:, None],
                         jnp.take(x_s, jnp.asarray(st.pad_gather), axis=0),
                         x.dtype.type(fill))
        return flat.reshape(G, C, x.shape[1])

    def unpad_array(self, xpad: jax.Array, fs: FmmState) -> jax.Array:
        """Padded [G, C, k] -> original-order [n, k]."""
        st = self.st
        xs = jnp.take(xpad.reshape(-1, xpad.shape[-1]),
                      jnp.asarray(st.unpad_gather), axis=0)
        return jnp.take(xs, fs.inv_perm, axis=0)

    @property
    def mask3(self) -> jax.Array:
        """[G, C] validity of padded slots (static)."""
        return jnp.asarray(self.st.pad_mask).reshape(1 << self.L, self.st.C)

    # ---------------- padded-layout remap (async rebuild adoption) -------
    # Re-sorting as unpad (2 N-gathers x 3 arrays) + pad (2 more) per
    # window boundary would cost more than the amortized rebuild itself.
    # The composition old-padded-slot <- new-padded-slot is a
    # single static-shape gather per array.

    @property
    def _repad_jit(self):
        fn = getattr(self, "_repad_cached", None)
        if fn is None:
            st = self.st
            G, C, dim = 1 << self.L, st.C, self.dim
            pad_g = jnp.asarray(st.pad_gather)      # [G*C] -> sorted slot
            unpad_g = jnp.asarray(st.unpad_gather)  # [n] -> padded slot
            maskf = jnp.asarray(st.pad_mask)[:, None]

            @jax.jit
            def compose(inv_old, perm_new):
                # new padded slot i -> old padded slot:
                #   orig particle o = perm_new[pad_gather[i]]
                #   old sorted slot s0 = inv_old[o]; old padded = unpad[s0]
                o = jnp.take(perm_new, pad_g)
                return jnp.take(unpad_g, jnp.take(inv_old, o))

            @jax.jit
            def repad(ppos, pvel, pacc, remap):
                def g(x, fill):
                    flat = jnp.take(x.reshape(G * C, dim), remap, axis=0)
                    return jnp.where(maskf, flat,
                                     x.dtype.type(fill)).reshape(G, C, dim)
                return g(ppos, FAR), g(pvel, 0.0), g(pacc, 0.0)

            fn = self._repad_cached = (compose, repad)
        return fn

    def make_repad(self, fs_old: FmmState, fs_new: FmmState) -> jax.Array:
        """[G*C] gather map: new padded slot -> old padded slot (device)."""
        return self._repad_jit[0](fs_old.inv_perm, fs_new.perm)

    def repad_triple(self, ppos, pvel, pacc, remap):
        """Apply a :meth:`make_repad` map to the padded (pos, vel, acc)."""
        return self._repad_jit[1](ppos, pvel, pacc, remap)

    def force_padded_in_jit(self, ppad: jax.Array, fs: FmmState) -> jax.Array:
        """Coulomb acceleration on padded blocks [G, C, dim] (kappa-scaled).
        Pad slots (pos = FAR) receive ~0; mask before integrating."""
        dtype = ppad.dtype
        kappa = dtype.type(self.config.kappa(self.n))
        mask3 = self.mask3
        t = self.tables
        G = 1 << self.L
        C = self.st.C
        Gb, CB = self.G_blk, self.C_blk
        nsub = 1 << self.sub_depth
        leaf0 = _heap_off(self.L)

        # --- leaf frames in BLOCK layout -----------------------------------
        # All per-particle far-field work runs on [Gb, CB]-shaped arrays
        # (CB = the 128-wide block); per-SUB-LEAF quantities broadcast into
        # their C-wide groups via free reshape/broadcast folding.
        pblk = ppad.reshape(Gb, CB, self.dim)
        maskB = mask3.reshape(Gb, CB)
        leafc = fs.center[leaf0:leaf0 + G].reshape(Gb, nsub, 1, self.dim)
        leafl = fs.lam[leaf0:leaf0 + G]
        lamB = leafl.reshape(Gb, nsub, 1)
        e = (pblk.reshape(Gb, nsub, C, self.dim) - leafc) / lamB[..., None]
        e = jnp.where(maskB.reshape(Gb, nsub, C)[..., None], e, 0.0)
        e = e.reshape(Gb, CB, self.dim)
        Vcols = mop.eval_monomial_cols(e, t.PL, t.dim)     # list of [Gb, CB]
        # L2P recomputes its monomial columns from a CSE-barrier'd copy of
        # the offsets: sharing ONE materialized column set between P2M and
        # L2P makes XLA write all ~S_Lf [Gb, CB] columns to device memory
        # and re-read them per output dim.  The monomial DAG is ~100 cheap
        # flops per particle; duplicating it lets each consumer fuse it
        # inline and the columns never materialize.
        e_l2p = jax.lax.optimization_barrier(e)
        Vcols_l2p = mop.eval_monomial_cols(e_l2p, t.PL, t.dim)

        # --- P2M (block layout; masked offsets are 0, so only the order-0
        # column needs masking — its sum is the static sub-leaf count) ------
        counts = jnp.asarray(
            self.st.mult[leaf0:].reshape(Gb, nsub).astype(np.float32))
        mp_cols = [counts]
        for j in range(1, t.S_M):
            col = Vcols[int(t.m_slots[j])]
            s = col.reshape(Gb, nsub, C).sum(axis=2)       # [Gb, nsub]
            mp_cols.append(dtype.type(t.p2m_coef[j]) * s)
        mpole_leaf = jnp.stack(mp_cols, axis=-1).reshape(G, t.S_M)

        mpole_heap = self.m2m_up(mpole_leaf, fs)
        local_heap = self._stage_m2l(mpole_heap, fs)
        leaf_local = self.l2l_down(local_heap, fs)

        # --- L2P (block layout, static-column derivative terms) -------------
        Lf = mop.expand_L(t, leaf_local)                   # [G, S_Lf]
        LfB = Lf.reshape(Gb, nsub, t.S_Lf)
        from coulomb_oscillators.ops.multipole.operators import _l2p_terms
        terms = _l2p_terms(t.dim, t.PL)
        outs = []
        for a in range(t.dim):
            acc = None
            for (j, k, c) in terms[a]:
                lj = (dtype.type(c) * LfB[:, :, j])[:, :, None]  # [Gb,nsub,1]
                term = (lj * Vcols_l2p[k].reshape(Gb, nsub, C)).reshape(Gb, CB)
                acc = term if acc is None else acc + term
            outs.append(acc)
        lam_div = lamB[..., None]                          # [Gb, nsub, 1, 1]
        far_blk = (-jnp.stack(outs, axis=-1).reshape(Gb, nsub, C, t.dim)
                   / lam_div).reshape(Gb, CB, t.dim)
        far_blk = far_blk * maskB[..., None]

        near_blk = self._stage_p2p(ppad, fs).reshape(Gb, CB, self.dim)
        return ((far_blk + near_blk) * kappa).reshape(G, C, self.dim)

    def potential(self, pos: jax.Array, fs: FmmState) -> jax.Array:
        """Per-particle softened Coulomb potential (kappa-scaled), original
        order.  Far field from the local expansions (which include the
        monopole term), near field via a direct pass over the P2P pair
        list, minus the self-interaction 1/eps.  Enables O(N) total-energy
        diagnostics at scales where the O(N^2) oracle is impractical."""
        return self._potential_jit(pos, fs)

    def _potential_impl(self, pos: jax.Array, fs: FmmState) -> jax.Array:
        import math as _math
        st = self.st
        t = self.tables
        n, L, dim, C = self.n, self.L, self.dim, st.C
        G = 1 << L
        dtype = pos.dtype
        kappa = dtype.type(self.config.kappa(n))

        pos_s = jnp.take(pos, fs.perm, axis=0)
        pad_mask = jnp.asarray(st.pad_mask)
        flat = jnp.where(pad_mask[:, None],
                         jnp.take(pos_s, jnp.asarray(st.pad_gather), axis=0),
                         dtype.type(FAR))
        ppad = flat.reshape(G, C, dim)
        mask3 = pad_mask.reshape(G, C)

        mpole_heap = self._stage_multipoles(ppad, mask3, fs)
        local_heap = self._stage_m2l(mpole_heap, fs)

        # far-field potential: Phi = sum mult(d) Lf[d] w^d per leaf block
        leaf_local = self.l2l_down(local_heap, fs)

        w, _leafl = self._leaf_frame(ppad, mask3, fs)
        from coulomb_oscillators.ops.multipole import harmonics as hm
        Lf = mop.expand_L(t, leaf_local)                    # [G, S_Lf]
        V = hm.eval_monomials(w.reshape(G * C, dim), t.PL, t.dim)
        V = V.reshape(G, C, -1)
        multv = jnp.asarray(t.l2p_mult, dtype)
        pot_far = jnp.einsum("gj,gcj->gc", Lf * multv[None, :], V,
                             precision=mop.PREC)

        # near-field potential over the p2p list
        pchunk = min(self.p2p_chunk, fs.p2p_tgt.shape[0])
        Q = fs.p2p_tgt.shape[0]
        qpad = -(-Q // pchunk) * pchunk
        tgt_c = jnp.pad(jnp.minimum(fs.p2p_tgt, G), (0, qpad - Q),
                        constant_values=G).reshape(-1, pchunk)
        src_c = jnp.pad(fs.p2p_src, (0, qpad - Q)).reshape(-1, pchunk)
        val_c = jnp.pad(fs.p2p_valid, (0, qpad - Q)).reshape(-1, pchunk)
        eps2 = dtype.type(self.config.eps2)

        pos_blk = ppad.reshape(self.G_blk, self.C_blk, dim)
        shift = self.mask_shift
        blkmask = (1 << shift) - 1
        group = jnp.arange(self.C_blk, dtype=jnp.int32) // C

        def pot_body(acc, args):
            ti, si, vv = args
            mb = ((si[:, None] >> (shift + group[None, :])) & 1)
            P_t = jnp.take(ppad, jnp.minimum(ti, G - 1), axis=0)
            P_s = jnp.take(pos_blk, si & blkmask, axis=0)
            dist2 = eps2
            for a in range(dim):
                da = P_t[:, :, None, a] - P_s[:, None, :, a]
                dist2 = dist2 + da * da
            if dim == 3:
                phi = jax.lax.rsqrt(dist2)
            else:
                phi = -0.5 * jnp.log(dist2)
            phi = phi * (vv[:, None, None] & (mb[:, None, :] > 0))
            part = jax.ops.segment_sum(jnp.sum(phi, axis=2), ti,
                                       num_segments=G + 1,
                                       indices_are_sorted=True)
            return acc + part, None

        pot_init = jnp.zeros((G + 1, C), dtype)
        pot_near, _ = jax.lax.scan(pot_body, pot_init, (tgt_c, src_c, val_c))
        pot_near = pot_near[:G]
        # remove the self term contributed by each leaf's self pair; with
        # coll=False the P2P list is empty, so no self term was ever added
        if self.config.coll:
            self_phi = (1.0 / _math.sqrt(self.config.eps2) if dim == 3
                        else -0.5 * _math.log(self.config.eps2))
            pot_near = pot_near - dtype.type(self_phi)

        pot_pad = ((pot_far + pot_near) * mask3).reshape(G * C)
        pot_s = jnp.take(pot_pad, jnp.asarray(st.unpad_gather), axis=0)
        return jnp.take(pot_s * kappa, fs.inv_perm, axis=0)

    # ---- pipeline stages (separately jittable for perf work) ----

    def _leaf_frame(self, ppad, mask3, fs):
        """Normalized offsets per padded slot: [G, C, dim] (0 at pad)."""
        L = self.L
        leaf0 = _heap_off(L)
        G = ppad.shape[0]
        leafc = fs.center[leaf0:leaf0 + G]                 # slice, no gather
        leafl = fs.lam[leaf0:leaf0 + G]
        e = (ppad - leafc[:, None, :]) / leafl[:, None, None]
        return jnp.where(mask3[..., None], e, 0.0), leafl

    def p2m_blocks(self, ppad: jax.Array, mask3: jax.Array,
                   leafc: jax.Array, leafl: jax.Array) -> jax.Array:
        """P2M on a run of padded leaf blocks (any contiguous slice):
        [Gb, C, dim] + per-block center/scale -> leaf multipoles [Gb, S_M]."""
        t = self.tables
        e = (ppad - leafc[:, None, :]) / leafl[:, None, None]
        e = jnp.where(mask3[..., None], e, 0.0)
        Vcols = mop.eval_monomial_cols(e, t.PM, t.dim)
        return mop.p2m_from_cols(t, Vcols, mask3)

    def m2m_up(self, mpole_leaf: jax.Array, fs: FmmState) -> jax.Array:
        """M2M sweep: leaf multipoles [G, S_M] -> full heap [Mheap, S_M].

        One fori_loop over the levels, each step on G-row windows of the
        heap (rows past the level's 2^l nodes are masked), so the program
        holds one traced M2M body instead of L unrolled copies: its size
        and compile time no longer grow with the tree depth.  The padded
        rows cost ~L/4 times the sweep's own flops, a small share of the
        force eval."""
        t = self.tables
        L = self.L
        G = 1 << L
        S = mpole_leaf.shape[1]
        dtype = mpole_leaf.dtype
        rows = jnp.arange(G // 2)
        heap = jnp.concatenate(
            [jnp.zeros((G - 1, S), dtype), mpole_leaf], axis=0)
        dslice = jax.lax.dynamic_slice_in_dim

        def body(i, carry):
            heap, cur = carry            # cur: level l+1 in its first rows
            l = L - 1 - i
            off_c = (1 << (l + 1)) - 1
            off_p = (1 << l) - 1
            pc = jnp.repeat(dslice(fs.center, off_p, G // 2), 2, axis=0)
            pl = jnp.repeat(dslice(fs.lam, off_p, G // 2), 2, axis=0)
            s = (dslice(fs.center, off_c, G) - pc) / pl[:, None]
            rho = dslice(fs.lam, off_c, G) / pl
            par = mop.m2m(t, cur, s, rho).reshape(G // 2, 2, S).sum(axis=1)
            live = (rows < (1 << l))[:, None]
            par = jnp.where(live, par, 0.0)
            heap = jax.lax.dynamic_update_slice_in_dim(
                heap, jnp.where(live, par, dslice(heap, off_p, G // 2)),
                off_p, axis=0)
            return heap, jnp.concatenate([par, jnp.zeros_like(par)], axis=0)

        heap, _ = jax.lax.fori_loop(0, L, body, (heap, mpole_leaf))
        return heap                                           # [Mheap, S_M]

    def _stage_multipoles(self, ppad: jax.Array, mask3: jax.Array,
                          fs: FmmState) -> jax.Array:
        """P2M at leaves (padded blocks) + M2M up; mpole_heap [Mheap, S_M]."""
        G = 1 << self.L
        leaf0 = _heap_off(self.L)
        mpole_leaf = self.p2m_blocks(ppad, mask3,
                                     fs.center[leaf0:leaf0 + G],
                                     fs.lam[leaf0:leaf0 + G])
        return self.m2m_up(mpole_leaf, fs)

    def _stage_m2l(self, mpole_heap: jax.Array, fs: FmmState) -> jax.Array:
        """M2L over the DIRECTED entry list (t <- s); returns local_heap.

        Directed entries replace the reference's both-directions-per-pair
        parity reuse (fmm_c2c3_kdtree_krnl:655-661): the dual-granularity
        near field absorbs individual directions, and the sparse
        static-column contraction (operators.m2l_sparse) is cheap enough
        per entry that directed application wins overall."""
        t = self.tables
        L = self.L
        dtype = mpole_heap.dtype
        Mheap = _heap_off(L + 1)

        K = fs.m2l_tgt.shape[0]
        # grouped layout active iff the gtgt array matches this (possibly
        # sharded) entry slice — parallel wrappers that re-pad entries
        # without regrouping fall back to the per-entry scatter
        g = self.m2l_group
        grouped = g > 1 and fs.m2l_gtgt.shape[0] * g == K
        chunk = _pick_chunk(K, self.m2l_chunk, g if grouped else 1)
        nch = K // chunk

        # per-step live data: the multipole gather, plus either the
        # rebuild-time geometry fold (streamed sequentially) or — fly mode —
        # 8 gathered words/entry from fs.center/fs.lam with the fold
        # recomputed in-body (same m2l_fold_geo -> m2l_sparse_pre numerics;
        # kills the stored fold's per-eval relayout + slicing and keeps the
        # geometry current with geom_refresh'd centers for free)
        bc = fs.m2l_src.reshape(nch, chunk)
        vc = fs.m2l_valid.reshape(nch, chunk)
        fly = self.m2l_fly
        if fly:
            center, lam = fs.center, fs.lam
            dim = self.dim

            def geo(bi, vv, ta):
                a_cl = jnp.minimum(ta, Mheap - 1)
                R = tuple(
                    jnp.where(vv,
                              jnp.take(center[:, d], a_cl)
                              - jnp.take(center[:, d], bi),
                              jnp.float32(1.0))
                    for d in range(dim))
                la = jnp.take(lam, a_cl)
                lb = jnp.take(lam, bi)
                return mop.m2l_fold_geo(t, R, la, lb)
        else:
            h2c = fs.m2l_h2.reshape(nch, chunk, -1)
            wc = fs.m2l_w.reshape(nch, chunk)
            lgc = fs.m2l_logc.reshape(nch, chunk)
        tac = jnp.minimum(
            fs.m2l_tgt + (~fs.m2l_valid) * Mheap,
            Mheap).reshape(nch, chunk)

        if grouped:
            # dense-reduce each g-run of same-target entries (a cheap
            # reshape-sum), then a g-fold-smaller sorted segment_sum
            gtc = fs.m2l_gtgt.reshape(nch, chunk // g)

            if fly:
                def m2l_body(acc, args):
                    bi, vv, ta, gta = args
                    MbX = jnp.take(mpole_heap, bi, axis=0)  # [chunk, S_M]
                    H2, w, logc = geo(bi, vv, ta)
                    La = mop.m2l_sparse_pre(t, MbX, H2, w, logc)
                    La = La * vv[:, None]
                    La = La.reshape(-1, g, t.S_Lt).sum(axis=1)
                    part = jax.ops.segment_sum(La, gta,
                                               num_segments=Mheap + 1,
                                               indices_are_sorted=True)
                    return acc + part, None

                xs = (bc, vc, tac, gtc)
            else:
                def m2l_body(acc, args):
                    bi, vv, H2, w, logc, gta = args
                    MbX = jnp.take(mpole_heap, bi, axis=0)  # [chunk, S_M]
                    La = mop.m2l_sparse_pre(t, MbX, H2, w, logc)
                    La = La * vv[:, None]
                    La = La.reshape(-1, g, t.S_Lt).sum(axis=1)
                    part = jax.ops.segment_sum(La, gta,
                                               num_segments=Mheap + 1,
                                               indices_are_sorted=True)
                    return acc + part, None

                xs = (bc, vc, h2c, wc, lgc, gtc)
        else:
            if fly:
                def m2l_body(acc, args):
                    bi, vv, ta = args
                    MbX = jnp.take(mpole_heap, bi, axis=0)  # [chunk, S_M]
                    H2, w, logc = geo(bi, vv, ta)
                    La = mop.m2l_sparse_pre(t, MbX, H2, w, logc)
                    La = La * vv[:, None]
                    part = jax.ops.segment_sum(La, ta,
                                               num_segments=Mheap + 1,
                                               indices_are_sorted=True)
                    return acc + part, None

                xs = (bc, vc, tac)
            else:
                def m2l_body(acc, args):
                    bi, vv, ta, H2, w, logc = args
                    MbX = jnp.take(mpole_heap, bi, axis=0)  # [chunk, S_M]
                    La = mop.m2l_sparse_pre(t, MbX, H2, w, logc)
                    La = La * vv[:, None]
                    part = jax.ops.segment_sum(La, ta,
                                               num_segments=Mheap + 1,
                                               indices_are_sorted=True)
                    return acc + part, None

                xs = (bc, vc, tac, h2c, wc, lgc)

        local_init = jnp.zeros((Mheap + 1, t.S_Lt), dtype)
        local_heap, _ = jax.lax.scan(m2l_body, local_init, xs)
        return local_heap[:Mheap]

    def l2l_down(self, local_heap: jax.Array, fs: FmmState) -> jax.Array:
        """L2L sweep: local heap [Mheap, S_Lt] -> leaf locals [G, S_Lt].

        One fori_loop over the levels on G-row windows (rows past the
        level's 2^l nodes are masked), as in :meth:`m2m_up`."""
        t = self.tables
        L = self.L
        G = 1 << L
        rows = jnp.arange(G)
        dslice = jax.lax.dynamic_slice_in_dim
        cur = jnp.zeros((G, local_heap.shape[1]), local_heap.dtype)
        cur = cur.at[0].set(local_heap[0])

        def body(l, cur):                # cur: level l-1 in its first rows
            off = (1 << l) - 1
            off_p = (1 << (l - 1)) - 1
            pc = jnp.repeat(dslice(fs.center, off_p, G // 2), 2, axis=0)
            pl = jnp.repeat(dslice(fs.lam, off_p, G // 2), 2, axis=0)
            s = (dslice(fs.center, off, G) - pc) / pl[:, None]
            rho = dslice(fs.lam, off, G) / pl
            parent = jnp.repeat(cur[:G // 2], 2, axis=0)
            locs = mop.l2l(t, parent, s, rho) + dslice(local_heap, off, G)
            return jnp.where((rows < (1 << l))[:, None], locs, 0.0)

        return jax.lax.fori_loop(1, L + 1, body, cur)         # [G, S_Lt]

    def l2p_blocks(self, ppad: jax.Array, mask3: jax.Array,
                   leaf_local: jax.Array, leafc: jax.Array,
                   leafl: jax.Array) -> jax.Array:
        """L2P on a run of padded leaf blocks (any contiguous slice)."""
        t = self.tables
        w = (ppad - leafc[:, None, :]) / leafl[:, None, None]
        w = jnp.where(mask3[..., None], w, 0.0)
        Vcols = mop.eval_monomial_cols(w, t.PL, t.dim)
        Lf = mop.expand_L(t, leaf_local)
        F = mop.l2p_field_cols(t, Lf, Vcols, leafl)
        return F * mask3[..., None]

    def _stage_local(self, ppad: jax.Array, mask3: jax.Array,
                     local_heap: jax.Array, fs: FmmState) -> jax.Array:
        """L2L down + L2P; far-field acceleration on padded blocks."""
        L = self.L
        G = 1 << L
        leaf0 = _heap_off(L)
        leaf_local = self.l2l_down(local_heap, fs)
        return self.l2p_blocks(ppad, mask3, leaf_local,
                               fs.center[leaf0:leaf0 + G],
                               fs.lam[leaf0:leaf0 + G])

    def _stage_p2p(self, ppad: jax.Array, fs: FmmState) -> jax.Array:
        """Near-field pass; acceleration on padded blocks [G, C, dim]
        (unscaled by kappa): the P2P kernel where `use_pallas`, else the
        jnp scan.

        Both use the per-axis difference form.  An assembled form
        (f_d = t'_d * sum w - sum w s'_d as a batched matmul) cancels in
        f32 for close pairs: the two terms are each O(sum_w * leaf_scale)
        while their difference is O(w * |t-s|).
        """
        if self.use_pallas:
            return self._p2p_kernel(ppad, fs)
        return self._p2p_scan(ppad, fs)

    def _p2p_kernel(self, ppad: jax.Array, fs: FmmState) -> jax.Array:
        from coulomb_oscillators.ops.fmm.p2p_triton import p2p_near
        return p2p_near(ppad, fs.p2p_row_ptr, fs.p2p_src,
                        nsub=1 << self.sub_depth,
                        eps2=float(self.config.eps2),
                        mask_shift=self.mask_shift,
                        interpret=self.p2p_interpret)

    def _p2p_scan(self, ppad: jax.Array, fs: FmmState) -> jax.Array:
        """Chunked jnp scan over the near list: each chunk of `p2p_chunk`
        (target sub-leaf, source block) entries builds its [C, CB] tiles
        and segment-sums them into the target rows (the reference's
        warp-cooperative accumulation, fmm_cart3_kdtree.cuh:767-1046)."""
        st = self.st
        dim, C = self.dim, st.C
        G = self.G_sub
        Gb, CB = self.G_blk, self.C_blk
        dtype = ppad.dtype
        eps2 = dtype.type(self.config.eps2)

        pos_blk = ppad.reshape(Gb, CB, dim)
        shift = self.mask_shift
        blkmask = (1 << shift) - 1
        group = jnp.arange(CB, dtype=jnp.int32) // C          # [CB]

        tgt = jnp.minimum(fs.p2p_tgt, G - 1)
        src = fs.p2p_src

        pchunk = min(self.p2p_chunk, tgt.shape[0])
        Q = tgt.shape[0]
        qpad = -(-Q // pchunk) * pchunk
        tgt_c = jnp.pad(tgt, (0, qpad - Q), constant_values=G).reshape(-1, pchunk)
        src_c = jnp.pad(src, (0, qpad - Q)).reshape(-1, pchunk)
        val_c = jnp.pad(fs.p2p_valid, (0, qpad - Q)).reshape(-1, pchunk)

        def p2p_body(acc, args):
            ti, si, vv = args
            ti_cl = jnp.minimum(ti, G - 1)
            si_blk = si & blkmask
            # sub-leaf group mask from the packed top bits
            mb = ((si[:, None] >> (shift + group[None, :])) & 1)  # [pc, CB]
            P_t = jnp.take(ppad, ti_cl, axis=0)               # [pc, C, dim]
            P_s = jnp.take(pos_blk, si_blk, axis=0)           # [pc, CB, dim]
            dist2 = eps2
            ds = []
            for a in range(dim):
                da = P_t[:, :, None, a] - P_s[:, None, :, a]  # [pc, C, CB]
                ds.append(da)
                dist2 = dist2 + da * da
            r = jax.lax.rsqrt(dist2)
            if dim == 3:
                wgt = r * r * r
            else:
                wgt = r * r
            wgt = wgt * (vv[:, None, None] & (mb[:, None, :] > 0))
            f = jnp.stack([jnp.sum(ds[a] * wgt, axis=2)
                           for a in range(dim)], axis=-1)
            part = jax.ops.segment_sum(f, ti, num_segments=G + 1,
                                       indices_are_sorted=True)
            return acc + part, None

        acc_init = jnp.zeros((G + 1, C, dim), dtype)
        acc_pad, _ = jax.lax.scan(p2p_body, acc_init, (tgt_c, src_c, val_c))
        return acc_pad[:G]
