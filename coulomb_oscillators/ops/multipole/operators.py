"""Batched FMM operators (runtime, jnp).

All functions are pure, batched over a leading axis, static-shaped, and
built from the tables in tables.py.  See tables.py for the conventions.

Reference parity: p2m/p2m_acc3 (fmm_cart_base3.cuh:896-994), m2m_acc3
(:1006-1179), m2l_acc3 (:1181-1346), l2l_acc3 (:1348-1454), l2p_field3 /
m2p_field3 (:1456-1611) — re-derived, not translated; the per-element
recursions become gathers + einsums.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coulomb_oscillators.ops.multipole import harmonics as hm
from coulomb_oscillators.ops.multipole.tables import FmmTables, build_tables

# All operator contractions run at HIGHEST precision: by default an
# accelerator may multiply f32 matmul inputs at reduced precision (TF32 on
# the GPU's tensor cores, about three decimal digits), which floors the
# whole far field near 1e-3 relative error regardless of the expansion
# order p, while in f32 the engine converges to ~2e-7 (p=9).  The operator
# matmuls are a small share of the force eval; the near field is
# elementwise and unaffected.
PREC = jax.lax.Precision.HIGHEST

# Above this expansion order the static-column sparse operator forms are
# counterproductive: their term lists grow combinatorially (thousands of
# traced ops at p=10), exploding trace+compile time, while the dense
# W-matrix forms stay one matmul.  p <= 6 covers every production config
# (the reference autotune grid stops at 6, main3.cu:739); higher orders
# (-test sweeps to 10) take the dense path.
SPARSE_P_MAX = 6


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _m2l_terms(dim: int, p: int, truncate: bool = True,
               no_dipole: bool = False):
    """Static sparse term list of the M2L contraction, grouped by output
    slot: terms[i] = tuple of (j, h, coef) with
    L[b, i] = sum coef * Mv[b, j] * H[b, h].

    The dense per-pair operator form (K = H @ m2l_W reshaped [B, S_Lt, S_M])
    materializes a [B, S_Lt*S_M] intermediate (~2000 floats/pair at p=5);
    this static-column form runs the same contraction as ~380 fused
    multiply-adds per pair with no intermediate — the analogue of the
    reference's unrolled static_m2l_acc3 (fmm_cart_base3.cuh:1265-1346).
    """
    t = build_tables(dim, p, truncate, no_dipole)
    terms = []
    for i in range(t.S_Lt):
        row = []
        for j in range(t.S_M):
            c = t.m2l_coef[i, j]
            if c != 0.0:
                row.append((j, int(t.m2l_idx[i, j]), float(c)))
        terms.append(tuple(row))
    return tuple(terms)


def _pow_cols(x: jax.Array, max_order: int):
    """[B] -> list of [B] columns [1, x, x^2, .., x^max_order]."""
    cols = [jnp.ones_like(x)]
    for _ in range(max_order):
        cols.append(cols[-1] * x)
    return cols


def m2l_sparse(t: FmmTables, M: jax.Array, H: jax.Array, v: jax.Array,
               u: jax.Array, sign: int = 1) -> jax.Array:
    """Directed sparse M2L core: source multipoles M [B, S_M], harmonics
    H [B, S_H] at Rhat (R = x_tgt - x_src), v = lam_src/r, u = lam_tgt/r.
    Returns L [B, S_Lt] BEFORE the 1/r^eta factor and the 2D monopole
    log-correction (callers apply those).  sign=-1 evaluates the opposite
    direction using the parity H_k(-Rhat) = (-1)^k H_k(Rhat).
    """
    if t.p > SPARSE_P_MAX:
        W = _j(t.m2l_W, M.dtype).reshape(t.S_H, -1)
        K = jnp.matmul(H, W, precision=PREC).reshape(-1, t.S_Lt, t.S_M)
        if sign == -1:
            par = _j((-1.0) ** (np.asarray(t.nt_order)[:, None]
                                + np.asarray(t.m_order)[None, :]), M.dtype)
            K = K * par[None]
        Mv = M * (v[:, None] ** _j(t.m_order, M.dtype)[None, :])
        L = jnp.sum(K * Mv[:, None, :], axis=2)
        return L * (u[:, None] ** _j(t.nt_order, M.dtype)[None, :])
    terms = _m2l_terms(t.dim, t.p, True, t.no_dipole)
    vp = _pow_cols(v, t.PM)
    up = _pow_cols(u, t.PL)
    m_ord = t.m_order
    n_ord = t.nt_order
    Mv = [M[:, j] * vp[int(m_ord[j])] for j in range(t.S_M)]
    cols = []
    for i, row in enumerate(terms):
        acc = None
        for (j, h, c) in row:
            if sign == -1 and (int(n_ord[i]) + int(m_ord[j])) % 2 == 1:
                c = -c
            term = (c * Mv[j]) * H[:, h]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros(M.shape[0], M.dtype)
        cols.append(acc * up[int(n_ord[i])])
    return jnp.stack(cols, axis=1)


def m2l_fold_geo(t: FmmTables, R: jax.Array, lam_tgt: jax.Array,
                 lam_src: jax.Array):
    """Per-entry M2L geometry, precomputed once per tree rebuild.

    Between rebuilds the centers/scales are frozen, so the harmonics and
    scale factors of every directed M2L entry are constants; folding them
    out of the per-step loop leaves only the (live) multipole gather there.

    Returns (H2, w, logc):
      H2[b, h] = H_h(Rhat) * u^ord(h) / r^eta   (u = lam_tgt/r)
      w[b]     = v/u                            (v = lam_src/r)
      logc[b]  = -log r - 1 (2D monopole correction; unused slot in 3D)
    such that L[b, i] = sum_j coef[i,j] * M[b,j] * w^m_j * H2[b, idx[i,j]]
    (+ M[:,0]*logc in slot 0 for 2D) — see m2l_sparse_pre.

    `R` is a [B, dim] array or a tuple of dim [B] component vectors; at
    the multi-million-entry M2L list sizes the component form avoids
    42x-padded [B, dim] HLO temps (see harmonics.eval_monomials).
    """
    if not isinstance(R, (tuple, list)):
        R = tuple(R[:, d] for d in range(t.dim))
    r = jnp.sqrt(sum(rd * rd for rd in R))
    Rh = tuple(rd / r for rd in R)
    H = hm.eval_H(Rh, t.maxH, t.dim)
    u = lam_tgt / r
    v = lam_src / r
    from coulomb_oscillators.ops.multipole import packing as pk
    _, ord_h, _ = pk.sym_layout(t.maxH, t.dim)
    up = _pow_cols(u, int(ord_h.max()))
    Hcols = [H[:, h] * up[int(ord_h[h])] for h in range(t.S_H)]
    H2 = jnp.stack(Hcols, axis=1)
    if t.dim == 3:
        H2 = H2 / r[:, None]
        logc = jnp.zeros_like(r)
    else:
        logc = -jnp.log(r) - 1.0
    return H2, v / u, logc


def m2l_sparse_pre(t: FmmTables, M: jax.Array, H2: jax.Array,
                   w: jax.Array, logc: jax.Array) -> jax.Array:
    """Per-step sparse M2L application against precomputed geometry
    (see :func:`m2l_fold_geo`): [B, S_M] x [B, S_H] x [B] -> [B, S_Lt]."""
    if t.p > SPARSE_P_MAX:
        W = _j(t.m2l_W, M.dtype).reshape(t.S_H, -1)
        K = jnp.matmul(H2, W, precision=PREC).reshape(-1, t.S_Lt, t.S_M)
        Mv = M * (w[:, None] ** _j(t.m_order, M.dtype)[None, :])
        L = jnp.sum(K * Mv[:, None, :], axis=2)
        if t.dim == 2:
            L = L.at[:, 0].add(M[:, 0] * logc)
        return L
    terms = _m2l_terms(t.dim, t.p, True, t.no_dipole)
    wp = _pow_cols(w, t.PM)
    m_ord = t.m_order
    Mv = [M[:, j] * wp[int(m_ord[j])] for j in range(t.S_M)]
    cols = []
    for i, row in enumerate(terms):
        acc = None
        for (j, h, c) in row:
            term = (c * Mv[j]) * H2[:, h]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros(M.shape[0], M.dtype)
        cols.append(acc)
    L = jnp.stack(cols, axis=1)
    if t.dim == 2:
        L = L.at[:, 0].add(M[:, 0] * logc)
    return L


def eval_monomial_cols(u: jax.Array, max_order: int, dim: int):
    """Monomial columns of u [..., dim] over the sym layout: list of [...]
    arrays (static per-slot products — no [B, S] materialization unless the
    caller stacks them)."""
    import numpy as _np
    from coulomb_oscillators.ops.multipole import packing as pk
    exps = pk.monomial_exponents(max_order, dim)
    pows = [_pow_cols(u[..., a], max_order) for a in range(dim)]
    cols = []
    for s in range(exps.shape[0]):
        c = pows[0][int(exps[s, 0])]
        for a in range(1, dim):
            e = int(exps[s, a])
            if e:
                c = c * pows[a][e]
        cols.append(c)
    return cols


@functools.lru_cache(maxsize=None)
def _l2p_terms(dim: int, p: int):
    """Static term list of the L2P field: per axis a, tuples (j, k, coef)
    with F_a = -(1/lam) sum coef * Lf[:, j] * V[:, k], where
    coef = mult(j) * j_a and k = slot(j - e_a)."""
    from coulomb_oscillators.ops.multipole import packing as pk
    symL, _, symL_idx = pk.sym_layout(p, dim)
    out = []
    for a in range(dim):
        row = []
        for j, dl in enumerate(symL):
            if dl[a] == 0:
                continue
            tgt = list(dl)
            tgt[a] -= 1
            row.append((j, symL_idx[tuple(tgt)],
                        float(pk.multinomial(dl) * dl[a])))
        out.append(tuple(row))
    return tuple(out)


def l2p_field_cols(t: FmmTables, Lf: jax.Array, Vcols, lam: jax.Array) -> jax.Array:
    """Leaf-blocked L2P from precomputed monomial columns.

    Lf [G, S_Lf] expanded locals; Vcols = eval_monomial_cols of w [G, C, dim]
    (list of [G, C]); lam [G].  Returns F [G, C, dim].  Replaces the batched
    [C, S] x [S, dim] einsum (skinny at dim=3) with ~dim*S_Lf fused
    column multiply-adds; monomial columns are shared with P2M.
    """
    terms = _l2p_terms(t.dim, t.PL)
    outs = []
    for a in range(t.dim):
        acc = None
        for (j, k, c) in terms[a]:
            term = (c * Lf[:, j])[:, None] * Vcols[k]
            acc = term if acc is None else acc + term
        outs.append(acc)
    F = -jnp.stack(outs, axis=-1)
    return F / lam[:, None, None]


def p2m_from_cols(t: FmmTables, Vcols, mask3: jax.Array) -> jax.Array:
    """Leaf multipoles from precomputed monomial columns of the normalized
    offsets (slots t.m_slots of any sym layout of order >= PM): [G, S_M]."""
    coef = t.p2m_coef
    cols = []
    for j in range(t.S_M):
        cj = jnp.where(mask3, Vcols[int(t.m_slots[j])], 0.0)
        cols.append(coef[j] * jnp.sum(cj, axis=1))
    return jnp.stack(cols, axis=1)


def eval_monomials_M(t: FmmTables, e: jax.Array) -> jax.Array:
    """Monomials over the multipole layout: [B, S_M] (no_dipole layouts
    gather their kept slots from the full evaluation)."""
    V = hm.eval_monomials(e, t.PM, t.dim)
    if t.no_dipole:
        V = V[..., np.asarray(t.m_slots)]
    return V


def eval_monomials_L(t: FmmTables, e: jax.Array) -> jax.Array:
    """Monomials over the local layout (orders 0..PL): [B, S_Lf]."""
    return hm.eval_monomials(e, t.PL, t.dim)


def p2m_contrib(t: FmmTables, e: jax.Array, q=None) -> jax.Array:
    """Per-particle multipole contributions [B, S_M].

    e = (x_j - x_c)/lam_c normalized offsets; q optional weights [B].
    Sum per cell (segment_sum) is the caller's job.
    """
    V = eval_monomials_M(t, e)
    out = V * _j(t.p2m_coef, e.dtype)[None, :]
    if q is not None:
        out = out * q[:, None]
    return out


@functools.lru_cache(maxsize=None)
def _m2m_terms(dim: int, p: int, no_dipole: bool = False):
    """Static sparse term list of M2M grouped by output slot:
    terms[i] = tuple of (j, h, coef) with
    M'[b, i] = sum coef * Mrho[b, j] * Vs[b, h] (h indexes the FULL sym
    layout of the shift monomials)."""
    t = build_tables(dim, p, True, no_dipole)
    terms = []
    for i in range(t.S_M):
        row = []
        for j in range(t.S_M):
            c = t.m2m_coef[i, j]
            if c != 0.0:
                row.append((j, int(t.m2m_idx[i, j]), float(c)))
        terms.append(tuple(row))
    return tuple(terms)


def m2m(t: FmmTables, M: jax.Array, s: jax.Array, rho: jax.Array) -> jax.Array:
    """Shift multipoles to a new center: [B,S_M],[B,dim],[B] -> [B,S_M].

    s = (x_child - x_parent)/lam_parent ; rho = lam_child/lam_parent.
    Static-column sparse form: the dense per-node operator (K = Vs @ W,
    [B, S_M, S_M]) runs as skinny K=S_M f32 matmuls per tree level, while
    the same contraction is a few hundred fused column multiply-adds."""
    if t.p > SPARSE_P_MAX:
        Vs = hm.eval_monomials(-s, t.PM, t.dim)           # [B, S_Mfull]
        W = _j(t.m2m_W, M.dtype).reshape(t.S_Mfull, -1)
        K = jnp.matmul(Vs, W, precision=PREC).reshape(-1, t.S_M, t.S_M)
        Mpre = M * (rho[:, None] ** _j(t.m_order, M.dtype)[None, :])
        return jnp.sum(K * Mpre[:, None, :], axis=2)
    terms = _m2m_terms(t.dim, t.p, t.no_dipole)
    Vcols = eval_monomial_cols(-s, t.PM, t.dim)           # full layout
    rp = _pow_cols(rho, t.PM)
    m_ord = t.m_order
    Mv = [M[:, j] * rp[int(m_ord[j])] for j in range(t.S_M)]
    cols = []
    for i, row in enumerate(terms):
        acc = None
        for (j, h, c) in row:
            term = (c * Mv[j]) * Vcols[h]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros(M.shape[0], M.dtype)
        cols.append(acc)
    return jnp.stack(cols, axis=1)


def m2l(t: FmmTables, M: jax.Array, R: jax.Array,
        lam_src: jax.Array, lam_tgt: jax.Array) -> jax.Array:
    """Multipoles -> traceless locals for a batch of interacting pairs.

    R = x_tgt - x_src (unnormalized).  Returns [B, S_Lt] contributions
    (caller scatter-adds into target cells).
    """
    r = jnp.linalg.norm(R, axis=-1)
    Rh = R / r[:, None]
    H = hm.eval_H(Rh, t.maxH, t.dim)                      # [B, S_H]
    L = m2l_sparse(t, M, H, lam_src / r, lam_tgt / r)
    if t.dim == 3:
        L = L / r[:, None]
    else:
        # 2D kernel is -log r : order-0 harmonic H_0=1 stands in for G_0;
        # correct the monopole->L_0 term (affects potential only).
        corr = M[:, 0] * (-jnp.log(r) - 1.0)
        L = L.at[:, 0].add(corr)
    return L


def m2l_both(t: FmmTables, M1: jax.Array, M2: jax.Array, R: jax.Array,
             lam1: jax.Array, lam2: jax.Array):
    """Both directions of an unordered M2L pair, one harmonic evaluation.

    R = x_1 - x_2.  Returns (L1 from M2, L2 from M1).  Uses the parity
    H_k(-Rhat) = (-1)^k H_k(Rhat) (the reference's symmetry trick,
    fmm_c2c3_kdtree_krnl:655-661) so the gradient table is evaluated once
    per unordered pair.
    """
    r = jnp.linalg.norm(R, axis=-1)
    Rh = R / r[:, None]
    H = hm.eval_H(Rh, t.maxH, t.dim)
    v1 = lam1 / r
    v2 = lam2 / r
    L1 = m2l_sparse(t, M2, H, v2, v1, sign=1)
    L2 = m2l_sparse(t, M1, H, v1, v2, sign=-1)
    if t.dim == 3:
        L1 = L1 / r[:, None]
        L2 = L2 / r[:, None]
    else:
        L1 = L1.at[:, 0].add(M2[:, 0] * (-jnp.log(r) - 1.0))
        L2 = L2.at[:, 0].add(M1[:, 0] * (-jnp.log(r) - 1.0))
    return L1, L2


@functools.lru_cache(maxsize=None)
def _expand_terms(dim: int, p: int):
    t = build_tables(dim, p)
    terms = []
    for j in range(t.S_Lf):
        row = [(i, float(t.extend_L[j, i])) for i in range(t.S_Lt)
               if t.extend_L[j, i] != 0.0]
        terms.append(tuple(row))
    return tuple(terms)


def expand_L(t: FmmTables, Lt: jax.Array) -> jax.Array:
    """Traceless-stored locals -> full symmetric layout [B, S_Lf].

    Sparse column form: the detrace recurrence gives each full slot a
    handful of traceless contributions (fmm_cart_base3.cuh:234-241)."""
    terms = _expand_terms(t.dim, t.p)
    Lcols = [Lt[:, i] for i in range(t.S_Lt)]
    cols = []
    for row in terms:
        acc = None
        for (i, c) in row:
            term = c * Lcols[i] if c != 1.0 else Lcols[i]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros(Lt.shape[0], Lt.dtype)
        cols.append(acc)
    return jnp.stack(cols, axis=1)


@functools.lru_cache(maxsize=None)
def _l2l_terms(dim: int, p: int):
    """Static sparse term list of L2L grouped by output slot:
    terms[i] = tuple of (j, h, coef) with
    T'[b, i] = sum coef * Lf[b, j] * Vs[b, h]."""
    t = build_tables(dim, p)
    terms = []
    for i in range(t.S_Lt):
        row = []
        for j in range(t.S_Lf):
            c = t.l2l_coef[i, j]
            if c != 0.0:
                row.append((j, int(t.l2l_idx[i, j]), float(c)))
        terms.append(tuple(row))
    return tuple(terms)


def l2l(t: FmmTables, Lt_parent: jax.Array, s: jax.Array,
        rho: jax.Array) -> jax.Array:
    """Recenter locals from parent to child: [B,S_Lt],[B,dim],[B] -> [B,S_Lt].

    s = (x_child - x_parent)/lam_parent ; rho = lam_child/lam_parent.
    Static-column sparse form (see :func:`m2m`)."""
    Lf = expand_L(t, Lt_parent)
    if t.p > SPARSE_P_MAX:
        Vs = eval_monomials_L(t, s)
        W = _j(t.l2l_W, Lf.dtype).reshape(t.S_Lf, -1)
        K = jnp.matmul(Vs, W, precision=PREC).reshape(-1, t.S_Lt, t.S_Lf)
        out = jnp.sum(K * Lf[:, None, :], axis=2)
        return out * (rho[:, None] ** _j(t.nt_order, Lf.dtype)[None, :])
    terms = _l2l_terms(t.dim, t.p)
    Vcols = eval_monomial_cols(s, t.PL, t.dim)
    rp = _pow_cols(rho, t.PL)
    nt_ord = t.nt_order
    Lcols = [Lf[:, j] for j in range(t.S_Lf)]
    cols = []
    for i, row in enumerate(terms):
        acc = None
        for (j, h, c) in row:
            term = (c * Lcols[j]) * Vcols[h]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros(Lf.shape[0], Lf.dtype)
        cols.append(acc * rp[int(nt_ord[i])])
    return jnp.stack(cols, axis=1)


def l2p_field(t: FmmTables, Lt: jax.Array, w: jax.Array,
              lam: jax.Array) -> jax.Array:
    """Field -grad(Phi) at particles: [B,S_Lt],[B,dim],[B] -> [B,dim].

    w = (x - x_cell)/lam normalized offsets.
    """
    Lf = expand_L(t, Lt)
    V = eval_monomials_L(t, w)                            # [B, S_Lf]
    D = _j(t.l2p_D, Lf.dtype)                             # [dim, S_Lf, S_Lf]
    U = jnp.einsum("bk,akj->baj", V, D, precision=PREC)
    F = -jnp.einsum("bj,baj->ba", Lf, U, precision=PREC)
    return F / lam[:, None]


def l2p_field_blocked(t: FmmTables, Lt: jax.Array, w: jax.Array,
                      lam: jax.Array) -> jax.Array:
    """Leaf-blocked L2P: Lt [G, S_Lt], w [G, C, dim], lam [G] -> [G, C, dim].

    Same math as :func:`l2p_field` but the local expansion is shared per
    leaf block, so no per-particle gather of Lt is needed.  Contraction
    order matters: fold the (small) derivative tables into the per-leaf
    locals FIRST — W[g, a, k] = sum_j D[a, k, j] Lf[g, j] is [G, dim, S] —
    then contract against the particle monomials.  The naive order
    (U = V x D, then reduce by Lf) materializes a [G, C, dim, S]
    intermediate (~700 MB at N=1M, p=5) and cost ~300 ms/eval.
    """
    G, C, dim = w.shape
    Lf = expand_L(t, Lt)                                   # [G, S_Lf]
    V = hm.eval_monomials(w.reshape(G * C, dim), t.PL, t.dim)
    V = V.reshape(G, C, -1)
    D = _j(t.l2p_D, Lf.dtype)                              # [dim, S_V, S_Lf]
    W = jnp.einsum("akj,gj->gak", D, Lf, precision=PREC)   # [G, dim, S_V]
    F = -jnp.einsum("gck,gak->gca", V, W, precision=PREC)  # batched matmul
    return F / lam[:, None, None]


def l2p_potential(t: FmmTables, Lt: jax.Array, w: jax.Array) -> jax.Array:
    """Phi at particles from the local expansion: [B]."""
    Lf = expand_L(t, Lt)
    V = eval_monomials_L(t, w)
    return jnp.sum(Lf * _j(t.l2p_mult, Lf.dtype)[None] * V, axis=-1)


def m2p_field(t: FmmTables, M: jax.Array, R: jax.Array,
              lam_src: jax.Array) -> jax.Array:
    """Far field of a cell's multipoles at points R = x - x_src: [B,dim]."""
    r = jnp.linalg.norm(R, axis=-1)
    Rh = R / r[:, None]
    H = hm.eval_H(Rh, t.maxH, t.dim)
    v = lam_src / r
    Mv = M * (v[:, None] ** _j(t.m_order, M.dtype)[None, :])
    W = _j(t.m2p_W, M.dtype).reshape(t.S_H, -1)
    K = jnp.matmul(H, W, precision=PREC).reshape(-1, t.dim, t.S_M)
    F = -jnp.sum(K * Mv[:, None, :], axis=2)
    eta = 1 if t.dim == 3 else 0
    return F / (r[:, None] ** (eta + 1))


def m2p_potential(t: FmmTables, M: jax.Array, R: jax.Array,
                  lam_src: jax.Array) -> jax.Array:
    """Far potential of a cell's multipoles at points R = x - x_src: [B]."""
    r = jnp.linalg.norm(R, axis=-1)
    Rh = R / r[:, None]
    H = hm.eval_H(Rh, t.maxH, t.dim)
    v = lam_src / r
    Mv = M * _j(t.m2p_coef, M.dtype)[None] * \
        (v[:, None] ** _j(t.m_order, M.dtype)[None, :])
    # H slots for the multipole layout (layouts nest; m_slots skips any
    # dropped dipole slots)
    pot = jnp.sum(Mv * H[:, np.asarray(t.m_slots)], axis=-1)
    if t.dim == 3:
        return pot / r
    # 2D: monopole term uses -log r instead of H_0 = 1
    return pot + M[:, 0] * (-jnp.log(r) - 1.0)
