"""Near-field (P2P) kernel of the kd-tree FMM, in Pallas for the GPU's
Triton route.

The reference evaluates the near field with shared-memory source tiles,
one block per target leaf, and an atomic scatter (fmm_p2p3_kdtree*,
fmm_cart3_kdtree.cuh:767-1132).  Here the near list is target-sorted and
each target sub-leaf owns its rows, so no atomics are needed:

  * one program per target sub-leaf g (C rows, C a power of two);
  * it reads its CSR slice [row_ptr[g], row_ptr[g+1]) of the packed
    partner list: each entry is a source block id (nsub sub-leaves of C
    lanes) with an nsub-bit sub-leaf mask in its top bits;
  * per partner it loads the source block's [CB] coordinate rows from the
    position SoA (about 16 MB at N=1M, so it stays in the 50 MB L2),
    evaluates the softened kernel on a [C, CB] tile in the per-axis
    difference form, zeroes the lane groups the mask excludes (those
    sub-pairs belong to M2L) and accumulates in registers;
  * it stores its C output rows once.

Padded slots sit at FAR, so their weights underflow to exactly zero, and
the self pair contributes d * w(eps) = 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _p2p_kernel(row_ptr_ref, part_ref, soa_ref, out_ref, *, C: int,
                nsub: int, eps2: float, mask_shift: int):
    g = pl.program_id(0)
    CB = C * nsub
    blkmask = (1 << mask_shift) - 1
    # lane -> bit position of its sub-leaf group in a packed partner entry
    lane_bit = mask_shift + jnp.arange(CB, dtype=jnp.int32) // C
    # the targets are sub-leaf g's lanes of its own block in the SoA
    tb = g // nsub
    lanes = pl.ds((g % nsub) * C, C)
    tcol = [soa_ref[tb, a, lanes][:, None] for a in range(3)]   # [C, 1]

    def body(k, acc):
        v = part_ref[k]
        blk = v & blkmask
        m = ((v >> lane_bit) & 1).astype(jnp.float32)           # [CB]
        d = [tcol[a] - soa_ref[blk, a, :][None, :] for a in range(3)]
        dist2 = eps2 + d[0] * d[0] + d[1] * d[1] + d[2] * d[2]  # [C, CB]
        r = jax.lax.rsqrt(dist2)
        w = r * r * r * m[None, :]
        return tuple(acc[a] + d[a] * w for a in range(3))

    zero = jnp.zeros((C, CB), jnp.float32)
    acc = jax.lax.fori_loop(row_ptr_ref[g], row_ptr_ref[g + 1], body,
                            (zero, zero, zero))
    for a in range(3):
        out_ref[a, :] = jnp.sum(acc[a], axis=1)
    out_ref[3, :] = jnp.zeros((C,), jnp.float32)


@functools.partial(jax.jit, static_argnames=(
    "nsub", "eps2", "mask_shift", "num_warps", "interpret"))
def p2p_near(ppad: jax.Array, row_ptr: jax.Array, partners: jax.Array, *,
             nsub: int, eps2: float, mask_shift: int, num_warps: int = 16,
             interpret: bool = False) -> jax.Array:
    """Near-field accelerations (unscaled by kappa) on padded leaf blocks.

    ppad: [G, C, 3] float32 positions (C a power of two, G a multiple of
    nsub; pad slots at FAR).  row_ptr: [G + 1] int32 CSR over the
    target-sorted packed partner list `partners` (entries past
    row_ptr[G] are never read).  Returns [G, C, 3].
    """
    G, C, dim = ppad.shape
    if dim != 3:
        raise ValueError(f"p2p_near is 3D only, got dim={dim}")
    if C & (C - 1) or nsub & (nsub - 1) or G % nsub:
        raise ValueError(f"need power-of-two C and nsub, G % nsub == 0; "
                         f"got G={G} C={C} nsub={nsub}")
    Gb, CB = G // nsub, C * nsub
    # source SoA [Gb, 4, CB]: coordinate rows per block (row 3 is padding
    # that keeps every block shape a power of two)
    soa = jnp.swapaxes(ppad.reshape(Gb, CB, 3), 1, 2)
    soa = jnp.pad(soa, ((0, 0), (0, 1), (0, 0)))
    out = pl.pallas_call(
        functools.partial(_p2p_kernel, C=C, nsub=nsub, eps2=float(eps2),
                          mask_shift=mask_shift),
        grid=(G,),
        in_specs=[
            pl.BlockSpec(row_ptr.shape, lambda g: (0,)),
            pl.BlockSpec(partners.shape, lambda g: (0,)),
            pl.BlockSpec(soa.shape, lambda g: (0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, 4, C), lambda g: (g, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((G, 4, C), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="p2p_near",
    )(row_ptr, partners, soa)
    return jnp.swapaxes(out[:, :3, :], 1, 2)
