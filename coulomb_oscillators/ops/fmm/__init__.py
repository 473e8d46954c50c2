"""Fast Multipole Method force engines.

Engine registry (reference parity, SURVEY.md §2.2):
  * "fmm3_kd" / "fmm2_kd"  — kd-tree FMM with dual-tree MAC traversal; the
    production path (fmm_cart3_kdtree.cuh).  Dim-generic.
  * "fmm3" / "fmm3_traceless" — 3D uniform octree FMM
    (fmm_cart3_symmetric.cuh / fmm_cart3_traceless.cuh); static stencil,
    no traversal.
  * "fmm2"  — 2D uniform quadtree FMM (fmm_cart.cuh).
  * "appel" — monopole tree code (appel.cuh): per-cell charge + center of
    charge, constant-field locals, COC-exact cell-cell far field
    (ops/fmm/appel.py — a dedicated engine, not an octree alias).
"""

from coulomb_oscillators.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators.ops.fmm.octree import OctreeFmmEngine
from coulomb_oscillators.ops.fmm.appel import AppelEngine

_KD_NAMES = ("fmm3_kd", "fmm2_kd", "fmm_kd")
_OCT_NAMES = ("fmm3", "fmm2", "fmm3_traceless", "fmm2_traceless")


def make_engine_object(config, n, name: str):
    """Engine instance for the simulator (build/force API)."""
    if name in _KD_NAMES:
        return KdFmmEngine(config, n)
    if name == "appel":
        return AppelEngine(config, n)
    if name in _OCT_NAMES:
        storage = "traceless" if name.endswith("_traceless") else "symmetric"
        return OctreeFmmEngine(config, n, multipole_storage=storage)
    raise ValueError(f"unknown FMM engine {name!r}")


def make_engine(config, n, name: str):
    """pos -> acc callable that rebuilds its tree every call (test modes;
    for amortized stepping use the engine object / Simulator)."""
    eng = make_engine_object(config, n, name)

    def force(pos):
        fstate = eng.build(pos)
        return eng.force(pos, fstate)

    force.engine = eng
    return force
