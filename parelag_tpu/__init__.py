"""parelag_tpu — element-agglomeration AMGe on the de Rham complex in JAX.

A from-scratch JAX/XLA framework with the capabilities of LLNL/ParElag
(C++/MPI on MFEM+hypre): operator-dependent numerical upscaling and AMGe
solvers for H1 / H(curl) / H(div) / L2 discretizations.

Architecture:
  * mesh topology & agglomeration  -> integer index arrays + scipy CSR on host
  * per-agglomerate local problems -> padded, bucketed batched dense kernels
                                      (vmap) on device
  * solve phase (SpMV, smoothers, Krylov, V-cycle) -> jitted JAX on device
  * distribution -> one mesh-partition axis via jax.sharding / shard_map
                    (the reference's MPI domain decomposition analog)
"""

__version__ = "0.1.0"


def _tune_malloc():
    """Keep large allocations on the heap instead of per-allocation mmap
    (glibc mallopt M_MMAP_THRESHOLD / M_TRIM_THRESHOLD).

    The setup phase streams many ~100MB-1GB numpy temporaries; with
    glibc's default mmap behavior every one is returned to the OS on free
    and re-faulted page-by-page on the next allocation. This is the
    framework's MemoryUtils analog (reference
    src/utilities/MemoryUtils.hpp). Disable with PARELAG_MALLOC_TUNE=0.
    Trade-off: process high-water RSS stays allocated (not returned to
    the OS between phases). Its effect on the GPU machine's host is not
    measured."""
    import os
    if os.environ.get("PARELAG_MALLOC_TUNE", "1") in ("0", "false"):
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        # effectively infinite (INT_MAX — mallopt takes a C int, and a
        # wider Python value would be silently truncated by ctypes:
        # 1 << 44 masks to 0, the exact opposite setting): every
        # allocation rides the brk heap and freed space is NEVER
        # returned to the OS, so the heap holds its high-water mark
        libc.mallopt(-3, 0x7FFFFFFF)    # M_MMAP_THRESHOLD
        libc.mallopt(-1, 0x7FFFFFFF)    # M_TRIM_THRESHOLD
        libc.mallopt(-8, 1)             # M_ARENA_MAX: single arena
    except Exception:                   # non-glibc platforms: no-op
        pass


def _install_np_allocator():
    """Route numpy array data through the caching size-class allocator
    (native/parelag_npalloc.c): freed >=1 MB blocks keep their populated
    pages and are reused, so the GB-scale setup temporaries do not re-pay
    the first-touch population cost.
    Disable with PARELAG_NPALLOC=0; cap via PARELAG_NPALLOC_CAP_GB."""
    import os
    if os.environ.get("PARELAG_NPALLOC", "1") in ("0", "false"):
        return
    try:
        from parelag_tpu.ops import npalloc
        cap = int(float(os.environ.get("PARELAG_NPALLOC_CAP_GB", "48"))
                  * (1 << 30))
        npalloc.install(cap)
    except Exception:
        pass


_tune_malloc()
_install_np_allocator()

from parelag_tpu.mesh.mesh import (
    Mesh, hex_grid_mesh, quad_grid_mesh, read_mesh)
from parelag_tpu.topology.topology import AgglomeratedTopology
from parelag_tpu.partitioning.partitioners import (
    refined_mesh_partition, cartesian_partition, geometric_box_partition,
    logical_partition, graph_partition)

# jax-heavy subsystems load lazily so host-only topology work stays light
_LAZY = {
    "DeRhamSequenceFE": ("parelag_tpu.amge.fespace", "DeRhamSequenceFE"),
    "DeRhamSequence2DFE": ("parelag_tpu.amge.fespace2d",
                           "DeRhamSequence2DFE"),
    "SolverLibrary": ("parelag_tpu.solvers.library", "SolverLibrary"),
    "SolverState": ("parelag_tpu.solvers.library", "SolverState"),
    "ParameterList": ("parelag_tpu.utils.params", "ParameterList"),
    "read_xml": ("parelag_tpu.utils.params", "read_xml"),
    "build_amge_hierarchy": ("parelag_tpu.solvers.amge_solver",
                             "build_amge_hierarchy"),
    "amge_pcg_solve": ("parelag_tpu.solvers.amge_solver", "amge_pcg_solve"),
    "Hierarchy": ("parelag_tpu.solvers.hierarchy", "Hierarchy"),
    "build_hierarchy": ("parelag_tpu.solvers.hierarchy", "build_hierarchy"),
    "HybridHdivL2": ("parelag_tpu.amge.hybridization", "HybridHdivL2"),
    "write_vtk": ("parelag_tpu.mesh.vtk", "write_vtk"),
    "save_agglomerates_vtk": ("parelag_tpu.mesh.vtk",
                              "save_agglomerates_vtk"),
    "TimeManager": ("parelag_tpu.utils.timing", "TimeManager"),
    "save_pytree": ("parelag_tpu.utils.checkpoint", "save_pytree"),
    "load_pytree": ("parelag_tpu.utils.checkpoint", "load_pytree"),
    # round 3: arbitrary order, multi-level distribution, partitioning
    "DeRhamSequence3DFE_HO": ("parelag_tpu.amge.fespace3d_ho",
                              "DeRhamSequence3DFE_HO"),
    "DeRhamSequenceTetFE_HO": ("parelag_tpu.amge.fespace3d_tet_ho",
                               "DeRhamSequenceTetFE_HO"),
    "DeRhamSequence2DFE_HO": ("parelag_tpu.amge.fespace2d_ho",
                              "DeRhamSequence2DFE_HO"),
    "build_ml_hiptmair": ("parelag_tpu.solvers.amge_solver",
                          "build_ml_hiptmair"),
    "GhostMap": ("parelag_tpu.parallel.ghost", "GhostMap"),
    "parmetis_kway": ("parelag_tpu.parallel.dist_partition",
                      "parmetis_kway"),
    "metis_material_partition": ("parelag_tpu.partitioning.partitioners",
                                 "metis_material_partition"),
    "distributed_coarsen_multilevel": (
        "parelag_tpu.parallel.dist_hierarchy",
        "distributed_coarsen_multilevel"),
    "distributed_operator_setup": ("parelag_tpu.parallel.dist_hierarchy",
                                   "distributed_operator_setup"),
    "build_hierarchy_from_setup": ("parelag_tpu.parallel.dist_hierarchy",
                                   "build_hierarchy_from_setup"),
    "assert_invariants": ("parelag_tpu.utils.errors", "assert_invariants"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'parelag_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
