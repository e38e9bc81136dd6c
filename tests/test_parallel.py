"""Distributed (domain-decomposition) execution tests on an 8-device CPU
mesh — serial vs distributed equivalence, the analog of the reference's
mpiexec -n {2,4} lanes reproducing identical golden values
(testsuite/CMakeLists.txt:164-169)."""

import numpy as np
import scipy.sparse.linalg as spla
import jax
import jax.numpy as jnp
import pytest

from parelag_tpu.mesh.mesh import hex_grid_mesh
from parelag_tpu.topology.topology import AgglomeratedTopology
from parelag_tpu.amge.fespace import DeRhamSequenceFE
from parelag_tpu.partitioning.partitioners import cartesian_partition
from parelag_tpu.models.upscaling import (
    mark_dofs_on_bndr, boundary_rhs, eliminate_rowcols)
from parelag_tpu.parallel.sharding import (
    dof_partition, distribute_system, make_dd_mesh, distributed_pcg)


@pytest.fixture(scope="module")
def poisson():
    m = hex_grid_mesh(4, 4, 4)
    topo = AgglomeratedTopology.from_mesh(m)
    seq = DeRhamSequenceFE(topo, m)
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return seq, A, b


def test_distribution_plan_matvec(poisson):
    seq, A, b = poisson
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    sysd = distribute_system(A, owner, 8, dtype=np.float64)
    x = np.random.RandomState(0).rand(A.shape[0])
    xv = np.zeros(8 * sysd.n_loc)
    xv[sysd.virt] = x
    y = np.einsum("dnk,dnk->dn", sysd.values,
                  xv[sysd.indices]) * sysd.row_mask
    assert np.allclose(sysd.to_global(y), A @ x)


def test_distributed_pcg_matches_serial(poisson):
    seq, A, b = poisson
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    sysd = distribute_system(A, owner, 8, dtype=np.float64)
    mesh = make_dd_mesh(8)
    x = distributed_pcg(sysd, b, mesh, iters=80, dtype=np.float64)
    xref = spla.spsolve(A.tocsc(), b)
    assert np.abs(x - xref).max() < 1e-10


@pytest.fixture(scope="module")
def dist_record():
    from parelag_tpu.parallel.dist_bench import (
        distributed_setup, compare_solves)
    setup, b, _ = distributed_setup((16, 32, 20), 8)
    return compare_solves(jax.devices()[:8], setup, b, dtype=np.float64)


def test_dryrun_multichip(dist_record):
    """The distributed multilevel setup + sharded V-cycle PCG on the 8
    virtual devices matches the serial hierarchy PCG of the same operator
    (the path `chip_smoke.py --multi` runs on four GPUs)."""
    rec = dist_record
    assert abs(rec["dist_iters"] - rec["serial_iters"]) <= 1, rec
    assert rec["x_rel_diff"] < 1e-8, rec
    assert rec["dist_rel_res"] < 1e-4, rec
    assert rec["setup_solve_err"] < 1e-4, rec


def test_distributed_operands_sharded_over_dd(dist_record):
    """Each rank's level blocks live on its own device: the dd-sharded
    operands of the distributed step span all 8 virtual devices."""
    for name in ("values_l0", "P_l0", "rhs"):
        pl = dist_record["placement"][name]
        assert "dd" in pl["sharding"], pl
        assert sorted(pl["devices"]) == sorted(
            d.id for d in jax.devices()[:8]), pl


def test_distributed_mg_pcg_matches_serial():
    """Distributed two-level MG-PCG == serial direct solve (the 1-vs-N
    equivalence lane, reference par_form* tests)."""
    import scipy.sparse.linalg as spla
    from parelag_tpu.mesh.mesh import hex_grid_mesh
    from parelag_tpu.topology.topology import AgglomeratedTopology
    from parelag_tpu.amge.fespace import DeRhamSequenceFE
    from parelag_tpu.partitioning.partitioners import refined_mesh_partition
    from parelag_tpu.parallel.sharding import distributed_mg_pcg
    from parelag_tpu.solvers.hierarchy import rap

    m = hex_grid_mesh(2, 2, 2).uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(m)
    topo.coarsen_local_partitioning(refined_mesh_partition(64, 8))
    seq = DeRhamSequenceFE(topo, m)
    seq.set_upscaling_targets(0)
    seq.coarsen()
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    P = seq.P[0]
    Ac = rap(A, P)
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    sysd = distribute_system(A, owner, 8, dtype=np.float64)
    mesh = make_dd_mesh(8)
    x = distributed_mg_pcg(sysd, P, Ac, b, mesh, iters=15)
    xref = spla.spsolve(A.tocsc(), b)
    assert np.abs(x - xref).max() < 1e-12


def test_halo_plan_spmv_matches(poisson):
    """ppermute halo-exchange SpMV == all_gather SpMV == scipy."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from parelag_tpu.parallel.sharding import shard_map
    from parelag_tpu.parallel.sharding import (
        build_halo_plan, _halo_spmv_local)

    seq, A, b = poisson
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    sysd = distribute_system(A, owner, 8, dtype=np.float64)
    plan = build_halo_plan(sysd)
    # a DD split of a structured grid talks to few ring offsets only
    assert len(plan.offsets) < 8
    mesh = make_dd_mesh(8)
    n_send = len(plan.offsets)

    @partial(shard_map, mesh=mesh,
             in_specs=(P("dd"), P("dd"), P("dd"),
                       tuple(P("dd") for _ in range(n_send)), P("dd")),
             out_specs=P("dd"))
    def spmv(vals, idx_ext, mask, sends, x):
        return _halo_spmv_local(vals, idx_ext, mask, sends,
                                plan.offsets, 8, x)

    x = np.random.RandomState(3).rand(A.shape[0])
    xl = jnp.asarray(sysd.to_local(x))
    y = spmv(jnp.asarray(sysd.values), jnp.asarray(plan.indices_ext),
             jnp.asarray(sysd.row_mask),
             tuple(jnp.asarray(t) for t in plan.send_slots), xl)
    yg = sysd.to_global(np.asarray(y))
    assert np.abs(yg - A @ x).max() < 1e-12


def test_distributed_mg_pcg_halo_matches_serial():
    """Same 1-vs-N equivalence through the neighbor-only halo exchange."""
    from parelag_tpu.partitioning.partitioners import refined_mesh_partition
    from parelag_tpu.parallel.sharding import distributed_mg_pcg
    from parelag_tpu.solvers.hierarchy import rap

    m = hex_grid_mesh(2, 2, 2).uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(m)
    topo.coarsen_local_partitioning(refined_mesh_partition(64, 8))
    seq = DeRhamSequenceFE(topo, m)
    seq.set_upscaling_targets(0)
    seq.coarsen()
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    P = seq.P[0]
    Ac = rap(A, P)
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    sysd = distribute_system(A, owner, 8, dtype=np.float64)
    mesh = make_dd_mesh(8)
    x = distributed_mg_pcg(sysd, P, Ac, b, mesh, iters=15, halo=True)
    xref = spla.spsolve(A.tocsc(), b)
    assert np.abs(x - xref).max() < 1e-12


def test_distributed_l_level_mg_pcg():
    """3-level fully distributed V-cycle (every level row-sharded with its
    own halo plan; reduce-scatter restriction; replicated coarsest dense
    solve) == serial direct solve."""
    from parelag_tpu.partitioning.partitioners import refined_mesh_partition
    from parelag_tpu.parallel.sharding import (
        build_distributed_hierarchy, distributed_mg_l_pcg)
    from parelag_tpu.solvers.hierarchy import rap

    m = hex_grid_mesh(2, 2, 2).uniform_refinement().uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(m)
    t1 = topo.coarsen_local_partitioning(refined_mesh_partition(512, 64))
    t1.coarsen_local_partitioning(refined_mesh_partition(64, 8))
    seq = DeRhamSequenceFE(topo, m)
    seq.set_upscaling_targets(0)
    s1 = seq.coarsen()
    s1.coarsen()
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    A1 = rap(A, seq.P[0])
    A2 = rap(A1, s1.P[0])
    part = cartesian_partition((8, 8, 8), (4, 4, 4))
    owner = dof_partition(seq.dof[0].entity_dof_pattern(0), part)
    hier = build_distributed_hierarchy(
        [A, A1, A2], [seq.P[0], s1.P[0]], owner, 8)
    mesh = make_dd_mesh(8)
    x = distributed_mg_l_pcg(hier, b, mesh, iters=25)
    xref = spla.spsolve(A.tocsc(), b)
    assert np.abs(x - xref).max() < 1e-11 * max(1.0, np.abs(xref).max())


def test_make_dd_mesh_multihost_plumbing():
    """Multi-host mesh construction degenerates correctly in one process
    (reference role: mpi_session/SharingMap world setup,
    mpiUtils.hpp:22-76, SharingMap.hpp:41): the dd mesh spans all visible
    devices, is process-count-agnostic, and shard_blocks places row
    blocks with a dd NamedSharding usable by the step functions."""
    from parelag_tpu.parallel.sharding import (
        make_dd_mesh, shard_blocks, ensure_distributed_initialized)
    ensure_distributed_initialized()           # no-op single-process
    mesh = make_dd_mesh()
    n = len(jax.devices())
    assert mesh.devices.size == n
    assert mesh.axis_names == ("dd",)
    blocks = np.arange(n * 6, dtype=np.float32).reshape(n, 6)
    arr = shard_blocks(mesh, blocks)
    assert arr.shape == (n, 6)
    np.testing.assert_array_equal(np.asarray(arr), blocks)
    # each dd row lands on its own device
    assert len(arr.sharding.device_set) == n

    sub = make_dd_mesh(2)
    assert sub.devices.size == 2
