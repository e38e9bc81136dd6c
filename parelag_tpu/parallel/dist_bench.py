"""Distributed multilevel H1 solve over a dd device mesh, checked against
the serial hierarchy solve of the same operator on one device.

The distributed setup (per-rank patches, recursive Coarsen, per-level
owned operator rows — no global fine matrix; reference DeRhamSequence.cpp:
572-692 + ParELAG_Hierarchy.cpp:282-385) feeds the sharded L-level V-cycle
PCG with neighbour-only ppermute halo exchange at every level.  The same
functions run on four GPUs (`python chip_smoke.py --multi`) and on eight
virtual CPU devices (tests/test_parallel.py); they take the devices they
are given and never switch platform.
"""

import time

import numpy as np


def _rank_partitions(grid, n_ranks):
    """Two 2x2x2 agglomeration levels, then one AE per rank along y."""
    from parelag_tpu.partitioning.partitioners import cartesian_partition
    gx, gy, gz = grid
    if gx % 4 or gz % 4 or gy % (4 * n_ranks):
        raise ValueError(f"grid {grid} does not split into {n_ranks} ranks")
    return [cartesian_partition(grid, (2, 2, 2)),
            cartesian_partition((gx // 2, gy // 2, gz // 2), (2, 2, 2)),
            cartesian_partition((gx // 4, gy // 4, gz // 4),
                                (gx // 4, gy // 4 // n_ranks, gz // 4))]


def _global_levels(setup):
    """Assemble the serial operators and interpolations from the
    distributed setup's owned rows and published P triplets."""
    import scipy.sparse as sp
    A_levels = []
    for lvl in range(setup.n_levels):
        rows, cols, vals = (np.concatenate(t) for t in
                            zip(*setup.A_rows[lvl]))
        n = setup.ndofs[lvl]
        A_levels.append(sp.coo_matrix((vals, (rows, cols)),
                                      shape=(n, n)).tocsr())
    P_levels = []
    for lvl in range(setup.n_levels - 1):
        rows, cols, vals = setup.P_published[lvl]
        P_levels.append(sp.coo_matrix(
            (vals, (rows, cols)),
            shape=(setup.ndofs[lvl], setup.ndofs[lvl + 1])).tocsr())
    return A_levels, P_levels


def _placement(x):
    return dict(sharding=str(x.sharding),
                devices=[s.device.id for s in x.addressable_shards])


def distributed_setup(grid, n_ranks):
    """Host-side distributed setup of the H1 (mass + stiffness) problem on
    `grid` over `n_ranks` patches; returns (setup, fine rhs, seconds)."""
    from parelag_tpu.mesh.mesh import hex_grid_mesh
    from parelag_tpu.parallel.dist_hierarchy import (
        distributed_coarsen_multilevel, distributed_operator_setup,
        distributed_rhs, compose_partitions)

    partitions = _rank_partitions(grid, n_ranks)
    rank_of_elem = compose_partitions(partitions)[-1]
    t0 = time.perf_counter()
    patches, gents = distributed_coarsen_multilevel(
        hex_grid_mesh(*grid), rank_of_elem, partitions, n_ranks,
        upscaling_order=0)

    def patch_A(p):
        s = p.seqs[0]
        M = s.compute_mass_operator(0)
        W = s.compute_mass_operator(1)
        return (M + s.D[0].T @ W @ s.D[0]).tocsr()

    setup = distributed_operator_setup(
        patches, gents, 0, patch_A, rank_of_elem)
    b = distributed_rhs(
        setup, patches,
        lambda p: p.seqs[0].domain_lf_scalar(0, lambda q: q[..., 0]))
    return setup, b, time.perf_counter() - t0


def compare_solves(devices, setup, b, rtol=1e-5, maxiter=200, nu=2,
                   omega=0.7, dtype=np.float32):
    """Sharded V-cycle PCG to `rtol` on `devices` against the serial
    hierarchy PCG of the same operator on devices[0], plus the
    rank-sharded batched setup solve; returns a record of both solves
    (with the distributed solution under "x")."""
    import jax
    import jax.numpy as jnp
    from parelag_tpu.parallel.sharding import (
        Mesh, distributed_mg_l_step, shard_blocks, gather_global)
    from parelag_tpu.parallel.dist_hierarchy import build_hierarchy_from_setup
    from parelag_tpu.parallel.shard_setup import sharded_solve_groups
    from parelag_tpu.solvers.cg import pcg
    from parelag_tpu.solvers.hierarchy import build_hierarchy
    from parelag_tpu.solvers.smoothers import make_l1_jacobi

    n = len(devices)
    mesh = Mesh(np.array(devices), ("dd",))
    hier = build_hierarchy_from_setup(setup, n, dtype=dtype)

    # ---- sharded V-cycle PCG: every rank's blocks on its own device ----
    levels_args, cinv, g2v = hier.device_args(mesh)
    step = jax.jit(distributed_mg_l_step(mesh, hier, nu=nu, omega=omega)(
        levels_args))
    s0 = hier.systems[0]
    bb = shard_blocks(mesh, s0.to_local(b.astype(dtype)))
    x = jnp.zeros_like(bb)
    # init step with d = 0 leaves (x, r) unchanged and sets z = MG(r)
    t0 = time.perf_counter()
    x, r, z, d = step(levels_args, cinv, g2v, x, bb, bb, jnp.zeros_like(bb))
    nom0 = float(jnp.vdot(r, z))
    it = 0
    while it < maxiter:
        x, r, z, d = step(levels_args, cinv, g2v, x, r, z, d)
        it += 1
        if float(jnp.vdot(r, z)) <= rtol * rtol * nom0:
            break
    x_dist = s0.to_global(gather_global(x)).astype(np.float64)
    dist_solve_s = time.perf_counter() - t0
    placement = dict(values_l0=_placement(levels_args[0]["values"]),
                     P_l0=_placement(levels_args[0]["Pv"]),
                     rhs=_placement(bb), coarse_inv=_placement(cinv))

    # ---- serial hierarchy PCG of the same operator on devices[0] ----
    A_levels, P_levels = _global_levels(setup)
    with jax.default_device(devices[0]):
        H = build_hierarchy(
            A_levels, P_levels,
            lambda A_l, l: make_l1_jacobi(A_l, sweeps=nu, omega=omega),
            dtype=dtype)
        t0 = time.perf_counter()
        xs, (its, _) = jax.jit(lambda Hh, v: pcg(
            lambda u: Hh.levels[0].A @ u, v, precond=Hh.apply, rtol=rtol,
            atol=0.0, maxiter=maxiter))(H, jnp.asarray(b.astype(dtype)))
        x_serial = np.asarray(xs, dtype=np.float64)
        serial_solve_s = time.perf_counter() - t0
    A0 = A_levels[0].astype(np.float64)
    nb = float(np.linalg.norm(b))

    # ---- rank-sharded batched dense solves of the setup phase ----
    rng = np.random.RandomState(0)
    As = [rng.randn(2 + rk % 3, 6, 6).astype(np.float32)
          + 6 * np.eye(6, dtype=np.float32) for rk in range(n)]
    Bs = [rng.randn(a.shape[0], 6, 2).astype(np.float32) for a in As]
    Xs = sharded_solve_groups(As, Bs, mesh)
    setup_solve_err = max(
        float(np.abs(np.einsum("mij,mjk->mik", a.astype(np.float64), xx)
                     - bx).max())
        for a, bx, xx in zip(As, Bs, Xs))

    return dict(
        n_devices=n, dtype=np.dtype(dtype).name,
        ndofs=[int(v) for v in setup.ndofs],
        dist_iters=it, serial_iters=int(its),
        dist_solve_s=dist_solve_s, serial_solve_s=serial_solve_s,
        dist_rel_res=float(np.linalg.norm(b - A0 @ x_dist)) / nb,
        serial_rel_res=float(np.linalg.norm(b - A0 @ x_serial)) / nb,
        x_rel_diff=float(np.linalg.norm(x_dist - x_serial)
                         / np.linalg.norm(x_serial)),
        placement=placement, setup_solve_err=setup_solve_err, x=x_dist)
