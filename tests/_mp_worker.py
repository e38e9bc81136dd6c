"""Worker for the simulated multi-process (2-host) distributed-solve test.

Launched twice by tests/test_multiprocess.py with JAX_PROCESS_ID 0/1; each
process owns 4 virtual CPU devices, the dd mesh spans all 8 across the two
processes (DCN role played by gloo), and the 3-level distributed V-cycle
PCG must reproduce the serial direct solve. The reference analog is an
mpirun -np 2 lane over hypre ParCSR operators (testsuite add_mpi_test,
cmake/modules/ParELAGCMakeUtilities.cmake:422-436).

Host-side problem construction is rank-replicated (as the reference
examples replicate the serial mesh before ParMesh distribution); the
multi-process surface under test is the device-sharded solve.
"""

import os
import sys


def main():
    pid = sys.argv[1]
    port = sys.argv[2]
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = pid
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    # pin the CPU client even where a GPU is present
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np
    import scipy.sparse.linalg as spla

    from parelag_tpu.mesh.mesh import hex_grid_mesh
    from parelag_tpu.topology.topology import AgglomeratedTopology
    from parelag_tpu.amge.fespace import DeRhamSequenceFE
    from parelag_tpu.partitioning.partitioners import cartesian_partition
    from parelag_tpu.parallel.sharding import (
        ensure_distributed_initialized, make_dd_mesh,
        build_distributed_hierarchy, distributed_mg_l_pcg, dof_partition)

    ensure_distributed_initialized()
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    mesh = make_dd_mesh()

    # rank-replicated serial setup (deterministic on both processes)
    m = hex_grid_mesh(8, 8, 4)
    topo = AgglomeratedTopology.from_mesh(m)
    topo.coarsen_local_partitioning(cartesian_partition((8, 8, 4),
                                                        (2, 2, 2)))
    topo.coarser.coarsen_local_partitioning(
        cartesian_partition((4, 4, 2), (2, 2, 2)))
    seqs = [DeRhamSequenceFE(topo, m)]
    seqs[0].set_upscaling_targets(0)
    seqs.append(seqs[0].coarsen())
    seqs.append(seqs[1].coarsen())

    def op(seq):
        M = seq.compute_mass_operator(0)
        W = seq.compute_mass_operator(1)
        D = seq.D[0]
        return (M + D.T @ W @ D).tocsr()

    A0 = op(seqs[0])
    P_levels = [seqs[0].P[0].tocsr(), seqs[1].P[0].tocsr()]
    A_levels = [A0]
    for P in P_levels:
        A_levels.append((P.T @ A_levels[-1] @ P).tocsr())

    elem_part = cartesian_partition((8, 8, 4), (4, 4, 2))   # 8 rank blocks
    owner = dof_partition(seqs[0].dof[0].entity_dof_pattern(0), elem_part)
    hier = build_distributed_hierarchy(A_levels, P_levels, owner, 8)

    rng = np.random.RandomState(7)
    b = rng.randn(A0.shape[0])
    x = distributed_mg_l_pcg(hier, b, mesh, iters=30, dtype=np.float64)
    xref = spla.spsolve(A0.tocsc(), b)
    err = np.abs(x - xref).max() / max(np.abs(xref).max(), 1.0)
    digest = float(np.dot(x, np.arange(x.size) % 97))
    print(f"MPOK pid={pid} err={err:.3e} digest={digest:.12e}", flush=True)
    assert err < 1e-10, err


if __name__ == "__main__":
    main()
