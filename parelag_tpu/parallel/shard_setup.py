"""Setup-phase compute on the device mesh: rank-sharded batched dense work.

The distributed Coarsen (parallel.dist_coarsen) decomposes the setup into
per-rank patches whose heavy kernels are batched small dense problems
(weighted SVDs of trace targets, saddle-point solves of the extensions —
SURVEY.md §3.5 hot loops 1-2). Here those batches execute over the
jax device mesh with shard_map: one rank's padded batch per device, a
single traced computation for all ranks — the device replacement for the
reference's per-MPI-rank LAPACK loops.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def pad_rank_batches(batches, n_devices):
    """Stack per-rank (m_r, n, t) batches into one (n_devices * m_max, n, t)
    array (zero-padded), plus per-rank valid counts."""
    R = len(batches)
    assert R <= n_devices
    n, t = batches[0].shape[1], batches[0].shape[2]
    m_max = max(max(b.shape[0] for b in batches), 1)
    out = np.zeros((n_devices, m_max, n, t), dtype=batches[0].dtype)
    counts = np.zeros(n_devices, dtype=np.int64)
    for r, b in enumerate(batches):
        out[r, : b.shape[0]] = b
        counts[r] = b.shape[0]
    return out.reshape(n_devices * m_max, n, t), counts, m_max


def sharded_batched_svd(batches, mesh, axis="dd"):
    """Thin SVD of every matrix in every rank's batch, each rank's batch
    resident on (and computed by) its own device via shard_map. batches:
    list of (m_r, n, t) arrays, len <= mesh size. Returns per-rank lists of
    (U, s) (padding removed)."""
    n_devices = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    stacked, counts, m_max = pad_rank_batches(batches, n_devices)

    @partial(shard_map, mesh=mesh, in_specs=P(axis),
             out_specs=(P(axis), P(axis)))
    def run(x):
        # padded (all-zero) members produce zero factors — harmless
        U, s, _ = jnp.linalg.svd(x, full_matrices=False)
        return U, s

    U, s = run(jnp.asarray(stacked))
    U = np.asarray(U).reshape(n_devices, m_max, *U.shape[1:])
    s = np.asarray(s).reshape(n_devices, m_max, -1)
    return [
        [(U[r, i], s[r, i]) for i in range(int(counts[r]))]
        for r in range(len(batches))]


def sharded_solve_groups(As, Bs, mesh, axis="dd"):
    """Per-rank batched dense solves on the device mesh: As[r] (m_r, k, k),
    Bs[r] (m_r, k, s) -> Xs[r]; one shard_map call, each rank's batch on
    its own device (the extension-stage saddle solves of
    dist_coarsen under device execution). Padded members solve an identity
    system (harmless)."""
    n_devices = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    R = len(As)
    k = As[0].shape[1]
    s = Bs[0].shape[2]
    m_max = max(max(a.shape[0] for a in As), 1)
    A = np.tile(np.eye(k, dtype=As[0].dtype), (n_devices, m_max, 1, 1))
    B = np.zeros((n_devices, m_max, k, s), dtype=Bs[0].dtype)
    counts = np.zeros(n_devices, dtype=np.int64)
    for r in range(R):
        A[r, : As[r].shape[0]] = As[r]
        B[r, : Bs[r].shape[0]] = Bs[r]
        counts[r] = As[r].shape[0]

    @partial(shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
             out_specs=P(axis))
    def run(a, b):
        return jnp.linalg.solve(a, b)

    X = np.asarray(run(jnp.asarray(A.reshape(-1, k, k)),
                       jnp.asarray(B.reshape(-1, k, s))))
    X = X.reshape(n_devices, m_max, k, s)
    return [X[r, : int(counts[r])] for r in range(R)]
