"""Distributed domain-decomposition execution over a JAX device mesh.

The reference's parallel model is one MPI rank per mesh subdomain with all
communication expressed through SharingMap/ParCSR halo exchanges
(src/structures/SharingMap.hpp:41-311, SURVEY.md §2.3). The equivalent
here: one `dd` mesh axis; dofs are assigned to the device owning their first
adjacent element; device-local padded row blocks of each sparse operator
index a virtual global vector (device*stride + slot); SpMV gathers remote
entries after an all_gather over the dd axis, and inner products are local
partials + psum — exactly SharingMap.Assemble/Distribute semantics in
collective form.

Everything below works identically on a CPU mesh of virtual devices
(xla_force_host_platform_device_count) and on several GPUs.

The f32 SpMV and transfer contractions pass precision=HIGHEST: on the GPU
a default-precision f32 contraction may run in TF32 (~3 digits).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class DistributedSystem:
    """Row-partitioned sparse operator + dof distribution plan."""
    ndev: int
    n_loc: int                   # padded owned dofs per device
    ndofs: int                   # true global dof count
    owner: np.ndarray            # (ndofs,) owning device
    slot: np.ndarray             # (ndofs,) local slot on owner
    virt: np.ndarray             # (ndofs,) = owner * n_loc + slot
    indices: np.ndarray          # (ndev, n_loc, k) virtual-global columns
    values: np.ndarray           # (ndev, n_loc, k)
    row_mask: np.ndarray         # (ndev, n_loc) 1 for real rows
    dinv: np.ndarray             # (ndev, n_loc) l1-Jacobi weights

    def to_local(self, x_global) -> np.ndarray:
        """Scatter a global vector to (ndev, n_loc) blocks."""
        out = np.zeros((self.ndev, self.n_loc), dtype=np.asarray(
            x_global).dtype)
        out[self.owner, self.slot] = np.asarray(x_global)
        return out

    def to_global(self, x_blocks) -> np.ndarray:
        return np.asarray(x_blocks)[self.owner, self.slot]


def owner_layout(owner, ndev):
    """(slot, n_loc, virt): padded per-device slot assignment in global
    dof order — THE virtual-global layout convention (owner * n_loc +
    slot) shared by distribute_system, dist_hierarchy.
    distribute_from_rank_rows and ghost.GhostMap."""
    owner = np.asarray(owner)
    n = owner.size
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=ndev)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.arange(n) - np.repeat(starts, counts)
    n_loc = max(int(counts.max()), 1) if n else 1
    return slot, n_loc, owner * n_loc + slot


def dof_partition(entity_dof_pattern, elem_partition) -> np.ndarray:
    """Owner of each dof = partition of its first adjacent element
    (owner-computes convention, SharingMap.hpp:52-66)."""
    de = sp.csr_matrix(entity_dof_pattern).T.tocsr()   # dof x element
    part = np.asarray(elem_partition)
    owner = np.zeros(de.shape[0], dtype=np.int64)
    nnz = np.diff(de.indptr)
    has = nnz > 0
    if de.nnz:
        owner[has] = np.minimum.reduceat(
            part[de.indices], de.indptr[:-1][has])
    return owner


def distribute_system(A, owner, ndev, dtype=np.float32) -> DistributedSystem:
    """Build the device-local padded row blocks of a global sparse matrix."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    owner = np.asarray(owner)
    slot, n_loc, virt = owner_layout(owner, ndev)

    nnz_per_row = np.diff(A.indptr)
    k = max(int(nnz_per_row.max()), 1)
    indices = np.zeros((ndev, n_loc, k), dtype=np.int32)
    values = np.zeros((ndev, n_loc, k), dtype=dtype)
    row_mask = np.zeros((ndev, n_loc), dtype=dtype)
    rows = np.repeat(np.arange(n), nnz_per_row)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
    indices[owner[rows], slot[rows], pos] = virt[A.indices]
    values[owner[rows], slot[rows], pos] = A.data
    row_mask[owner, slot] = 1.0
    l1 = np.abs(values).sum(axis=2)
    dinv = np.where(l1 > 0, 1.0 / np.maximum(l1, 1e-30), 0.0).astype(dtype)
    return DistributedSystem(ndev, n_loc, n, owner, slot, virt,
                             indices, values, row_mask, dinv)


# ---------------------------------------------------------------------- #
@dataclass
class HaloPlan:
    """Neighbor-only halo exchange plan (the SharingMap comm-pattern analog,
    SharingMap.hpp:41-311): instead of all_gather-ing the whole virtual
    vector, each device ships exactly the owned entries its neighbors read,
    one ppermute per device offset actually present in the sparsity.

    offsets:     static tuple of ring offsets s (receiver = sender + s)
    send_slots:  per offset, (ndev, m_s) local slots each device sends to
                 device (d + s) % ndev (padded with 0 — receivers never
                 read padded ghost positions)
    indices_ext: (ndev, n_loc, k) columns remapped into the extended local
                 vector [own block | ghosts of offset 0 | offset 1 | ...]
    """
    offsets: tuple
    send_slots: list
    indices_ext: np.ndarray


def build_halo_plan(system: "DistributedSystem") -> HaloPlan:
    ndev, n_loc = system.ndev, system.n_loc
    idx = system.indices.astype(np.int64)
    own = idx // n_loc

    # needs[d][src] = sorted unique remote slots device d reads from src
    needs = [dict() for _ in range(ndev)]
    for d in range(ndev):
        remote = own[d] != d
        srcs = own[d][remote]
        slots = idx[d][remote] % n_loc
        for s_dev in np.unique(srcs):
            needs[d][int(s_dev)] = np.unique(slots[srcs == s_dev])

    offsets = sorted({(d - src) % ndev
                      for d in range(ndev) for src in needs[d]})
    send_slots, widths = [], []
    for s in offsets:
        m_s = max((needs[(e + s) % ndev].get(e, np.zeros(0)).size
                   for e in range(ndev)), default=0)
        m_s = max(m_s, 1)
        tbl = np.zeros((ndev, m_s), dtype=np.int32)
        for e in range(ndev):
            sl = needs[(e + s) % ndev].get(e)
            if sl is not None:
                tbl[e, : sl.size] = sl
        send_slots.append(tbl)
        widths.append(m_s)

    # ghost layout per device: concatenated receive buffers in offset order
    base = n_loc + np.concatenate([[0], np.cumsum(widths)[:-1]]) \
        if offsets else np.zeros(0)
    ghost_pos = [dict() for _ in range(ndev)]
    for i, s in enumerate(offsets):
        for d in range(ndev):
            src = (d - s) % ndev
            sl = needs[d].get(src)
            if sl is not None:
                for p, slot in enumerate(sl):
                    ghost_pos[d][src * n_loc + int(slot)] = int(base[i]) + p

    indices_ext = np.empty_like(system.indices)
    for d in range(ndev):
        flat = idx[d].reshape(-1)
        out = np.empty(flat.size, dtype=np.int64)
        local = own[d].reshape(-1) == d
        out[local] = flat[local] % n_loc
        gp = ghost_pos[d]
        rem = np.where(~local)[0]
        for i in rem:
            out[i] = gp[int(flat[i])]
        indices_ext[d] = out.reshape(idx[d].shape).astype(
            system.indices.dtype)
    return HaloPlan(tuple(int(s) for s in offsets), send_slots, indices_ext)


def _halo_spmv_local(values_blk, indices_ext_blk, row_mask_blk, send_blks,
                     offsets, ndev, x_blk):
    """SpMV body inside shard_map: per-offset ppermute of the requested
    entries, then a purely local gather over [own | ghosts]."""
    ghosts = []
    for i, s in enumerate(offsets):
        buf = x_blk[0][send_blks[i][0]]                  # (m_s,)
        perm = [(d, (d + s) % ndev) for d in range(ndev)]
        ghosts.append(jax.lax.ppermute(buf, "dd", perm))
    xext = jnp.concatenate([x_blk[0]] + ghosts) if ghosts else x_blk[0]
    y = jnp.einsum("nk,nk->n", values_blk[0], xext[indices_ext_blk[0]],
                   precision=_HIGHEST)
    return (y * row_mask_blk[0])[None, :]


def ensure_distributed_initialized():
    """Initialize the JAX multi-process runtime for multi-host meshes
    (the reference's mpi_session role, src/utilities/mpiUtils.hpp:22-76).

    One process per host; controlled by the standard coordinator env vars
    (JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES + JAX_PROCESS_ID), or by
    any cluster environment jax.distributed auto-detects. A no-op in
    single-process runs (the degenerate case all tests exercise — real
    multi-host hardware is not available in this environment)."""
    import os
    if getattr(ensure_distributed_initialized, "_done", False):
        return
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]))
    ensure_distributed_initialized._done = True


def make_dd_mesh(n_devices=None) -> Mesh:
    """The dd device mesh over ALL processes' devices (jax.devices() is
    global after ensure_distributed_initialized), in enumeration order:
    the cards of one host are joined all to all, so no order is better
    for the halo ppermutes."""
    ensure_distributed_initialized()
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dd",))


def shard_blocks(mesh: Mesh, blocks):
    """Device-put (ndev, n_loc, ...) row blocks sharded over the dd axis.

    In a multi-process run each process materializes only its addressable
    shard (jax.make_array_from_callback); single-process this is an
    ordinary sharded device_put. Use for the per-rank operator/vector
    blocks consumed by the distributed step functions."""
    from jax.sharding import NamedSharding
    blocks = np.asarray(blocks)
    spec = P("dd", *([None] * (blocks.ndim - 1)))
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        blocks.shape, sh, lambda idx: blocks[idx])


def replicate_array(mesh: Mesh, x):
    """Fully-replicated global array over the mesh (multi-process safe:
    every process holds a full copy of its addressable shard)."""
    from jax.sharding import NamedSharding
    x = np.asarray(x)
    sh = NamedSharding(mesh, P(*([None] * x.ndim)))
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def gather_global(x) -> np.ndarray:
    """Host copy of a global sharded array; multi-process safe (uses
    process_allgather when shards live on other processes)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(
            multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def distributed_pcg_step(mesh: Mesh):
    """One preconditioned-CG iteration under shard_map — the distributed
    'training step' of the solve phase. State = (x, r, z, d, rz); all blocks
    sharded over dd; scalars replicated via psum."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("dd"), P("dd"), P("dd"), P("dd"), P("dd"),
                  P("dd"), P("dd"), P("dd")),
        out_specs=(P("dd"), P("dd"), P("dd"), P("dd")),
    )
    def step(indices, values, row_mask, dinv, x, r, z, d):
        # halo exchange: gather the full virtual-global vector
        # (local block shape is (1, n_loc); all_gather -> (ndev, 1, n_loc))
        dg = jax.lax.all_gather(d, "dd").reshape(-1)
        Ad = jnp.einsum("nk,nk->n", values[0], dg[indices[0]],
                        precision=_HIGHEST)[None, :]
        Ad = Ad * row_mask
        rz = jax.lax.psum(jnp.vdot(r, z), "dd")
        dAd = jax.lax.psum(jnp.vdot(d, Ad), "dd")
        alpha = rz / jnp.where(dAd != 0, dAd, 1.0)
        x = x + alpha * d
        r = r - alpha * Ad
        z = dinv * r * row_mask
        rz_new = jax.lax.psum(jnp.vdot(r, z), "dd")
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        d = z + beta * d
        return x, r, z, d

    return step


def distribute_rect(P, row_owner, ndev, n_loc, dtype=np.float64):
    """Row-distribute a rectangular operator (e.g. the interpolation P):
    local padded row blocks with REPLICATED columns (coarse dofs). Returns
    (indices (ndev, n_loc, k) into the coarse vector, values)."""
    P = sp.csr_matrix(P)
    n, nc = P.shape
    slot = np.zeros(n, dtype=np.int64)
    counts = np.zeros(ndev, dtype=np.int64)
    for d in range(n):
        slot[d] = counts[row_owner[d]]
        counts[row_owner[d]] += 1
    assert counts.max() <= n_loc
    k = max(int(np.diff(P.indptr).max()), 1)
    indices = np.zeros((ndev, n_loc, k), dtype=np.int32)
    values = np.zeros((ndev, n_loc, k), dtype=dtype)
    for r in range(n):
        a, b = P.indptr[r], P.indptr[r + 1]
        indices[row_owner[r], slot[r], : b - a] = P.indices[a:b]
        values[row_owner[r], slot[r], : b - a] = P.data[a:b]
    return indices, values


def distributed_mg_pcg_step(mesh: Mesh, nu=2, omega=1.0):
    """One PCG iteration preconditioned by a distributed two-level cycle:
    l1-Jacobi smoothing on the distributed fine level, psum-reduced
    restriction to a REPLICATED coarse level solved by a dense inverse,
    local interpolation back (the standard gathered-coarse-grid design; the
    reference's analog is its hypre coarse solves).

    State: (x, r, z, d, rz). All fine blocks sharded over dd.
    """

    def mg_apply(indices, values, row_mask, dinv, Pi, Pv, coarse_inv, r):
        # pre-smooth from zero: x = w D^{-1} r, then one more sweep
        x = omega * dinv * r * row_mask
        for _ in range(nu - 1):
            xg = jax.lax.all_gather(x, "dd").reshape(-1)
            Ax = (jnp.einsum("nk,nk->n", values[0], xg[indices[0]],
                             precision=_HIGHEST))[None, :] * row_mask
            x = x + omega * dinv * (r - Ax) * row_mask
        # residual + restriction (psum of local P^T r parts)
        xg = jax.lax.all_gather(x, "dd").reshape(-1)
        Ax = (jnp.einsum("nk,nk->n", values[0], xg[indices[0]],
                         precision=_HIGHEST))[None, :] * row_mask
        res = (r - Ax) * row_mask
        nc = coarse_inv.shape[0]
        rc_part = jnp.zeros(nc, dtype=r.dtype).at[Pi[0].reshape(-1)].add(
            (Pv[0] * res[0][:, None]).reshape(-1))
        rc = jax.lax.psum(rc_part, "dd")
        ec = jnp.dot(coarse_inv, rc, precision=_HIGHEST)
        # interpolate + correct (local rows of P)
        x = x + jnp.einsum("nk,nk->n", Pv[0], ec[Pi[0]],
                           precision=_HIGHEST)[None, :] * row_mask
        # post-smooth
        for _ in range(nu):
            xg = jax.lax.all_gather(x, "dd").reshape(-1)
            Ax = (jnp.einsum("nk,nk->n", values[0], xg[indices[0]],
                             precision=_HIGHEST))[None, :] * row_mask
            x = x + omega * dinv * (r - Ax) * row_mask
        return x

    from functools import partial as _partial

    @_partial(
        shard_map, mesh=mesh,
        in_specs=(P("dd"), P("dd"), P("dd"), P("dd"), P("dd"), P("dd"),
                  P(), P("dd"), P("dd"), P("dd"), P("dd")),
        out_specs=(P("dd"), P("dd"), P("dd"), P("dd")),
    )
    def step(indices, values, row_mask, dinv, Pi, Pv, coarse_inv,
             x, r, z, d):
        dg = jax.lax.all_gather(d, "dd").reshape(-1)
        Ad = (jnp.einsum("nk,nk->n", values[0], dg[indices[0]],
                         precision=_HIGHEST))[None, :] * row_mask
        rz = jax.lax.psum(jnp.vdot(r, z), "dd")
        dAd = jax.lax.psum(jnp.vdot(d, Ad), "dd")
        alpha = rz / jnp.where(dAd != 0, dAd, 1.0)
        x = x + alpha * d
        r = r - alpha * Ad
        z = mg_apply(indices, values, row_mask, dinv, Pi, Pv,
                     coarse_inv, r)
        rz_new = jax.lax.psum(jnp.vdot(r, z), "dd")
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        d = z + beta * d
        return x, r, z, d

    return step


def distributed_mg_pcg_step_halo(mesh: Mesh, plan: HaloPlan, nu=2,
                                 omega=1.0):
    """distributed_mg_pcg_step with neighbor-only ppermute halo exchange in
    every SpMV (fine-level smoothing, residual, and the CG matvec) instead
    of all_gather: traffic per device is O(surface) instead of O(volume),
    between only the devices that the subdomain graph joins."""
    ndev = mesh.devices.size
    offsets = plan.offsets
    n_send = len(offsets)

    def spmv(values, idx_ext, row_mask, sends, x):
        return _halo_spmv_local(values, idx_ext, row_mask, sends,
                                offsets, ndev, x)

    def mg_apply(values, idx_ext, row_mask, dinv, sends, Pi, Pv,
                 coarse_inv, r):
        x = omega * dinv * r * row_mask
        for _ in range(nu - 1):
            x = x + omega * dinv * (r - spmv(values, idx_ext, row_mask,
                                             sends, x)) * row_mask
        res = (r - spmv(values, idx_ext, row_mask, sends, x)) * row_mask
        nc = coarse_inv.shape[0]
        rc_part = jnp.zeros(nc, dtype=r.dtype).at[Pi[0].reshape(-1)].add(
            (Pv[0] * res[0][:, None]).reshape(-1))
        rc = jax.lax.psum(rc_part, "dd")
        ec = jnp.dot(coarse_inv, rc, precision=_HIGHEST)
        x = x + jnp.einsum("nk,nk->n", Pv[0], ec[Pi[0]],
                           precision=_HIGHEST)[None, :] * row_mask
        for _ in range(nu):
            x = x + omega * dinv * (r - spmv(values, idx_ext, row_mask,
                                             sends, x)) * row_mask
        return x

    from functools import partial as _partial

    @_partial(
        shard_map, mesh=mesh,
        in_specs=(P("dd"), P("dd"), P("dd"), P("dd"),
                  tuple(P("dd") for _ in range(n_send)),
                  P("dd"), P("dd"), P(),
                  P("dd"), P("dd"), P("dd"), P("dd")),
        out_specs=(P("dd"), P("dd"), P("dd"), P("dd")),
    )
    def step(values, idx_ext, row_mask, dinv, sends, Pi, Pv, coarse_inv,
             x, r, z, d):
        Ad = spmv(values, idx_ext, row_mask, sends, d)
        rz = jax.lax.psum(jnp.vdot(r, z), "dd")
        dAd = jax.lax.psum(jnp.vdot(d, Ad), "dd")
        alpha = rz / jnp.where(dAd != 0, dAd, 1.0)
        x = x + alpha * d
        r = r - alpha * Ad
        z = mg_apply(values, idx_ext, row_mask, dinv, sends, Pi, Pv,
                     coarse_inv, r)
        rz_new = jax.lax.psum(jnp.vdot(r, z), "dd")
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        d = z + beta * d
        return x, r, z, d

    return step


def distributed_mg_pcg(system: DistributedSystem, P_scipy, A_coarse,
                       b_global, mesh: Mesh, iters=20, dtype=np.float64,
                       nu=2, omega=0.7, halo=False):
    """Distributed two-level MG-PCG solve; returns the global solution.
    halo=True uses the neighbor-only ppermute exchange (HaloPlan) instead
    of all_gather."""
    Pi, Pv = distribute_rect(P_scipy, system.owner, system.ndev,
                             system.n_loc, dtype=dtype)
    coarse_inv = np.linalg.inv(np.asarray(
        A_coarse.todense() if sp.issparse(A_coarse) else A_coarse)
    ).astype(dtype)
    b = jnp.asarray(system.to_local(np.asarray(b_global, dtype=dtype)))
    vals = jnp.asarray(system.values)
    mask = jnp.asarray(system.row_mask)
    dinv = jnp.asarray(system.dinv)
    Pi = jnp.asarray(Pi)
    Pv = jnp.asarray(Pv)
    cinv = jnp.asarray(coarse_inv)
    x = jnp.zeros_like(b)
    r = b
    # initialization trick: one step with d = 0 leaves (x, r) unchanged and
    # produces z = MG(r), d = z — the correct PCG start
    z = b
    d = jnp.zeros_like(b)
    if halo:
        plan = build_halo_plan(system)
        step = jax.jit(distributed_mg_pcg_step_halo(
            mesh, plan, nu=nu, omega=omega))
        idx_ext = jnp.asarray(plan.indices_ext)
        sends = tuple(jnp.asarray(t) for t in plan.send_slots)
        args = (vals, idx_ext, mask, dinv, sends, Pi, Pv, cinv)
    else:
        step = jax.jit(distributed_mg_pcg_step(mesh, nu=nu, omega=omega))
        args = (jnp.asarray(system.indices), vals, mask, dinv, Pi, Pv, cinv)
    x, r, z, d = step(*args, x, r, z, d)
    for _ in range(iters):
        x, r, z, d = step(*args, x, r, z, d)
    return system.to_global(np.asarray(x))


# ---------------------------------------------------------------------- #
# Distributed L-level multigrid
# ---------------------------------------------------------------------- #
@dataclass
class DistributedHierarchy:
    """L-level distributed MG: every level's operator is row-sharded with
    its own HaloPlan; restriction reduces partial P^T r contributions with
    psum_scatter (reduce-scatter); prolongation all_gathers the
    (geometrically shrinking) coarse block; the coarsest level applies a
    replicated dense inverse. The reference's analog is hypre's parallel
    V-cycle over ParCSR operators (SURVEY.md §2.3)."""
    systems: list                # DistributedSystem per level 0..L-1
    plans: list                  # HaloPlan per level
    P_rows: list                 # (Pi, Pv) per level: row-sharded by fine
                                 # owner, columns = coarse VIRTUAL ids
    coarse_inv: np.ndarray       # replicated dense inverse of level L
    owners: list                 # dof owner per level

    def device_args(self, mesh: "Mesh" = None):
        """Device-resident level arrays. With `mesh` given, every
        (ndev, ...) block is placed as a GLOBAL dd-sharded array via
        shard_blocks (jax.make_array_from_callback) and the replicated
        pieces via replicate_array — the multi-process-safe path (each
        process materializes only its addressable shards; plain
        jnp.asarray host arrays cannot cross process boundaries).
        Without `mesh`, single-process jnp.asarray placement."""
        import jax.numpy as jnp
        if mesh is None:
            put = jnp.asarray
            rep = jnp.asarray
        else:
            def put(x):
                return shard_blocks(mesh, x)

            def rep(x):
                return replicate_array(mesh, x)
        lv = []
        for s, p, (Pi, Pv) in zip(self.systems, self.plans, self.P_rows):
            lv.append(dict(
                values=put(s.values),
                idx_ext=put(p.indices_ext),
                mask=put(s.row_mask),
                dinv=put(s.dinv),
                sends=tuple(put(t) for t in p.send_slots),
                Pi=put(Pi), Pv=put(Pv)))
        # virtual index of each global coarsest dof (for the replicated
        # dense solve: virtual layout interleaves per-device padding)
        g2v = rep(self.systems[-1].virt.astype(np.int32))
        return lv, rep(self.coarse_inv), g2v


def coarse_owner_from_P(P, fine_owner):
    """Owner of a coarse dof = owner of its first fine dof (owner-computes,
    the SharingMap convention for coarse SharingMaps)."""
    Pc = sp.csc_matrix(P)
    owner = np.zeros(Pc.shape[1], dtype=np.int64)
    for c in range(Pc.shape[1]):
        rows = Pc.indices[Pc.indptr[c]:Pc.indptr[c + 1]]
        owner[c] = fine_owner[rows].min() if rows.size else 0
    return owner


def build_distributed_hierarchy(A_levels, P_levels, fine_owner, ndev,
                                dtype=np.float64) -> DistributedHierarchy:
    """A_levels: host CSR per level (finest first, coarsest last);
    P_levels: interpolations; fine_owner: dof owner vector at level 0."""
    owners = [np.asarray(fine_owner)]
    for P_l in P_levels:
        owners.append(coarse_owner_from_P(P_l, owners[-1]))
    systems, plans, P_rows = [], [], []
    for l, P_l in enumerate(P_levels):
        s = distribute_system(A_levels[l], owners[l], ndev, dtype=dtype)
        systems.append(s)
        plans.append(build_halo_plan(s))
        # coarse layout (needed for virtual column ids of P)
        s_c = distribute_system(A_levels[l + 1], owners[l + 1], ndev,
                                dtype=dtype)
        P_csr = sp.csr_matrix(P_levels[l])
        Pv_virt = sp.csr_matrix(
            (P_csr.data, s_c.virt[P_csr.indices], P_csr.indptr),
            shape=(P_csr.shape[0], ndev * s_c.n_loc))
        Pi, Pv = distribute_rect(Pv_virt, owners[l], ndev, s.n_loc,
                                 dtype=dtype)
        P_rows.append((Pi, Pv))
        if l == len(P_levels) - 1:
            systems.append(s_c)
            plans.append(build_halo_plan(s_c))
    coarse_inv = np.linalg.inv(A_levels[-1].toarray()).astype(dtype)
    return DistributedHierarchy(systems, plans, P_rows, coarse_inv, owners)


def distributed_mg_l_step(mesh: Mesh, hierarchy: DistributedHierarchy,
                          nu=2, omega=0.7):
    """One MG(L-level V-cycle)-preconditioned CG iteration under shard_map.
    Level arrays arrive as a pytree argument (levels list from
    DistributedHierarchy.device_args)."""
    ndev = mesh.devices.size
    offsets = [p.offsets for p in hierarchy.plans]
    n_levels = len(hierarchy.systems)
    n_locs = [s.n_loc for s in hierarchy.systems]

    def spmv(l, lv, x):
        return _halo_spmv_local(lv["values"], lv["idx_ext"], lv["mask"],
                                lv["sends"], offsets[l], ndev, x)

    def smooth(l, lv, r, x):
        return x + omega * lv["dinv"] * (
            r - spmv(l, lv, x)) * lv["mask"]

    def vcycle(l, levels, coarse_inv, g2v, r):
        if l == n_levels - 1:
            # replicated coarse solve: gather the full coarse vector
            # (virtual layout), reorder to global, solve, scatter back
            rg = jax.lax.all_gather(r, "dd").reshape(-1)
            e = jnp.dot(coarse_inv, rg[g2v], precision=_HIGHEST)
            ep = jnp.zeros(ndev * n_locs[l], r.dtype).at[g2v].set(e)
            me = jax.lax.axis_index("dd")
            return jax.lax.dynamic_slice_in_dim(
                ep, me * n_locs[l], n_locs[l])[None, :]
        lv = levels[l]
        x = omega * lv["dinv"] * r * lv["mask"]
        for _ in range(nu - 1):
            x = smooth(l, lv, r, x)
        res = (r - spmv(l, lv, x)) * lv["mask"]
        # restriction: partial P^T res into the coarse VIRTUAL layout,
        # reduced and scattered in one collective
        buf = jnp.zeros(ndev * n_locs[l + 1], r.dtype).at[
            lv["Pi"][0].reshape(-1)].add(
            (lv["Pv"][0] * res[0][:, None]).reshape(-1))
        rc = jax.lax.psum_scatter(
            buf.reshape(ndev, n_locs[l + 1]), "dd",
            scatter_dimension=0, tiled=True)
        ec = vcycle(l + 1, levels, coarse_inv, g2v, rc.reshape(1, -1))
        # prolongation: all_gather the coarse block, local P rows
        eg = jax.lax.all_gather(ec, "dd").reshape(-1)
        x = x + jnp.einsum("nk,nk->n", lv["Pv"][0], eg[lv["Pi"][0]],
                           precision=_HIGHEST)[None, :] * lv["mask"]
        for _ in range(nu):
            x = smooth(l, lv, r, x)
        return x

    def make_spec(lv, with_P=True):
        d = dict(values=P("dd"), idx_ext=P("dd"), mask=P("dd"),
                 dinv=P("dd"),
                 sends=tuple(P("dd") for _ in lv["sends"]))
        if "Pi" in lv:
            d.update(Pi=P("dd"), Pv=P("dd"))
        return d

    def bind(levels_args):
        specs = [make_spec(lv) for lv in levels_args]

        @partial(
            shard_map, mesh=mesh,
            in_specs=(specs, P(), P(), P("dd"), P("dd"), P("dd"), P("dd")),
            out_specs=(P("dd"), P("dd"), P("dd"), P("dd")),
        )
        def step(levels, coarse_inv, g2v, x, r, z, d):
            lv0 = levels[0]
            Ad = spmv(0, lv0, d)
            rz = jax.lax.psum(jnp.vdot(r, z), "dd")
            dAd = jax.lax.psum(jnp.vdot(d, Ad), "dd")
            alpha = rz / jnp.where(dAd != 0, dAd, 1.0)
            x = x + alpha * d
            r = r - alpha * Ad
            z = vcycle(0, levels, coarse_inv, g2v, r)
            rz_new = jax.lax.psum(jnp.vdot(r, z), "dd")
            beta = rz_new / jnp.where(rz != 0, rz, 1.0)
            d = z + beta * d
            return x, r, z, d

        return step

    return bind


def distributed_mg_l_pcg(hier: DistributedHierarchy, b_global, mesh: Mesh,
                         iters=20, dtype=np.float64, nu=2, omega=0.7):
    """Distributed L-level MG-PCG driver; returns the global solution.
    Multi-process safe: level blocks and state ride
    make_array_from_callback global arrays and the result is
    process-allgathered (the reference's analog is hypre's ParCSR V-cycle
    over an arbitrary MPI world, ParELAG_Hierarchy.cpp:109-253)."""
    multi = jax.process_count() > 1
    levels_args, cinv, g2v = hier.device_args(mesh if multi else None)
    step = jax.jit(distributed_mg_l_step(mesh, hier, nu=nu,
                                         omega=omega)(levels_args))
    s0 = hier.systems[0]
    b_blocks = s0.to_local(np.asarray(b_global, dtype=dtype))
    b = shard_blocks(mesh, b_blocks) if multi else jnp.asarray(b_blocks)
    x = jnp.zeros_like(b)
    r = b
    z = b
    d = jnp.zeros_like(b)
    # init step with d = 0: z becomes MG(r), (x, r) unchanged
    x, r, z, d = step(levels_args, cinv, g2v, x, r, z, d)
    for _ in range(iters):
        x, r, z, d = step(levels_args, cinv, g2v, x, r, z, d)
    return s0.to_global(gather_global(x))


def distributed_pcg(system: DistributedSystem, b_global, mesh: Mesh,
                    iters=20, dtype=np.float32):
    """Run `iters` distributed PCG iterations; returns global solution."""
    step = jax.jit(distributed_pcg_step(mesh))
    b = jnp.asarray(system.to_local(np.asarray(b_global, dtype=dtype)))
    idx = jnp.asarray(system.indices)
    vals = jnp.asarray(system.values)
    mask = jnp.asarray(system.row_mask)
    dinv = jnp.asarray(system.dinv)
    x = jnp.zeros_like(b)
    r = b
    z = dinv * r
    d = z
    for _ in range(iters):
        x, r, z, d = step(idx, vals, mask, dinv, x, r, z, d)
    return system.to_global(np.asarray(x))
