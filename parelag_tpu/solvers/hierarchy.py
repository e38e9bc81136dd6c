"""Multigrid hierarchy: V/W(mu)-cycle over level pytrees, fully jittable.

Rebuild of reference Hierarchy (ParELAG_Hierarchy.hpp:28-114, .cpp:109-253):
pre-smooth -> residual -> restrict -> recurse (mu times) -> interpolate +
correct -> post-smooth; the coarsest level applies a dense direct solve.
The level loop is unrolled at trace time (static level count), so one XLA
computation contains the entire cycle — no host round trips per level.
"""

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from parelag_tpu.ops.device_sparse import EllMatrix, from_scipy


@jax.tree_util.register_pytree_node_class
@dataclass
class Level:
    A: EllMatrix
    P: EllMatrix | None          # interpolation from next-coarser level
    R: EllMatrix | None          # restriction (P^T)
    pre: object | None
    post: object | None
    coarse_inv: jnp.ndarray | None   # dense inverse at the coarsest level

    def tree_flatten(self):
        return (self.A, self.P, self.R, self.pre, self.post,
                self.coarse_inv), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class Hierarchy:
    levels: list
    mu: int = 1                  # 1 = V-cycle, 2 = W-cycle
    perm: object = None          # dof reordering of level 0 (e.g. RCM);
    iperm: object = None         # solve in permuted space: b'=b[perm],
                                 # x = x'[iperm]

    def tree_flatten(self):
        return (self.levels, self.perm, self.iperm), (self.mu,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], children[1], children[2])

    # -------------------------------------------------------------- #
    def cycle(self, b, x=None):
        # Promote to a floating dtype: scipy's LinearOperator dtype-probes
        # preconditioners with an int8 zero vector, and an integer b would
        # otherwise propagate into zeros_like/scatter-adds.
        if not jnp.issubdtype(jnp.asarray(b).dtype, jnp.floating):
            b = jnp.asarray(b, dtype=self.levels[0].A.dtype)
        if x is None:
            return _cycle(self.levels, 0, b, jnp.zeros_like(b), self.mu,
                          x_is_zero=True)
        return _cycle(self.levels, 0, b, x, self.mu)

    def apply(self, b):
        """One cycle from zero guess — usable as a preconditioner."""
        return self.cycle(b)

    def cast(self, dtype, keep_coarse_inv=True):
        """Return a copy with all floating leaves cast to `dtype` (e.g.
        jnp.bfloat16). The preconditioner tolerates low precision — SpMV is
        memory-bound, so bf16 tables halve the bytes a cycle streams — while
        the Krylov vectors, dots, and A-matvec stay f32. The coarse dense
        inverse is kept at full precision by default (it is tiny and its
        conditioning matters most)."""
        def cast_leaf(x):
            if isinstance(x, jnp.ndarray) and jnp.issubdtype(
                    x.dtype, jnp.floating):
                return x.astype(dtype)
            return x

        levels = []
        for lvl in self.levels:
            new = jax.tree_util.tree_map(cast_leaf, lvl)
            if keep_coarse_inv and lvl.coarse_inv is not None:
                new.coarse_inv = lvl.coarse_inv
            levels.append(new)
        return Hierarchy(levels, self.mu, self.perm, self.iperm)


def _cycle(levels, l, b, x, mu, x_is_zero=False):
    lvl = levels[l]
    if lvl.coarse_inv is not None:
        # HIGHEST: an f32 coarse inverse would otherwise run in TF32 on
        # the GPU; the level is tiny, so full precision costs nothing
        return jnp.dot(lvl.coarse_inv, b,
                       precision=jax.lax.Precision.HIGHEST)
    if x_is_zero and hasattr(lvl.pre, "apply_zero"):
        x = lvl.pre.apply_zero(lvl.A, b)
    else:
        x = lvl.pre.apply(lvl.A, b, x)
    r = b - lvl.A @ x
    rc = lvl.R @ r
    ec = jnp.zeros((lvl.R.shape[0],) + b.shape[1:], dtype=b.dtype)
    first = True
    for _ in range(mu):
        ec = _cycle(levels, l + 1, rc, ec, mu, x_is_zero=first)
        first = False
    x = x + lvl.P @ ec
    x = lvl.post.apply(lvl.A, b, x)
    return x


def build_hierarchy(A_scipy_levels, P_scipy_levels, smoother_factory,
                    mu=1, dtype=np.float64,
                    matrix_format="auto", reorder=None,
                    transfer_dtype=None) -> Hierarchy:
    """Assemble a device Hierarchy from host sparse matrices.

    A_scipy_levels: [A_0, ..., A_L] (A_{l+1} = P_l^T A_l P_l, already built —
    see amge_solver.build_amge_hierarchy); P_scipy_levels: [P_0, ..., P_{L-1}].
    smoother_factory(A_scipy, level) -> smoother object.

    reorder="rcm": reverse-Cuthill-McKee permute every level — tightens the
    bandwidth so BCSR needs fewer column blocks per row block (~35% fewer
    tile bytes on the 27-point H1 operator). Its effect on V-cycle time is
    not measured on the H100, so it stays opt-in. The returned Hierarchy
    carries perm/iperm for level 0; solve in permuted space (b[perm] in,
    x[iperm] out) — amge_pcg_solve does this automatically.
    """
    from parelag_tpu.ops.device_sparse import (
        to_bcsr, to_tilecoo, bcsr_stats)
    import jax as _jax

    def to_dev_transfer(M):
        """Device format for P/R. Transfer operators are thin (~2-8 nnz
        per row) and agglomerate-spread, so the A-format heuristics
        misfire: DIA needs square shifts, and the BCSR guards tuned for
        operators reject P at scale. Pick by host-side structure stats:
        BCSR when its kb-padding stays within 4x of the nonempty-tile
        bytes, TileCoo when padding explodes but the tile count is sane,
        ELL as the last resort. The thresholds are inherited and not
        measured on the H100."""
        M = sp.csr_matrix(M)
        tdt = transfer_dtype if transfer_dtype is not None else dtype
        if matrix_format == "ell" or _jax.default_backend() == "cpu":
            return from_scipy(M, dtype=tdt)
        itemsize = np.dtype(tdt).itemsize
        nbr, kb, ntiles = bcsr_stats(M)
        bcsr_b = nbr * kb * 1024 * itemsize
        coo_b = ntiles * 1024 * itemsize
        cap = 1.5e9
        if bcsr_b <= min(max(4 * coo_b, 64e6), cap):
            return to_bcsr(M, dtype=tdt)
        if coo_b <= cap:
            return to_tilecoo(M, dtype=tdt)
        return from_scipy(M, dtype=tdt)

    def to_dev(M):
        M = sp.csr_matrix(M)
        fmt = matrix_format
        if fmt == "auto":
            # BCSR block gathers on accelerators, ELL on CPU where the
            # padded tiles only add overhead (the choice between them is
            # not measured on the H100). Callers pass the Hierarchy as a
            # jit ARGUMENT, never close over it: multi-MB arrays closed
            # over by jit become constants embedded in the module.
            fmt = "ell" if _jax.default_backend() == "cpu" else "bcsr"
        if fmt == "dia":
            # gather-free shift SpMV. The scan over diagonals is SERIAL,
            # so DIA only wins when the offset count is small (the
            # 27-diagonal lexicographic-grid case); coarse RAP levels are
            # not banded and must fall through to bcsr
            from parelag_tpu.ops.device_sparse import to_dia, dia_n_offsets
            nd = dia_n_offsets(M)
            if (nd <= 48 and nd * max(M.shape)
                    * np.dtype(dtype).itemsize <= (1 << 30)):
                return to_dia(M, dtype=dtype)
            fmt = "bcsr"
        if fmt == "bcsr":
            B = to_bcsr(M, dtype=dtype)
            size_ok = (B.tiles.size * np.dtype(dtype).itemsize <= (1 << 29)
                       and B.tiles.size <= 128 * max(M.nnz, 1))
            if size_ok:
                return B
        return from_scipy(M, dtype=dtype)

    perm0 = iperm0 = None
    if reorder == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        A_scipy_levels = list(A_scipy_levels)
        P_scipy_levels = list(P_scipy_levels)
        perms = []
        for l, A in enumerate(A_scipy_levels):
            p = np.asarray(reverse_cuthill_mckee(
                sp.csr_matrix(A), symmetric_mode=True))
            perms.append(p)
            A_scipy_levels[l] = sp.csr_matrix(A)[p][:, p]
        for l, Pl in enumerate(P_scipy_levels):
            P_scipy_levels[l] = sp.csr_matrix(Pl)[perms[l]][:, perms[l + 1]]
        perm0 = jnp.asarray(perms[0])
        inv = np.empty_like(perms[0])
        inv[perms[0]] = np.arange(perms[0].size)
        iperm0 = jnp.asarray(inv)

    n_lev = len(A_scipy_levels)
    levels = []
    for l in range(n_lev):
        A = A_scipy_levels[l]
        if l == n_lev - 1:
            if A.shape[0] > 16384:
                # a dense inverse here is O(n^2) memory / O(n^3) flops —
                # at 45k rows that is a 16 GB allocation and hours of
                # LAPACK (observed when a stalled SA chain handed its
                # fine level down as "coarsest").  Fail loudly: the
                # caller's coarsening chain is broken and must be fixed.
                raise RuntimeError(
                    f"coarsest level has {A.shape[0]} rows — too large "
                    "for a dense coarse inverse; the coarsening chain "
                    "stalled (see solvers/sa_amg.py decoupled-row "
                    "handling) or coarse_size is misconfigured")
            Ainv = np.linalg.inv(A.toarray())
            levels.append(Level(
                A=to_dev(A), P=None, R=None,
                pre=None, post=None, coarse_inv=jnp.asarray(
                    Ainv.astype(dtype))))
        else:
            P = sp.csr_matrix(P_scipy_levels[l])
            sm = smoother_factory(A, l)
            levels.append(Level(
                A=to_dev(A),
                P=to_dev_transfer(P),
                R=to_dev_transfer(P.T.tocsr()),
                pre=sm, post=sm, coarse_inv=None))
    return Hierarchy(levels, mu, perm0, iperm0)


def rap(A, P):
    """Coarse operator P^T A P with zero-row fix for eliminated BC rows
    (reference buildHierarchyFromDeRhamSequence, ParELAG_Hierarchy.cpp:366-371
    + hypre_ParCSRMatrixFixZeroRows)."""
    A = sp.csr_matrix(A)
    P = sp.csr_matrix(P)
    Ac = (P.T @ A @ P).tocsr()
    rowsum = np.asarray(np.abs(Ac).sum(axis=1)).ravel()
    zero = np.where(rowsum < 1e-14)[0]
    if zero.size:
        Ac = (Ac + sp.csr_matrix(
            (np.ones(zero.size), (zero, zero)), shape=Ac.shape)).tocsr()
    return Ac
