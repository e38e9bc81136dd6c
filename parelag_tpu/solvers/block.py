"""Blocked saddle-point multigrid: the Darcy AMGe solver.

Rebuild of the reference's blocked hierarchy
(buildBlockedHierarchyFromDeRhamSequence, ParELAG_Hierarchy.cpp:397+,
MonolithicBlockedOperatorFactory) and its Block-Jacobi/GS smoothers
(sample XML GMRES-AMGe-BlkJacobi-GS-AMG): each level holds the monolithic
saddle operator

    A_l = [ M_l  B_l^T ]      B_l = W_l D_l,  C_l = w W_l (>= 0)
          [ B_l  -C_l  ]

with block-diagonal transfers diag(P_u, P_p); the smoother is an inexact
Uzawa / block-triangular sweep with l1-Jacobi approximations of M and of the
explicit Schur complement S = B diag(M)^{-1} B^T + C. The whole V-cycle is a
jitted pytree (reuses solvers.hierarchy) and is wrapped in device GMRES.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from parelag_tpu.ops.device_sparse import EllMatrix, from_scipy
from parelag_tpu.solvers.hierarchy import Level, Hierarchy, rap
from parelag_tpu.solvers.smoothers import make_l1_jacobi


@jax.tree_util.register_pytree_node_class
@dataclass
class BlockSaddleSmoother:
    """Inexact-Uzawa sweeps on [M B^T; B -C] (symmetrizable variant of the
    reference's Block Jacobi/GS smoother with diagonal Schur approximation,
    ParELAG_SchurComplementFactory.cpp)."""
    n0: int
    m_dinv: jnp.ndarray       # l1-Jacobi weights of M
    s_dinv: jnp.ndarray       # l1-Jacobi weights of S
    sweeps: int
    omega: float

    def tree_flatten(self):
        return (self.m_dinv, self.s_dinv), (self.n0, self.sweeps,
                                            self.omega)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], children[0], children[1], aux[1], aux[2])

    def apply(self, A: EllMatrix, b, x):
        n0 = self.n0
        for _ in range(self.sweeps):
            r = b - A @ x
            du = self.omega * self.m_dinv * r[:n0]
            x = x.at[:n0].add(du)
            r = b - A @ x
            # Schur sign: after eliminating u the p-block is -(S);
            # descend along -S^{-1} r_p
            dp = -self.omega * self.s_dinv * r[n0:]
            x = x.at[n0:].add(dp)
        return x


def monolithic_saddle(M, B, C=None) -> sp.csr_matrix:
    """[[M, B^T], [B, -C]] as one sparse matrix
    (MonolithicBlockedOperatorFactory analog)."""
    Cblk = None if C is None else (-sp.csr_matrix(C))
    return sp.bmat([[M, B.T], [B, Cblk]], format="csr")


def build_darcy_amge_hierarchy(seqs, w_weight=0.0, sweeps=2, omega=0.8,
                               dtype=np.float64, mu=1):
    """Blocked AMGe hierarchy for the Darcy saddle problem over a
    DeRhamSequence chain. Returns (Hierarchy, A_levels, offsets)."""
    dim = seqs[0].dim
    uform, pform = dim - 1, dim
    n_lev = len(seqs)

    A_levels, n0s = [], []
    for s in seqs:
        M = s.compute_mass_operator(uform)
        W = s.compute_mass_operator(pform)
        B = (W @ s.D[uform]).tocsr()
        C = (w_weight * W) if w_weight != 0 else None
        A_levels.append(monolithic_saddle(M, B, C))
        n0s.append(M.shape[0])

    P_levels = []
    for l in range(n_lev - 1):
        P = sp.block_diag(
            [seqs[l].P[uform], seqs[l].P[pform]], format="csr")
        P_levels.append(P)

    levels = []
    for l in range(n_lev):
        A = A_levels[l]
        if l == n_lev - 1:
            Ainv = np.linalg.inv(A.toarray())
            levels.append(Level(
                A=from_scipy(A, dtype=dtype), P=None, R=None, pre=None,
                post=None, coarse_inv=jnp.asarray(Ainv.astype(dtype))))
        else:
            n0 = n0s[l]
            M = A[:n0, :n0].tocsr()
            B = A[n0:, :n0].tocsr()
            C = (-A[n0:, n0:]).tocsr()
            dM = np.asarray(np.abs(M).sum(axis=1)).ravel()
            S = (B @ sp.diags(1.0 / M.diagonal()) @ B.T + C).tocsr()
            dS = np.asarray(np.abs(S).sum(axis=1)).ravel()
            sm = BlockSaddleSmoother(
                n0=n0,
                m_dinv=jnp.asarray((1.0 / np.where(dM > 0, dM, 1.0)
                                    ).astype(dtype)),
                s_dinv=jnp.asarray((1.0 / np.where(dS > 0, dS, 1.0)
                                    ).astype(dtype)),
                sweeps=sweeps, omega=omega)
            P = sp.csr_matrix(P_levels[l])
            levels.append(Level(
                A=from_scipy(A, dtype=dtype),
                P=from_scipy(P, dtype=dtype),
                R=from_scipy(P.T.tocsr(), dtype=dtype),
                pre=sm, post=sm, coarse_inv=None))
    return Hierarchy(levels, mu), A_levels, n0s


def darcy_gmres_solve(H, A_scipy, b, rtol=1e-6, restart=50,
                      max_restarts=40, dtype=np.float64):
    """Device GMRES with one blocked V-cycle as right preconditioner
    (the GMRES-AMGe composition of the reference's darcy XML)."""
    from parelag_tpu.solvers.cg import gmres
    bj = jnp.asarray(np.asarray(b, dtype=dtype))

    # hierarchy passed as a jit argument, not closed over as constants
    @jax.jit
    def run(Harg, bb):
        return gmres(lambda v: Harg.levels[0].A @ v, bb, precond=Harg.apply,
                     rtol=rtol, restart=restart,
                     max_restarts=max_restarts)

    x, (it, res) = run(H, bj)
    return np.asarray(x), (int(it), float(res))
