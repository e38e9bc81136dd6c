"""AMGe solver construction from a DeRhamSequence chain.

Rebuild of reference AMGeSolverFactory::_do_build_solver
(factories/ParELAG_AMGeSolverFactory.cpp:49-163) +
buildHierarchyFromDeRhamSequence (ParELAG_Hierarchy.cpp:282-385): walk the
sequence chain, P_l = seq_l.P[form], A_{l+1} = P^T A_l P with BC zero-row
fix, smoothers per level (l1-Jacobi / Chebyshev, or Hiptmair for forms with a
potential space), dense direct solve at the coarsest level.
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp

from parelag_tpu.solvers.hierarchy import build_hierarchy, rap
from parelag_tpu.solvers import smoothers as sm


def build_amge_hierarchy(seqs, form, A_fine, smoother="l1jacobi",
                         sweeps=2, mu=1, dtype=np.float64,
                         cheby_degree=3, matrix_format="auto",
                         reorder=None, transfer_dtype=None):
    """seqs: list of DeRhamSequence levels (finest first); A_fine: assembled
    + BC-eliminated fine operator. Returns (Hierarchy, A_levels, P_levels).

    smoother: 'l1jacobi' | 'chebyshev' | 'hiptmair' (Hiptmair uses the
    potential-space derivative D[form-1] coarsened per level, the reference
    HiptmairSmootherFactory pattern)."""
    assert not (smoother == "hiptmair" and reorder), \
        "reorder folds into A/P only; the Hiptmair aux derivative is not " \
        "permuted yet"
    n_lev = len(seqs)
    A_levels = [sp.csr_matrix(A_fine)]
    P_levels = []
    for l in range(n_lev - 1):
        P = seqs[l].P[form]
        P_levels.append(P)
        A_levels.append(rap(A_levels[l], P))

    def factory(A, l):
        if smoother == "l1jacobi":
            return sm.make_l1_jacobi(A, sweeps=sweeps)
        if smoother == "chebyshev":
            return sm.make_chebyshev(A, degree=cheby_degree)
        if smoother == "hiptmair":
            D = seqs[l].D[form - 1]
            return sm.make_hiptmair(A, D)
        raise ValueError(smoother)

    H = build_hierarchy(A_levels, P_levels, factory, mu=mu, dtype=dtype,
                        matrix_format=matrix_format, reorder=reorder,
                        transfer_dtype=transfer_dtype)
    return H, A_levels, P_levels


def build_ml_hiptmair(seqs, form, A_fine, sweeps=1, mu=1,
                      dtype=np.float64, matrix_format="auto"):
    """MLHiptmairSolver analog (reference ParELAG_MLHiptmairSolver.hpp:
    34-130, templated on problem type): multilevel MG on the `form` space
    with Hiptmair two-space smoothing at EVERY level — the auxiliary space
    reached through the potential derivative D[form-1] coarsened along the
    sequence chain. Template instances: form=1 (Hcurl, H1 potentials) and
    form=2 (Hdiv, Hcurl potentials). Returns (Hierarchy, A_levels,
    P_levels); solve with amge_pcg_solve."""
    assert form >= 1, "Hiptmair needs a potential space (form >= 1)"
    return build_amge_hierarchy(
        seqs, form, A_fine, smoother="hiptmair", sweeps=sweeps, mu=mu,
        dtype=dtype, matrix_format=matrix_format)


def amge_pcg_solve(H, A_ell, b, rtol=1e-6, atol=1e-12, maxiter=500):
    """PCG with one MG cycle as preconditioner (the reference's
    'Krylov + AMGe preconditioner' composition, CreateXFormParameterList).

    Jitted with the hierarchy/operator as ARGUMENTS: closing over multi-MB
    device arrays would embed them as XLA constants in the module."""
    import jax
    from parelag_tpu.solvers.cg import pcg

    bj = jnp.asarray(b)

    @jax.jit
    def _solve(Harg, Aarg, bb):
        if Harg.perm is not None:
            bb = bb[Harg.perm]
            Aarg = Harg.levels[0].A
        x, info = pcg(lambda v: Aarg @ v, bb, precond=Harg.apply,
                      rtol=rtol, atol=atol, maxiter=maxiter)
        if Harg.iperm is not None:
            x = x[Harg.iperm]
        return x, info

    x, info = _solve(H, A_ell, bj)
    return np.asarray(x), info
