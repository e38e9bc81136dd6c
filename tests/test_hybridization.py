"""Hybridized Hdiv-L2 solver tests (HybridHdivL2 / HybridizationSolver
equivalents; reference golden lanes: MultigridTestDarcy_Hybrid,
examples/CMakeLists.txt:168-182). The hybridized solve must reproduce the
monolithic saddle-point solution exactly (same discrete system, eliminated
differently)."""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import pytest

from parelag_tpu.models.darcy import build_darcy_hierarchy
from parelag_tpu.amge.hybridization import HybridHdivL2
from parelag_tpu.amge import hexfe


@pytest.fixture(scope="module")
def hierarchy():
    return build_darcy_hierarchy(nref_parallel=1)


def _saddle_solve(s, rhs_u, rhs_p, w_weight=0.0):
    M = s.compute_mass_operator(2)
    W = s.compute_mass_operator(3)
    B = (W @ s.D[2]).tocsr()
    C = (-w_weight * W) if w_weight != 0 else None
    A = sp.bmat([[M, B.T], [B, C]], format="csc")
    x = spla.spsolve(A, np.concatenate([rhs_u, rhs_p]))
    return x[: B.shape[1]], x[B.shape[1]:]


@pytest.mark.parametrize("level", [0, 1])
def test_hybrid_matches_saddle(hierarchy, level):
    mesh, topos, seqs = hierarchy
    s = seqs[level]
    nu = s.dof[2].ndofs
    if level == 0:
        vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
        rhs_u, rhs_p = np.zeros(nu), vols
    else:
        vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
        rhs_u = seqs[0].P[2].T @ np.zeros(seqs[0].dof[2].ndofs)
        rhs_p = seqs[0].P[3].T @ vols
    u_ref, p_ref = _saddle_solve(s, rhs_u, rhs_p)
    hyb = HybridHdivL2(s)
    u, p = hyb.solve(rhs_u, rhs_p)
    assert np.abs(u - u_ref).max() < 1e-12
    assert np.abs(p - p_ref).max() < 1e-12


def test_hybrid_w_weight(hierarchy):
    """[M B^T; B -wW] variant (MultigridTestDarcy_Hybrid 'L2-mass weight'
    lane, examples/CMakeLists.txt:176-182)."""
    mesh, topos, seqs = hierarchy
    s = seqs[0]
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    rhs_u, rhs_p = np.zeros(s.dof[2].ndofs), vols
    u_ref, p_ref = _saddle_solve(s, rhs_u, rhs_p, w_weight=1.0)
    hyb = HybridHdivL2(s, W_weight=1.0)
    u, p = hyb.solve(rhs_u, rhs_p)
    assert np.abs(u - u_ref).max() < 1e-12
    assert np.abs(p - p_ref).max() < 1e-12


def test_hybrid_cg_with_rescaling(hierarchy):
    mesh, topos, seqs = hierarchy
    s = seqs[0]
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    rhs_u, rhs_p = np.zeros(s.dof[2].ndofs), vols
    u_ref, p_ref = _saddle_solve(s, rhs_u, rhs_p)
    hyb = HybridHdivL2(s)
    u, p = hyb.solve(rhs_u, rhs_p, solver="cg", rtol=1e-12, rescale=True)
    assert np.abs(u - u_ref).max() < 1e-8
    assert np.abs(p - p_ref).max() < 1e-8


def test_hybridization_device_solver():
    """Device multiplier solve (jitted l1-Jacobi PCG) matches the
    direct solve."""
    from parelag_tpu.models.darcy import build_darcy_hierarchy
    from parelag_tpu.amge.hybridization import HybridHdivL2
    from parelag_tpu.amge import hexfe
    mesh, topos, seqs = build_darcy_hierarchy(nref_parallel=1)
    s = seqs[0]
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    hyb = HybridHdivL2(s)
    b_u = np.zeros(s.dof[2].ndofs)
    u1, p1 = hyb.solve(b_u, vols, solver="direct", rescale=True)
    u2, p2 = hyb.solve(b_u, vols, solver="device", rescale=True,
                       rtol=1e-12)
    assert np.abs(u1 - u2).max() < 1e-7
    assert np.abs(p1 - p2).max() < 1e-7


def test_hybridization_with_l2_mass_weight():
    """The MGDarcyWithL2MassHybrid variant (--L2mass-weight 1.0,
    examples/CMakeLists.txt:178-186): hybridized solve of
    [M B^T; B -W] equals the direct saddle solve."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from parelag_tpu.models.darcy import build_darcy_hierarchy
    from parelag_tpu.amge.hybridization import HybridHdivL2
    from parelag_tpu.amge import hexfe
    mesh, topos, seqs = build_darcy_hierarchy(nref_parallel=1)
    s = seqs[0]
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    hyb = HybridHdivL2(s, W_weight=1.0)
    b_u = np.zeros(s.dof[2].ndofs)
    u, p = hyb.solve(b_u, vols, solver="direct", rescale=True)
    M = s.compute_mass_operator(2)
    W = s.compute_mass_operator(3)
    B = (W @ s.D[2]).tocsr()
    A = sp.bmat([[M, B.T], [B, -W]], format="csc")
    x = spla.spsolve(A, np.concatenate([b_u, vols]))
    assert np.abs(u - x[:M.shape[0]]).max() < 1e-8
    assert np.abs(p - x[M.shape[0]:]).max() < 1e-8
