"""Device sparse format correctness: ELL / BCSR / DIA against scipy,
square + rectangular + multi-RHS, and hierarchy integration of the DIA
(gather-free) format."""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest

from parelag_tpu.ops.device_sparse import (
    from_scipy, to_bcsr, to_dia, dia_n_offsets)


@pytest.mark.parametrize("shape", [(300, 300), (200, 300), (300, 200)])
def test_formats_match_scipy(shape):
    rng = np.random.RandomState(0)
    A = sp.random(*shape, density=0.03, random_state=rng).tocsr()
    if shape[0] == shape[1]:
        A = (A + sp.identity(shape[0])).tocsr()
    x = rng.randn(shape[1])
    X = rng.randn(shape[1], 5)
    y = A @ x
    E = from_scipy(A, dtype=np.float64)
    assert np.allclose(np.asarray(E @ jnp.asarray(x)), y)
    B = to_bcsr(A, dtype=np.float64)
    assert np.allclose(np.asarray(B @ jnp.asarray(x)), y)
    assert np.allclose(np.asarray(B @ jnp.asarray(X)), A @ X)
    D = to_dia(A, dtype=np.float64)
    assert np.allclose(np.asarray(D @ jnp.asarray(x)), y)
    assert np.allclose(np.asarray(D @ jnp.asarray(X)), A @ X)


def test_dia_n_offsets_banded():
    A = sp.diags([1.0, 2.0, 3.0], offsets=[-2, 0, 5],
                 shape=(50, 50)).tocsr()
    assert dia_n_offsets(A) == 3


def test_hierarchy_dia_format_matches_bcsr():
    """A 2-level H1 hierarchy in DIA format produces the same V-cycle
    application as the ELL build (digit-exact in f64)."""
    from parelag_tpu.models.multigrid import build_seq_hierarchy
    from parelag_tpu.models.upscaling import (
        mark_dofs_on_bndr, boundary_rhs, eliminate_rowcols)
    from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
    mesh, topos, seqs = build_seq_hierarchy(nref_parallel=1)
    s = seqs[0]
    M = s.compute_mass_operator(0)
    W = s.compute_mass_operator(1)
    A = (M + s.D[0].T @ W @ s.D[0]).tocsr()
    b = boundary_rhs(s, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    H1, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi",
                                    sweeps=1, matrix_format="dia")
    H2, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi",
                                    sweeps=1, matrix_format="ell")
    bj = jnp.asarray(b)
    y1 = np.asarray(H1.apply(bj))
    y2 = np.asarray(H2.apply(bj))
    assert np.abs(y1 - y2).max() < 1e-12 * max(np.abs(y2).max(), 1)


def test_coo_and_dia_ell_match_scipy():
    """CooMatrix / DiaEllMatrix (hybrid split) reproduce scipy SpMV: the
    high-occupancy diagonals ride gather-free DIA and the straggler nnz a
    short padded COO."""
    from parelag_tpu.ops.device_sparse import (
        to_coo, to_dia_ell, dia_ell_fill)
    rng = np.random.RandomState(3)
    n = 400
    # banded core + random stragglers, like a facet multiplier system
    A = sp.diags([rng.randn(n - abs(o)) for o in (-7, -1, 0, 1, 7)],
                 offsets=(-7, -1, 0, 1, 7), shape=(n, n)).tocsr()
    A = (A + sp.random(n, n, density=0.002, random_state=rng)).tocsr()
    x = rng.randn(n)
    y = A @ x
    C = to_coo(A, dtype=np.float64, pad_to=64)
    assert np.allclose(np.asarray(C @ jnp.asarray(x)), y)
    H = to_dia_ell(A, dtype=np.float64)
    assert len(H.dia.offs) >= 5          # the 5 dense bands go DIA
    assert np.allclose(np.asarray(H @ jnp.asarray(x)), y)
    assert 0.8 < dia_ell_fill(A) <= 1.0


def test_block_diag_inverse_apply():
    """BlockDiagInverse: static-slice batched apply == dense blockdiag."""
    from parelag_tpu.ops.device_sparse import BlockDiagInverse
    rng = np.random.RandomState(5)
    d = 1.0 / (1.0 + np.abs(rng.randn(6)))             # 6 singletons
    B3 = rng.randn(4, 3, 3) + 3 * np.eye(3)            # 4 blocks of 3
    B3i = np.linalg.inv(B3)
    op = BlockDiagInverse([jnp.asarray(d), jnp.asarray(B3i)], [1, 3])
    r = rng.randn(6 + 12)
    got = np.asarray(op @ jnp.asarray(r))
    want = np.concatenate(
        [d * r[:6]] + [B3i[k] @ r[6 + 3 * k: 9 + 3 * k] for k in range(4)])
    assert np.allclose(got, want)


@pytest.mark.parametrize("shape", [(300, 300), (200, 300), (300, 200)])
def test_tilecoo_matches_scipy(shape):
    from parelag_tpu.ops.device_sparse import to_tilecoo, bcsr_stats
    rng = np.random.RandomState(1)
    A = sp.random(*shape, density=0.03, random_state=rng).tocsr()
    x = rng.randn(shape[1])
    X = rng.randn(shape[1], 5)
    T = to_tilecoo(A, dtype=np.float64)
    assert np.allclose(np.asarray(T @ jnp.asarray(x)), A @ x)
    assert np.allclose(np.asarray(T @ jnp.asarray(X)), A @ X)
    nbr, kb, ntiles = bcsr_stats(A)
    # stats describe the layouts: BCSR pads to nbr*kb tiles, TileCoo
    # stores exactly the nonempty ones
    assert T.tiles.shape[0] == max(ntiles, 1)
    assert ntiles <= nbr * kb
    B = to_bcsr(A, dtype=np.float64)
    assert B.col_blocks.shape == (nbr, kb)


def test_transfer_format_selection_and_dtype():
    """build_hierarchy picks device formats for P/R from structure stats
    and honors transfer_dtype (the solve-phase fix for the ELL-fallback
    transfers that dominated the flagship V-cycle)."""
    import jax
    from parelag_tpu.solvers.hierarchy import build_hierarchy
    from parelag_tpu.solvers import smoothers as sm
    rng = np.random.RandomState(2)
    n, nc = 400, 60
    A = sp.random(n, n, density=0.02, random_state=rng)
    A = (A + A.T + 20 * sp.identity(n)).tocsr()
    P = sp.random(n, nc, density=0.05, random_state=rng).tocsr()
    Ac = (P.T @ A @ P).tocsr()
    H = build_hierarchy([A, Ac], [P],
                        lambda M, l: sm.make_l1_jacobi(M, sweeps=1),
                        dtype=np.float32, transfer_dtype=jnp.bfloat16)
    assert H.levels[0].P.dtype == jnp.bfloat16
    assert H.levels[0].R.dtype == jnp.bfloat16
    b = rng.randn(n).astype(np.float32)
    y = np.asarray(H.apply(jnp.asarray(b)), np.float64)
    assert np.isfinite(y).all() and np.linalg.norm(y) > 0


def _stencil(n, w):
    """Banded 5-diagonal operator (offsets 0, +-1, +-w), f32."""
    return sp.diags([6.0 + np.arange(n) % 3, -np.ones(n - 1),
                     -np.ones(n - 1), -0.5 * np.ones(n - w),
                     -0.5 * np.ones(n - w)],
                    [0, 1, -1, w, -w]).tocsr().astype(np.float32)


@pytest.mark.parametrize("shape,s", [((900, 900), 1), ((900, 900), 16),
                                     ((700, 900), 1), ((900, 700), 16)])
def test_dia_matvec_matches_scipy(shape, s):
    """DiaMatrix.matvec (the XLA shift loop) == scipy for 1 and 16
    right-hand sides, square and rectangular."""
    A = _stencil(max(shape), 30)[:shape[0], :shape[1]].tocsr()
    D = to_dia(A, dtype=np.float32)
    rng = np.random.RandomState(4)
    x = rng.randn(shape[1]) if s == 1 else rng.randn(shape[1], s)
    x = x.astype(np.float32)
    y = np.asarray(D @ jnp.asarray(x), np.float64)
    ref = A.astype(np.float64) @ x.astype(np.float64)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() < 1e-5 * np.abs(ref).max()


def test_l1_jacobi_apply_zero_dia_matches_numpy():
    """L1JacobiSmoother.apply_zero on a DIA operator == the f64 numpy
    sweeps from a zero guess."""
    from parelag_tpu.solvers.smoothers import make_l1_jacobi
    n = 3000
    A = _stencil(n, 30)
    smo = make_l1_jacobi(A, sweeps=3, omega=0.9)
    b = np.random.RandomState(6).randn(n).astype(np.float32)
    out = np.asarray(smo.apply_zero(to_dia(A, dtype=np.float32),
                                    jnp.asarray(b)), np.float64)
    d = 0.9 / np.asarray(np.abs(A).sum(axis=1), np.float64).ravel()
    A64 = A.astype(np.float64)
    x = d * b
    for _ in range(2):
        x = x + d * (b - A64 @ x)
    assert np.abs(out - x).max() < 1e-5 * np.abs(x).max()


def test_dia_multirhs_matvec_fallback_parity():
    """DiaMatrix.matvec on (n, s) input matches scipy column-wise."""
    n, s = 4000, 4
    A = sp.diags([4.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1]).tocsr().astype(np.float32)
    Ad = to_dia(A, dtype=np.float32)
    rng = np.random.RandomState(1)
    X = rng.randn(n, s).astype(np.float32)
    y = np.asarray(Ad @ jnp.asarray(X))
    ref = A @ X
    assert np.abs(y - ref).max() < 1e-5 * np.abs(ref).max()


def test_dia_jacobi_sweeps_method_fallback_parity():
    """The l1-Jacobi smoother on a DIA operator (XLA shift loop inside
    the sweep) agrees with the f64 formula x + d * (b - A x)."""
    from parelag_tpu.solvers.smoothers import L1JacobiSmoother
    n = 4000
    A = sp.diags([4.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1]).tocsr().astype(np.float32)
    Ad = to_dia(A, dtype=np.float32)
    dinv = (1.0 / np.asarray(np.abs(A).sum(axis=1)).ravel()
            ).astype(np.float32)
    smo = L1JacobiSmoother(jnp.asarray(dinv), sweeps=2, omega=1.0)
    rng = np.random.RandomState(1)
    b = rng.randn(n).astype(np.float32)
    x0 = rng.randn(n).astype(np.float32)
    out = np.asarray(smo.apply(Ad, jnp.asarray(b), jnp.asarray(x0)),
                     dtype=np.float64)
    x = x0.astype(np.float64)
    A64 = A.astype(np.float64)
    d64 = dinv.astype(np.float64)
    for _ in range(2):
        x = x + d64 * (b - A64 @ x)
    assert np.abs(out - x).max() < 1e-5 * np.abs(x).max()
