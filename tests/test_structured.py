"""Oracle for the structured (device-resident) AMGe setup engine.

amge/structured.py re-derives the generic coarsening math
(DeRhamSequence.cpp:1723-2086 traces, :2169-2656 extensions) as uniform
batched dense stages on cartesian-nested hex grids.  This file is the
parity contract the module's docstring promises:

  * the reference's own invariants (DeRhamSequence::CheckInvariants,
    DeRhamSequence.cpp:694-970) hold on the structured chain:
    D@D = 0, M_c = P^T M_f P, commutation D_f P_j = P_{j+1} D_c,
    Pi P = I;
  * the structured engine and the generic host engine
    (amge/sequence.py) build THE SAME coarse spaces on the same grid —
    asserted convention-free through B-orthogonal projectors onto the
    coarse space after an explicit (empirically scaled) fine-entity
    remap between the two numbering schemes, for all four forms, on
    homogeneous and heterogeneous coefficients.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from parelag_tpu.amge import structured as st
from parelag_tpu.mesh.mesh import hex_grid_mesh
from parelag_tpu.mesh.entities import derive_entities
from parelag_tpu.topology.topology import AgglomeratedTopology
from parelag_tpu.amge.fespace import DeRhamSequenceFE
from parelag_tpu.partitioning.partitioners import cartesian_partition


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    den = max(np.abs(b).max(), 1e-300)
    return np.abs(a - b).max() / den


def _spdiff(A, B):
    den = max(np.abs(B.data).max() if B.nnz else 0.0, 1e-300)
    D = (A - B).tocsr()
    return (np.abs(D.data).max() if D.nnz else 0.0) / den


# ------------------------------------------------------------------ #
# invariants on the structured chain
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def chain884():
    lvl0 = st.fine_level((8, 8, 8))
    return st.coarsen_chain(lvl0, 3, jform_start=0)


def test_dd_zero_all_levels(chain884):
    levels, _ = chain884
    for lvl in levels:
        D0 = st.global_derivative(lvl, 0)
        D1 = st.global_derivative(lvl, 1)
        D2 = st.global_derivative(lvl, 2)
        assert np.abs((D1 @ D0).toarray()).max() < 1e-13
        assert np.abs((D2 @ D1).toarray()).max() < 1e-13


def test_galerkin_mass_parity(chain884):
    """M_c == P^T M_f P for every form at every level transition."""
    levels, outs = chain884
    for lvl, out, coarse in zip(levels, outs, levels[1:]):
        for j in range(4):
            P = st.materialize_P(out, lvl.shape, j)
            Mf = st.global_mass(lvl, j)
            Mc = st.global_mass(coarse, j)
            err = _spdiff((P.T @ Mf @ P).tocsr(), Mc)
            assert err < 1e-12, (lvl.shape, j, err)


def test_commutation_nested(chain884):
    """D_f P_j == P_{j+1} D_c (nested spaces: interpolation commutes
    with the exterior derivative)."""
    levels, outs = chain884
    for lvl, out in zip(levels, outs):
        coarse_shape = out.cshape
        for j in range(3):
            Pj = st.materialize_P(out, lvl.shape, j)
            Pj1 = st.materialize_P(out, lvl.shape, j + 1)
            Df = st.global_derivative(lvl, j)
            lvl_c = [l for l in levels if l.shape == coarse_shape][0]
            Dc = st.global_derivative(lvl_c, j)
            lhs = (Df @ Pj).tocsr()
            rhs = (Pj1 @ Dc).tocsr()
            den = max(np.abs(lhs.data).max(), 1e-300)
            D = (lhs - rhs).tocsr()
            err = (np.abs(D.data).max() if D.nnz else 0.0) / den
            assert err < 1e-11, (lvl.shape, j, err)


def test_pi_p_identity(chain884):
    """Pi P = I for the trace-functional forms (L2 cell averages, Hdiv
    facet fluxes: CochainProjector.cpp:318 invariant)."""
    levels, outs = chain884
    for lvl, out in zip(levels, outs):
        ncf = st.grid_counts(lvl.shape)[0]
        nff = sum(st.grid_counts(lvl.shape)[1])
        ncc = st.grid_counts(out.cshape)[0]
        nfc = sum(st.grid_counts(out.cshape)[1])
        # L2
        F3 = sp.coo_matrix(
            (np.asarray(out.f3).ravel(),
             (np.repeat(np.arange(ncc), 8), out.cc.ravel())),
            shape=(ncc, ncf)).tocsr()
        P3 = st.materialize_P(out, lvl.shape, 3)
        I3 = (F3 @ P3).toarray()
        assert _rel(I3, np.eye(ncc)) < 1e-12
        # Hdiv facet traces
        F2 = sp.coo_matrix(
            (np.asarray(out.f2).ravel(),
             (np.repeat(np.arange(nfc), 4), out.cf.ravel())),
            shape=(nfc, nff)).tocsr()
        P2 = st.materialize_P(out, lvl.shape, 2)
        I2 = (F2 @ P2).toarray()
        assert _rel(I2, np.eye(nfc)) < 1e-12


def test_darcy_chain_matches_full_chain():
    """coarsen_darcy (the Hdiv-L2 production path) emits the same
    trace/extension values as the full-chain driver."""
    lvl0 = st.fine_level((4, 4, 4))
    cd, outd = st.coarsen_darcy(lvl0)
    cs, outs = st.coarsen_structured(lvl0, jform_start=2)
    for f in ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c"):
        assert _rel(np.asarray(getattr(outd, f)),
                    np.asarray(getattr(outs, f))) < 1e-14, f
    assert _rel(np.asarray(cd.m02), np.asarray(cs.m02)) < 1e-14


def test_heterogeneous_chain_invariants():
    """Agglomerate-resolved coefficients (constant per coarse cell —
    the supported heterogeneous regime, since finer-scale variation
    puts genuine extra modes into the coarse spaces): Galerkin and
    commutation invariants must hold on the weighted chain too."""
    rng = np.random.default_rng(7)
    shape = (4, 4, 4)
    per_ae = 10.0 ** rng.uniform(-2, 2, size=8)
    cc = st.children_cells((2, 2, 2))          # (8, 8) fine cells per AE
    coeff = np.empty(int(np.prod(shape)))
    coeff[cc] = per_ae[:, None]
    lvl0 = st.fine_level(shape, coeff=coeff)
    levels, outs = st.coarsen_chain(lvl0, 2, jform_start=0)
    lvl, out, coarse = levels[0], outs[0], levels[1]
    for j in range(4):
        P = st.materialize_P(out, lvl.shape, j)
        err = _spdiff((P.T @ st.global_mass(lvl, j) @ P).tocsr(),
                      st.global_mass(coarse, j))
        assert err < 1e-12, (j, err)
    for j in range(3):
        Pj = st.materialize_P(out, lvl.shape, j)
        Pj1 = st.materialize_P(out, lvl.shape, j + 1)
        lhs = (st.global_derivative(lvl, j) @ Pj).tocsr()
        rhs = (Pj1 @ st.global_derivative(coarse, j)).tocsr()
        D = (lhs - rhs).tocsr()
        den = max(np.abs(lhs.data).max(), 1e-300)
        assert (np.abs(D.data).max() if D.nnz else 0.0) / den < 1e-11, j


def test_ns_mode_matches_direct():
    """The device production solve strategy (f32 Newton-Schulz +
    refinement) reproduces the direct-solve chain to the f32 floor."""
    lvl0 = st.fine_level((4, 4, 4))
    cd, outd = st.coarsen_structured(lvl0, jform_start=0)
    with st.solve_mode("ns"):
        cn, outn = st.coarsen_structured(lvl0, jform_start=0)
    for f in ("ptr2", "pint2", "d2c", "pf1", "pc1", "d1c",
              "pe0", "pf0", "pc0", "d0c"):
        a, b = np.asarray(getattr(outd, f)), np.asarray(getattr(outn, f))
        assert _rel(b, a) < 5e-5, (f, _rel(b, a))
    for f in ("m00", "m01", "m02", "m03"):
        a, b = np.asarray(getattr(cd, f)), np.asarray(getattr(cn, f))
        assert _rel(b, a) < 5e-5, (f, _rel(b, a))


def test_chunked_matches_whole_level():
    """The HBM-bounded chunked stage driver (forced via chunk=) emits
    bit-for-bit the same level as the whole-level program: same stage
    kernels, same f32-precision trace, only the batch tiling differs."""
    lvl0 = st.fine_level((8, 8, 8))
    cw, outw = st.coarsen_structured(lvl0, jform_start=0, chunk=0)
    # chunk=7 deliberately misaligns with every entity count to cover
    # the repeated-row padding of the last chunk
    cch, outc = st.coarsen_structured(lvl0, jform_start=0, chunk=7)
    for f in ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c", "ptr1", "f1",
              "pf1", "pc1", "d1c", "pe0", "pf0", "pc0", "d0c"):
        a, b = np.asarray(getattr(outw, f)), np.asarray(getattr(outc, f))
        assert _rel(b, a) < 1e-13, (f, _rel(b, a))
    for f in ("m00", "m01", "m02", "m03", "m10", "m11", "m12", "m20",
              "m21", "d0", "d1", "d2", "t0", "t1", "t2", "t3"):
        a, b = np.asarray(getattr(cw, f)), np.asarray(getattr(cch, f))
        assert _rel(b, a) < 1e-13, (f, _rel(b, a))
    assert outc.bub_sv < 1e-9 and outc.max_rel_sv < 1e-9


def test_chunked_slice_dispatch_two_chunk_sizes():
    """The slice dispatch caches one executable per stage: a second run
    with another chunk size must not reuse the first run's slice length
    (it once raised 'slice_sizes must be less than or equal to operand
    shape' after a larger level had run)."""
    lvl0 = st.fine_level((8, 8, 8))
    cw, outw = st.coarsen_structured(lvl0, jform_start=0, chunk=0)
    for chunk in (50, 7):
        _, outc = st.coarsen_structured(lvl0, jform_start=0, chunk=chunk)
        for f in ("ptr3", "ptr2", "pint2", "d2c", "pf1", "pc1", "d1c",
                  "pe0", "pf0", "pc0", "d0c"):
            a = np.asarray(getattr(outw, f))
            b = np.asarray(getattr(outc, f))
            assert _rel(b, a) < 1e-13, (chunk, f, _rel(b, a))


def test_subagglomerate_heterogeneity_fails_loudly():
    """Fine-scale coefficient variation genuinely enlarges the coarse
    Hcurl/Hdiv spaces (the generic engine keeps bubble modes), so the
    static-structure engine must REFUSE, not silently drop them."""
    rng = np.random.default_rng(9)
    shape = (4, 4, 4)
    coeff = 10.0 ** rng.uniform(-2, 2, size=np.prod(shape))
    lvl0 = st.fine_level(shape, coeff=coeff)
    with pytest.raises(AssertionError, match="bubble SVD kept a mode"):
        st.coarsen_structured(lvl0, jform_start=0)


# ------------------------------------------------------------------ #
# parity vs the generic engine
# ------------------------------------------------------------------ #

def _entity_remap(shape, mesh, seq):
    """Signed/scaled fine-dof remap R_j per form (u_generic = R_j
    u_structured) between the generic engine's entity numbering
    (derive_entities) and the structured lexicographic one.  Vertices
    and cells coincide by construction (hex_grid_mesh numbering);
    edge/face permutations are matched through vertex-id signatures and
    the per-dof scale is read off the interpolated unit-field targets
    (convention-free: any consistent dof scaling passes)."""
    ents = derive_entities(mesh)
    nv = st.grid_counts(shape)[3]
    nc = st.grid_counts(shape)[0]
    R = {0: sp.identity(nv, format="csr"),
         3: sp.identity(nc, format="csr")}

    # edges
    sev = st.edge_verts(shape)
    lookup = {tuple(sorted(p)): i for i, p in enumerate(sev)}
    ge = np.asarray(ents.edges)
    perm = np.array([lookup[tuple(sorted(p))] for p in ge])
    t1g = np.asarray(seq.targets[1])
    t1s = np.asarray(st.fine_level(shape).t1)
    ax = np.abs(t1s[perm]).argmax(axis=1)
    scale = t1g[np.arange(len(ge)), ax] / t1s[perm, ax]
    R[1] = sp.coo_matrix(
        (scale, (np.arange(len(ge)), perm)),
        shape=(len(ge), t1s.shape[0])).tocsr()

    # faces
    sfv = st.face_verts(shape)
    lookup = {tuple(sorted(q)): i for i, q in enumerate(sfv)}
    gf = np.asarray(ents.face_verts)
    perm = np.array([lookup[tuple(sorted(q))] for q in gf])
    t2g = np.asarray(seq.targets[2])
    t2s = np.asarray(st.fine_level(shape).t2)
    ax = np.abs(t2s[perm]).argmax(axis=1)
    scale = t2g[np.arange(len(gf)), ax] / t2s[perm, ax]
    R[2] = sp.coo_matrix(
        (scale, (np.arange(len(gf)), perm)),
        shape=(len(gf), t2s.shape[0])).tocsr()
    return R


def _b_projector(P, B):
    """B-orthogonal projector onto span(P): x -> P (P^T B P)^{-1} P^T B x.
    Basis-independent — the convention-free parity probe."""
    P = sp.csr_matrix(P)
    A = (P.T @ B @ P).toarray()
    return lambda v: P @ np.linalg.solve(A, P.T @ (B @ v))


def _generic_setup(shape, coeff_fn=None):
    mesh = hex_grid_mesh(*shape)
    topo = AgglomeratedTopology.from_mesh(mesh)
    topo.coarsen_local_partitioning(
        cartesian_partition(shape, (2, 2, 2)))
    seq = DeRhamSequenceFE(topo, mesh)
    if coeff_fn is not None:
        for j in range(4):
            seq.replace_mass_integrator(j, coeff_fn)
    seq.set_upscaling_targets(0)
    seq.coarsen(svd_tol=1e-9)
    return mesh, seq


@pytest.mark.parametrize("hetero", [False, True])
def test_parity_vs_generic_engine(hetero):
    """The structured engine builds THE SAME coarse spaces as the
    generic host engine (the digit-parity oracle): fine operators match
    entrywise after the entity remap, coarse dof counts match, and the
    B-orthogonal projectors onto the coarse spaces agree to 1e-9 for
    all four forms."""
    shape = (4, 4, 4)
    nc = int(np.prod(shape))
    if hetero:
        rng = np.random.default_rng(3)
        per_ae = 10.0 ** rng.uniform(-1.5, 1.5, size=8)
        cc = st.children_cells((2, 2, 2))
        coeff = np.empty(nc)
        coeff[cc] = per_ae[:, None]

        def coeff_fn(pts):
            pts = np.asarray(pts)
            ijk = np.clip((pts * np.asarray(shape)).astype(int), 0,
                          np.asarray(shape) - 1)
            return coeff[ijk[..., 0] + shape[0] * ijk[..., 1]
                         + shape[0] * shape[1] * ijk[..., 2]]
    else:
        coeff, coeff_fn = None, None

    mesh, seq = _generic_setup(shape, coeff_fn)
    lvl0 = st.fine_level(shape, coeff=coeff)
    coarse, out = st.coarsen_structured(lvl0, jform_start=0)
    R = _entity_remap(shape, mesh, seq)

    # fine-operator parity: M_j(structured) == R^T M_j(generic) R
    for j in range(4):
        Mg = seq.compute_mass_operator(j)
        Ms = st.global_mass(lvl0, j)
        err = _spdiff((R[j].T @ Mg @ R[j]).tocsr(), Ms)
        assert err < 1e-12, (j, err)
    for j in range(3):
        Dg = sp.csr_matrix(seq.D[j])
        Ds = st.global_derivative(lvl0, j)
        err = _spdiff((Dg @ R[j]).tocsr(), (R[j + 1] @ Ds).tocsr())
        assert err < 1e-12, (j, err)

    # coarse-space parity through B-orthogonal projectors
    rng = np.random.default_rng(11)
    counts = st.grid_counts(out.cshape)
    want = {0: counts[3], 1: sum(counts[2]), 2: sum(counts[1]),
            3: counts[0]}
    for j in range(4):
        Pg = sp.csr_matrix(seq.P[j])
        Ps = R[j] @ st.materialize_P(out, shape, j)
        assert Pg.shape[1] == want[j], (j, Pg.shape, want[j])
        assert Ps.shape[1] == want[j]
        Mj = seq.compute_mass_operator(j)
        if j < 3:
            Dj = sp.csr_matrix(seq.D[j])
            B = (Dj.T @ seq.compute_mass_operator(j + 1) @ Dj
                 + Mj).tocsr()
        else:
            B = Mj
        pig = _b_projector(Pg, B)
        pis = _b_projector(Ps, B)
        for _ in range(3):
            v = rng.standard_normal(B.shape[0])
            a, b = pig(v), pis(v)
            den = max(np.abs(a).max(), 1e-300)
            assert np.abs(a - b).max() / den < 1e-9, j


def test_parity_two_level_composite():
    """Multilevel: the composite structured P over two coarsenings spans
    the same space as the generic engine's two-level chain (H1)."""
    shape = (8, 8, 8)
    mesh = hex_grid_mesh(*shape)
    topo = AgglomeratedTopology.from_mesh(mesh)
    t1 = topo.coarsen_local_partitioning(
        cartesian_partition(shape, (2, 2, 2)))
    t1.coarsen_local_partitioning(
        cartesian_partition((4, 4, 4), (2, 2, 2)))
    seq = DeRhamSequenceFE(topo, mesh)
    seq.set_upscaling_targets(0)
    s1 = seq.coarsen(svd_tol=1e-9)
    s1.coarsen(svd_tol=1e-9)
    Pg = (sp.csr_matrix(seq.P[0]) @ sp.csr_matrix(s1.P[0])).tocsr()

    lvl0 = st.fine_level(shape)
    levels, outs = st.coarsen_chain(lvl0, 3, jform_start=0)
    Ps = (st.materialize_P(outs[0], shape, 0)
          @ st.materialize_P(outs[1], (4, 4, 4), 0)).tocsr()

    assert Pg.shape == Ps.shape
    M0 = seq.compute_mass_operator(0)
    D0 = sp.csr_matrix(seq.D[0])
    B = (D0.T @ seq.compute_mass_operator(1) @ D0 + M0).tocsr()
    pig = _b_projector(Pg, B)
    pis = _b_projector(Ps, B)
    rng = np.random.default_rng(5)
    for _ in range(3):
        v = rng.standard_normal(B.shape[0])
        a, b = pig(v), pis(v)
        assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-300) < 1e-9


def test_h1_stiffness_blocks_match_global():
    """A = M0 + D0^T M1 D0 from per-cell blocks equals the spgemm
    assembly, fine and coarse."""
    lvl0 = st.fine_level((4, 4, 4))
    levels, _ = st.coarsen_chain(lvl0, 2, jform_start=0)
    for lvl in levels:
        D0 = st.global_derivative(lvl, 0)
        ref = (st.global_mass(lvl, 0)
               + D0.T @ st.global_mass(lvl, 1) @ D0).tocsr()
        got = st.h1_stiffness(lvl)
        assert _spdiff(got, ref) < 1e-13
