"""Local spectral target generation (spectral AMGe).

Rebuild of reference src/amge/LocalSpectralTargets.{hpp,cpp}: per-agglomerate
generalized eigenproblems produce problem-adapted coarse-space targets.

* compute_local_spectral_targets: A_loc x = lambda diag(d) x per AE with the
  weighted-l1 diagonal d_i = sum_j |a_ij| sqrt(a_ii/a_jj)
  (Weightedl1Smoother, ParELAG_MatrixUtils.cpp:967-995); keep the smallest
  eigenvectors with |lambda| <= rel_tol (and at least one, at most
  max_evects) — SymEigensolver::ComputeDiagonalSmallerMagnitude semantics
  (ParELAG_Eigensolver.cpp:440-516).

* compute_local_hdiv_l2_spectral_targets: per-AE mixed eigenproblem on the
  boundary-flux + pressure Schur complement
      S = [B; C] M^{-1} [B^T C^T],  S x = lambda blockdiag(W, Q) x
  giving L2 targets (pressure part) and Hdiv coarse-facet trace targets
  (restrictions of the boundary-flux parts of adjacent agglomerates)
  (LocalSpectralTargets.cpp:93-297).

These loops are embarrassingly parallel small dense eigensolves — the
archetypal vmapped batched device kernel (ops.batched handles bucketing).
"""

import numpy as np
import scipy.linalg


def weighted_l1_diagonal(A) -> np.ndarray:
    """d_i = sum_j |a_ij| sqrt(a_ii / a_jj)."""
    A = np.asarray(A)
    dg = np.diag(A)
    return (np.abs(A) * np.sqrt(np.outer(dg, 1.0 / dg))).sum(axis=1)


def smallest_generalized(A, D, rel_tol, max_evects, max_eval=1.0):
    """Eigenpairs of A x = lambda D x (D diagonal or dense SPD), keeping
    min(#{|lambda| <= rel_tol*max_eval}, max_evects) >= 1 smallest."""
    A = np.asarray(A)
    B = np.diag(D) if np.ndim(D) == 1 else np.asarray(D)
    w, V = scipy.linalg.eigh(A, B)
    count = int(np.sum(np.abs(w) <= rel_tol * max_eval))
    m = max(min(count, max_evects) if max_evects >= 1 else count, 1)
    return w[:m], V[:, :m]


_EIGH_JIT = None


def _device_eigh_batch(At):
    """Module-cached jitted batched symmetric eigh (one compile per
    padded shape bucket for the process)."""
    global _EIGH_JIT
    import jax
    import jax.numpy as jnp
    if _EIGH_JIT is None:
        _EIGH_JIT = jax.jit(lambda A: jnp.linalg.eigh(A))
    return _EIGH_JIT(At)


def compute_local_spectral_targets(agg_blocks, rel_tol, max_evects,
                                   backend="auto"):
    """agg_blocks: per-AE dense local operators (e.g. M + D^T W D on the
    agglomerate); returns per-AE (n_ae_dofs, m) target arrays. Batched by
    shape group: the diagonal weight makes the generalized problem a
    symmetric similarity transform, one stacked eigh per group.

    backend 'device' runs the stacked eigh on the jax default backend in
    f32 (bucketed/padded — reference hot loop
    LocalSpectralTargets.cpp:46-90 as a batched device eigensolve). The
    mode-count threshold stays f64-safe: rel_tol below the f32 eigenvalue
    floor (~1e-6 of the unit-bounded weighted spectrum) falls back to the
    host f64 path so no mode is kept/dropped on f32 noise."""
    from parelag_tpu.ops import ragged as Rg
    from parelag_tpu.ops.batched import _round_bucket
    n = len(agg_blocks)
    out = [None] * n
    if backend == "auto":
        backend = "host"     # device is opt-in (placement not measured
        #                      on the H100)
    if backend == "device" and rel_tol < 1e-5:
        backend = "host"          # f32-unsafe threshold
    groups = {}
    for i, A in enumerate(agg_blocks):
        groups.setdefault(np.asarray(A).shape, []).append(i)
    for shape, idxs in groups.items():
        Ast = Rg.take(agg_blocks, idxs, shape)
        dg = np.einsum("bii->bi", Ast)
        D = (np.abs(Ast)
             * np.sqrt(dg[:, :, None] / dg[:, None, :])).sum(axis=2)
        isq = 1.0 / np.sqrt(D)
        At = Ast * isq[:, :, None] * isq[:, None, :]
        At = 0.5 * (At + At.transpose(0, 2, 1))
        if backend == "device":
            m_g, nn = At.shape[0], At.shape[1]
            nb = _round_bucket(nn)
            Ap = np.zeros((m_g, nb, nb), dtype=np.float32)
            Ap[:, :nn, :nn] = At
            # pad with an identity block scaled to sit ABOVE the kept
            # band so padding modes are never selected
            Ap[:, range(nn, nb), range(nn, nb)] = 2.0
            import jax.numpy as jnp
            wd, Vd = _device_eigh_batch(jnp.asarray(Ap))
            w = np.asarray(wd, dtype=np.float64)[:, :nn]
            V = np.asarray(Vd, dtype=np.float64)[:, :nn, :nn]
        else:
            w, V = np.linalg.eigh(At)
        # smallest_generalized's criterion: |lambda| <= rel_tol * max_eval
        # with max_eval = 1 (the weighted-l1 diagonal bounds |lambda| by 1)
        counts = np.sum(np.abs(w) <= rel_tol, axis=1)
        for j, i in enumerate(idxs):
            m = int(counts[j])
            m = max(min(m, max_evects) if max_evects >= 1 else m, 1)
            out[i] = isq[j][:, None] * V[j, :, :m]
    return out


def compute_local_hdiv_l2_spectral_targets(
        seq, rel_tol, max_evects, kinv_scaling=None):
    """Per-AE mixed spectral targets for the Hdiv-L2 pair
    (ComputeLocalHdivL2SpectralTargetsFromAEntity).

    Returns (hdiv_trace_targets per coarse facet, l2_targets per coarse
    element), each a list of (n_ae_dofs, m) arrays in the DofAgglomeration
    closure-dof order.
    """
    from parelag_tpu.amge.localmass import assemble_agglomerate_blocks
    from parelag_tpu.ops import csr as C

    dim = seq.dim
    uform, pform = dim - 1, dim
    uagg = seq.dofagg[uform]
    pagg = seq.dofagg[pform]
    topo = seq.topo
    AE_e = topo.AEntity_entity[0]
    Md = assemble_agglomerate_blocks(seq.M[(0, uform)], AE_e, uagg, 0)
    Wd = assemble_agglomerate_blocks(seq.M[(0, pform)], AE_e, pagg, 0)
    # Q: facet trace mass of Hdiv, gathered per AE over its boundary dofs
    Qlocal = seq.M[(1, uform)]
    D = seq.D[uform].tocsr()

    n_ae = len(Md)
    AE_AF = C.pattern(topo.coarser.B[0]).tocsr()
    AF_AE = AE_AF.T.tocsr()
    n_af = AF_AE.shape[0]

    # fine facets on each AE's boundary (orientation product cancels the
    # interior ones, reference AE_fc pattern)
    AE_bfc = C.drop_zeros((AE_e @ topo.B[0]).tocsr(), 1e-10)

    # ---- batched per-AE eigenproblems, grouped by shape signature ----- #
    # (the per-AE dict/np.ix_ loop cost minutes at SPE10 scale; on
    # quasi-uniform agglomerations a handful of groups cover everything
    # and every dense step below is one stacked LAPACK call per group)
    from parelag_tpu.ops import ragged as Rg
    nu_ints = uagg.n_interior(0)
    u_cat, u_off = uagg.ae_dofs_cat(0)
    p_cat, p_off = pagg.ae_dofs_cat(0)
    u_sizes = np.diff(u_off)
    p_sizes = np.diff(p_off)
    Dlocs = C.extract_blocks_cat(D, p_cat, p_off, u_cat, u_off)

    # per-AE assembled boundary trace mass Q via a scratch position array
    ndofs_u = uagg.dof.ndofs
    posarr = np.full(ndofs_u, -1, dtype=np.int64)
    Q_list = [None] * n_ae
    qd_cat, qd_off, qb_cat, qb_off = Qlocal.concatenated()
    for iae in range(n_ae):
        u_all = u_cat[u_off[iae]:u_off[iae + 1]]
        nu_int = int(nu_ints[iae])
        u_bdr = u_all[nu_int:]
        nb = u_bdr.size
        posarr[u_bdr] = np.arange(nb)
        Qloc = np.zeros((nb, nb))
        bfacets = AE_bfc.indices[
            AE_bfc.indptr[iae]:AE_bfc.indptr[iae + 1]]
        for f in bfacets:
            dofs = qd_cat[qd_off[f]:qd_off[f + 1]]
            idx = posarr[dofs]
            assert (idx >= 0).all(), \
                "boundary facet dof outside the AE's boundary-dof set"
            k = dofs.size
            Qloc[idx[:, None], idx[None, :]] += \
                qb_cat[qb_off[f]:qb_off[f + 1]].reshape(k, k)
        posarr[u_bdr] = -1
        Q_list[iae] = Qloc

    sigs = list(zip(u_sizes, nu_ints, p_sizes))
    l2_targets = [None] * n_ae
    AE_mu = [None] * n_ae
    for sig, idxs in Rg.group_by(sigs).items():
        nu_all, nu_int, npl = (int(v) for v in sig)
        nb = nu_all - nu_int
        m_g = len(idxs)
        Mst = Rg.take(Md, idxs, (nu_all, nu_all))
        if kinv_scaling is not None:
            Mst = Mst * np.asarray(
                [kinv_scaling[i] for i in idxs])[:, None, None]
        Wst = Rg.take(Wd, idxs, (npl, npl))
        Dst = Rg.take(Dlocs, idxs, (npl, nu_all))
        Bst = Wst @ Dst
        Qst = np.stack([Q_list[i] for i in idxs])
        Cst = np.concatenate(
            [np.zeros((m_g, nb, nu_int)), Qst], axis=2)
        BC = np.concatenate([Bst, Cst], axis=1)
        Minv_BC = np.linalg.solve(Mst, BC.transpose(0, 2, 1))
        S = BC @ Minv_BC
        S = 0.5 * (S + S.transpose(0, 2, 1))
        RHS = np.zeros((m_g, npl + nb, npl + nb))
        RHS[:, :npl, :npl] = Wst
        RHS[:, npl:, npl:] = Qst
        # Cholesky-reduced generalized eigh, one batched LAPACK call
        # (what ?sygvd does internally, stacked)
        L = np.linalg.cholesky(RHS)
        Sst = np.linalg.solve(L, S.transpose(0, 2, 1))
        Sst = np.linalg.solve(L, Sst.transpose(0, 2, 1))
        w, Vt = np.linalg.eigh(Sst)
        # V = L^{-T} Vt: solve L^T V = Vt
        V = np.linalg.solve(L.transpose(0, 2, 1), Vt)
        counts = np.sum(
            np.abs(w) <= rel_tol
            * np.maximum(np.abs(w[:, -1:]), 1.0), axis=1)
        for j, iae in enumerate(idxs):
            m = int(counts[j])
            m = max(min(m, max_evects) if max_evects >= 1 else m, 1)
            Vj = V[j, :, :m].copy()
            if Vj[0, 0] < 0:
                Vj[:, 0] *= -1
            l2_targets[iae] = Vj[:npl, :]
            u_all = u_cat[u_off[iae]:u_off[iae + 1]]
            AE_mu[iae] = (u_all[nu_int:], Vj[npl:, :])

    # coarse-facet Hdiv trace targets: restrict adjacent AEs' mu parts
    hdiv_trace_targets = []
    af_dofs_list = uagg.ae_dofs(1)
    for iaf in range(n_af):
        af_dofs = af_dofs_list[iaf]
        aes = AF_AE.indices[AF_AE.indptr[iaf]:AF_AE.indptr[iaf + 1]]
        cols = []
        for ae in aes:
            u_bdr, mu = AE_mu[ae]
            posarr[u_bdr] = np.arange(u_bdr.size)
            idx = posarr[af_dofs]
            assert (idx >= 0).all(), \
                "coarse-facet dof outside an adjacent AE's boundary set"
            cols.append(mu[idx, :])
            posarr[u_bdr] = -1
        if cols:
            hdiv_trace_targets.append(np.concatenate(cols, axis=1))
        else:
            hdiv_trace_targets.append(np.ones((af_dofs.size, 1)))
    return hdiv_trace_targets, l2_targets
