"""Device-resident spectral Hdiv-L2 coarsening on cartesian grids.

The SPE10 north star (examples/MultigridTestSPE10.cpp:169-187) needs
what the homogeneous structured engine (amge/structured.py) refuses:
sub-agglomerate coefficient variation genuinely enlarges the coarse
spaces, so the kept-mode count per entity is data-dependent.  This
module is the heterogeneous extension for the Darcy pair (jform_start=2
in the generic engine's terms): ONE cartesian coarsening step with

  * per-AE spectral Hdiv-L2 eigenproblems
    (ComputeLocalHdivL2SpectralTargetsFromAEntity,
    LocalSpectralTargets.cpp:46-90; host oracle
    amge/spectral.py::compute_local_hdiv_l2_spectral_targets),
  * coarse facet traces with targets (ComputeCoarseTracesWithTargets,
    DeRhamSequence.cpp:1723-2086; oracle
    amge/sequence.py::_compute_coarse_traces),
  * Hdiv interior Lagrange extensions with RangeT bubbles and null
    target extensions (hFacetExtension, DeRhamSequence.cpp:2169-2628;
    oracle amge/sequence.py::_extension),

each stage one batched dense device program over all entities of a
family (uniform shapes: every AE is the same fx*fy*fz cell block).
Variable kept-mode counts ride FIXED slot capacities plus masks: a
masked slot is a zero target column (zero singular value, never kept)
and a zero P column (dropped at host materialization).  Only the P
values and per-entity kept counts leave the device.

General per-axis coarsening factors (fx, fy, fz) — the SPE10 grid
(60, 220, 85) has an odd z extent, so the z factor is 5.
"""

import os
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from parelag_tpu.amge import structured as _st


# --------------------------------------------------------------------- #
# index plane: general-factor AE closure numbering (host, int arithmetic)
# --------------------------------------------------------------------- #

def _grid3(*ranges):
    return _st._grid3(*ranges)


def ae_cells(cshape, f):
    """(n_ae, fx*fy*fz) fine cell ids per AE, lex within the AE
    (x fastest) — the p-dof (L2) order of every stage."""
    fx, fy, fz = f
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    cols = []
    for dz in range(fz):
        for dy in range(fy):
            for dx in range(fx):
                cols.append(_st.cell_id(
                    fshape, f[0] * ijk[:, 0] + dx,
                    f[1] * ijk[:, 1] + dy, f[2] * ijk[:, 2] + dz))
    return np.stack(cols, axis=1)


def _ae_face_offsets(f):
    """Static (axis, ox, oy, oz) lattice offsets of one AE's closure
    faces in the canonical interior-first order:
      [interior: family a, a-coord 1..fa-1, (b,c)-lex]  then
      [boundary: facet-by-facet in [x0,x1,y0,y1,z0,z1] order, each
       facet's fb*fc children (b,c)-lex (b fastest)].
    Returns (offsets list, nu_int)."""
    fx, fy, fz = f
    offs = []
    for a, (na, nb_, nc_) in enumerate(((fx, fy, fz), (fy, fx, fz),
                                        (fz, fx, fy))):
        b, c = [ax for ax in range(3) if ax != a]
        for da in range(1, na):
            for dc in range(f[c]):
                for db in range(f[b]):
                    o = [0, 0, 0]
                    o[a], o[b], o[c] = da, db, dc
                    offs.append((a, o[0], o[1], o[2]))
    nu_int = len(offs)
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        for side in (0, 1):
            for dc in range(f[c]):
                for db in range(f[b]):
                    o = [0, 0, 0]
                    o[a], o[b], o[c] = side * f[a], db, dc
                    offs.append((a, o[0], o[1], o[2]))
    return offs, nu_int


def ae_faces(cshape, f):
    """(n_ae, nu) fine face ids of every AE's closure, interior-first
    (see _ae_face_offsets).  Returns (ids, nu_int)."""
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    offs, nu_int = _ae_face_offsets(f)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    base = ijk * np.asarray(f)[None, :]
    out = np.empty((len(ijk), len(offs)), dtype=np.int64)
    for s, (a, ox, oy, oz) in enumerate(offs):
        out[:, s] = _st.face_id(fshape, a, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
    return out, nu_int


def cell_face_slots(f):
    """(fx*fy*fz, 6) position of each child cell's local faces (M02
    order [x0,x1,y0,y1,z0,z1]) within the AE face-slot order."""
    offs, _ = _ae_face_offsets(f)
    pos = {off: s for s, off in enumerate(offs)}
    fx, fy, fz = f
    out = np.empty((fx * fy * fz, 6), dtype=np.int64)
    i = 0
    for dz in range(fz):
        for dy in range(fy):
            for dx in range(fx):
                out[i] = [pos[(0, dx, dy, dz)], pos[(0, dx + 1, dy, dz)],
                          pos[(1, dx, dy, dz)], pos[(1, dx, dy + 1, dz)],
                          pos[(2, dx, dy, dz)], pos[(2, dx, dy, dz + 1)]]
                i += 1
    return out


def facet_children(cshape, f):
    """Per family a: (n_facets_a, fb*fc) fine face ids of each coarse
    facet's children, (b,c)-lex — the same in-facet order as the AE
    boundary slots, so restricting an AE's boundary block to one of its
    facets is a contiguous slice.  Returns [ids_x, ids_y, ids_z]."""
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    nx, ny, nz = cshape
    fams = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = ijk * np.asarray(f)[None, :]
        base[:, a] = ijk[:, a] * f[a]
        out = np.empty((len(ijk), f[b] * f[c]), dtype=np.int64)
        s = 0
        for dc in range(f[c]):
            for db in range(f[b]):
                o = np.zeros((len(ijk), 3), dtype=np.int64)
                o[:, b], o[:, c] = db, dc
                out[:, s] = _st.face_id(
                    fshape, a, base[:, 0] + o[:, 0],
                    base[:, 1] + o[:, 1], base[:, 2] + o[:, 2])
                s += 1
        fams.append(out)
    return fams


def facet_neighbors(cshape):
    """Per family a: (n_facets_a, 2) [left AE, right AE] ids with -1
    for missing (domain boundary).  Left = AE on the -a side (sees the
    facet as its a1 boundary block), right = +a side (sees it as a0)."""
    nx, ny, nz = cshape
    fams = []
    for a in range(3):
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        left = ijk.copy()
        left[:, a] -= 1
        lvalid = left[:, a] >= 0
        rvalid = ijk[:, a] < (nx, ny, nz)[a]
        lid = np.where(lvalid, _st.cell_id(
            cshape, np.clip(left[:, 0], 0, None),
            np.clip(left[:, 1], 0, None),
            np.clip(left[:, 2], 0, None)), -1)
        rid = np.where(rvalid, _st.cell_id(
            cshape, np.minimum(ijk[:, 0], nx - 1),
            np.minimum(ijk[:, 1], ny - 1),
            np.minimum(ijk[:, 2], nz - 1)), -1)
        fams.append(np.stack([lid, rid], axis=1))
    return fams


def facet_bdr_slices(f):
    """Per family a: (slot0_left, slot0_right, nch) — where a facet's
    children sit inside the left/right neighbor AE's boundary block
    (offsets RELATIVE to the boundary start).  Left neighbor sees the
    facet as its (a, side=1) block, right neighbor as (a, side=0)."""
    out = []
    start = 0
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        nch = f[b] * f[c]
        s0, s1 = start, start + nch
        out.append((s1, s0, nch))        # (left sees a1, right sees a0)
        start += 2 * nch
    return out


def ae_facet_ids(cshape):
    """(n_ae, 6) coarse facet ids per AE in [x0,x1,y0,y1,z0,z1] order
    (the coarse d2 column pattern)."""
    return _st.d2_cols(cshape)


# --------------------------------------------------------------------- #
# stage kernels (jittable; solve strategy via structured.solve_mode)
# --------------------------------------------------------------------- #

def _spectral_stage(m02_ch, m03_ch, m12_bdr, d2_ch, fslot, nu_int,
                    spect_tol, max_evects):
    """Per-AE mixed Hdiv-L2 eigenproblem (mirrors
    compute_local_hdiv_l2_spectral_targets, one uniform batch):
      m02_ch (n, ncell, 6, 6) kinv-weighted cell Hdiv blocks,
      m03_ch (n, ncell) L2 masses (vols), m12_bdr (n, nbd) boundary
      facet trace masses, d2_ch (n, ncell, 6) fine div values,
      fslot (ncell, 6) static, nu_int static.
    Returns (w (n, npl+nbd) eigenvalues ascending, V (n, npl+nbd, K)
    lowest-K eigenvectors, nkeep (n,) counts by the reference
    criterion |w| <= tol * max(|w_max|, 1))."""
    n, ncell = m03_ch.shape
    nu = nu_int + m12_bdr.shape[1]
    nbd = m12_bdr.shape[1]
    dt = m02_ch.dtype
    idx = (fslot[:, :, None] * nu + fslot[:, None, :]).reshape(-1)
    M = jnp.zeros((n, nu * nu), dtype=dt).at[:, idx].add(
        m02_ch.reshape(n, -1)).reshape(n, nu, nu)
    Dloc = jnp.zeros((n, ncell, nu), dtype=dt).at[
        :, np.arange(ncell)[:, None], fslot].set(d2_ch)
    B = m03_ch[:, :, None] * Dloc                    # (n, ncell, nu)
    # C = [0 | diag(Q)] rows for the boundary trace block
    C = jnp.zeros((n, nbd, nu), dtype=dt).at[
        :, np.arange(nbd), nu_int + np.arange(nbd)].set(m12_bdr)
    BC = jnp.concatenate([B, C], axis=1)             # (n, npl+nbd, nu)
    X = _st._solve_batch(M, BC.transpose(0, 2, 1))   # M^{-1} BC^T
    S = BC @ X
    S = 0.5 * (S + S.transpose(0, 2, 1))
    # RHS = blkdiag(W, Q); Cholesky-reduced generalized eigh on the
    # diagonal RHS is a symmetric similarity scale
    rd = jnp.concatenate([m03_ch, m12_bdr], axis=1)  # (n, npl+nbd)
    isq = 1.0 / jnp.sqrt(rd)
    St = S * isq[:, :, None] * isq[:, None, :]
    St = 0.5 * (St + St.transpose(0, 2, 1))
    w, Vt = jnp.linalg.eigh(St)                      # ascending
    V = isq[:, :, None] * Vt                         # L^{-T} Vt
    nkeep = jnp.sum(
        jnp.abs(w) <= spect_tol
        * jnp.maximum(jnp.abs(w[:, -1:]), 1.0), axis=1)
    nkeep = jnp.clip(nkeep, 1, max_evects)
    K = int(max_evects)
    Vk = V[:, :, :K]
    # reference sign convention: first component of the first kept
    # vector non-negative
    sgn = jnp.where(Vk[:, 0, 0] < 0, -1.0, 1.0).astype(dt)
    Vk = Vk.at[:, :, 0].multiply(sgn[:, None])
    # mask: slots >= nkeep are zeroed (never kept downstream)
    mask = (jnp.arange(K)[None, :] < nkeep[:, None]).astype(dt)
    return Vk * mask[:, None, :], nkeep


def _trace_stage_targets(m_ch, pv_ch, T, svd_tol, kcap):
    """Facet/cell trace stage with targets and 1x1 child blocks
    (mirrors _compute_coarse_traces): m_ch (n, nd) diag mass, pv_ch
    (n, nd), T (n, nd, kt) targets (masked columns are zero).
    Returns (ptr (n, nd) PV column values, F (n, nd) cochain
    functionals, U (n, nd, kcap) kept columns scaled sqrt(dots) and
    masked, nkeep (n,), dots (n,))."""
    n, nd = m_ch.shape
    dt = m_ch.dtype
    mpv = m_ch * pv_ch
    dots = jnp.sum(pv_ch * mpv, axis=1)
    F = mpv / dots[:, None]
    coef = jnp.einsum("bi,bik->bk", mpv, T) / dots[:, None]
    Td = T - pv_ch[:, :, None] * coef[:, None, :]
    # M-weighted SVD (true SVD, not the Gram: squaring the Gram also
    # squares the rounding floor to sqrt(eps)*sigma_max, which leaks
    # junk modes past the dots*svd_tol threshold the generic engine's
    # LAPACK SVD rejects)
    sc = jnp.sqrt(m_ch)
    U0, s, _ = jnp.linalg.svd(Td * sc[:, :, None], full_matrices=False)
    U = U0 / sc[:, :, None]
    keep = s > dots[:, None] * svd_tol
    # junk floor: true-SVD rounding noise scales with sigma_max at the
    # WORKING precision (eps_f32 ~ 1.2e-7), not with the dots-relative
    # reference threshold; modes below ~200*eps*sigma_max are
    # indistinguishable from noise in this dtype and must not be kept
    keep = keep & (s > 200.0 * float(jnp.finfo(dt).eps)
                   * jnp.maximum(s[:, :1], 1e-30))
    nmax = s.shape[1]
    nkeep = jnp.minimum(jnp.sum(keep, axis=1), kcap)
    mask = (jnp.arange(nmax)[None, :] < nkeep[:, None]).astype(dt)
    U = U * mask[:, None, :]
    kcap = int(kcap)
    U = (U[:, :, :kcap] if nmax >= kcap else jnp.pad(
        U, ((0, 0), (0, 0), (0, kcap - nmax))))
    scale = jnp.sqrt(dots).astype(dt)
    return pv_ch, F, U * scale[:, None, None], nkeep, dots


def _ns_spd_inverse(M, iters=40):
    """Newton-Schulz inverse of a batched SPD matrix, Jacobi-equilibrated
    (pure matmuls).  Returns X ~= M^{-1}."""
    dt = M.dtype
    dg = jnp.einsum("bii->bi", M)
    d = 1.0 / jnp.sqrt(jnp.maximum(dg, 1e-30))
    Meq = (M * d[:, :, None] * d[:, None, :]).astype(jnp.float32)
    n = Meq.shape[1]
    a1 = jnp.abs(Meq).sum(axis=1).max(axis=1)
    ainf = jnp.abs(Meq).sum(axis=2).max(axis=1)
    c = jnp.maximum(a1 * ainf, 1e-30)
    X = Meq.transpose(0, 2, 1) / c[:, None, None]
    I2 = 2.0 * jnp.eye(n, dtype=jnp.float32)[None]
    X = jax.lax.fori_loop(0, iters, lambda _, X: X @ (I2 - Meq @ X), X)
    return (X * d[:, None, :] * d[:, :, None]).astype(dt)


# Convergence guard for the Schur-eliminated extension solve: its
# backward-normalized residual floors at 1.11e-4 on the full SPE10 grid
# (measured refine-count-INDEPENDENT: identical at refine=3 and 6 — an
# f32 representation floor of the metric, not a stalled iteration; the
# genuinely broken plain-NS solve measured 0.067).
_EXT_GUARD_TOL = 5e-4


def _ext_saddle_solve_ns(M_ii, B_ii, T, rhs, nu_int, ncell,
                         refine=4):
    """Device solve of the Lagrange saddle [[M, B^T, 0], [B, 0, T],
    [0, T^T, 0]] by block elimination: NS inverse of the SPD M block +
    a SMALL bordered LU on the (ncell+1) Schur system + full-system
    iterative refinement: every op here is a GEMM or an LU at
    (ncell+1)^2, avoiding a monolithic batched LU at the full nsys
    (the direct mode's choice).  The backward
    residual ||R|| / (||A||_max ||Y|| + ||B||) is registered in
    _NS_DIAG for the driver's convergence guard."""
    n = M_ii.shape[0]
    dt = M_ii.dtype
    Xm = _ns_spd_inverse(M_ii)
    BX = B_ii @ Xm                                  # (n, ncell, nu_int)
    S = BX @ B_ii.transpose(0, 2, 1)                # (n, ncell, ncell)
    nb = ncell + 1
    Ab = jnp.zeros((n, nb, nb), dtype=dt)
    Ab = Ab.at[:, :ncell, :ncell].set(-S)
    Ab = Ab.at[:, :ncell, -1].set(T)
    Ab = Ab.at[:, -1, :ncell].set(T)

    def _lu(ab_rb):
        a, r = ab_rb
        return jnp.linalg.solve(a, r)

    def solve_once(R):
        ru = R[:, :nu_int]
        rp = R[:, nu_int:nu_int + ncell]
        rl = R[:, -1:]
        rb = jnp.concatenate([rp - BX @ ru, rl], axis=1)
        # sub-batched LU: lax.map bounds the batch each triangular
        # solve sees (inherited bound; not measured on the H100)
        Yb = jax.lax.map(_lu, (Ab, rb), batch_size=64)
        p = Yb[:, :ncell]
        lam = Yb[:, -1:]
        u = Xm @ (ru - B_ii.transpose(0, 2, 1) @ p)
        return jnp.concatenate([u, p, lam], axis=1)

    def apply_A(Y):
        u = Y[:, :nu_int]
        p = Y[:, nu_int:nu_int + ncell]
        lam = Y[:, -1:]
        top = M_ii @ u + B_ii.transpose(0, 2, 1) @ p
        mid = B_ii @ u + T[:, :, None] * lam
        bot = jnp.einsum("bi,bik->bk", T, p)[:, None, :]
        return jnp.concatenate([top, mid, bot], axis=1)

    Y = solve_once(rhs)
    for _ in range(refine):
        Y = Y + solve_once(rhs - apply_A(Y))
    R = rhs - apply_A(Y)
    anrm = jnp.abs(M_ii).max(axis=(1, 2))
    ynrm = jnp.sqrt(jnp.sum(Y * Y, axis=(1, 2)))
    bnrm = jnp.sqrt(jnp.sum(rhs * rhs, axis=(1, 2)))
    res = jnp.max(jnp.sqrt(jnp.sum(R * R, axis=(1, 2)))
                  / jnp.maximum(anrm * ynrm + bnrm, 1e-30))
    _st._NS_DIAG.append(res.astype(jnp.float32))
    return Y


def _ext_spot_check(shape, h, coeff, l2_weight, cells, fslot,
                    slot_facet, nu_int, ptr_bdr, pb_slot, U3np,
                    Pintnp, K2, n_spot):
    """f64 host oracle for the extension stage on `n_spot` AEs (spread
    deterministically over the grid): rebuild each AE's Lagrange saddle
    from analytic f64 inputs plus the SAME upstream trace data the
    device stage consumed (ptr_bdr/pb_slot/U3), solve it directly, and
    return the worst relative M_ii-energy error of any kept Pint
    column.  Cost: n_spot dense (nu_int+ncell+1)^2 f64 solves — O(ms)
    against a minutes-scale setup."""
    n_ae, ncell = cells.shape
    nbd = ptr_bdr.shape[1]
    nu = nu_int + nbd
    K3 = U3np.shape[2]
    k_ext = 6 * (1 + K2)
    ref64 = _st.fine_local_masses(h, np.float64)
    m02_ref = np.asarray(ref64[(0, 2)], dtype=np.float64)
    m03_ref = float(np.asarray(ref64[(0, 3)])[0, 0])
    _, _, d2np = _st.fine_derivative_values(shape, h, np.float64)
    coeff64 = np.asarray(coeff, dtype=np.float64)
    w64 = (np.asarray(l2_weight, dtype=np.float64)
           if l2_weight is not None else None)
    rows = np.arange(nbd)
    cols_extra = (6 + np.asarray(slot_facet)[:, None] * K2
                  + np.arange(K2)[None, :])
    spots = np.unique(np.linspace(0, n_ae - 1, n_spot).astype(np.int64))
    worst = 0.0
    for e in spots:
        ce = cells[e]
        m02_e = coeff64[ce][:, None, None] * m02_ref[None]
        m03_e = (w64[ce] if w64 is not None
                 else np.ones(ncell)) * m03_ref
        d2_e = d2np[ce]
        M = np.zeros((nu, nu))
        Dloc = np.zeros((ncell, nu))
        for i in range(ncell):
            sl = fslot[i]
            M[np.ix_(sl, sl)] += m02_e[i]
            Dloc[i, sl] = d2_e[i]
        B = m03_e[:, None] * Dloc
        Pb = np.zeros((nbd, k_ext))
        Pb[rows, slot_facet] = np.asarray(ptr_bdr[e], dtype=np.float64)
        Pb[rows[:, None], cols_extra] = np.asarray(
            pb_slot[e], dtype=np.float64)
        M_ii, M_ib = M[:nu_int, :nu_int], M[:nu_int, nu_int:]
        B_ii, B_ib = B[:, :nu_int], B[:, nu_int:]
        nsys = nu_int + ncell + 1
        rhs = np.zeros((nsys, k_ext + K3))
        rhs[:nu_int, :k_ext] = -(M_ib @ Pb)
        rhs[nu_int:nu_int + ncell, :k_ext] = -(B_ib @ Pb)
        rhs[nu_int:nu_int + ncell, k_ext:] = m03_e[:, None] * U3np[e]
        A = np.zeros((nsys, nsys))
        A[:nu_int, :nu_int] = M_ii
        A[nu_int:nu_int + ncell, :nu_int] = B_ii
        A[:nu_int, nu_int:nu_int + ncell] = B_ii.T
        A[-1, nu_int:nu_int + ncell] = m03_e
        A[nu_int:nu_int + ncell, -1] = m03_e
        try:
            X = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:       # pragma: no cover
            X = np.linalg.lstsq(A, rhs, rcond=None)[0]
        P64 = X[:nu_int]
        D = Pintnp[e][:, :k_ext + K3] - P64
        e_col = np.einsum("ik,ij,jk->k", D, M_ii, D)
        ref_col = np.einsum("ik,ij,jk->k", P64, M_ii, P64)
        scale = max(float(ref_col.max()), 1e-30)
        worst = max(worst, float(np.sqrt(
            np.clip(e_col, 0.0, None).max() / scale)))
    return worst


def _extension_stage(m02_ch, m03_ch, d2_ch, ptr_bdr, pb_slot, t2_u,
                     rt_cols, fslot, slot_facet, nu_int, null_tol):
    """Hdiv interior Lagrange extension with RangeT bubbles and null
    targets (mirrors _extension use_lagrange=True):
      m02_ch (n, ncell, 6, 6), m03_ch (n, ncell), d2_ch (n, ncell, 6),
      ptr_bdr (n, nbd) facet PV trace values on the AE's boundary
      slots, pb_slot (n, nbd, K2) each boundary slot's row of its own
      facet's kept-mode columns (masked), t2_u (n, nu, 3) global Hdiv
      targets in AE slot order, rt_cols (n, ncell, K3) kept L2 target
      columns (masked), fslot (ncell, 6) static, slot_facet (nbd,)
      static facet index [0..6) of each boundary slot, nu_int static.
    Returns (Pint (n, nu_int, k_ext + K3), lam (n, k_ext), bubU
    (n, nu_int, 3) masked kept bubbles, n_null (n,), bub_sv (n, 3))."""
    n, ncell = m03_ch.shape
    nbd = ptr_bdr.shape[1]
    nu = nu_int + nbd
    dt = m02_ch.dtype
    idx = (fslot[:, :, None] * nu + fslot[:, None, :]).reshape(-1)
    M = jnp.zeros((n, nu * nu), dtype=dt).at[:, idx].add(
        m02_ch.reshape(n, -1)).reshape(n, nu, nu)
    Dloc = jnp.zeros((n, ncell, nu), dtype=dt).at[
        :, np.arange(ncell)[:, None], fslot].set(d2_ch)
    B = m03_ch[:, :, None] * Dloc                    # (n, ncell, nu)
    T = m03_ch                                       # W_ii @ pv (pv=1)

    K2 = pb_slot.shape[2]
    k_ext = 6 * (1 + K2)
    # Pb (n, nbd, k_ext): boundary slot s of facet j carries the PV
    # value at column j and its facet's kept-mode row at columns
    # 6 + j*K2 .. (block-diagonal by facet; masked slots are zero)
    rows = np.arange(nbd)
    Pb = jnp.zeros((n, nbd, k_ext), dtype=dt)
    Pb = Pb.at[:, rows, slot_facet].set(ptr_bdr)
    cols_extra = (6 + slot_facet[:, None] * K2
                  + np.arange(K2)[None, :])          # (nbd, K2)
    Pb = Pb.at[:, rows[:, None], cols_extra].set(pb_slot)

    M_ii, M_ib = M[:, :nu_int, :nu_int], M[:, :nu_int, nu_int:]
    B_ii, B_ib = B[:, :, :nu_int], B[:, :, nu_int:]
    nsys = nu_int + ncell + 1

    K3 = rt_cols.shape[2]
    t_int, t_bdr = t2_u[:, :nu_int], t2_u[:, nu_int:]
    kn = t2_u.shape[2]
    rhs = jnp.zeros((n, nsys, k_ext + K3 + kn), dtype=dt)
    rhs = rhs.at[:, :nu_int, :k_ext].set(-(M_ib @ Pb))
    rhs = rhs.at[:, nu_int:nu_int + ncell, :k_ext].set(-(B_ib @ Pb))
    rhs = rhs.at[:, nu_int:nu_int + ncell, k_ext:k_ext + K3].set(
        m03_ch[:, :, None] * rt_cols)
    rhs = rhs.at[:, :nu_int, k_ext + K3:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, nu_int:nu_int + ncell, k_ext + K3:].set(
        B_ii @ t_int)

    if _st._SOLVE_MODE == "ns":
        # block elimination (NS inverse of SPD M + small bordered LU):
        # the monolithic nsys x nsys LU is unusable on the chip at
        # SPE10-scale shapes (see _ext_saddle_solve_ns)
        X = _ext_saddle_solve_ns(M_ii, B_ii, T, rhs, nu_int, ncell)
    else:
        A = jnp.zeros((n, nsys, nsys), dtype=dt)
        A = A.at[:, :nu_int, :nu_int].set(M_ii)
        A = A.at[:, nu_int:nu_int + ncell, :nu_int].set(B_ii)
        A = A.at[:, :nu_int, nu_int:nu_int + ncell].set(
            B_ii.transpose(0, 2, 1))
        A = A.at[:, -1, nu_int:nu_int + ncell].set(T)
        A = A.at[:, nu_int:nu_int + ncell, -1].set(T)
        X = _st._solve_batch(A, rhs)
    Pint = X[:, :nu_int, :k_ext + K3]
    lam = X[:, -1, :k_ext]
    bub = t_int - X[:, :nu_int, k_ext + K3:]
    # thin SVD of the (nu_int, kn) bubble stack via the kn x kn Gram
    # eigendecomposition (no batched tall-skinny SVD; whether
    # jnp.linalg.svd is faster on the H100 is not measured).  The Gram floor is
    # sqrt(eps)*sigma_max; in ns mode the relative keep-floor is raised
    # to 1e-3 to sit above it (genuine SPE10 bubbles are O(1e-2..1) of
    # sigma_max).
    G = jnp.einsum("bik,bil->bkl", bub, bub)
    ev, Q = jnp.linalg.eigh(G)
    s = jnp.sqrt(jnp.clip(ev, 0.0, None))[:, ::-1]
    Q = Q[:, :, ::-1]
    safe = jnp.where(s > 0, s, 1.0)
    U = jnp.einsum("bik,bkl->bil", bub, Q) / safe[:, None, :]
    keep = s > null_tol
    # Gram noise floor is sqrt(eps)*sigma_max at the working precision
    keep = keep & (s > 50.0 * float(np.sqrt(jnp.finfo(dt).eps))
                   * jnp.maximum(s[:, :1], 1e-30))
    n_null = jnp.sum(keep, axis=1)
    mask = (jnp.arange(kn)[None, :] < n_null[:, None]).astype(dt)
    return Pint, lam, U * mask[:, None, :], n_null, s


# --------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------- #

@dataclass
class SpectralDarcyOut:
    """One structured spectral Hdiv-L2 coarsening step."""
    cshape: tuple
    f: tuple
    P2: object            # host CSR (fine faces x coarse Hdiv dofs)
    P3: object            # host CSR (fine cells x coarse L2 dofs)
    n_facet_dofs: object  # (n_facets,) 1 + kept per coarse facet
    n_ae_u_dofs: object   # (n_ae,) rt + null interior Hdiv dofs
    n_ae_p_dofs: object   # (n_ae,) 1 + kept L2 dofs
    ns_res: float = 0.0
    ext_spot_err: float = 0.0  # f64 spot-oracle energy error (worst AE)


def spectral_coarsen_darcy(shape, f, coeff, h=None, l2_weight=None,
                           spect_tol=0.002, max_evects=5,
                           svd_tol=1e-9, kcap2=None, dtype=np.float64,
                           chunk=8192, spot_check=3, spot_tol=None):
    """One spectral Hdiv-L2 coarsening of the fine grid `shape` with
    per-axis factors `f` and per-cell Hdiv coefficient `coeff` (SPE10
    kinv; the L2 mass keeps unit weight like the reference examples).
    Returns SpectralDarcyOut with host CSR P2/P3.

    Every stage runs as a batched device program under the solve mode
    selected via structured.solve_mode; chunked over entities to bound
    device memory."""
    assert all(s % ff == 0 for s, ff in zip(shape, f)), (shape, f)
    cshape = tuple(s // ff for s, ff in zip(shape, f))
    if h is None:
        h = tuple(1.0 / s for s in shape)
    dt = np.dtype(dtype)
    mode = _st._SOLVE_MODE
    if spot_tol is None:
        # calibrated against measured spot errors (f64 direct ~1e-13;
        # f32 ns with refinement — see tests/test_structured_spectral)
        spot_tol = 1e-8 if dt.itemsize == 8 else 2e-3
    nc, nf, ne, nv = _st.grid_counts(shape)
    ncells_ae = int(np.prod(f))
    n_ae = int(np.prod(cshape))

    # ---- fine value plane (analytic, device) ---- #
    ref = _st.fine_local_masses(h, dt)
    c = jnp.asarray(np.asarray(coeff, dtype=dt))
    w = (jnp.asarray(np.asarray(l2_weight, dtype=dt))
         if l2_weight is not None else jnp.ones(nc, dtype=dt))
    m02 = c[:, None, None] * jnp.asarray(ref[(0, 2)], dtype=dt)[None]
    m03 = w * float(ref[(0, 3)][0, 0])
    m12 = jnp.concatenate([
        jnp.full(nf[a], float(ref[(1, 2)][a][0, 0]), dtype=dt)
        for a in range(3)])
    _, _, d2np = _st.fine_derivative_values(shape, h, dt)
    d2 = jnp.asarray(d2np)
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    pv2 = jnp.concatenate([
        jnp.full(nf[a], float(areas[a]), dtype=dt) for a in range(3)])
    # order-0 global Hdiv targets: three unit fields (flux = area)
    t2 = jnp.concatenate([
        jnp.broadcast_to(
            (jnp.eye(3, dtype=dt)
             * jnp.asarray(areas, dtype=dt))[a], (nf[a], 3))
        for a in range(3)], axis=0)

    # ---- index plane ---- #
    cells = ae_cells(cshape, f)                       # (n_ae, ncells)
    faces, nu_int = ae_faces(cshape, f)               # (n_ae, nu)
    fslot = cell_face_slots(f)
    fch = facet_children(cshape, f)
    fnbr = facet_neighbors(cshape)
    bsl = facet_bdr_slices(f)
    nbd = faces.shape[1] - nu_int
    K3 = int(max_evects)
    if kcap2 is None:
        kcap2 = 2 * K3
    K2 = int(kcap2)

    ns_parts = []
    ns_by_stage = {}
    nu = faces.shape[1]
    # per-stage chunk: bound the largest stage tensor (the nu x nu
    # scatter of M plus the solve workspace, ~4 copies) to ~300 MB
    chunk_big = max(128, min(chunk, int(3.0e8 / max(
        4 * nu * nu * dt.itemsize, 1))))

    sync_debug = os.environ.get("PARELAG_SPS_SYNC", "") == "1"

    def run(name, fn, spec, n, ch=None, stage_mode=None):
        outs, ns = _st._run_stage_chunked(
            f"sps_{name}_{f}_{K2}_{K3}", fn, spec, n,
            ch or chunk, stage_mode or mode)
        if sync_debug:
            # force a device->host read after EVERY stage so a chip
            # fault is attributed to the stage that raised it (the
            # async queue otherwise surfaces it at the final fetch)
            import sys as _sys
            print(f"[sps] stage {name} ns={float(ns):.3e} n={n}",
                  file=_sys.stderr, flush=True)
        ns_parts.append(ns)
        ns_by_stage[name] = ns
        return outs

    # ---- stage A: per-AE spectral eigenproblems ---- #
    bdr_faces = faces[:, nu_int:]
    Vk, nkeepA = run(
        f"spec_{spect_tol}", lambda a, b, c_, d_: _spectral_stage(
            a, b, c_, d_, fslot, nu_int, float(spect_tol), K3),
        [("g", m02, cells), ("g", m03, cells), ("g", m12, bdr_faces),
         ("g", d2, cells)], n_ae, ch=chunk_big)
    npl = ncells_ae
    l2_tars = Vk[:, :npl]                             # (n_ae, npl, K3)
    mu = Vk[:, npl:]                                  # (n_ae, nbd, K3)

    # ---- stage T3: L2 traces with the spectral L2 targets ---- #
    svd_eff = float(max(svd_tol, 200.0 * np.finfo(dt).eps))
    ptr3, F3, U3, nk3, dots3 = run(
        f"t3_{svd_eff}", lambda m, p, t: _trace_stage_targets(
            m, p, t, svd_eff, K3),
        [("g", m03, cells),
         ("g", jnp.ones(nc, dtype=dt), cells), ("d", l2_tars)], n_ae)

    # ---- stage T2 (per family): facet traces with merged AE targets - #
    mu_np = mu                                        # device (n_ae,nbd,K3)
    fam_out = []
    for a in range(3):
        ids = fch[a]                                  # (nfa, nch)
        nbrs = fnbr[a]
        s_left, s_right, nch = bsl[a]
        # targets: left AE's block at its a1 slots, right AE's at a0;
        # -1 neighbors gather row 0 and are masked to zero
        lidx = np.where(nbrs[:, 0] >= 0, nbrs[:, 0], 0)
        ridx = np.where(nbrs[:, 1] >= 0, nbrs[:, 1], 0)
        lmask = (nbrs[:, 0] >= 0).astype(dt)
        rmask = (nbrs[:, 1] >= 0).astype(dt)

        def t2fam(m_ch, pv_ch, muL, muR, lm, rm,
                  _sl=s_left, _sr=s_right, _nch=nch):
            TL = muL[:, _sl:_sl + _nch] * lm[:, None, None]
            TR = muR[:, _sr:_sr + _nch] * rm[:, None, None]
            T = jnp.concatenate([TL, TR], axis=2)
            return _trace_stage_targets(m_ch, pv_ch, T, svd_eff, K2)

        outs = run(f"t2{a}_{svd_eff}", t2fam,
                   [("g", m12, ids), ("g", pv2, ids),
                    ("g", mu_np, lidx), ("g", mu_np, ridx),
                    ("g", jnp.asarray(lmask), np.arange(len(ids))),
                    ("g", jnp.asarray(rmask), np.arange(len(ids)))],
                   len(ids))
        fam_out.append(outs)

    # stitch the three families into global facet arrays (per-facet
    # child counts differ across families; keep ragged as a list)
    nfacets = [len(fch[a]) for a in range(3)]
    facet_off = np.concatenate([[0], np.cumsum(nfacets)])

    # per-AE boundary-slot views of the facet-stage outputs: the PV
    # trace value and the facet's kept-mode row per boundary slot
    # (boundary slots are facet-contiguous in the same (b,c)-lex order
    # as facet_children, so these are direct gathers)
    afacets = ae_facet_ids(cshape)                    # (n_ae, 6) global
    nk2_all = np.empty(int(facet_off[-1]), dtype=np.int64)
    for a in range(3):
        nk2_all[facet_off[a]:facet_off[a + 1]] = np.asarray(fam_out[a][3])
    ptr2_fam = [np.asarray(fam_out[a][0], dtype=dt) for a in range(3)]
    u2_fam = [np.asarray(fam_out[a][2], dtype=dt) for a in range(3)]
    ptr_bdr = np.empty((n_ae, nbd), dtype=dt)
    pb_slot = np.zeros((n_ae, nbd, K2), dtype=dt)
    slot_facet = np.empty(nbd, dtype=np.int64)
    for j in range(6):
        a, side = j // 2, j % 2
        loc = afacets[:, j] - facet_off[a]
        s_left, s_right, nch = bsl[a]
        s0 = s_left if side == 1 else s_right
        slot_facet[s0:s0 + nch] = j
        ptr_bdr[:, s0:s0 + nch] = ptr2_fam[a][loc]
        pb_slot[:, s0:s0 + nch, :] = u2_fam[a][loc]

    # ---- stage E2: interior extension ---- #
    # In ns mode the saddle is solved by block elimination — NS inverse
    # of the SPD M block + a small bordered LU + full-system refinement
    # (_ext_saddle_solve_ns): a plain f32 Newton-Schulz on the full
    # saddle stalls at SPE10 contrast (equilibrated cond ~7e6, measured
    # residual 0.067); direct mode runs the monolithic batched LU.
    tol_n = (max(svd_tol, 1e-3) if mode == "ns"
             else max(svd_tol, 200.0 * float(np.finfo(dt).eps)))
    Pint, lam, bubU, n_null, bubsv = run(
        f"ext_{tol_n}", lambda a_, b_, c_, d_, e_, g_, r_:
        _extension_stage(a_, b_, c_, d_, e_, g_, r_, fslot, slot_facet,
                         nu_int, tol_n),
        [("g", m02, cells), ("g", m03, cells), ("g", d2, cells),
         ("g", jnp.asarray(ptr_bdr), np.arange(n_ae)),
         ("g", jnp.asarray(pb_slot), np.arange(n_ae)),
         ("g", t2, faces), ("d", U3)], n_ae, ch=chunk_big)

    ns_res = float(jnp.max(jnp.stack(ns_parts))) if ns_parts else 0.0
    for k, v in ns_by_stage.items():
        tol = _EXT_GUARD_TOL if k.startswith("ext") else \
            _st._NS_GUARD_TOL
        assert float(v) < tol, (
            float(v), f"stage {k} solve did not converge",
            {kk: float(vv) for kk, vv in ns_by_stage.items()})

    # ---- coarse-operator quality invariant (f64 spot oracle) ---- #
    # The backward-residual guard above has a 4.5x silent band between
    # its tolerance and the measured f32 floor; this closes it with a
    # FORWARD-error check: a handful of AEs' extension saddles are
    # re-solved on the host in f64 and the device Pint columns are
    # compared in the M_ii ENERGY norm — the quantity the two-level
    # preconditioner actually feels.  Mirrors the reference's
    # CheckInvariants spirit (DeRhamSequence.cpp CheckD/CheckTrueD) at
    # the stage where f32 degradation would otherwise pass silently.
    ext_spot = 0.0
    if spot_check:
        ext_spot = _ext_spot_check(
            shape, h, coeff, l2_weight, cells, fslot,
            slot_facet, nu_int, ptr_bdr, pb_slot,
            np.asarray(U3, dtype=np.float64), np.asarray(
                Pint, dtype=np.float64), K2, int(spot_check))
        assert ext_spot < spot_tol, (
            ext_spot, "extension spot oracle: device Pint deviates "
            "from the f64 host solution in energy norm", spot_tol)

    # ---- host materialization (masked columns dropped) ---- #
    # All four ragged kept-column blocks are emitted by ARRAY ops over a
    # (entity, capacity) keep-mask — at the (60,220,85) north star the
    # per-AE/per-facet list-append loops this replaces were the setup's
    # host hump (round-4 verdict item 6): 14k AEs x 6 facets of appends.
    import scipy.sparse as sp

    def _ragged_sel(counts, cap):
        """(entity, k) index pairs where k < counts[entity], row-major —
        the same visit order as the loops this replaces."""
        counts = np.asarray(counts, dtype=np.int64)
        mask = np.arange(cap)[None, :] < counts[:, None]
        return np.nonzero(mask)

    nk3np = np.asarray(nk3, dtype=np.int64)
    p_off = np.concatenate([[0], np.cumsum(1 + nk3np)])
    n_p_coarse = int(p_off[-1])
    ptr3np = np.asarray(ptr3, dtype=np.float64)
    U3np = np.asarray(U3, dtype=np.float64)
    rows3, cols3, vals3 = [], [], []
    rows3.append(cells.ravel())
    cols3.append(np.repeat(p_off[:-1], npl))
    vals3.append(ptr3np.ravel())
    ia, kk = _ragged_sel(nk3np, U3np.shape[2])
    rows3.append(cells[ia].ravel())
    cols3.append(np.repeat(p_off[ia] + 1 + kk, npl))
    vals3.append(U3np[ia, :, kk].ravel())
    P3 = sp.coo_matrix(
        (np.concatenate(vals3),
         (np.concatenate(rows3), np.concatenate(cols3))),
        shape=(nc, n_p_coarse)).tocsr()

    # coarse Hdiv dof numbering: [facet blocks (PV + kept) in global
    # facet order] then [per-AE interior: rt (nk3) + null (n_null)]
    nk2np = nk2_all
    u_off_f = np.concatenate([[0], np.cumsum(1 + nk2np)])
    n_facet_dofs = int(u_off_f[-1])
    n_nullnp = np.asarray(n_null, dtype=np.int64)
    u_off_i = (n_facet_dofs
               + np.concatenate([[0], np.cumsum(nk3np + n_nullnp)]))
    n_u_coarse = int(u_off_i[-1])

    rows2, cols2, vals2 = [], [], []
    # facet trace blocks
    for a in range(3):
        ids = fch[a]
        ptr2a = np.asarray(ptr2_fam[a], dtype=np.float64)
        u2a = np.asarray(u2_fam[a], dtype=np.float64)
        base = facet_off[a]
        nfa, nch = ids.shape
        offs = u_off_f[base:base + nfa]
        rows2.append(ids.ravel())
        cols2.append(np.repeat(offs, nch))
        vals2.append(ptr2a.ravel())
        fi, kk = _ragged_sel(nk2np[base:base + nfa], u2a.shape[2])
        rows2.append(ids[fi].ravel())
        cols2.append(np.repeat(offs[fi] + 1 + kk, nch))
        vals2.append(u2a[fi, :, kk].ravel())
    # interior blocks: extension columns in [6*(1+K2) ext | K3 rt] +
    # null bubbles
    Pintnp = np.asarray(Pint, dtype=np.float64)
    bubnp = np.asarray(bubU, dtype=np.float64)
    int_faces = faces[:, :nu_int]
    K2b = K2
    # ext PV columns: every (iae, j) pair
    gfc_all = afacets                           # (n_ae, 6)
    rows2.append(np.repeat(int_faces, 6, axis=0).ravel())
    cols2.append(np.repeat(u_off_f[gfc_all.ravel()], nu_int))
    vals2.append(np.swapaxes(Pintnp[:, :, :6], 1, 2).ravel())
    # ext kept columns: (iae, j, k) with k < nk2[afacets[iae, j]]
    iae_j, kk = _ragged_sel(nk2np[gfc_all.ravel()], K2b)
    ia, jj = iae_j // 6, iae_j % 6
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_f[gfc_all.ravel()[iae_j]] + 1 + kk,
                           nu_int))
    vals2.append(Pintnp[ia, :, 6 + jj * K2b + kk].ravel())
    # rt columns: (iae, k) with k < nk3
    ia, kk = _ragged_sel(nk3np, Pintnp.shape[2] - 6 * (1 + K2b))
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_i[ia] + kk, nu_int))
    vals2.append(Pintnp[ia, :, 6 * (1 + K2b) + kk].ravel())
    # null bubbles: (iae, k) with k < n_null
    ia, kk = _ragged_sel(n_nullnp, bubnp.shape[2])
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_i[ia] + nk3np[ia] + kk, nu_int))
    vals2.append(bubnp[ia, :, kk].ravel())
    P2 = sp.coo_matrix(
        (np.concatenate(vals2),
         (np.concatenate(rows2), np.concatenate(cols2))),
        shape=(sum(nf), n_u_coarse)).tocsr()

    return SpectralDarcyOut(
        cshape=cshape, f=tuple(f), P2=P2, P3=P3,
        n_facet_dofs=1 + nk2np, n_ae_u_dofs=nk3np + n_nullnp,
        n_ae_p_dofs=1 + nk3np, ns_res=ns_res, ext_spot_err=ext_spot)
