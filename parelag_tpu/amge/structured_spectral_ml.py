"""Multilevel device-resident spectral Hdiv-L2 coarsening (block engine).

The one-step engine (amge/structured_spectral.py) coarsens the FINE
cartesian grid, where every facet carries exactly one Hdiv dof and every
cell one L2 dof.  Its coarse level is no longer that simple: a coarse
facet carries 1 + kept spectral modes, a coarse AE carries interior
RangeT/bubble dofs — variable counts.  The reference recurses Coarsen()
to arbitrary depth (DeRhamSequence.cpp:572-692, with spectral targets
recomputed per level as in MultigridTestSPE10.cpp:169-187); this module
is the device recursion: every per-entity dof population rides a FIXED
slot capacity plus an active-count mask, so each level's three stages
(per-AE spectral eigenproblems, facet trace SVDs, Lagrange interior
extensions) stay uniform batched dense programs:

  * CapF slots per facet  (1 + kcap2 after one coarsening),
  * CapP slots per cell   (1 + max_evects),
  * CapI interior-u slots per cell (max_evects + n_bubble_targets),

with slot 0 of every facet/cell block the PV (constant) dof by
construction.  Level 1 is the degenerate case CapF=CapP=1, CapI=0 and
the block stages reduce EXACTLY to the one-step engine's math (parity
pinned by tests/test_structured_spectral_ml.py); level k+1 consumes the
cell-local Galerkin blocks (P_loc^T M P_loc etc.) the level-k extension
emits, so no global sparse matrix is ever re-agglomerated.

Masked (inactive) slots carry zero operator rows/columns; they are made
harmless by identity diagonal padding in the local solves and a large
eigenvalue shift in the spectral stage's padded directions (kept-mode
thresholds compare against the ACTIVE eigenvalue range only).

Reference flow: recursive Coarsen with LocalSpectralTargets
(/root/reference/src/amge/DeRhamSequence.cpp:572-692,
LocalSpectralTargets.cpp:46-90); polynomial targets are coarsened with
the cochain projector between levels (DeRhamSequence.cpp:674-689),
mirrored here by the per-entity dof-functional projection in
_next_level_stage.
"""

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from parelag_tpu.amge import structured as _st
from parelag_tpu.amge import structured_spectral as _sp


# multiplier on the Gershgorin bound of the ACTIVE transformed Schur
# block: padded (inactive) slots get a planted eigenvalue this factor
# above every physical mode, so they are never among the kept smallest.
# The pad must stay SCALE-AWARE: a fixed huge shift (1e8) makes the f32
# eigh's absolute eigenvalue noise (~eps * ||A||) swamp the O(1) active
# eigenvalues — seen on an accelerator as kept-mode collapse (46 vs 70
# coarse u dofs at (12,20,8)); 16x the active bound keeps the noise at
# ~16*eps relative, far under the 2e-3 spectral keep threshold.
_PAD_EIG_FACTOR = 16.0


@dataclass
class BlockLevelOut:
    """One block-level coarsening step: host CSR prolongations in the
    level's COMPRESSED dof numbering ([facet dofs by facet, then cell
    interior dofs] for u; [cell dofs by cell] for p) plus the next
    BlockLevel for recursion."""
    P2: object
    P3: object
    next_level: object
    ns_res: float


@dataclass
class BlockLevel:
    """One level of the block chain: the cartesian cell grid plus the
    cell/facet-local operator blocks in slot-capacity layout.

    Layouts (all device arrays, dtype uniform):
      cell_M (nc, 6*CapF + CapI, same) — cell-local Hdiv mass in the
          cell layout [x0|x1|y0|y1|z0|z1 facet blocks, interior block]
          (level 1: the 6x6 kinv-weighted hex blocks);
      cell_B (nc, CapP, 6*CapF + CapI) — W-weighted divergence rows;
      cell_W (nc, CapP, CapP) — L2 mass blocks (level 1: vol scalars);
      facet_Q (sum nf, CapF, CapF) — facet trace mass blocks, global
          facet order (x family, then y, then z);
      pv_f (sum nf, CapF) — the global PV (constant-flux) field's
          representation on each facet block (level 1: the face areas;
          level >= 2: the slot-0 indicator, since column 0 of every
          facet block IS the PV trace by construction);
      t2_f (sum nf, CapF, kt) / t2_i (nc, CapI, kt) — the polynomial
          (bubble) targets' representation in this level's coordinates;
      facet_n (sum nf,) / cell_pn (nc,) — active slot counts (prefix
          of CapF / CapP);
      cell_rt_n / cell_null_n (nc,) — active interior-u counts: the
          interior block is [capRT RangeT slots | CapI - capRT null
          slots] and each sub-block's actives are a prefix.
    """
    cshape: tuple
    capF: int
    capP: int
    capI: int
    capRT: int
    cell_M: object
    cell_B: object
    cell_W: object
    facet_Q: object
    pv_f: object
    t2_f: object
    t2_i: object
    facet_n: object          # host int arrays
    cell_pn: object
    cell_rt_n: object
    cell_null_n: object
    h: tuple

    @property
    def dtype(self):
        return self.cell_M.dtype

    def un_mask_np(self):
        """(nc, capI) active interior-u slot mask (host)."""
        nc = len(self.cell_rt_n)
        m = np.zeros((nc, self.capI))
        m[:, :self.capRT] = (np.arange(self.capRT)[None, :]
                             < self.cell_rt_n[:, None])
        m[:, self.capRT:] = (np.arange(self.capI - self.capRT)[None, :]
                             < self.cell_null_n[:, None])
        return m

    def u_offsets(self):
        """Compressed u-dof numbering: facet blocks then cell
        interiors.  Returns (facet dof offsets (nf+1,), interior dof
        offsets (nc+1,) shifted past the facets, ndofs_u)."""
        fo = np.concatenate([[0], np.cumsum(self.facet_n)])
        io = int(fo[-1]) + np.concatenate(
            [[0], np.cumsum(self.cell_rt_n + self.cell_null_n)])
        return fo, io, int(io[-1])

    def p_offsets(self):
        po = np.concatenate([[0], np.cumsum(self.cell_pn)])
        return po, int(po[-1])


def fine_block_level(shape, coeff, h=None, l2_weight=None,
                     dtype=np.float64) -> BlockLevel:
    """The fine grid as the degenerate block level (CapF=CapP=1,
    CapI=0) — same value plane as spectral_coarsen_darcy's."""
    if h is None:
        h = tuple(1.0 / s for s in shape)
    dt = np.dtype(dtype)
    nc, nf, ne, nv = _st.grid_counts(shape)
    ref = _st.fine_local_masses(h, dt)
    c = jnp.asarray(np.asarray(coeff, dtype=dt))
    w = (jnp.asarray(np.asarray(l2_weight, dtype=dt))
         if l2_weight is not None else jnp.ones(nc, dtype=dt))
    m02 = c[:, None, None] * jnp.asarray(ref[(0, 2)], dtype=dt)[None]
    vol = float(ref[(0, 3)][0, 0])
    m03 = w * vol
    m12 = jnp.concatenate([
        jnp.full(nf[a], float(ref[(1, 2)][a][0, 0]), dtype=dt)
        for a in range(3)])
    _, _, d2np = _st.fine_derivative_values(shape, h, dt)
    d2 = jnp.asarray(d2np)
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    # order-0 global Hdiv targets (unit fields, flux = area) in facet
    # coordinates; no interior component at the fine level
    t2_f = jnp.concatenate([
        jnp.broadcast_to(
            (jnp.eye(3, dtype=dt)
             * jnp.asarray(areas, dtype=dt))[a], (nf[a], 3)
        ) for a in range(3)], axis=0)[:, None, :]       # (nf, 1, 3)
    pv_f = jnp.concatenate([
        jnp.full(nf[a], float(areas[a]), dtype=dt)
        for a in range(3)])[:, None]                     # (nf, 1)
    return BlockLevel(
        cshape=tuple(shape), capF=1, capP=1, capI=0, capRT=0,
        cell_M=m02,
        cell_B=(m03[:, None] * d2)[:, None, :],          # (nc, 1, 6)
        cell_W=m03[:, None, None],
        facet_Q=m12[:, None, None],
        pv_f=pv_f,
        t2_f=t2_f, t2_i=jnp.zeros((nc, 0, 3), dtype=dt),
        facet_n=np.ones(sum(nf), np.int64),
        cell_pn=np.ones(nc, np.int64),
        cell_rt_n=np.zeros(nc, np.int64),
        cell_null_n=np.zeros(nc, np.int64), h=tuple(h))


def _colmap(f, capF, capI):
    """(ncell, 6*capF + capI) AE-local u-dof index of every cell's
    local dofs, in the AE layout [interior-facet blocks | cell-interior
    blocks | boundary-facet blocks] (interior-first for the extension's
    contiguous elimination).  Also returns (nu_int_dofs, nbd_slots,
    slot_facet6) with slot_facet6 (nbd_slots,) = which of the AE's 6
    coarse facets each boundary SLOT belongs to."""
    fslot = _sp.cell_face_slots(f)                  # (ncell, 6) slots
    offs, nu_int = _sp._ae_face_offsets(f)
    ncell = fslot.shape[0]
    n_slots = len(offs)
    nbd = n_slots - nu_int
    base_int_cells = nu_int * capF
    base_bdr = nu_int * capF + ncell * capI

    def slot_base(t):
        return np.where(t < nu_int, t * capF,
                        base_bdr + (t - nu_int) * capF)

    cm = np.empty((ncell, 6 * capF + capI), dtype=np.int64)
    for j in range(6):
        b = slot_base(fslot[:, j])
        cm[:, j * capF:(j + 1) * capF] = b[:, None] + np.arange(capF)
    cm[:, 6 * capF:] = (base_int_cells
                        + np.arange(ncell)[:, None] * capI
                        + np.arange(capI)[None, :])
    # boundary slots appear facet-contiguous in [x0,x1,y0,y1,z0,z1]
    # order with f[b]*f[c] children each (same as _ae_face_offsets)
    slot_facet6 = np.empty(nbd, dtype=np.int64)
    s0 = 0
    for a in range(3):
        bb, cc = [ax for ax in range(3) if ax != a]
        nch = f[bb] * f[cc]
        for side in (0, 1):
            slot_facet6[s0:s0 + nch] = 2 * a + side
            s0 += nch
    return cm, nu_int * capF + ncell * capI, nbd, slot_facet6


def _scatter_ae_ops(mch, bch, qbdr, cm, nu_dofs, nbd, capF, u_act):
    """Assemble the AE-local operators from gathered cell/facet blocks.

    mch (n, ncell, cl, cl) cell_M blocks (cl = 6*capF + capI),
    bch (n, ncell, capP, cl), qbdr (n, nbd, capF, capF) boundary facet
    trace masses, cm (ncell, cl) static AE-local column map, u_act
    (n, nu) active-u mask assembled by the driver from the facet/cell
    masks.

    Returns (M (n, nu, nu) identity-padded on inactive u slots,
             B (n, ncell*capP, nu), C (n, nbd*capF, nu) trace rows)."""
    n, ncell, cl, _ = mch.shape
    capP = bch.shape[2]
    nu = nu_dofs + nbd * capF
    dt = mch.dtype
    idx = (cm[:, :, None] * nu + cm[:, None, :]).reshape(-1)
    M = jnp.zeros((n, nu * nu), dtype=dt).at[:, idx].add(
        mch.reshape(n, -1)).reshape(n, nu, nu)
    B = jnp.zeros((n, ncell * capP, nu), dtype=dt)
    rows = (np.arange(ncell)[:, None] * capP
            + np.arange(capP)[None, :])                 # (ncell, capP)
    B = B.at[:, rows[:, :, None], cm[:, None, :]].add(bch)
    # trace rows: boundary facet block j occupies rows j*capF.. and
    # columns nu_dofs + j*capF..
    C = jnp.zeros((n, nbd * capF, nu), dtype=dt)
    rb = (np.arange(nbd)[:, None] * capF
          + np.arange(capF)[None, :])                   # (nbd, capF)
    cbl = nu_dofs + rb
    C = C.at[:, rb[:, :, None], cbl[:, None, :]].set(qbdr)
    M = M + (1.0 - u_act)[:, :, None] * (
        jnp.eye(nu, dtype=dt)[None]
        * (1.0 - u_act)[:, None, :])
    return M, B, C


def _blk_chol_scale(R_blocks, mask):
    """Batched Cholesky of SPD blocks with inactive slots padded to the
    identity: R (n, k, s, s), mask (n, k, s) active flags.  Returns L
    (lower) with identity rows/cols on inactive slots."""
    n, k, s, _ = R_blocks.shape
    dt = R_blocks.dtype
    eye = jnp.eye(s, dtype=dt)
    pad = (1.0 - mask)[:, :, :, None] * eye[None, None]
    Rp = R_blocks * mask[:, :, :, None] * mask[:, :, None, :] + pad
    return jnp.linalg.cholesky(Rp)


def _spectral_stage_blk(mch, bch, wch, qbdr, wmask, qmask_bdr,
                        u_act, cm, nu_dofs, nbd, capF,
                        spect_tol, max_evects):
    """Generalized per-AE mixed Hdiv-L2 eigenproblem over block slots
    (level-1 degenerate case == _sp._spectral_stage; reference
    LocalSpectralTargets.cpp:46-90).

    wmask (n, ncell, capP), qmask_bdr (n, nbd, capF) active masks,
    u_act (n, nu) AE-layout u activity.  Returns (V (n, npl+nbdofs, K)
    masked kept modes, nkeep (n,))."""
    n, ncell = wch.shape[:2]
    capP = wch.shape[2]
    dt = mch.dtype
    M, B, C = _scatter_ae_ops(mch, bch, qbdr, cm, nu_dofs, nbd, capF,
                              u_act)
    BC = jnp.concatenate([B, C], axis=1)     # (n, npl + nbdofs, nu)
    X = _st._solve_batch(M, BC.transpose(0, 2, 1))
    S = BC @ X
    S = 0.5 * (S + S.transpose(0, 2, 1))
    # RHS = blkdiag(W blocks, Q boundary blocks); generalized eigh via
    # blockwise Cholesky (the blocks are tiny: capP/capF <= ~11)
    Lw = _blk_chol_scale(wch, wmask)
    Lq = _blk_chol_scale(qbdr, qmask_bdr)
    npl = ncell * capP
    nbdofs = nbd * capF
    nn = npl + nbdofs
    rmask = jnp.concatenate(
        [wmask.reshape(n, -1), qmask_bdr.reshape(n, -1)], axis=1)
    # zero inactive rows/cols of S so the only thing on padded slots is
    # the planted shift (applied to St below, AFTER the Cholesky
    # transform, where its scale can be tied to the active spectrum)
    S = S * rmask[:, :, None] * rmask[:, None, :]

    def blk_solve_T(L_blocks, V, base, k, s):
        """V <- blkdiag(L)^-1 V on rows [base, base + k*s)."""
        seg = V[:, base:base + k * s].reshape(n, k, s, -1)
        sol = jax.scipy.linalg.solve_triangular(L_blocks, seg,
                                                lower=True)
        return V.at[:, base:base + k * s].set(sol.reshape(n, k * s, -1))

    # St = L^-1 S L^-T with L = blkdiag(Lw, Lq)
    St = blk_solve_T(Lw, S, 0, ncell, capP)
    St = blk_solve_T(Lq, St, npl, nbd, capF)
    St = St.transpose(0, 2, 1)
    St = blk_solve_T(Lw, St, 0, ncell, capP)
    St = blk_solve_T(Lq, St, npl, nbd, capF)
    St = 0.5 * (St + St.transpose(0, 2, 1))
    # scale-aware pad on the inactive slots: Gershgorin bound of the
    # active block puts every planted eigenvalue above the physical
    # range without inflating ||St|| (see _PAD_EIG_FACTOR note)
    bound = jnp.max(jnp.sum(jnp.abs(St), axis=2) * rmask, axis=1)
    pad = _PAD_EIG_FACTOR * jnp.maximum(bound, 1.0)
    St = St + (1.0 - rmask)[:, :, None] * (
        jnp.eye(nn, dtype=dt)[None] * pad[:, None, None]
        * (1.0 - rmask)[:, None, :])
    w, Vt = jnp.linalg.eigh(St)

    # back-transform: V = L^-T Vt
    def blk_solve_Tt(L_blocks, V, base, k, s):
        seg = V[:, base:base + k * s].reshape(n, k, s, -1)
        sol = jax.scipy.linalg.solve_triangular(
            L_blocks.transpose(0, 1, 3, 2), seg, lower=False)
        return V.at[:, base:base + k * s].set(sol.reshape(n, k * s, -1))

    V = blk_solve_Tt(Lw, Vt, 0, ncell, capP)
    V = blk_solve_Tt(Lq, V, npl, nbd, capF)

    # active eigenvalue range: padded eigenvalues sit at the TOP
    # (ascending eigh); the reference threshold compares against the
    # largest ACTIVE eigenvalue
    n_act = jnp.sum(rmask, axis=1).astype(jnp.int32)
    w_act_max = jnp.take_along_axis(
        w, jnp.maximum(n_act[:, None] - 1, 0), axis=1)[:, 0]
    nkeep = jnp.sum(
        (jnp.abs(w) <= spect_tol
         * jnp.maximum(jnp.abs(w_act_max), 1.0)[:, None])
        & (jnp.arange(w.shape[1])[None, :] < n_act[:, None]), axis=1)
    nkeep = jnp.clip(nkeep, 1, max_evects)
    K = int(max_evects)
    Vk = V[:, :, :K]
    sgn = jnp.where(Vk[:, 0, 0] < 0, -1.0, 1.0).astype(dt)
    Vk = Vk.at[:, :, 0].multiply(sgn[:, None])
    mask = (jnp.arange(K)[None, :] < nkeep[:, None]).astype(dt)
    # zero components on inactive slots too
    Vk = Vk * mask[:, None, :] * rmask[:, :, None]
    return Vk, nkeep


def _trace_stage_blk(Qb, pv, T, dof_mask, svd_tol, kcap):
    """Generalized facet/cell trace stage (block mass): Qb (n, k, s, s)
    child mass blocks, pv (n, k*s) PV vector, T (n, k*s, kt) deflation
    targets, dof_mask (n, k, s) active flags.  Mirrors
    _sp._trace_stage_targets with the diag mass replaced by
    blkdiag(Qb) through its Cholesky.  Returns (F (n, k*s) PV cochain
    functional, U (n, k*s, kcap) kept columns scaled sqrt(dots),
    nkeep, dots)."""
    n, k, s, _ = Qb.shape
    nd = k * s
    dt = Qb.dtype
    L = _blk_chol_scale(Qb, dof_mask)
    mvec = dof_mask.reshape(n, nd)
    pv = pv * mvec

    def mdot(V):
        """blkdiag(Qb) @ V (active-masked)."""
        seg = (V * mvec[:, :, None]).reshape(n, k, s, -1)
        return (Qb @ seg).reshape(n, nd, -1) * mvec[:, :, None]

    mpv = mdot(pv[:, :, None])[:, :, 0]
    dots = jnp.sum(pv * mpv, axis=1)
    F = mpv / dots[:, None]
    T = T * mvec[:, :, None]
    coef = jnp.einsum("bi,bik->bk", mpv, T) / dots[:, None]
    Td = T - pv[:, :, None] * coef[:, None, :]
    # M-weighted SVD through the block Cholesky (true SVD — the Gram
    # squares the rounding floor, see _sp._trace_stage_targets)
    seg = Td.reshape(n, k, s, -1)
    Ts = jnp.einsum("bksr,bkrt->bkst", L.transpose(0, 1, 3, 2),
                    seg).reshape(n, nd, -1)
    U0, sv, _ = jnp.linalg.svd(Ts, full_matrices=False)
    seg = U0.reshape(n, k, s, -1)
    U = jax.scipy.linalg.solve_triangular(
        L.transpose(0, 1, 3, 2), seg, lower=False).reshape(n, nd, -1)
    keep = sv > dots[:, None] * svd_tol
    keep = keep & (sv > 200.0 * float(jnp.finfo(dt).eps)
                   * jnp.maximum(sv[:, :1], 1e-30))
    nmax = sv.shape[1]
    nkeep = jnp.minimum(jnp.sum(keep, axis=1), kcap)
    mask = (jnp.arange(nmax)[None, :] < nkeep[:, None]).astype(dt)
    U = U * mask[:, None, :] * mvec[:, :, None]
    kcap = int(kcap)
    U = (U[:, :, :kcap] if nmax >= kcap else jnp.pad(
        U, ((0, 0), (0, 0), (0, kcap - nmax))))
    scale = jnp.sqrt(dots).astype(dt)
    return F, U * scale[:, None, None], nkeep, dots


def _extension_stage_blk(mch, bch, wch, cm, nu_dofs, nbd, capF,
                         ptr_bdr, pb_slot, slot_facet6, t2_loc,
                         rt_cols, u_act, wmask, null_tol):
    """Generalized Hdiv interior Lagrange extension (level-1 degenerate
    case == _sp._extension_stage; reference hFacetExtension,
    DeRhamSequence.cpp:2169-2628).

      ptr_bdr (n, nbd*capF) PV boundary values (slot-0 indicators x pv
      values), pb_slot (n, nbd*capF, K2) each boundary dof's row of its
      own facet's kept-mode columns, slot_facet6 (nbd,) static,
      t2_loc (n, nu, kt) bubble targets in AE coordinates, rt_cols
      (n, ncell*capP, K3) kept L2 target columns, u_act (n, nu)
      AE-layout u activity.

    Returns (Pint (n, nu_int, k_ext + K3), bubU (n, nu_int, kt) masked,
    n_null (n,), and the AE-local assembled (M, B, Pb) for the
    next-level Galerkin stage)."""
    n, ncell = wch.shape[:2]
    capP = wch.shape[2]
    dt = mch.dtype
    # trace rows don't appear in the extension saddle
    qpad = jnp.zeros((n, nbd, capF, capF), dtype=dt)
    M, B, _ = _scatter_ae_ops(mch, bch, qpad, cm, nu_dofs, nbd, capF,
                              u_act)
    nu = M.shape[1]
    nu_int = nu_dofs
    # T = W_loc @ pv_p with pv_p = slot-0 indicator per cell block
    pv_p = jnp.zeros((n, ncell, capP), dtype=dt).at[:, :, 0].set(1.0)
    T = (wch @ pv_p[:, :, :, None])[:, :, :, 0].reshape(n, -1) \
        * wmask.reshape(n, -1)

    K2 = pb_slot.shape[2]
    k_ext_f = 1 + K2                       # new dofs per coarse facet
    k_ext = 6 * k_ext_f
    nbdofs = nbd * capF
    rows = np.arange(nbdofs)
    sf = np.repeat(slot_facet6, capF)      # facet6 id per boundary DOF
    Pb = jnp.zeros((n, nbdofs, k_ext), dtype=dt)
    Pb = Pb.at[:, rows, sf * k_ext_f].set(ptr_bdr)
    cols_extra = (sf[:, None] * k_ext_f + 1
                  + np.arange(K2)[None, :])
    Pb = Pb.at[:, rows[:, None], cols_extra].set(pb_slot)

    M_ii, M_ib = M[:, :nu_int, :nu_int], M[:, :nu_int, nu_int:]
    B_ii, B_ib = B[:, :, :nu_int], B[:, :, nu_int:]
    npl = ncell * capP
    nsys = nu_int + npl + 1

    K3 = rt_cols.shape[2]
    t_int, t_bdr = t2_loc[:, :nu_int], t2_loc[:, nu_int:]
    kn = t2_loc.shape[2]
    rhs = jnp.zeros((n, nsys, k_ext + K3 + kn), dtype=dt)
    rhs = rhs.at[:, :nu_int, :k_ext].set(-(M_ib @ Pb))
    rhs = rhs.at[:, nu_int:nu_int + npl, :k_ext].set(-(B_ib @ Pb))
    Wblk = jnp.zeros((n, npl, npl), dtype=dt)
    rw = (np.arange(ncell)[:, None] * capP
          + np.arange(capP)[None, :])
    Wblk = Wblk.at[:, rw[:, :, None], rw[:, None, :]].set(wch)
    rhs = rhs.at[:, nu_int:nu_int + npl, k_ext:k_ext + K3].set(
        Wblk @ rt_cols)
    rhs = rhs.at[:, :nu_int, k_ext + K3:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, nu_int:nu_int + npl, k_ext + K3:].set(B_ii @ t_int)

    # inactive p rows: keep the saddle nonsingular (their B rows are
    # zero); the multiplier row always stays (PV pressure is active)
    p_act = wmask.reshape(n, npl)
    if _st._SOLVE_MODE == "ns":
        X = _ext_saddle_solve_ns_blk(M_ii, B_ii, T, p_act, rhs,
                                     nu_int, npl)
    else:
        A = jnp.zeros((n, nsys, nsys), dtype=dt)
        A = A.at[:, :nu_int, :nu_int].set(M_ii)
        A = A.at[:, nu_int:nu_int + npl, :nu_int].set(B_ii)
        A = A.at[:, :nu_int, nu_int:nu_int + npl].set(
            B_ii.transpose(0, 2, 1))
        A = A.at[:, -1, nu_int:nu_int + npl].set(T)
        A = A.at[:, nu_int:nu_int + npl, -1].set(T)
        eye = jnp.eye(nsys, dtype=dt)[None]
        pd = jnp.zeros((n, nsys), dtype=dt).at[
            :, nu_int:nu_int + npl].set(1.0 - p_act)
        A = A + pd[:, :, None] * eye
        X = _st._solve_batch(A, rhs)
    Pint = X[:, :nu_int, :k_ext + K3]
    bub = t_int - X[:, :nu_int, k_ext + K3:]
    G = jnp.einsum("bik,bil->bkl", bub, bub)
    ev, Q = jnp.linalg.eigh(G)
    sv = jnp.sqrt(jnp.clip(ev, 0.0, None))[:, ::-1]
    Q = Q[:, :, ::-1]
    safe = jnp.where(sv > 0, sv, 1.0)
    U = jnp.einsum("bik,bkl->bil", bub, Q) / safe[:, None, :]
    keep = sv > null_tol
    keep = keep & (sv > 50.0 * float(np.sqrt(jnp.finfo(dt).eps))
                   * jnp.maximum(sv[:, :1], 1e-30))
    n_null = jnp.sum(keep, axis=1)
    mask = (jnp.arange(kn)[None, :] < n_null[:, None]).astype(dt)
    return Pint, U * mask[:, None, :], n_null, M, B, Pb


# --------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------- #

def coarsen_block_level(level: BlockLevel, f, spect_tol=0.002,
                        max_evects=5, svd_tol=1e-9, kcap2=None,
                        chunk=8192) -> BlockLevelOut:
    """One cartesian coarsening of a BlockLevel with per-axis factors
    `f`: the three stages of the one-step engine generalized to block
    slots, plus the Galerkin emission of the next BlockLevel.  Chunked
    through _st._run_stage_chunked like the one-step engine; solve
    strategy via structured.solve_mode."""
    import scipy.sparse as sp

    cshape = level.cshape
    assert all(s % ff == 0 for s, ff in zip(cshape, f)), (cshape, f)
    ae_shape = tuple(s // ff for s, ff in zip(cshape, f))
    dt = np.dtype(np.asarray(level.cell_M).dtype)
    mode = _st._SOLVE_MODE
    capF, capP, capI = level.capF, level.capP, level.capI
    ncell = int(np.prod(f))
    n_ae = int(np.prod(ae_shape))
    kt = level.t2_f.shape[2]

    # ---- index plane ---- #
    cells = _sp.ae_cells(ae_shape, f)                 # (n_ae, ncell)
    faces, nu_int_sl = _sp.ae_faces(ae_shape, f)      # (n_ae, nslots)
    cm, nu_dofs, nbd, slot_facet6 = _colmap(f, capF, capI)
    nslots = faces.shape[1]
    fch = _sp.facet_children(ae_shape, f)
    fnbr = _sp.facet_neighbors(ae_shape)
    bsl = _sp.facet_bdr_slices(f)
    afacets = _sp.ae_facet_ids(ae_shape)              # (n_ae, 6)
    nu = nu_dofs + nbd * capF

    K3 = int(max_evects)
    if kcap2 is None:
        kcap2 = 2 * K3
    K2 = int(kcap2)
    capFp = 1 + K2
    k_ext = 6 * capFp
    capPp = 1 + K3
    capIp = K3 + kt

    # ---- device masks ---- #
    qm = jnp.asarray((np.arange(capF)[None, :]
                      < level.facet_n[:, None]).astype(dt))
    wm = jnp.asarray((np.arange(capP)[None, :]
                      < level.cell_pn[:, None]).astype(dt))
    um = jnp.asarray(level.un_mask_np().astype(dt))

    def build_u_act(qm_sl, um_c):
        """AE-layout u activity from the gathered facet/cell masks:
        layout [interior facet blocks | cell interiors | boundary
        facet blocks] is contiguous in exactly this order."""
        n = qm_sl.shape[0]
        return jnp.concatenate([
            qm_sl[:, :nu_int_sl].reshape(n, -1),
            um_c.reshape(n, -1),
            qm_sl[:, nu_int_sl:].reshape(n, -1)], axis=1)

    ns_parts = []
    ns_by_stage = {}
    chunk_big = max(64, min(chunk, int(3.0e8 / max(
        4 * nu * nu * dt.itemsize, 1))))
    svd_eff = float(max(svd_tol, 200.0 * np.finfo(dt).eps))

    def run(name, fn, spec, n, ch=None, stage_mode=None):
        outs, ns = _st._run_stage_chunked(
            f"spsml_{name}_{f}_{capF}_{capP}_{capI}_{K2}_{K3}", fn,
            spec, n, ch or chunk, stage_mode or mode)
        ns_parts.append(ns)
        ns_by_stage[name] = ns
        return outs

    # ---- stage A: per-AE block spectral eigenproblems ---- #
    bdr_faces = faces[:, nu_int_sl:]

    def specfn(mch, bch, wch, qbdr, wm_c, qm_sl, um_c):
        u_act = build_u_act(qm_sl, um_c)
        return _spectral_stage_blk(
            mch, bch, wch, qbdr, wm_c, qm_sl[:, nu_int_sl:],
            u_act, cm, nu_dofs, nbd, capF, float(spect_tol), K3)

    Vk, nkeepA = run(
        f"spec_{spect_tol}", specfn,
        [("g", level.cell_M, cells), ("g", level.cell_B, cells),
         ("g", level.cell_W, cells), ("g", level.facet_Q, bdr_faces),
         ("g", wm, cells), ("g", qm, faces), ("g", um, cells)],
        n_ae, ch=chunk_big)
    npl = ncell * capP
    l2_tars = Vk[:, :npl]                     # (n_ae, npl, K3)
    mu = Vk[:, npl:]                          # (n_ae, nbd*capF, K3)

    # ---- stage T3: L2 traces with the spectral L2 targets ---- #
    def t3fn(wch, wm_c, tars):
        n = wch.shape[0]
        pv = jnp.zeros((n, ncell * capP), dtype=wch.dtype
                       ).at[:, ::capP].set(1.0)
        return _trace_stage_blk(wch, pv, tars,
                                wm_c, svd_eff, K3)

    F3, U3, nk3, dots3 = run(
        f"t3_{svd_eff}", t3fn,
        [("g", level.cell_W, cells), ("g", wm, cells),
         ("d", l2_tars)], n_ae)

    # ---- stage T2 per family: facet traces + coarse facet mass + the
    #      bubble-target facet functionals ---- #
    fam_out = []
    for a in range(3):
        ids = fch[a]                          # (nfa, nch)
        nbrs = fnbr[a]
        s_left, s_right, nch = bsl[a]
        dl, dr = s_left * capF, s_right * capF
        w = nch * capF
        lidx = np.where(nbrs[:, 0] >= 0, nbrs[:, 0], 0)
        ridx = np.where(nbrs[:, 1] >= 0, nbrs[:, 1], 0)
        lmask = jnp.asarray((nbrs[:, 0] >= 0).astype(dt))
        rmask = jnp.asarray((nbrs[:, 1] >= 0).astype(dt))

        def t2fam(Qb, pvch, t2ch, muL, muR, lm, rm, qm_ch,
                  _dl=dl, _dr=dr, _w=w):
            n, nch_, cF = pvch.shape
            nd = nch_ * cF
            TL = muL[:, _dl:_dl + _w] * lm[:, None, None]
            TR = muR[:, _dr:_dr + _w] * rm[:, None, None]
            T = jnp.concatenate([TL, TR], axis=2)
            F2, U2, nk2, dots2 = _trace_stage_blk(
                Qb, pvch.reshape(n, nd), T, qm_ch, svd_eff, K2)
            # coarse facet mass + bubble-target functionals through
            # the SAME prolongation columns the materialization emits
            Pf = jnp.concatenate(
                [pvch.reshape(n, nd, 1), U2], axis=2)   # (n, nd, capFp)
            mPf = (Qb @ (Pf * qm_ch.reshape(n, nd)[:, :, None]
                         ).reshape(n, nch_, cF, -1)).reshape(
                n, nd, -1) * qm_ch.reshape(n, nd)[:, :, None]
            Qp = Pf.transpose(0, 2, 1) @ mPf
            colm = (jnp.arange(capFp)[None, :]
                    < (1 + nk2)[:, None]).astype(Qp.dtype)
            Qp = Qp * colm[:, :, None] * colm[:, None, :] + (
                (1.0 - colm)[:, :, None]
                * jnp.eye(capFp, dtype=Qp.dtype)[None]
                * (1.0 - colm)[:, None, :])
            t2flat = t2ch.reshape(n, nd, -1)
            rhsT = mPf.transpose(0, 2, 1) @ t2flat
            coefF = _st._solve_batch(Qp, rhsT) * colm[:, :, None]
            return F2, U2, nk2, dots2, Qp, coefF

        outs = run(f"t2{a}_{svd_eff}", t2fam,
                   [("g", level.facet_Q, ids), ("g", level.pv_f, ids),
                    ("g", level.t2_f, ids),
                    ("g", mu, lidx), ("g", mu, ridx),
                    ("g", lmask, np.arange(len(ids))),
                    ("g", rmask, np.arange(len(ids))),
                    ("g", qm, ids)], len(ids))
        fam_out.append(outs)

    nfacets = [len(fch[a]) for a in range(3)]
    facet_off = np.concatenate([[0], np.cumsum(nfacets)])
    nk2_all = np.empty(int(facet_off[-1]), dtype=np.int64)
    for a in range(3):
        nk2_all[facet_off[a]:facet_off[a + 1]] = np.asarray(
            fam_out[a][2])

    # per-AE boundary views: PV values and kept-mode rows per slot dof
    u2_fam = [np.asarray(fam_out[a][1], dtype=dt) for a in range(3)]
    pvf_np = np.asarray(level.pv_f, dtype=dt)
    nbdofs = nbd * capF
    ptr_bdr = pvf_np[bdr_faces].reshape(n_ae, nbdofs)
    pb_slot = np.zeros((n_ae, nbdofs, K2), dtype=dt)
    for j in range(6):
        a, side = j // 2, j % 2
        loc = afacets[:, j] - facet_off[a]
        s_left, s_right, nch = bsl[a]
        # bsl offsets are RELATIVE to the boundary start already
        d0 = (s_left if side == 1 else s_right) * capF
        pb_slot[:, d0:d0 + nch * capF, :] = u2_fam[a][loc]

    # ---- stage E2 + Galerkin: extension and next-level emission ---- #
    tol_n = (max(svd_tol, 1e-3) if mode == "ns"
             else max(svd_tol, 200.0 * float(np.finfo(dt).eps)))
    coefF_all = jnp.concatenate(
        [fam_out[a][5] for a in range(3)], axis=0)    # (nf, capFp, kt)

    def extfn(mch, bch, wch, ptr_b, pb_s, t2f_sl, t2i_c, u3_c, nk3_c,
              coefF_ae, qm_sl, um_c, wm_c):
        n = mch.shape[0]
        u_act = build_u_act(qm_sl, um_c)
        t2_loc = jnp.concatenate([
            t2f_sl[:, :nu_int_sl].reshape(n, -1, kt),
            t2i_c.reshape(n, -1, kt),
            t2f_sl[:, nu_int_sl:].reshape(n, -1, kt)], axis=1)
        Pint, bubU, n_null, M, B, Pb = _extension_stage_blk(
            mch, bch, wch, cm, nu_dofs, nbd, capF,
            ptr_b, pb_s, slot_facet6, t2_loc, u3_c, u_act, wm_c,
            tol_n)
        # ---- next-level Galerkin blocks ---- #
        capUp = k_ext + K3 + kt
        P_loc = jnp.zeros((n, nu, capUp), dtype=mch.dtype)
        P_loc = P_loc.at[:, :nu_dofs, :k_ext + K3].set(Pint)
        P_loc = P_loc.at[:, :nu_dofs, k_ext + K3:].set(bubU)
        P_loc = P_loc.at[:, nu_dofs:, :k_ext].set(Pb)
        MP = M @ P_loc
        cellMp = P_loc.transpose(0, 2, 1) @ MP
        pv_p = jnp.zeros((n, ncell * capP, 1), dtype=mch.dtype
                         ).at[:, ::capP, 0].set(1.0)
        P3_loc = jnp.concatenate([pv_p, u3_c], axis=2)
        cellBp = P3_loc.transpose(0, 2, 1) @ (B @ P_loc)
        Wblk = jnp.zeros((n, ncell * capP, ncell * capP),
                         dtype=mch.dtype)
        rw = (np.arange(ncell)[:, None] * capP
              + np.arange(capP)[None, :])
        Wblk = Wblk.at[:, rw[:, :, None], rw[:, None, :]].set(wch)
        cellWp = P3_loc.transpose(0, 2, 1) @ (Wblk @ P3_loc)
        # ---- bubble-target interior projection (cochain Π) ---- #
        r = t2_loc - P_loc[:, :, :k_ext] @ coefF_ae.reshape(
            n, k_ext, kt)
        P_i = P_loc[:, :nu_dofs, k_ext:]
        MiPi = M[:, :nu_dofs, :nu_dofs] @ P_i
        G = P_i.transpose(0, 2, 1) @ MiPi
        colm = jnp.concatenate([
            (jnp.arange(K3)[None, :] < nk3_c[:, None]),
            (jnp.arange(kt)[None, :] < n_null[:, None])],
            axis=1).astype(mch.dtype)
        G = G * colm[:, :, None] * colm[:, None, :] + (
            (1.0 - colm)[:, :, None]
            * jnp.eye(K3 + kt, dtype=mch.dtype)[None]
            * (1.0 - colm)[:, None, :])
        coef_i = _st._solve_batch(
            G, MiPi.transpose(0, 2, 1) @ r[:, :nu_dofs]) \
            * colm[:, :, None]
        return Pint, bubU, n_null, cellMp, cellBp, cellWp, coef_i

    Pint, bubU, n_null, cellMp, cellBp, cellWp, t2_i_p = run(
        f"ext_{tol_n}", extfn,
        [("g", level.cell_M, cells), ("g", level.cell_B, cells),
         ("g", level.cell_W, cells),
         ("g", jnp.asarray(ptr_bdr), np.arange(n_ae)),
         ("g", jnp.asarray(pb_slot), np.arange(n_ae)),
         ("g", level.t2_f, faces), ("g", level.t2_i, cells),
         ("d", U3), ("d", nk3),
         ("g", coefF_all, afacets),
         ("g", qm, faces), ("g", um, cells), ("g", wm, cells)],
        n_ae, ch=chunk_big)

    ns_res = float(jnp.max(jnp.stack(ns_parts))) if ns_parts else 0.0
    for k, v in ns_by_stage.items():
        tol = _sp._EXT_GUARD_TOL if k.startswith("ext") else \
            _st._NS_GUARD_TOL
        assert float(v) < tol, (
            float(v), f"block stage {k} solve did not converge",
            {kk: float(vv) for kk, vv in ns_by_stage.items()})

    # ---- host materialization + next level ---- #
    P2, P3 = _materialize(level, ae_shape, f, fch, facet_off, faces,
                          nu_int_sl, cells, afacets, fam_out, nk2_all,
                          np.asarray(nk3, np.int64),
                          np.asarray(n_null, np.int64),
                          np.asarray(U3, np.float64),
                          np.asarray(Pint, np.float64),
                          np.asarray(bubU, np.float64),
                          capFp, K2, K3, kt)

    Qp_all = jnp.concatenate([fam_out[a][4] for a in range(3)], axis=0)
    pvfp = jnp.zeros((int(facet_off[-1]), capFp), dtype=dt
                     ).at[:, 0].set(1.0)
    nxt = BlockLevel(
        cshape=ae_shape, capF=capFp, capP=capPp, capI=capIp, capRT=K3,
        cell_M=cellMp, cell_B=cellBp, cell_W=cellWp, facet_Q=Qp_all,
        pv_f=pvfp, t2_f=coefF_all, t2_i=t2_i_p,
        facet_n=1 + nk2_all, cell_pn=1 + np.asarray(nk3, np.int64),
        cell_rt_n=np.asarray(nk3, np.int64),
        cell_null_n=np.asarray(n_null, np.int64), h=level.h)
    return BlockLevelOut(P2=P2, P3=P3, next_level=nxt, ns_res=ns_res)


def _materialize(level, ae_shape, f, fch, facet_off, faces, nu_int_sl,
                 cells, afacets, fam_out, nk2, nk3, n_null, U3np,
                 Pintnp, bubnp, capFp, K2, K3, kt):
    """Host CSR P2/P3 in the level's compressed dof numbering (facet
    dofs by facet, then cell interior dofs), masked columns dropped —
    the block generalization of the one-step engine's array-op
    materialization."""
    import scipy.sparse as sp

    capF, capP, capI = level.capF, level.capP, level.capI
    capRT = level.capRT
    fo, io, ndofs_u = level.u_offsets()
    po, ndofs_p = level.p_offsets()
    n_ae, ncell = cells.shape
    fn = level.facet_n
    pn = level.cell_pn
    rtn, nun = level.cell_rt_n, level.cell_null_n

    # new dof offsets
    u_off_f = np.concatenate([[0], np.cumsum(1 + nk2)])
    n_facet_dofs = int(u_off_f[-1])
    u_off_i = (n_facet_dofs
               + np.concatenate([[0], np.cumsum(nk3 + n_null)]))
    n_u_coarse = int(u_off_i[-1])
    p_off = np.concatenate([[0], np.cumsum(1 + nk3)])
    n_p_coarse = int(p_off[-1])

    rows2, cols2, vals2 = [], [], []
    # ---- facet trace blocks ---- #
    pvf_np = np.asarray(level.pv_f, dtype=np.float64)
    for a in range(3):
        ids = fch[a]                                   # (nfa, nch)
        nfa, nch = ids.shape
        nd = nch * capF
        base = facet_off[a]
        U2 = np.asarray(fam_out[a][1], dtype=np.float64)
        Pf = np.concatenate(
            [pvf_np[ids].reshape(nfa, nd, 1), U2], axis=2)
        # row dof ids + validity per (child slot)
        rid = (fo[ids][:, :, None]
               + np.arange(capF)[None, None, :]).reshape(nfa, nd)
        rok = (np.arange(capF)[None, None, :]
               < fn[ids][:, :, None]).reshape(nfa, nd)
        cok = (np.arange(capFp)[None, :] < (1 + nk2[base:base + nfa]
                                            )[:, None])   # (nfa, capFp)
        jf, rr, kk = np.nonzero(rok[:, :, None] & cok[:, None, :])
        rows2.append(rid[jf, rr])
        cols2.append(u_off_f[base + jf] + kk)
        vals2.append(Pf[jf, rr, kk])

    # ---- interior rows ---- #
    # AE-local interior dof ids + validity, layout [int facet blocks |
    # cell interior blocks]
    int_faces = faces[:, :nu_int_sl]
    rid_f = (fo[int_faces][:, :, None]
             + np.arange(capF)[None, None, :]).reshape(n_ae, -1)
    rok_f = (np.arange(capF)[None, None, :]
             < fn[int_faces][:, :, None]).reshape(n_ae, -1)
    # cell interiors: compressed id = io[c] + (k for rt slot k,
    # rtn[c] + k for null slot k)
    slot_in = np.arange(capI)
    off_in = np.where(slot_in[None, None, :] < capRT,
                      slot_in[None, None, :],
                      rtn[cells][:, :, None]
                      + (slot_in[None, None, :] - capRT))
    rid_c = (io[cells][:, :, None] + off_in).reshape(n_ae, -1)
    rok_c = np.where(
        slot_in[None, None, :] < capRT,
        slot_in[None, None, :] < rtn[cells][:, :, None],
        (slot_in[None, None, :] - capRT)
        < nun[cells][:, :, None]).reshape(n_ae, -1)
    rid_all = np.concatenate([rid_f, rid_c], axis=1)   # (n_ae, nu_dofs)
    rok_all = np.concatenate([rok_f, rok_c], axis=1)

    k_ext = 6 * capFp
    # ext columns: (j, k) -> new facet afacets[:, j] dof k
    gfc = afacets                                      # (n_ae, 6)
    ext_cols = (u_off_f[gfc][:, :, None]
                + np.arange(capFp)[None, None, :]).reshape(n_ae, -1)
    ext_cok = (np.arange(capFp)[None, None, :]
               < (1 + nk2)[gfc][:, :, None]).reshape(n_ae, -1)
    ia, rr, cc = np.nonzero(rok_all[:, :, None]
                            & ext_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(ext_cols[ia, cc])
    vals2.append(Pintnp[ia, rr, cc])
    # rt columns
    rt_cok = np.arange(K3)[None, :] < nk3[:, None]
    ia, rr, cc = np.nonzero(rok_all[:, :, None] & rt_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(u_off_i[ia] + cc)
    vals2.append(Pintnp[ia, rr, k_ext + cc])
    # null columns
    nl_cok = np.arange(kt)[None, :] < n_null[:, None]
    ia, rr, cc = np.nonzero(rok_all[:, :, None] & nl_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(u_off_i[ia] + nk3[ia] + cc)
    vals2.append(bubnp[ia, rr, cc])

    P2 = sp.coo_matrix(
        (np.concatenate(vals2),
         (np.concatenate(rows2), np.concatenate(cols2))),
        shape=(ndofs_u, n_u_coarse)).tocsr()

    # ---- P3 ---- #
    rid_p = (po[cells][:, :, None]
             + np.arange(capP)[None, None, :]).reshape(n_ae, -1)
    rok_p = (np.arange(capP)[None, None, :]
             < pn[cells][:, :, None]).reshape(n_ae, -1)
    pv_p = np.zeros((n_ae, ncell * capP, 1))
    pv_p[:, ::capP, 0] = 1.0
    P3_loc = np.concatenate([pv_p, U3np], axis=2)      # (n, npl, 1+K3)
    p_cok = np.arange(1 + K3)[None, :] < (1 + nk3)[:, None]
    ia, rr, cc = np.nonzero(rok_p[:, :, None] & p_cok[:, None, :])
    rows3 = rid_p[ia, rr]
    cols3 = p_off[ia] + cc
    vals3 = P3_loc[ia, rr, cc]
    P3 = sp.coo_matrix((vals3, (rows3, cols3)),
                       shape=(ndofs_p, n_p_coarse)).tocsr()
    return P2, P3


def spectral_coarsen_darcy_chain(shape, factors, coeff, h=None,
                                 l2_weight=None, spect_tol=0.002,
                                 max_evects=5, svd_tol=1e-9,
                                 kcap2=None, dtype=np.float64,
                                 chunk=8192):
    """Multilevel spectral Hdiv-L2 coarsening: `factors` is a list of
    per-axis factor triples, one per coarsening step (reference:
    recursive Coarsen() with per-level spectral targets,
    DeRhamSequence.cpp:572-692).  Returns (levels, outs): the
    BlockLevel chain and the per-step BlockLevelOut (host CSR P2/P3 in
    each level's compressed numbering)."""
    lvl = fine_block_level(shape, coeff, h=h, l2_weight=l2_weight,
                           dtype=dtype)
    levels, outs = [lvl], []
    for f in factors:
        out = coarsen_block_level(lvl, tuple(f), spect_tol=spect_tol,
                                  max_evects=max_evects,
                                  svd_tol=svd_tol, kcap2=kcap2,
                                  chunk=chunk)
        outs.append(out)
        lvl = out.next_level
        levels.append(lvl)
    return levels, outs


def _ext_saddle_solve_ns_blk(M_ii, B_ii, T, p_act, rhs, nu_int, npl,
                             refine=4):
    """Block-eliminated ns-mode solve of the generalized extension
    saddle (mirrors _sp._ext_saddle_solve_ns with block p rows and
    inactive-p padding)."""
    n = M_ii.shape[0]
    dt = M_ii.dtype
    Xm = _sp._ns_spd_inverse(M_ii)
    BX = B_ii @ Xm
    S = BX @ B_ii.transpose(0, 2, 1)
    nb = npl + 1
    Ab = jnp.zeros((n, nb, nb), dtype=dt)
    Ab = Ab.at[:, :npl, :npl].set(-S)
    Ab = Ab.at[:, :npl, -1].set(T)
    Ab = Ab.at[:, -1, :npl].set(T)
    eye = jnp.eye(nb, dtype=dt)[None]
    pd = jnp.zeros((n, nb), dtype=dt).at[:, :npl].set(1.0 - p_act)
    Ab = Ab - pd[:, :, None] * eye      # -S padding keeps sign pattern

    def _lu(ab_rb):
        a, r = ab_rb
        return jnp.linalg.solve(a, r)

    def solve_once(R):
        ru = R[:, :nu_int]
        rp = R[:, nu_int:nu_int + npl]
        rl = R[:, -1:]
        rb = jnp.concatenate([rp - BX @ ru, rl], axis=1)
        Yb = jax.lax.map(_lu, (Ab, rb), batch_size=64)
        p = Yb[:, :npl] * p_act[:, :, None]
        u = Xm @ (ru - B_ii.transpose(0, 2, 1) @ p)
        lam = Yb[:, -1:]
        return jnp.concatenate([u, p, lam], axis=1)

    def apply_A(Y):
        u = Y[:, :nu_int]
        p = Y[:, nu_int:nu_int + npl]
        lam = Y[:, -1:]
        top = M_ii @ u + B_ii.transpose(0, 2, 1) @ p
        mid = (B_ii @ u + T[:, :, None] * lam) * p_act[:, :, None]
        bot = jnp.einsum("bi,bik->bk", T, p)[:, None, :]
        return jnp.concatenate([top, mid, bot], axis=1)

    rhs = rhs.at[:, nu_int:nu_int + npl].multiply(p_act[:, :, None])
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
