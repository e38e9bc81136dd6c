"""DeRhamSequence: the AMGe coarsening engine.

Rebuild of reference src/amge/DeRhamSequence.{hpp,cpp} (the heart of ParElag).
A sequence holds, per level, the four spaces of the 3D de Rham complex
H1 -> H(curl) -> H(div) -> L2 with derivative operators D[j], local mass
matrices M[(codim, j)], targets, and — after coarsen() — the interpolators
P[j], cochain projectors Pi[j] and the coarse sequence with coarse D/M.

coarsen() (reference DeRhamSequence::Coarsen, DeRhamSequence.cpp:572-692)
runs per form, L2 first, H1 last:

  1. _compute_coarse_traces  (.cpp:1521-2086): per agglomerated trace entity,
     deflate targets against the PV trace in the local mass inner product,
     M-weighted SVD, threshold sigma >= ||pv||_M^2 * svd_tol -> coarse trace
     dofs; the PV dof is RangeT-type, the rest NullSpace.
  2. _h_facet_extension      (.cpp:2169-2589): per codim_dom agglomerate,
     harmonic extension of all boundary coarse dofs through the saddle system
       [M  B^T 0 ; B 0 T^T ; 0 T 0]   (B = W D, T = (W pv_loc)^T)
     building coarse-D rows from the Lagrange multiplier; RangeT "bubble"
     dofs whose derivative equals the jform+1 interior NullSpace basis;
     NullSpace dofs from divergence-corrected target extensions (plain SVD,
     absolute threshold).
  3. _h_ridge_peak_extension (.cpp:2589-3050): same at lower codims with the
     regularized system [M B^T; B -C], C = (D_{j+1})^T W2 D_{j+1} restricted
     (div-div regularization, Lashuk-Vassilevski (6.43)), and the coarse-
     derivative compatibility term W * (P_{j+1} D_c) on the right-hand side.

The per-AE dense factorizations and SVDs are the setup-phase hot loops; they
are batched over agglomerates (bucketed + padded + vmapped on device) by
parelag_tpu.ops.batched in the accelerated path.
"""

import numpy as np
import scipy.sparse as sp
import scipy.linalg

from parelag_tpu.ops import csr as C
from parelag_tpu.amge.dofhandler import DofHandlerALG
from parelag_tpu.amge.dofagg import DofAgglomeration
from parelag_tpu.amge.localmass import (
    LocalMass, assemble_agglomerate_blocks)
from parelag_tpu.amge.cochain import CochainProjector
_EPS = np.finfo(np.float64).eps


class DeRhamSequence:
    # accumulating coarsening log stream (the reference's static
    # DeRhamSequence_os, DeRhamSequence.hpp:499; PV/NullSpace dof counts
    # appended per coarse-dof stage, DeRhamSequence.cpp:2080-2083).
    # Bounded: long-lived processes would otherwise grow it forever.
    # Each entry carries a monotone sequence number so readers can slice
    # with log_mark()/log_since() without being invalidated by trims.
    log_stream = []
    _LOG_CAP = 4096
    _log_seq = 0

    @classmethod
    def _log(cls, line):
        cls.log_stream.append((cls._log_seq, line))
        cls._log_seq += 1
        if len(cls.log_stream) > cls._LOG_CAP:
            del cls.log_stream[:-cls._LOG_CAP // 2]

    @classmethod
    def log_mark(cls):
        """Monotone bookmark; pass to log_since to read newer lines."""
        return cls._log_seq

    @classmethod
    def log_since(cls, mark):
        """Lines appended after `mark` (trim-safe, oldest first)."""
        return [line for seq, line in cls.log_stream if seq >= mark]

    def __init__(self, topo, nforms):
        self.topo = topo
        self.nforms = nforms
        self.dim = topo.dim
        self.dof = [None] * nforms
        self.D = [None] * (nforms - 1)
        self.M = {}
        self.targets = [None] * nforms
        self.pv_traces = [None] * nforms
        self.svd_tol = 1e-9
        self.jform_start = 0
        self.P = [None] * nforms
        self.Pi = [None] * nforms
        self.coarser = None
        self.finer = None
        self.dofagg = [None] * nforms
        self.L2_const_rep = None
        # per-AE dense solve execution: 'host' (scipy loop), 'device'
        # (bucketed vmapped batches), or 'auto'
        self.solve_backend = "auto"
        # (codim, jform) -> per-AE (n_ae_dofs, k) local target arrays in
        # DofAgglomeration closure-dof order (LocalTargets_ analog,
        # DeRhamSequence.hpp:614-727)
        self.local_targets = {}
        # per-coarsen cache of agglomerate-assembled local mass blocks
        # keyed (codim, jform) — each is reused by 2-3 stages
        self._ae_blocks_cache = {}

    def _svd_tol_eff(self, dt):
        """SVD keep-threshold floored at the working precision: an f32
        pipeline's deflation residuals sit at ~eps_f32, so the f64
        default 1e-9 would keep pure roundoff modes as coarse dofs."""
        return max(self.svd_tol, 50.0 * float(np.finfo(dt).eps))

    def _ae_blocks(self, codim, jform):
        hit = self._ae_blocks_cache.get((codim, jform))
        if hit is None:
            from parelag_tpu.utils.timing import TimeManager
            with TimeManager.add_timer("coarsen: ae_blocks assemble"):
                hit = assemble_agglomerate_blocks(
                    self.M[(codim, jform)],
                    self.topo.AEntity_entity[codim],
                    self.dofagg[jform], codim)
            self._ae_blocks_cache[(codim, jform)] = hit
        return hit

    # ------------------------------------------------------------------ #
    def cast_setup(self, dtype):
        """Cast the setup-phase data (local masses, derivative operators,
        targets) to `dtype` and return self.

        cast_setup(np.float32) switches the whole coarsening engine to an
        f32 pipeline — every extraction, agglomerate assembly, saddle
        solve and scatter then streams half the bytes (the setup phase is
        host-memory-bound). Appropriate when
        the solve phase runs f32/bf16 anyway (the flagship bench);
        golden/invariant work keeps the f64 default (check_invariants
        tolerances assume f64)."""
        dtype = np.dtype(dtype)
        for k, lm in list(self.M.items()):
            dc, do, bc, bo = lm.concatenated()
            if bc.dtype != dtype:
                self.M[k] = LocalMass.from_cat(
                    dc, do, bc.astype(dtype), bo)
        for j, Dj in enumerate(self.D):
            if Dj is not None and Dj.dtype != dtype:
                self.D[j] = sp.csr_matrix(Dj).astype(dtype)
        for j, t in enumerate(self.targets):
            if t is not None and t.dtype != dtype:
                self.targets[j] = t.astype(dtype)
        self._ae_blocks_cache.clear()
        return self

    @property
    def setup_dtype(self):
        for lm in self.M.values():
            cat = getattr(lm, "_cat", None)
            if cat is not None:
                return cat[2].dtype
        return np.dtype(np.float64)

    def set_targets(self, targets):
        self.targets = [np.asarray(t) if t is not None else None
                        for t in targets]

    def agglomerate_dofs(self):
        """Build DofAgglomerations for all active forms
        (DeRhamSequence::AgglomerateDofs, DeRhamSequence.cpp:98-110)."""
        for j in range(self.jform_start, self.nforms):
            if self.dofagg[j] is None:
                self.dofagg[j] = DofAgglomeration(self.topo, self.dof[j])

    def set_local_targets(self, codim, jform, local_list):
        """Per-AE local targets at (codim, jform); each entry is a
        (n_ae_closure_dofs, k) array in DofAgglomeration dof order
        (SetLocalTargets/OwnLocalTargets, DeRhamSequence.cpp:112-174)."""
        self.agglomerate_dofs()
        ae_dofs = self.dofagg[jform].ae_dofs(codim)
        assert len(local_list) == len(ae_dofs)
        for t, d in zip(local_list, ae_dofs):
            assert t.shape[0] == d.size
        self.local_targets[(codim, jform)] = [
            np.asarray(t) for t in local_list]

    def populate_local_targets_from_form(self, jform):
        """Restrict agglomerated-element local targets to lower codims, add
        derivative targets for jform+1, restrict those too
        (PopulateLocalTargetsFromForm + populateLowerCodims +
        targetDerivativesInForm, DeRhamSequence.cpp:185-560; serial
        restriction — the distributed version adds the owner-gather/
        broadcast protocol of SharedEntityCommunication)."""
        self._populate_lower_codims(jform)
        if jform + 1 < self.nforms and (0, jform) in self.local_targets:
            # derivative targets: AE-local D @ targets
            src = self.local_targets[(0, jform)]
            uagg, pagg = self.dofagg[jform], self.dofagg[jform + 1]
            D = self.D[jform].tocsr()
            out = []
            for iae, t in enumerate(src):
                u_all = uagg.ae_dofs(0)[iae]
                p_all = pagg.ae_dofs(0)[iae]
                Dloc = C.extract_submatrix(D, p_all, u_all)
                out.append(Dloc @ t)
            self.set_local_targets(0, jform + 1, out)
            self._populate_lower_codims(jform + 1)

    def _populate_lower_codims(self, jform):
        if (0, jform) not in self.local_targets:
            return
        src = self.local_targets[(0, jform)]
        agg = self.dofagg[jform]
        max_codim = self.dof[jform].max_codim
        # position map: global dof -> row in each AE's local target
        for codim in range(1, max_codim + 1):
            ent_AE = C.pattern(
                self.topo.coarser.connectivity(0, codim)).T.tocsr()
            ae_dofs0 = agg.ae_dofs(0)
            out = []
            for ient in range(ent_AE.shape[0]):
                ed = agg.ae_dofs(codim)[ient]
                aes = ent_AE.indices[
                    ent_AE.indptr[ient]:ent_AE.indptr[ient + 1]]
                cols = []
                for ae in aes:
                    pos = {int(d): i for i, d in enumerate(ae_dofs0[ae])}
                    idx = np.array([pos[int(d)] for d in ed])
                    cols.append(src[ae][idx, :])
                out.append(np.concatenate(cols, axis=1) if cols
                           else np.zeros((ed.size, 0)))
            self.set_local_targets(codim, jform, out)

    def compute_mass_operator(self, jform, elem_scaling=None) \
            -> sp.csr_matrix:
        """Assembled mass of `jform`; elem_scaling (n_elements,) scales
        each element's local block before assembly (the reference's
        ComputeMassOperator(jform, elemMatrixScaling) overload,
        DeRhamSequence.cpp:1326-1371)."""
        lm = self.M[(0, jform)]
        if elem_scaling is None:
            return lm.assemble_global(self.dof[jform].ndofs)
        dof_cat, dof_off, blk_cat, blk_off = lm.concatenated()
        s = np.asarray(elem_scaling, dtype=np.float64)
        assert s.size == dof_off.size - 1, \
            (s.size, "elemMatrixScaling has the wrong size")
        scaled = blk_cat * np.repeat(s, np.diff(blk_off))
        return LocalMass.from_cat(dof_cat, dof_off, scaled, blk_off) \
            .assemble_global(self.dof[jform].ndofs)

    def compute_lumped_mass_operator(self, jform, elem_scaling=None) \
            -> sp.csr_matrix:
        """Diagonal lumped mass (ComputeLumpedMassOperator,
        DeRhamSequence.cpp:1285-1323 and the SpectralLumpedIntegrator
        recipe, bilinIntegrators.hpp:211-236): per element,
        S = D^{-1/2} M_loc D^{-1/2} with D = diag(M_loc), and the
        lumped diagonal accumulates lambda_min(S) * diag(M_loc) — a
        spectrally-safe lumping (x^T L x <= x^T M x elementwise).  The
        top form's mass is already diagonal and returned as-is."""
        n = self.dof[jform].ndofs
        if jform == self.nforms - 1:
            return self.compute_mass_operator(jform, elem_scaling)
        from parelag_tpu.ops import ragged as Rg
        dof_cat, dof_off, blk_cat, blk_off = \
            self.M[(0, jform)].concatenated()
        sizes = np.diff(dof_off)
        s = (np.ones(sizes.size) if elem_scaling is None
             else np.asarray(elem_scaling, dtype=np.float64))
        out = np.zeros(n)
        ar = np.arange
        for k, ii in Rg.group_by(np.asarray(sizes, np.int64)).items():
            k = int(k)
            B = blk_cat[blk_off[ii][:, None]
                        + ar(k * k)].reshape(-1, k, k).astype(np.float64)
            d = np.einsum("bii->bi", B)
            S = B / np.sqrt(d[:, :, None] * d[:, None, :])
            lmin = np.linalg.eigvalsh(S)[:, 0]
            dofs = dof_cat[dof_off[ii][:, None] + ar(k)]
            np.add.at(out, dofs.ravel(),
                      (s[ii, None] * lmin[:, None] * d).ravel())
        return sp.diags(out).tocsr()

    def compute_space_interpolation_error(self, jform, fine_vector):
        """Project finest-level vector(s) down to THIS level through
        the cochain projectors, interpolate back up through P, and
        return the finest-level relative errors
        (ComputeSpaceInterpolationError, DeRhamSequence.cpp:972-1062):
        dict with 'l2_rel' (k,) = ||v - P..Pi..v||_M / ||v||_M and,
        below the top form, 'energy_rel' (k,) with the ||D(.)||_W term
        folded in exactly as the reference prints."""
        seq = self
        while seq.finer is not None:
            seq = seq.finer
        chain = []
        s = seq
        while s is not self:
            chain.append(s)
            s = s.coarser
            assert s is not None, \
                "receiver is not a coarsening of the finest sequence"
        V = np.asarray(fine_vector, dtype=np.float64)
        V = V.reshape(V.shape[0], -1)
        X = V
        for sq in chain:
            X = sq.Pi[jform].project(X)
        for sq in reversed(chain):
            X = sq.P[jform] @ X
        diff = X - V
        Mg = seq.compute_mass_operator(jform)
        l2d = np.einsum("ik,ik->k", diff, Mg @ diff)
        l2v = np.einsum("ik,ik->k", V, Mg @ V)
        out = {"l2_rel": np.sqrt(l2d / np.where(l2v > 0, l2v, 1.0))}
        if jform < self.nforms - 1:
            Wg = seq.compute_mass_operator(jform + 1)
            dd = seq.D[jform] @ diff
            dv = seq.D[jform] @ V
            ed = np.einsum("ik,ik->k", dd, Wg @ dd)
            ev = np.einsum("ik,ik->k", dv, Wg @ dv)
            ev = np.where(np.abs(l2v + ev) < 1e-14, 1.0, ev)
            out["energy_rel"] = np.sqrt((l2d + ed) / (l2v + ev))
        return out

    def compute_pv_traces(self, codim) -> np.ndarray:
        """Algebraic (coarse-level) version: +-orientation at the PV dof of
        each member entity (DeRhamSequenceAlg::computePVTraces,
        DeRhamSequence.cpp:3235). Overridden by DeRhamSequenceFE."""
        jform = self.nforms - 1 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocoo()
        first = self.dof[jform].interior_offsets[codim][AE_e.col]
        pv[first] = AE_e.data
        return pv

    # ------------------------------------------------------------------ #
    def coarsen(self, svd_tol=None) -> "DeRhamSequence":
        if svd_tol is not None:
            self.svd_tol = svd_tol
        assert self.topo.coarser is not None, \
            "call topo.coarsen_local_partitioning first"
        coarse = DeRhamSequence(self.topo.coarser, self.nforms)
        coarse.finer = self
        coarse.jform_start = self.jform_start
        coarse.svd_tol = self.svd_tol
        self.coarser = coarse

        self.agglomerate_dofs()

        for codim in range(self.nforms):
            jform = self.nforms - codim - 1
            if jform < self.jform_start:
                break
            cdof = DofHandlerALG(jform, self.topo.coarser)
            coarse.dof[jform] = cdof
            self._P_builder = C.coo_builder()
            self._P_ncols = 0
            self._P_nrows = self.dof[jform].ndofs
            self._P_snapshot = sp.csr_matrix((self._P_nrows, 0))
            self._P_pieces = []          # per-stage snapshot deltas
            self._P_chunk_mark = 0
            self.Pi[jform] = CochainProjector(cdof, self.dofagg[jform])

            from parelag_tpu.utils.timing import TimeManager as _TM
            with _TM.add_timer("coarsen: traces"):
                self._compute_coarse_traces(jform)

            if codim > 0:
                self._D_builder = C.coo_builder()
                self._extension(jform, self.nforms - jform - 2,
                                use_lagrange=True)
                if codim > 1:
                    self._extension(jform, self.nforms - jform - 3,
                                    use_lagrange=False, with_nulls=True)
                    if codim > 2:
                        self._extension(jform, self.nforms - jform - 4,
                                        use_lagrange=False, with_nulls=False)
                coarse.D[jform] = self._D_builder.tocsr(
                    (coarse.dof[jform + 1].ndofs, cdof.ndofs))

            # evict agglomerate-block cache rows that no later stage can
            # read: jform j-1's extensions reach at most form j+1, and
            # _repair_curl_range at most form j+1 — (c, j+2) is dead.
            # Peak RSS is a first-order cost on the deployment hosts
            # (fresh backing beyond the host's fast pool is ~50x slow,
            # DESIGN.md), so dead GB-scale caches are not kept.
            for key in [k for k in self._ae_blocks_cache
                        if k[1] >= jform + 2]:
                del self._ae_blocks_cache[key]

            self._refresh_P(final=True)
            self.P[jform] = self._P_snapshot
            assert self.P[jform].shape[1] == cdof.ndofs
            # the builder's chunk arrays (every X basis block written this
            # form) and the per-stage pieces are dead once P is final
            self._P_builder = None
            self._P_pieces = []
            with _TM.add_timer("coarsen: cochain projector"):
                self.Pi[jform].compute_projector(self.P[jform])

            # coarsening-stats stream (PV/NullSpace dof counts,
            # DeRhamSequence.cpp:2080-2083)
            for cd in sorted(cdof.n_ranget):
                DeRhamSequence._log(
                    f"form {jform} codim {cd}: "
                    f"{cdof.n_ranget[cd].size} entities, "
                    f"RangeT dofs {int(cdof.n_ranget[cd].sum())}, "
                    f"NullSpace dofs {int(cdof.n_null[cd].sum())}")
            DeRhamSequence._log(
                f"form {jform}: coarse ndofs {cdof.ndofs} "
                f"(fine {self.dof[jform].ndofs})")

            if (jform == self.nforms - 3 and jform + 1 < self.nforms
                    and getattr(self.topo, "had_pinch_repair", False)):
                # after the Hcurl-class stage: enrich coarse Hdiv with any
                # curl components the pinched topology left uncovered
                # (regular MIS topology never needs this — gated on the
                # pinch-repair flag to skip the global commuting check)
                self._repair_curl_range(jform)

        # coarsen targets and the L2 constant representation
        for j in range(self.jform_start, self.nforms):
            if self.targets[j] is not None:
                coarse.targets[j] = self.Pi[j].project(self.targets[j])
        if self.L2_const_rep is not None:
            coarse.L2_const_rep = self.Pi[self.nforms - 1].project(
                self.L2_const_rep[:, None])[:, 0]
        self._ae_blocks_cache.clear()
        return coarse

    # ------------------------------------------------------------------ #
    # stage 1: coarse traces
    # ------------------------------------------------------------------ #
    def _compute_coarse_traces(self, jform):
        codim = self.dim - jform
        cdof = self.coarser.dof[jform]
        cdof.init_codim(codim)
        pv = self.compute_pv_traces(codim)
        self.pv_traces[jform] = pv

        if jform == 0:
            self._compute_0form_traces(cdof, pv)
            return

        dofagg = self.dofagg[jform]
        n_ae = dofagg.ae_dofs_cat(codim)[1].size - 1
        Md_blocks = self._ae_blocks(codim, jform)
        dt = Md_blocks.cat.dtype if hasattr(Md_blocks, "cat") \
            else np.float64
        pv = pv.astype(dt, copy=False)

        targets = self.targets[jform]
        n_targets = targets.shape[1] if targets is not None else 0
        loc_tars = self.local_targets.get((codim, jform))

        # gather pass: deflated target blocks per AE, then ONE stacked
        # LAPACK call per shape group for the M-weighted SVDs; everything
        # group-stacked end to end — no per-AE Python work at all (the
        # per-item scatter lists dominated flagship-scale coarsening)
        from parelag_tpu.ops import ragged as Rg
        from parelag_tpu.ops.batched import weighted_svd_group
        dof_cat, dof_off = dofagg.ae_dofs_cat(codim)
        sizes = np.diff(dof_off)
        ltws = (np.fromiter((t.shape[1] for t in loc_tars),
                            np.int64, n_ae)
                if loc_tars is not None else np.zeros(n_ae, np.int64))
        pv_dots = np.zeros(n_ae)
        nkeeps = np.zeros(n_ae, dtype=np.int64)
        gdata = []
        for (nd, _ltw), ii in Rg.group_by(
                np.stack([sizes, ltws], axis=1)).items():
            dof_st = dof_cat[dof_off[ii][:, None]
                             + np.arange(nd, dtype=np.int64)]  # (m, nd)
            Mst = Rg.take(Md_blocks, ii, (nd, nd))             # (m, nd, nd)
            pv_st = pv[dof_st]                                # (m, nd)
            T_st = (targets[dof_st, :].astype(dt) if n_targets
                    else np.zeros((ii.size, nd, 0), dtype=dt))
            if loc_tars is not None:
                T_st = np.concatenate(
                    [T_st, np.stack([loc_tars[i] for i in ii])], axis=2)
            pv_m = np.einsum("bij,bj->bi", Mst, pv_st)
            dots = np.einsum("bi,bi->b", pv_st, pv_m)
            if T_st.shape[2]:
                coef = np.einsum("bi,bik->bk", pv_m, T_st) / dots[:, None]
                T_st = T_st - pv_st[:, :, None] * coef[:, None, :]
            U_st, s_st = weighted_svd_group(Mst, T_st)
            pv_dots[ii] = dots
            nkeeps[ii] = (s_st > dots[:, None]
                          * self._svd_tol_eff(dt)).sum(axis=1)
            gdata.append((ii, dof_st, Mst, pv_st, U_st))

        col_off = Rg.sizes_to_offsets(nkeeps + 1)
        counter = int(col_off[-1])
        cdof.n_ranget[codim][:] = 1
        cdof.n_null[codim][:] = nkeeps

        # emission pass: P entries, cochain functionals and coarse local
        # mass blocks, one stacked write per (shape, kept-count) subgroup
        nlocs = nkeeps + 1
        blk_off = Rg.sizes_to_offsets(nlocs * nlocs)
        blk_cat = np.zeros(int(blk_off[-1]), dtype=dt)
        ar = np.arange
        for ii, dof_st, Mst, pv_st, U_st in gdata:
            nd = dof_st.shape[1]
            for nk, sel in Rg.group_by(nkeeps[ii]).items():
                jj = ii[sel]
                ms = jj.size
                scale = np.sqrt(pv_dots[jj]).astype(dt)
                p_st = np.concatenate(
                    [pv_st[sel][:, :, None],
                     scale[:, None, None] * U_st[sel][:, :, :nk]], axis=2)
                Mp = Mst[sel] @ p_st
                cm = np.einsum("bij,bik->bjk", p_st, Mp)
                cm = 0.5 * (cm + cm.transpose(0, 2, 1))
                nloc = nk + 1
                cols = (col_off[jj][:, None]
                        + ar(nloc, dtype=np.int64))
                self._P_builder.add_blocks_var(
                    dof_st[sel].ravel(),
                    ar(ms + 1, dtype=np.int64) * nd,
                    cols.ravel(), ar(ms + 1, dtype=np.int64) * nloc,
                    p_st.ravel())
                self.Pi[jform].add_functionals_group(
                    codim, jj, p_st, Mst[sel])
                blk_cat[blk_off[jj][:, None]
                        + ar(nloc * nloc, dtype=np.int64)] = \
                    cm.reshape(ms, -1)

        cdof.finalize_codim(codim)
        self._P_ncols = counter
        self._refresh_P()
        ccat, coff = Rg.ranges_cat(col_off[:-1], col_off[1:])
        self.coarser.M[(codim, jform)] = LocalMass.from_cat(
            ccat, coff, blk_cat, blk_off)

    def _compute_0form_traces(self, cdof, pv):
        """Vertex picks (Compute0formCoarseTraces, DeRhamSequence.cpp:1521).
        Fully vectorized: one identity-pick scatter and one grouped unit
        functional for all coarse vertices (the per-vertex Python loop
        dominated flagship-scale coarsening)."""
        codim = self.dim
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        n_ae = AE_e.shape[0]
        assert np.all(np.diff(AE_e.indptr) == 1), \
            "agglomerated peak with != 1 vertex (topology error)"
        verts = AE_e.indices.astype(np.int64)
        ar = np.arange(n_ae, dtype=np.int64)
        dt = self.setup_dtype
        self._P_builder.add_entries(verts, ar, np.ones(n_ae, dtype=dt))
        cdof.n_ranget[codim][:] = 1
        self.Pi[0].add_functionals_group(
            codim, ar, np.ones((n_ae, 1, 1), dtype=dt),
            np.ones((n_ae, 1, 1), dtype=dt))
        cdof.finalize_codim(codim)
        self._P_ncols = n_ae
        self._refresh_P()
        self.coarser.M[(codim, 0)] = LocalMass.from_cat(
            ar, np.arange(n_ae + 1, dtype=np.int64),
            np.ones(n_ae, dtype=dt), np.arange(n_ae + 1, dtype=np.int64))

    def _refresh_P(self, final=False):
        """Publish the P entries written so far for the next stage.

        Native path: stages only APPEND rows (each fine dof is interior
        to exactly one entity), so instead of merging a full CSR snapshot
        per stage — O(total nnz) every refresh — each stage publishes its
        delta as an extra row-disjoint full-height piece and extraction
        runs against the piece family (extract_blocks_cat_multi). The
        full matrix is materialized once per jform (final=True)."""
        from parelag_tpu.ops import native
        shape = (self._P_nrows, self._P_ncols)
        if native.available() and not final:
            chunks = self._P_builder.chunks
            if len(chunks) > self._P_chunk_mark:
                self._P_pieces.append(
                    native.chunks_tocsr(chunks[self._P_chunk_mark:],
                                        shape))
                self._P_chunk_mark = len(chunks)
            self._P_snapshot = None
        else:
            self._P_snapshot = self._P_builder.tocsr(shape)

    # ------------------------------------------------------------------ #
    # stages 2+3: harmonic extensions
    # ------------------------------------------------------------------ #
    def _extension(self, jform, codim_dom, use_lagrange, with_nulls=True):
        """Extend the coarse space of `jform` into the interiors of
        agglomerated entities of codim_dom.

        use_lagrange=True  -> hFacetExtension system with PV Lagrange
                              multiplier; coarse-D rows from the multiplier.
        use_lagrange=False -> hRidgePeakExtension system [M B^T; B -C] with
                              the W*(P_{j+1} D_c) compatibility term;
                              with_nulls chooses the hRidge (target nulls)
                              vs hPeak (no nulls) variant.
        """
        cdof = self.coarser.dof[jform]
        pdof = self.coarser.dof[jform + 1]
        cdof.init_codim(codim_dom)

        uagg = self.dofagg[jform]
        pagg = self.dofagg[jform + 1]
        Md = self._ae_blocks(codim_dom, jform)
        Wd = self._ae_blocks(codim_dom, jform + 1)
        D = self.D[jform].tocsr()
        Pp = self.P[jform + 1]
        targets = self.targets[jform]
        n_targets = targets.shape[1] if targets is not None else 0
        loc_tars = self.local_targets.get((codim_dom, jform))

        if not use_lagrange:
            # coarse-derivative image in the fine jform+1 space
            Dc = self._D_builder.tocsr(
                (pdof.ndofs, self._P_ncols))
            PDc = (Pp[:, :pdof.ndofs] @ Dc).tocsr()
            D2 = self.D[jform + 1].tocsr()
            w2agg = self.dofagg[jform + 2]
            # deliberately NOT memoized: each (codim, jform+2) block
            # family is used by exactly this one stage, and holding all
            # of them across a form's stages costs ~1 GB of peak RSS
            # (first-order on the deployment hosts, DESIGN.md)
            from parelag_tpu.utils.timing import TimeManager as _TM2
            with _TM2.add_timer("coarsen: ae_blocks assemble"):
                W2d = assemble_agglomerate_blocks(
                    self.M[(codim_dom, jform + 2)],
                    self.topo.AEntity_entity[codim_dom],
                    self.dofagg[jform + 2], codim_dom)

        n_ae = len(Md)
        counter = self._P_ncols
        # setup dtype flows from the local mass blocks: an f32 sequence
        # (seq.cast_setup(np.float32)) runs the whole extension pipeline
        # in f32 — half the streamed bytes on the host-bound setup path
        dt = Md.cat.dtype if hasattr(Md, "cat") else np.float64

        # ---- pass 0 (host): batched extraction of all per-AE blocks, all
        # index families built as flat (cat, off) arrays — no Python loops - #
        from parelag_tpu.ops import ragged as Rg
        from parelag_tpu.utils.timing import TimeManager as _TM
        _w = _TM.get_timer("coarsen: ext pass0 extract")
        _w.start()
        nu_ints = uagg.n_interior(codim_dom)
        np_ints = pagg.n_interior(codim_dom)
        u_cat, u_off = uagg.ae_dofs_cat(codim_dom)
        p_cat, p_off = pagg.ae_dofs_cat(codim_dom)
        ubi, ub_off = Rg.ranges_cat(u_off[:-1] + nu_ints, u_off[1:])
        ub_cat = u_cat[ubi]                          # boundary u dofs
        pii, pi_off = Rg.ranges_cat(p_off[:-1], p_off[:-1] + np_ints)
        pi_cat = p_cat[pii]                          # interior p dofs
        cb_cat, cb_off = cdof.dofs_on_bdr_cat(codim_dom)
        pn_cat, pn_off = pdof.null_dofs_cat(codim_dom)
        from parelag_tpu.ops import native as _nat0
        if _nat0.available() and hasattr(Wd, "cat"):
            # B = W[:np_int,:] @ Dloc computed straight from the fine D
            # CSR — the dense per-AE D blocks (the largest extraction
            # output of this stage) are never materialized
            Bs = _nat0.wd_blocks(D, p_cat, p_off, u_cat, u_off,
                                 np_ints, Wd, C._col_scratch(D.shape[1]))
            Dlocs = None
        else:
            Bs = None
            Dlocs = C.extract_blocks_cat(D, p_cat, p_off, u_cat, u_off)
        Pbs = (C.extract_blocks_cat(
                   self._P_snapshot, ub_cat, ub_off, cb_cat, cb_off)
               if self._P_snapshot is not None
               else C.extract_blocks_cat_multi(
                   self._P_pieces, ub_cat, ub_off, cb_cat, cb_off,
                   dtype=dt))
        cPs = C.extract_blocks_cat(Pp, pi_cat, pi_off, pn_cat, pn_off)
        if use_lagrange:
            pv_cat, pv_off = pdof.ranget_dofs_cat(codim_dom)
            assert np.all(np.diff(pv_off) == 1), \
                "expected exactly one RangeT (PV) dof per domain entity"
            ploc_pvs = C.extract_blocks_cat(
                Pp, pi_cat, pi_off, pv_cat, pv_off)
        else:
            e2_cat, e2_off = w2agg.ae_dofs_cat(codim_dom)
            D2locs = C.extract_blocks_cat(D2, e2_cat, e2_off, p_cat, p_off)
            dPcs = C.extract_blocks_cat(PDc, p_cat, p_off, cb_cat, cb_off)

        _w.stop()
        _w = _TM.get_timer("coarsen: ext pass1 assemble")
        _w.start()
        # ---- pass 1 (host): batched per-AE system/rhs assembly, grouped by
        # shape signature — on quasi-uniform agglomerations a handful of
        # groups cover thousands of AEs, so every dense op below is one
        # stacked numpy/BLAS call per group instead of per agglomerate ----- #
        u_sizes = np.diff(u_off)
        p_sizes = np.diff(p_off)
        cb_sizes = np.diff(cb_off)
        pn_sizes = np.diff(pn_off)
        lt_sizes = (np.fromiter((t.shape[1] for t in loc_tars),
                                np.int64, n_ae)
                    if loc_tars is not None else np.zeros(n_ae, np.int64))
        e2_sizes = (np.zeros(n_ae, np.int64) if use_lagrange
                    else np.diff(e2_off))
        sigs = np.stack([
            np.asarray(u_sizes, np.int64), np.asarray(nu_ints, np.int64),
            np.asarray(p_sizes, np.int64), np.asarray(np_ints, np.int64),
            np.asarray(cb_sizes, np.int64), np.asarray(pn_sizes, np.int64),
            np.asarray(lt_sizes, np.int64), np.asarray(e2_sizes, np.int64),
        ], axis=1)
        groups = []
        _tg = _TM.get_timer("coarsen: ext p1 gather+gemm")
        _ts = _TM.get_timer("coarsen: ext p1 system")
        _tr = _TM.get_timer("coarsen: ext p1 rhs")
        for sig, idxs in Rg.group_by(sigs).items():
            nu_all, nu_int, np_all, np_int, k_ext, n_rt_raw, ltw, ne2 = (
                int(v) for v in sig)
            m = len(idxs)
            _tg.start()
            Mst = Rg.take(Md, idxs, (nu_all, nu_all))
            Wst = Rg.take(Wd, idxs, (np_all, np_all))
            if Bs is not None:
                Bst = Rg.take(Bs, idxs, (np_int, nu_all))
            else:
                Dst = Rg.take(Dlocs, idxs, (np_all, nu_all))
                # only the first np_int rows of B = W D are ever used
                Bst = Wst[:, :np_int, :] @ Dst       # (m, p_int, u_all)
            M_ii = Mst[:, :nu_int, :nu_int]
            M_ib = Mst[:, :nu_int, nu_int:]
            B_ii = Bst[:, :, :nu_int]
            B_ib = Bst[:, :, nu_int:]
            W_ii = Wst[:, :np_int, :np_int]
            _tg.stop()

            # ---- local systems ---- #
            _ts.start()
            Tst = None
            if use_lagrange:
                ploc_pv = Rg.take(ploc_pvs, idxs,
                                  (np_int, 1)).reshape(m, np_int)
                Tst = np.einsum("bij,bj->bi", W_ii, ploc_pv)
                nsys = nu_int + np_int + 1
                # np.empty + explicit zeroing of only the untouched
                # blocks (p-p and the u/multiplier corners): a full
                # zeros pass over the group stack is host-phase-
                # sensitive (DESIGN.md)
                A = np.empty((m, nsys, nsys), dtype=dt)
                A[:, nu_int:, nu_int:] = 0.0
                A[:, :nu_int, -1] = 0.0
                A[:, -1, :nu_int] = 0.0
                A[:, :nu_int, :nu_int] = M_ii
                A[:, nu_int:nu_int + np_int, :nu_int] = B_ii
                A[:, :nu_int, nu_int:nu_int + np_int] = \
                    B_ii.transpose(0, 2, 1)
                A[:, -1, nu_int:nu_int + np_int] = Tst
                A[:, nu_int:nu_int + np_int, -1] = Tst
            else:
                D2st = Rg.take(D2locs, idxs, (ne2, np_all))
                W2st = Rg.take(W2d, idxs, (ne2, ne2))
                D2i = D2st[:, :, :np_int]
                Cst = np.einsum("bki,bkl,blj->bij", D2i, W2st, D2i,
                                optimize=True)
                nsys = nu_int + np_int
                # every block of A is written below -> np.empty
                A = np.empty((m, nsys, nsys), dtype=dt)
                A[:, :nu_int, :nu_int] = M_ii
                A[:, nu_int:, :nu_int] = B_ii
                A[:, :nu_int, nu_int:] = B_ii.transpose(0, 2, 1)
                A[:, nu_int:, nu_int:] = -Cst
            # reference semantics: the Lagrange system is always factored
            # (FacetSaddlePoint ctor); the [M B^T; B -C] system only when
            # there are interior u dofs (RidgePeakSaddlePoint + the
            # GetLocalOffsets(1) != 0 guards in hRidgePeakExtension).
            # A Lagrange system with empty u interior is singular (the p-p
            # block is zero); the multiplier is then determined directly by
            # T lambda = rhs_p in pass 3 (degenerate case from pinched
            # separators — the reference aborts here)
            do_solve = nu_int > 0 and nsys > 0
            _ts.stop()

            # ---- rhs blocks: [trace ext | RangeT bubbles | Null targets] - #
            _tr.start()
            Pbst = Rg.take(Pbs, idxs, (nu_all - nu_int, k_ext))
            rhs_ext = np.empty((m, nsys, k_ext), dtype=dt)
            rhs_ext[:, nu_int + np_int:] = 0.0   # Lagrange rows only
            rhs_ext[:, :nu_int] = -(M_ib @ Pbst)
            rhs_ext[:, nu_int:nu_int + np_int] = -(B_ib @ Pbst)
            if not use_lagrange:
                rhs_ext[:, nu_int:nu_int + np_int] += \
                    Wst[:, :np_int, :] @ Rg.take(dPcs, idxs,
                                                 (np_all, k_ext))

            # pinched entity (empty u interior): no interior dofs can carry
            # the RangeT bubble — create none, instead of the reference's
            # implicit zero column (its sharedvertex lanes fail outright,
            # testsuite CMakeLists.txt:94-109)
            n_rt = n_rt_raw if nu_int > 0 else 0
            rhs_rt = np.zeros((m, nsys, n_rt), dtype=dt)
            if n_rt:
                rhs_rt[:, nu_int:nu_int + np_int] = \
                    W_ii @ Rg.take(cPs, idxs, (np_int, n_rt_raw))

            n_tars_ae = n_targets + ltw
            u_st = u_cat[u_off[np.asarray(idxs)][:, None]
                         + np.arange(nu_all, dtype=np.int64)]
            if with_nulls and nu_int > n_rt and n_tars_ae:
                t_int = (targets[u_st[:, :nu_int], :].astype(dt)
                         if n_targets
                         else np.zeros((m, nu_int, 0), dtype=dt))
                t_bdr = (targets[u_st[:, nu_int:], :].astype(dt)
                         if n_targets
                         else np.zeros((m, nu_all - nu_int, 0), dtype=dt))
                if ltw:
                    # local target rows follow the interior-first AE order
                    # (PartitionLocalTargets, DeRhamSequence.cpp:2087-2112)
                    lt_st = np.stack([loc_tars[i] for i in idxs])
                    t_int = np.concatenate([t_int, lt_st[:, :nu_int]],
                                           axis=2)
                    t_bdr = np.concatenate([t_bdr, lt_st[:, nu_int:]],
                                           axis=2)
                rhs_null = np.zeros((m, nsys, n_tars_ae), dtype=dt)
                rhs_null[:, :nu_int] = -(M_ib @ t_bdr)
                rhs_null[:, nu_int:nu_int + np_int] = B_ii @ t_int
                k_null = n_tars_ae
            else:
                t_int = np.zeros((m, nu_int, 0), dtype=dt)
                rhs_null = np.zeros((m, nsys, 0), dtype=dt)
                k_null = 0

            _tr.stop()
            rhs = np.concatenate([rhs_ext, rhs_rt, rhs_null], axis=2)
            groups.append(dict(
                idxs=np.asarray(idxs, dtype=np.int64), m=m,
                nu_all=nu_all, nu_int=nu_int, np_int=np_int,
                k_ext=k_ext, n_rt=n_rt, k_null=k_null, nsys=nsys,
                A=A, rhs=rhs, t_int=t_int, Mst=Mst, Pbst=Pbst,
                Tst=(Tst if use_lagrange else None),
                do_solve=do_solve))

        _w.stop()
        _w = _TM.get_timer("coarsen: ext pass2 solve")
        _w.start()
        # ---- pass 2 (device): one batched solve per shape group --------- #
        from parelag_tpu.ops.batched import solve_groups
        Xs = solve_groups([g["A"] for g in groups],
                          [g["rhs"] for g in groups],
                          backend=self.solve_backend,
                          skip=[not g["do_solve"] for g in groups])

        # null-bubble SVDs: one stacked call per group; per-AE kept counts
        n_nulls = np.zeros(n_ae, dtype=np.int64)
        n_rts = np.zeros(n_ae, dtype=np.int64)
        for g, X in zip(groups, Xs):
            g["X"] = X
            n_rts[g["idxs"]] = g["n_rt"]
            if g["k_null"]:
                nu, c0 = g["nu_int"], g["k_ext"] + g["n_rt"]
                bub = g["t_int"] - X[:, :nu, c0:]
                U, sv, _ = np.linalg.svd(bub, full_matrices=False)
                g["bubU"] = U
                # device extension solves are f32-grade with an
                # iterative-refinement floor ~1e-4..1e-5 of the data
                # scale — the null threshold must clear that noise or
                # near-duplicate junk modes make the cochain Gram
                # singular (seen at 110k-element bench scale)
                tol_n = (max(self.svd_tol, 1e-3)
                         if self.solve_backend == "device"
                         else self._svd_tol_eff(dt))
                n_nulls[g["idxs"]] = np.sum(sv > tol_n, axis=1)

        _w.stop()
        _w = _TM.get_timer("coarsen: ext pass3 scatter")
        _w.start()
        # ---- pass 3 (host): group-level scatter into P, coarse D, Pi, and
        # the coarse mass — zero per-agglomerate Python work -------------- #
        aoff = Rg.sizes_to_offsets(n_rts + n_nulls) + counter
        counter = int(aoff[-1])
        cdof.n_ranget[codim_dom][:] = n_rts
        cdof.n_null[codim_dom][:] = n_nulls

        # coarse mass flat layout: dofs = [cbdr | rt cols | null cols]
        rtc = Rg.ranges_cat(aoff[:-1], aoff[:-1] + n_rts)
        nlc = Rg.ranges_cat(aoff[:-1] + n_rts, aoff[1:])
        mass_cat, mass_off = Rg.merge_ragged([(cb_cat, cb_off), rtc, nlc])
        nlocs = np.diff(mass_off)
        blk_off = Rg.sizes_to_offsets(nlocs * nlocs)
        # np.empty: every AE's full (nloc x nloc) block is written by
        # exactly one subgroup below (native gram kernel or the numpy
        # fallback's full-block fancy write)
        blk_cat = np.empty(int(blk_off[-1]), dtype=dt)

        ar = np.arange
        _tb = _TM.get_timer("coarsen: ext p3 builders")
        _tm = _TM.get_timer("coarsen: ext p3 gram")
        _tc = _TM.get_timer("coarsen: ext p3 cochain")
        for g in groups:
            idxs, X = g["idxs"], g["X"]
            m, nu_all, nu = g["m"], g["nu_all"], g["nu_int"]
            k_ext, n_rt, k_null = g["k_ext"], g["n_rt"], g["k_null"]
            u_int_st = u_cat[u_off[idxs][:, None] + ar(nu, dtype=np.int64)]
            cb_st = cb_cat[cb_off[idxs][:, None] + ar(k_ext,
                                                      dtype=np.int64)]
            if use_lagrange:
                if g["do_solve"]:
                    lam = X[:, -1, :k_ext]
                else:
                    # degenerate Lagrange (empty u interior): p-rows read
                    # T lambda = rhs_p, so lambda = (T . rhs_p) / (T . T)
                    T = g["Tst"]
                    rhs_p = g["rhs"][:, nu:nu + g["np_int"], :k_ext]
                    tt = np.einsum("bi,bi->b", T, T)
                    lam = np.einsum("bi,bik->bk", T, rhs_p) \
                        / np.where(tt > 0, tt, 1.0)[:, None]
                dvals = np.where(np.abs(lam) > _EPS, -lam, 0.0)
                pv_st = pv_cat[pv_off[idxs]]         # one PV cdof per AE
                self._D_builder.add_entries(
                    np.repeat(pv_st, k_ext), cb_st.ravel(), dvals.ravel())

            uoff_m = ar(m + 1, dtype=np.int64) * nu
            _tb.start()
            self._P_builder.add_blocks_var(
                u_int_st.ravel(), uoff_m, cb_st.ravel(),
                ar(m + 1, dtype=np.int64) * k_ext,
                X[:, :nu, :k_ext].ravel())
            if n_rt:
                rt_st = aoff[idxs][:, None] + ar(n_rt, dtype=np.int64)
                self._P_builder.add_blocks_var(
                    u_int_st.ravel(), uoff_m, rt_st.ravel(),
                    ar(m + 1, dtype=np.int64) * n_rt,
                    X[:, :nu, k_ext:k_ext + n_rt].ravel())
                pn_st = pn_cat[pn_off[idxs][:, None]
                               + ar(n_rt, dtype=np.int64)]
                self._D_builder.add_entries(
                    pn_st.ravel(), rt_st.ravel(),
                    np.ones(m * n_rt, dtype=dt))
            _tb.stop()

            # subgroups by kept null count: everything uniform inside
            Mst = g["Mst"]               # carried from pass 1 (re-gather
            Pbst = g["Pbst"]             # was latency-bound at scale)
            for nn, sel in Rg.group_by(n_nulls[idxs]).items():
                nn = int(nn)
                ii = idxs[sel]
                ms = sel.size
                whole = ms == m       # single-subgroup fast path: avoid
                #                       re-copying the full group stacks
                X_s = X if whole else X[sel]
                M_s = Mst if whole else Mst[sel]
                rt_basis = X_s[:, :nu, k_ext:k_ext + n_rt]
                Un = (g["bubU"][sel, :, :nn] if nn
                      else np.zeros((ms, nu, 0), dtype=dt))
                if nn:
                    nl_st = (aoff[ii][:, None] + n_rt
                             + ar(nn, dtype=np.int64))
                    self._P_builder.add_blocks_var(
                        (u_int_st if whole else u_int_st[sel]).ravel(),
                        ar(ms + 1, dtype=np.int64) * nu,
                        nl_st.ravel(), ar(ms + 1, dtype=np.int64) * nn,
                        Un.ravel())
                # cochain functionals over interior dofs
                _tc.start()
                self.Pi[jform].add_functionals_group(
                    codim_dom, ii,
                    np.concatenate([rt_basis, Un], axis=2),
                    M_s[:, :nu, :nu])
                _tc.stop()
                # coarse mass block over [cbdr, RangeT, Null]
                _tm.start()
                nloc = k_ext + n_rt + nn
                from parelag_tpu.ops import native as _nat
                if _nat.available():
                    # fused native gram: reads X / bubU through the group
                    # stacks as views (no zero-padded basis stack, no
                    # stacked-GEMM temporaries)
                    _nat.ext_gram_blocks(
                        Mst, g["Pbst"], X, g.get("bubU") if nn else None,
                        nu, k_ext, n_rt, nn,
                        np.asarray(sel, dtype=np.int64), blk_off[ii],
                        blk_cat)
                else:
                    basis = np.zeros((ms, nu_all, nloc), dtype=dt)
                    basis[:, nu:, :k_ext] = Pbst if whole else Pbst[sel]
                    basis[:, :nu, :k_ext] = X_s[:, :nu, :k_ext]
                    basis[:, :nu, k_ext:k_ext + n_rt] = rt_basis
                    basis[:, :nu, k_ext + n_rt:] = Un
                    blk = basis.transpose(0, 2, 1) @ (M_s @ basis)
                    blk = 0.5 * (blk + blk.transpose(0, 2, 1))
                    blk_cat[blk_off[ii][:, None]
                            + ar(nloc * nloc, dtype=np.int64)] = \
                        blk.reshape(ms, -1)
                _tm.stop()

        _w.stop()
        with _TM.add_timer("coarsen: ext refresh_P"):
            cdof.finalize_codim(codim_dom)
            self._P_ncols = counter
            self._refresh_P()
        self.coarser.M[(codim_dom, jform)] = LocalMass.from_cat(
            mass_cat, mass_off, blk_cat, blk_off)

    # ------------------------------------------------------------------ #
    def _repair_curl_range(self, jform):
        """Close the commuting gap D P_j = P_{j+1} D_c at pinched topology:
        if a coarse jform basis function's derivative has a component
        outside the coarse (jform+1) space (possible only after
        pinched-separator repairs — regular MIS topology never triggers
        this; the reference has no counterpart and its shared-vertex lanes
        simply fail, ELAG-19), append the M-orthonormalized residuals as
        extra agglomerate-interior coarse dofs of form jform+1 and extend
        P, D_c, the coarse mass and the cochain projector accordingly.
        Derivative exactness is preserved: the new functions are
        derivatives, so D_{j+1} of them vanishes."""
        jp = jform + 1
        P1, P2 = self.P[jform], self.P[jp]
        D1 = self.D[jform].tocsr()
        D1c = self.coarser.D[jform].tocsr()
        R = (D1 @ P1 - P2 @ D1c).tocsc()
        scale = max(C.max_abs((D1 @ P1).tocsr()), 1.0)
        colmax = np.zeros(R.shape[1])
        for j in range(R.shape[1]):
            seg = np.abs(R.data[R.indptr[j]:R.indptr[j + 1]])
            colmax[j] = seg.max() if seg.size else 0.0
        bad_cols = np.where(colmax > 1e-9 * scale)[0]
        if bad_cols.size == 0:
            return

        uagg = self.dofagg[jp]
        # every fine (jform+1) dof is interior to exactly ONE entity at
        # its separator codim (DofAgglomeration invariant) — residuals on
        # agglomerate interiors enrich the AE (codim 0); residuals on
        # separator entities (possible when a repair entity crosses a
        # distributed patch fringe on unstructured partitions — round-2
        # VERDICT item 6) enrich THAT facet/ridge entity instead, which
        # is deterministic per entity and therefore identical on every
        # patch that shares it
        n_fine = self.dof[jp].ndofs
        max_c = min(uagg.max_codim, self.nforms - 1 - jp)
        owner = np.full(n_fine, -1, dtype=np.int64)
        owner_codim = np.full(n_fine, -1, dtype=np.int64)
        for c in range(max_c + 1):
            cat, off = uagg.ae_dofs_cat(c)
            nints = uagg.n_interior(c)
            from parelag_tpu.ops import ragged as Rg
            icat, ioff = Rg.ranges_cat(off[:-1], off[:-1] + nints)
            ents = np.repeat(np.arange(ioff.size - 1, dtype=np.int64),
                             np.diff(ioff))
            dofs = cat[icat]
            sel = owner[dofs] < 0
            owner[dofs[sel]] = ents[sel]
            owner_codim[dofs[sel]] = c

        per_ent = {}
        for j in bad_cols:
            rows = R.indices[R.indptr[j]:R.indptr[j + 1]]
            vals = R.data[R.indptr[j]:R.indptr[j + 1]]
            keep = np.abs(vals) > 1e-12 * scale
            rows, vals = rows[keep], vals[keep]
            assert (owner[rows] >= 0).all(), \
                "curl residual on a dof interior to no entity"
            keys = owner_codim[rows] * (n_fine + 1) + owner[rows]
            for key in np.unique(keys):
                sel = keys == key
                per_ent.setdefault(
                    (int(key // (n_fine + 1)), int(key % (n_fine + 1))),
                    []).append((int(j), rows[sel], vals[sel]))

        cdof2 = self.coarser.dof[jp]
        P2 = P2.tolil()
        extra_cols = []
        d_rows, d_cols, d_vals = [], [], []
        for (cent, iae), items in per_ent.items():
            u_all = uagg.ae_dofs(cent)[iae]
            nu_int = int(uagg.n_interior(cent)[iae])
            u_int = u_all[:nu_int]
            pos = {int(d): i for i, d in enumerate(u_int)}
            Bres = np.zeros((nu_int, len(items)))
            cols_of = []
            for k, (j, rows, vals) in enumerate(items):
                idx = np.array([pos[int(r)] for r in rows])
                Bres[idx, k] = vals
                cols_of.append(j)
            Mloc = self._ae_blocks(cent, jp)[iae]
            M_ii = Mloc[:nu_int, :nu_int]
            U, s = _weighted_svd_on(M_ii, Bres)
            nkeep = int(np.sum(s > 1e-12 * max(float(s[0]), 1.0))) \
                if s.size else 0
            if nkeep == 0:
                continue
            V = U[:, :nkeep].copy()                # M-orthonormal
            # deterministic sign: largest-|entry| component positive, so
            # patches sharing the entity produce the identical basis
            # (SVD sign ambiguity would otherwise flip it per patch)
            piv = np.argmax(np.abs(V), axis=0)
            V *= np.where(V[piv, np.arange(nkeep)] < 0, -1.0, 1.0)
            coeffs = V.T @ (M_ii @ Bres)           # (nkeep, n_items)
            new_ids = cdof2.append_interior_dofs(cent, iae, nkeep)
            for t, nd in enumerate(new_ids):
                for k, j in enumerate(cols_of):
                    if abs(coeffs[t, k]) > 1e-13:
                        d_rows.append(nd)
                        d_cols.append(j)
                        d_vals.append(coeffs[t, k])
            extra_cols.append((u_int, new_ids, V))
            # extend the coarse mass block of this entity: products of
            # every existing coarse dof on its closure with the new
            # functions
            lm = self.coarser.M[(cent, jp)]
            old_dofs = lm.dofs[iae]
            basis_old = np.asarray(
                P2[u_all.reshape(-1, 1), old_dofs.reshape(1, -1)].todense())
            Vfull = np.zeros((u_all.size, nkeep))
            Vfull[:nu_int] = V
            X = basis_old.T @ (Mloc @ Vfull)
            blk = lm.blocks[iae]
            lm.blocks[iae] = np.block(
                [[blk, X], [X.T, np.eye(nkeep)]])
            lm.dofs[iae] = np.concatenate([old_dofs, new_ids])
            lm._cat = None          # flat layout is stale after enrichment
            # refresh the cochain functional with the enriched interior
            # basis [old interior columns | V]
            int_cols = cdof2.interior_dofs(cent, iae)
            L = np.zeros((nu_int, int_cols.size))
            L[:, : int_cols.size - nkeep] = np.asarray(
                P2[u_int.reshape(-1, 1),
                   int_cols[: int_cols.size - nkeep].reshape(1, -1)]
                .todense())
            L[:, int_cols.size - nkeep:] = V
            self.Pi[jp].create_dof_functional(cent, iae, L, M_ii)

        if not extra_cols:
            return
        # grow P2 with the new columns
        n_new = cdof2.ndofs - P2.shape[1]
        P2 = sp.hstack(
            [P2.tocsr(),
             sp.csr_matrix((P2.shape[0], n_new))], format="lil")
        for u_int, new_ids, V in extra_cols:
            for t, nd in enumerate(new_ids):
                P2[u_int, nd] = V[:, t]
        self.P[jp] = P2.tocsr()
        # D_c rows for the new dofs; D_{jp} gets zero columns (the new
        # functions are derivatives -> derivative-free)
        D1c = sp.csr_matrix(
            (np.concatenate([D1c.tocoo().data, d_vals]),
             (np.concatenate([D1c.tocoo().row, d_rows]),
              np.concatenate([D1c.tocoo().col, d_cols]))),
            shape=(cdof2.ndofs, D1c.shape[1]))
        self.coarser.D[jform] = D1c
        if self.coarser.D[jp] is not None:
            Dup = self.coarser.D[jp].tocoo()
            self.coarser.D[jp] = sp.csr_matrix(
                (Dup.data, (Dup.row, Dup.col)),
                shape=(Dup.shape[0], cdof2.ndofs))
        self.Pi[jp].compute_projector(self.P[jp])

    # ------------------------------------------------------------------ #
    # invariants (reference DeRhamSequence::CheckInvariants,
    # DeRhamSequence.cpp:694-970)
    # ------------------------------------------------------------------ #
    def check_invariants(self, tol=1e-9):
        errs = {}
        coarse = self.coarser
        for j in range(self.jform_start, self.nforms):
            P = self.P[j]
            Pi = self.Pi[j].matrix
            # Pi P = I
            errs[f"PiP_{j}"] = C.max_abs(
                (Pi @ P - sp.identity(P.shape[1])).tocsr())
            # coarse mass = P^T M P
            Mc = coarse.compute_mass_operator(j)
            Mf = self.compute_mass_operator(j)
            errs[f"mass_{j}"] = C.max_abs((Mc - P.T @ Mf @ P).tocsr())
        for j in range(self.jform_start, self.nforms - 1):
            P = self.P[j]
            Pi1 = self.Pi[j + 1].matrix
            Dc = coarse.D[j]
            Df = self.D[j]
            # D_c = Pi_{j+1} D_f P_j (reference CheckD,
            # DeRhamSequence.cpp:754-800)
            errs[f"D_{j}"] = C.max_abs((Dc - Pi1 @ Df @ P).tocsr())
            # interpolation commutativity D_f P_j = P_{j+1} D_c
            # (reference CheckDP, DeRhamSequence.cpp:830-856)
            errs[f"DP_{j}"] = C.max_abs(
                (Df @ P - self.P[j + 1] @ Dc).tocsr())
            # exactness
            if j < self.nforms - 2:
                errs[f"DD_{j}"] = C.max_abs((coarse.D[j + 1] @ Dc).tocsr())
        bad = {k: v for k, v in errs.items() if v > tol}
        return errs, bad


def _weighted_svd_on(M, T):
    """M-weighted SVD orthonormalization (SVD_Calculator::ComputeON with
    weight, ParELAG_SVDCalculator.cpp:248-290): returns (U, s) with
    U^T M U = I and span(U[:, :k]) = dominant-k M-subspace of span(T)."""
    d = np.diag(M).copy()
    if np.count_nonzero(M - np.diag(d)) == 0:
        sc = np.sqrt(d)
        U, s, _ = np.linalg.svd(T * sc[:, None], full_matrices=False)
        return U / sc[:, None], s
    w, V = np.linalg.eigh(M)
    w = np.maximum(w, 0.0)
    X = (V * np.sqrt(w)) @ V.T
    Xinv = (V * (1.0 / np.sqrt(np.maximum(w, 1e-300)))) @ V.T
    U, s, _ = np.linalg.svd(X @ T, full_matrices=False)
    return Xinv @ U, s
