"""Hybridization of the Hdiv x L2 saddle-point problem.

Rebuild of reference src/amge/HybridHdivL2.{hpp,cpp}: break Hdiv continuity
element-by-element, enforce it back with facet Lagrange multipliers, and
eliminate the element-local blocks:

    H = sum_e C_e A_e^{-1} C_e^T,   A_e = [M_e B_e^T; B_e -w W_e]

(HybridHdivL2::AssembleHybridSystem, HybridHdivL2.cpp:74-528). A multiplier
dof is created for every Hdiv dof on an interior or boundary facet; the
constraint entry is the element-facet orientation for interior facets and +1
on the boundary (our local matrices are globally oriented, so the reference's
rdof sign bookkeeping collapses to the IsSameOrient branch). Multipliers on
natural-BC boundary facets are essential in the hybrid system with value
-rhs_u of the underlying Hdiv dof (RHSTransform, .cpp:529-614). The
element-wise elimination and recovery are embarrassingly parallel - batched
per-element dense factorizations on device in the accelerated path.

Also computes the rescaling vector (CC^T)^{-1} C B^T 1 used by the reference
hybridization solver factory for diagonal rescaling of H
(ParELAG_HybridizationSolverFactory.cpp, GetRescaling).
"""

import numpy as np
import scipy.sparse as sp
import scipy.linalg

from parelag_tpu.ops import csr as C


class HybridHdivL2:
    def __init__(self, seq, W_weight=0.0, ess_hdiv_dofs=None,
                 elem_matrix_scaling=None):
        """seq: a DeRhamSequence level (FE or algebraic) with M[(0,2)] local
        element mass blocks; W_weight: the -w W block weight."""
        self.seq = seq
        self.W_weight = W_weight
        dim = seq.dim
        self.uform, self.pform = dim - 1, dim

        topo = seq.topo
        self.topo = topo
        Wmass = seq.compute_mass_operator(self.pform)
        D = seq.D[self.uform]
        self.B = (Wmass @ D).tocsr()
        self.Wmass = Wmass

        local = seq.M[(0, self.uform)]
        elem_udofs = local.dofs              # per element Hdiv dof list
        elem_Mblocks = local.blocks
        ne = len(elem_udofs)
        nu = seq.dof[self.uform].ndofs
        npp = seq.dof[self.pform].ndofs
        self.nu, self.np = nu, npp
        elem_pdofs = seq.dof[self.pform].entity_dofs(0)
        facet_udofs = seq.dof[self.uform].entity_dofs(1)

        ess_hdiv = np.zeros(nu, dtype=bool) if ess_hdiv_dofs is None \
            else np.asarray(ess_hdiv_dofs, dtype=bool)

        # ---- facet adjacency and boundary attributes ---- #
        B0 = topo.B[0].tocsr()
        facet_nelem = np.asarray(
            C.pattern(B0).sum(axis=0)).ravel().astype(int)
        battr = topo.facet_bdr_attribute
        facet_is_bdr = np.asarray(
            C.pattern(battr).sum(axis=1)).ravel().astype(bool) \
            if battr is not None else np.zeros(len(facet_udofs), dtype=bool)

        # dof -> facet map (only for facet-supported dofs)
        from parelag_tpu.ops import ragged as Rg
        fu_cat, fu_off = Rg.lists_to_cat(facet_udofs)
        dof_facet = np.full(nu, -1, dtype=np.int64)
        dof_facet[fu_cat] = np.repeat(
            np.arange(len(facet_udofs)), np.diff(fu_off))

        # ---- multiplier dofs: one per Hdiv dof on an active facet ---- #
        active_facet = (facet_nelem == 2) | facet_is_bdr
        has_mult = np.zeros(nu, dtype=bool)
        has_mult[fu_cat[np.repeat(active_facet, np.diff(fu_off))]] = True
        self.mult_of_dof = np.full(nu, -1, dtype=np.int64)
        self.mult_of_dof[has_mult] = np.arange(has_mult.sum())
        self.dof_of_mult = np.nonzero(has_mult)[0]
        n_mult = int(has_mult.sum())
        self.n_mult = n_mult

        # essential multipliers: natural-BC boundary dofs
        dof_is_bdr = np.zeros(nu, dtype=bool)
        dof_is_bdr[fu_cat[np.repeat(facet_is_bdr, np.diff(fu_off))]] = True
        self.ess_mult = np.zeros(n_mult, dtype=bool)
        sel = dof_is_bdr & (~ess_hdiv) & has_mult
        self.ess_mult[self.mult_of_dof[sel]] = True

        # ---- per-element elimination, shape-grouped and batched ---- #
        # (the reference's per-element LDL loop, HybridHdivL2.cpp:74-528;
        # here one batched inverse per shape group — embarrassingly
        # parallel, device-ready)
        Bg = self.B
        H = C.coo_builder()
        self.elem_udofs = elem_udofs
        self.elem_pdofs = elem_pdofs
        cct_diag = np.zeros(n_mult)
        cbt1 = np.zeros(n_mult)
        l2const = seq.L2_const_rep

        ud_cat, ud_off = Rg.lists_to_cat(elem_udofs)
        pd_cat, pd_off = Rg.lists_to_cat(elem_pdofs)
        Bls = C.extract_blocks_cat(Bg, pd_cat, pd_off, ud_cat, ud_off)
        Wls = (C.extract_blocks_cat(self.Wmass, pd_cat, pd_off,
                                    pd_cat, pd_off)
               if self.W_weight != 0.0 else None)
        # element -> facet sign lookup (orientation of the element's side)
        B0coo = B0.tocoo()
        sign_of = sp.csr_matrix(
            (B0coo.data, (B0coo.row, B0coo.col)), shape=B0.shape)

        # per-element multiplier structure (flat): for each element dof,
        # its multiplier id (or -1) and constraint sign
        elem_of = np.repeat(np.arange(ne), np.diff(ud_off))
        mi_cat = self.mult_of_dof[ud_cat]
        f_cat = dof_facet[ud_cat]
        # sign: +1 on boundary dofs, else the element's B0 orientation
        s_cat = np.where(
            dof_is_bdr[ud_cat], 1.0,
            np.asarray(sign_of[elem_of, f_cat]).ravel())
        keep = mi_cat >= 0
        # local multiplier tables per element (interior-order = dof order)
        lm_counts = np.bincount(elem_of[keep], minlength=ne)
        lm_off = Rg.sizes_to_offsets(lm_counts)
        lm_cat = mi_cat[keep]
        lrow_cat = (np.arange(ud_cat.size, dtype=np.int64)
                    - np.repeat(ud_off[:-1], np.diff(ud_off)))[keep]
        ls_cat = s_cat[keep]

        self._groups = []
        ksz = np.diff(ud_off)
        msz = np.diff(pd_off)
        sig = list(zip(ksz, msz, lm_counts))
        mblk_cat, mblk_off, mb_vals, mb_voff = (None,) * 4
        for (k, m, nl), idxs in Rg.group_by(sig).items():
            k, m, nl = int(k), int(m), int(nl)
            ii = np.asarray(idxs, dtype=np.int64)
            nsys = k + m
            A = np.zeros((ii.size, nsys, nsys))
            Mst = Rg.take(elem_Mblocks, ii, (k, k))
            if elem_matrix_scaling is not None:
                Mst = Mst * np.asarray(elem_matrix_scaling)[ii, None, None]
            A[:, :k, :k] = Mst
            Bst = Rg.take(Bls, ii, (m, k))
            A[:, k:, :k] = Bst
            A[:, :k, k:] = Bst.transpose(0, 2, 1)
            if Wls is not None:
                A[:, k:, k:] = -self.W_weight * Rg.take(Wls, ii, (m, m))

            lm_st = lm_cat[lm_off[ii][:, None] + np.arange(nl)]
            lr_st = lrow_cat[lm_off[ii][:, None] + np.arange(nl)]
            ls_st = ls_cat[lm_off[ii][:, None] + np.arange(nl)]
            Cst = np.zeros((ii.size, nl, nsys))
            bidx = np.repeat(np.arange(ii.size), nl)
            Cst[bidx, np.tile(np.arange(nl), ii.size),
                lr_st.ravel()] = ls_st.ravel()

            Ainv = np.linalg.inv(A)
            AinvCT = Ainv @ Cst.transpose(0, 2, 1)
            Hloc = Cst @ AinvCT
            Hloc = 0.5 * (Hloc + Hloc.transpose(0, 2, 1))
            H.add_blocks_var(
                lm_st.ravel(), np.arange(ii.size + 1) * nl,
                lm_st.ravel(), np.arange(ii.size + 1) * nl,
                Hloc.ravel())

            # rescaling vector pieces
            np.add.at(cct_diag, lm_st.ravel(),
                      (Cst ** 2).sum(axis=2).ravel())
            one = np.zeros((ii.size, nsys))
            one[:, k:] = l2const[pd_cat[pd_off[ii][:, None]
                                        + np.arange(m)]]
            Aone = np.einsum("bij,bj->bi", A, one)
            np.add.at(cbt1, lm_st.ravel(),
                      np.einsum("blj,bj->bl", Cst, Aone).ravel())

            self._groups.append(dict(
                idxs=ii, k=k, m=m, nl=nl,
                ud=ud_cat[ud_off[ii][:, None] + np.arange(k)],
                pd=pd_cat[pd_off[ii][:, None] + np.arange(m)],
                lm=lm_st, Ainv=Ainv, AinvCT=AinvCT))

        Hcsr = H.tocsr((n_mult, n_mult), sum_duplicates=True)
        Hcsr.sum_duplicates()
        self.hybrid_system = Hcsr
        self.rescaling = cbt1 / np.where(cct_diag > 0, cct_diag, 1.0)

    # ------------------------------------------------------------------ #
    def rhs_transform(self, rhs_u, rhs_p):
        """(HybridHdivL2::RHSTransform) returns (hybrid_rhs, essential_data)
        and caches per-element A^{-1} f for recovery (batched)."""
        g = np.zeros(self.n_mult)
        ess_data = np.zeros(self.n_mult)
        sel = self.mult_of_dof >= 0
        ess_data[self.mult_of_dof[sel]] = -np.asarray(rhs_u)[sel]
        for grp in self._groups:
            k, m = grp["k"], grp["m"]
            f = np.zeros((grp["idxs"].size, k + m))
            f[:, k:] = np.asarray(rhs_p)[grp["pd"]]
            grp["Ainv_f"] = np.einsum("bij,bj->bi", grp["Ainv"], f)
            np.add.at(g, grp["lm"].ravel(),
                      np.einsum("bjl,bj->bl", grp["AinvCT"], f).ravel())
        return g, ess_data

    def recover(self, mu):
        """(HybridHdivL2::RecoverOriginalSolution) multipliers -> (u, p)."""
        u = np.zeros(self.nu)
        p = np.zeros(self.np)
        for grp in self._groups:
            k = grp["k"]
            v = (np.einsum("bjl,bl->bj", grp["AinvCT"],
                           mu[grp["lm"]]) - grp["Ainv_f"])
            u[grp["ud"]] = -v[:, :k]
            p[grp["pd"]] = -v[:, k:]
        return u, p

    # ------------------------------------------------------------------ #
    # one compiled device solver per (n_bucket, ell_bucket) for the whole
    # process: shapes are padded to power-of-two rows and multiple-of-4
    # ELL width, so multi-level/multi-size runs share compiles (whether
    # the padding pays on the H100 is not measured)
    _DEV_SOLVE = None

    @staticmethod
    def _facet_blocks(Hcsr):
        """Block-Jacobi structure over multiplier supervariables: rows
        with identical sparsity patterns are the multiplier dofs of one
        facet, and the spectral coarse multiplier systems are
        near-singular under point Jacobi but well-conditioned under
        per-facet blocks (75 vs >8000 PCG iterations at the SPE10
        30x55x21 coarse level).

        Grouping is by a vectorized multiset hash of each row's column
        set; correctness does NOT depend on the grouping (any principal
        submatrix of an SPD matrix is SPD, so the block-diagonal inverse
        is SPD for every grouping).

        Returns (perm, buckets): a row permutation putting same-size
        blocks in contiguous segments (stable — all-singleton systems
        yield the identity, preserving any banded structure), and
        [(s, T)] buckets in segment order with T = (k,) inverse diagonal
        for s == 1 or (k, s, s) dense block inverses.
        """
        n = Hcsr.shape[0]
        indptr = Hcsr.indptr
        indices = Hcsr.indices
        rl = np.diff(indptr)
        if n == 0:
            return np.zeros(0, np.int64), []
        rng = np.random.RandomState(0x5eed)
        ch = (rng.randint(0, 2 ** 62, size=n).astype(np.uint64),
              rng.randint(0, 2 ** 62, size=n).astype(np.uint64))
        starts = np.minimum(indptr[:-1], max(len(indices) - 1, 0))
        hs = []
        for c in ch:
            h = (np.add.reduceat(c[indices], starts)
                 if len(indices) else np.zeros(n, np.uint64))
            h[rl == 0] = 0
            hs.append(h)
        key = np.stack([rl.astype(np.uint64)] + hs, axis=1)
        uk, first, grp = np.unique(key, axis=0, return_index=True,
                                   return_inverse=True)
        # renumber groups by first occurrence so the permutation stays
        # close to the original (often banded) row order
        rank = np.empty(uk.shape[0], np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(uk.shape[0])
        grp = rank[grp]
        order = np.argsort(grp, kind="stable")
        gsort = grp[order]          # group id per sorted position
        firsts = np.r_[0, np.flatnonzero(np.diff(gsort)) + 1]
        pos = np.arange(n) - np.repeat(firsts, np.diff(np.r_[firsts, n]))
        gs = gsort * 64 + pos // 64  # split pathological groups past 64
        _, gs = np.unique(gs, return_inverse=True)
        sizes = np.bincount(gs)
        s_of_pos = sizes[gs]        # block size per sorted position
        # segment-contiguous permutation: blocks ascending by size,
        # original order within each size class
        seg = np.argsort(s_of_pos, kind="stable")
        perm = order[seg]
        buckets = []
        for s in np.unique(sizes):
            sel = order[s_of_pos == s]
            k = sel.size // s
            rf = sel.reshape(k, s)
            if s == 1:
                d = Hcsr.diagonal()[rf[:, 0]]
                buckets.append((1, 1.0 / np.where(d != 0, d, 1.0)))
                continue
            flat = rf.ravel()
            X = Hcsr[flat][:, flat].tocoo()   # block-diagonal + cross junk
            keep = X.row // s == X.col // s   # keep the s x s diag blocks
            B = np.zeros((k, s, s))
            B[X.row[keep] // s, X.row[keep] % s, X.col[keep] % s] = \
                X.data[keep]
            buckets.append((int(s), np.linalg.inv(B)))
        return perm, buckets

    @staticmethod
    def _facet_block_inverse(Hcsr):
        """The _facet_blocks inverse assembled as a scipy CSR matrix in
        the ORIGINAL row numbering (host PCG path and tests)."""
        n = Hcsr.shape[0]
        perm, buckets = HybridHdivL2._facet_blocks(Hcsr)
        data, ri, ci = [], [], []
        o = 0
        for s, T in buckets:
            k = T.shape[0]
            rf = perm[o:o + k * s].reshape(k, s)
            o += k * s
            if s == 1:
                data.append(T)
                ri.append(rf[:, 0])
                ci.append(rf[:, 0])
            else:
                data.append(T.ravel())
                ri.append(np.repeat(rf, s, axis=1).ravel())
                ci.append(np.tile(rf, (1, s)).ravel())
        if not data:
            return sp.identity(n, format="csr")
        Binv = sp.csr_matrix(
            (np.concatenate(data),
             (np.concatenate(ri), np.concatenate(ci))), shape=(n, n))
        Binv.sum_duplicates()
        return Binv

    def _device_setup(self, Hcsr):
        """Device-solve setup (cached per system content): the
        block-contiguous permutation, the device operator, and the SA-AMG
        hierarchy whose fine smoother is the damped facet block-Jacobi.
        The reference solves the multiplier system with PCG+BoomerAMG
        (ParELAG_HybridizationSolverFactory.cpp:135-141); SA is the
        data-parallel AMG (see solvers/sa_amg.py) and rides the jitted
        device V-cycle."""
        import jax
        import jax.numpy as jnp
        from parelag_tpu.ops.device_sparse import (
            from_scipy, to_bcsr, to_dia_ell, dia_ell_fill,
            BlockDiagInverse)
        from parelag_tpu.solvers.sa_amg import build_device_sa_hierarchy
        from parelag_tpu.solvers.smoothers import BlockJacobiSmoother
        n = Hcsr.shape[0]
        key = (n, Hcsr.nnz, hash(Hcsr.data[
            :: max(1, Hcsr.nnz // 64)].tobytes()))
        cache = getattr(self, "_dev_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1:]
        npad = 1 << max(int(np.ceil(np.log2(max(n, 1024)))), 0)
        Hp = sp.bmat(
            [[Hcsr, None],
             [None, sp.identity(npad - n, format="csr")]],
            format="csr").tocsr() if npad > n else Hcsr
        # f32 on accelerators (f64 against f32 on the H100 is not
        # measured); full f64 single sweep on CPU backends (tests,
        # goldens).  The operator and its block smoother contract with
        # precision=HIGHEST (ops/device_sparse), so f32 stays f32 on the
        # GPU instead of TF32.
        f32 = jax.default_backend() != "cpu"
        dtype = np.float32 if f32 else np.float64
        # facet-block fine smoother + block-contiguous permutation: the
        # solve runs in permuted coordinates so the block inverse applies
        # with static slices + batched einsum — zero device gathers
        perm, buckets = self._facet_blocks(Hp)
        Hq = Hp[perm][:, perm].tocsr()
        Bd = BlockDiagInverse(
            [jnp.asarray(np.asarray(T).astype(dtype)) for _, T in buckets],
            [s for s, _ in buckets])
        # damping: omega ~ 1/rho(B^{-1}A) via a short host power iteration
        # (block Jacobi is exact on blocks, so rho is ~2 and omega ~ 0.5;
        # computing it keeps the smoothed V-cycle SPD for PCG)
        Binv = self._facet_block_inverse(Hq)
        rng = np.random.RandomState(0)
        v = rng.rand(Hq.shape[0])
        rho = 1.0
        for _ in range(10):
            w = Binv @ (Hq @ v)
            rho = np.linalg.norm(w)
            if rho <= 0:
                rho = 1.0
                break
            v = w / rho
        omega = 1.0 / max(rho, 1.0)
        smoother = BlockJacobiSmoother(Bd, sweeps=1, omega=omega)
        Hier, _, _ = build_device_sa_hierarchy(
            Hq.astype(np.float64), dtype=dtype, fine_smoother=smoother)
        kmax = int(np.diff(Hq.indptr).max()) if Hq.nnz else 1
        if kmax > 48:
            # wide rows (spectral coarse levels reach kmax ~ 250): block
            # tiles gather 128-wide x blocks instead of a wide ELL
            # element gather; kb is padded to a multiple of 8 so levels
            # share compiles
            Hd = to_bcsr(Hq.astype(dtype), dtype=dtype)
            kb = Hd.col_blocks.shape[1]
            kbp = -(-kb // 8) * 8
            if kbp != kb:
                Hd.col_blocks = jnp.pad(
                    Hd.col_blocks, ((0, 0), (0, kbp - kb)))
                Hd.tiles = jnp.pad(
                    Hd.tiles, ((0, 0), (0, kbp - kb), (0, 0), (0, 0)))
        elif dia_ell_fill(Hq) >= 0.5:
            # structured-mesh multiplier systems put 95%+ of nnz on a few
            # dozen diagonals: gather-free DIA majority + narrow COO rest
            Hd = to_dia_ell(Hq.astype(dtype), dtype=dtype)
        else:
            Hd = from_scipy(Hq.astype(dtype), dtype=dtype, pad_to=4)
        self._dev_cache = (key, perm, Hd, Hier, npad, dtype, f32)
        return perm, Hd, Hier, npad, dtype, f32

    def _device_solve(self, Hcsr, gf, rtol):
        """Device multiplier solve: f32 SA-AMG-preconditioned PCG on the
        device (facet-block-Jacobi fine smoother) inside f64 host residual
        refinement (reliable-updates CG — the f32 device loop stalls near
        its dtype floor on ill-conditioned multiplier systems). Operators
        are jit ARGUMENTS; shapes are bucketed."""
        import jax
        import jax.numpy as jnp
        from parelag_tpu.solvers.cg import pcg
        n = Hcsr.shape[0]
        perm, Hd, Hier, npad, dtype, f32 = self._device_setup(Hcsr)
        if HybridHdivL2._DEV_SOLVE is None:
            @jax.jit
            def _solve(Hdev, M, b, rt):
                return pcg(lambda v: Hdev @ v, b,
                           precond=lambda r: M.cycle(r),
                           rtol=rt, atol=0.0, maxiter=2000)
            HybridHdivL2._DEV_SOLVE = _solve
        solve = HybridHdivL2._DEV_SOLVE

        H64 = Hcsr.astype(np.float64)
        x = np.zeros(n)
        total_it = 0
        nrm = np.linalg.norm(gf)
        inner_rt = max(rtol, 1e-6) if f32 else rtol   # f32 floor/sweep
        rfull = np.zeros(npad)
        dxfull = np.zeros(npad)
        for _ in range(4 if f32 else 1):
            r = gf - H64 @ x
            if np.linalg.norm(r) <= rtol * max(nrm, 1e-300):
                break
            rfull[:n] = r
            dx, info = solve(Hd, Hier,
                             jnp.asarray(rfull[perm].astype(dtype)),
                             dtype(inner_rt))
            dxfull[perm] = np.asarray(dx, dtype=np.float64)
            x = x + dxfull[:n]
            total_it += int(info[0])
        self.last_iterations = total_it
        return x

    def solve(self, rhs_u, rhs_p, solver="direct", rtol=1e-10,
              rescale=False, inner=None):
        """Full hybridized solve (the HybridizationSolver::Mult flow,
        ParELAG_HybridizationSolver.hpp:59-67).

        solver: "direct" | "cg" (facet-block-Jacobi PCG) | "amg" (SA-AMG
        preconditioned PCG — the reference's CG_PCG-AMG composition,
        CreateDarcyParameterList.hpp:60-80) | "device" (device SA-AMG PCG) |
        "auto". `inner`, if given, overrides all of them: a callable
        (Hff, gf, rtol) -> xf or (xf, iterations) on the reduced
        (rescaled) multiplier system — the library's composed named
        solver (ParELAG_HybridizationSolverFactory.cpp:135-141)."""
        import scipy.sparse.linalg as spla
        g, ess_data = self.rhs_transform(rhs_u, rhs_p)
        H = self.hybrid_system.copy()
        mu = np.zeros(self.n_mult)
        ess = self.ess_mult
        mu[ess] = ess_data[ess]
        g = g - H @ (mu * ess)
        keep = ~ess
        if keep.sum() == 0:
            return self.recover(mu)
        Hff = H[keep][:, keep].tocsc()
        gf = g[keep]
        if rescale:
            d = self.rescaling[keep]
            d = np.where(np.abs(d) > 0, d, 1.0)
            Hff = sp.diags(d) @ Hff @ sp.diags(d)
            gf = d * gf
        if solver == "auto":
            # device PCG when an accelerator is the default backend (the
            # bench's darcy lane path), host SA-AMG PCG otherwise
            solver = "amg"
            try:
                import jax
                if jax.default_backend() != "cpu":
                    solver = "device"
            except Exception:
                pass
        if inner is not None:
            out = inner(Hff.tocsr(), gf, rtol)
            xf, its = out if isinstance(out, tuple) else (out, 0)
            self.last_iterations = int(its)
        elif solver == "direct":
            xf = spla.spsolve(Hff, gf)
        elif solver == "device":
            xf = self._device_solve(Hff.tocsr(), gf, rtol)
        elif solver == "amg":
            xf = self._host_amg_solve(Hff.tocsr(), gf, rtol)
        else:
            Binv = self._facet_block_inverse(Hff.tocsr())
            M = spla.LinearOperator(Hff.shape, matvec=lambda r: Binv @ r)
            it = [0]
            xf, info = spla.cg(Hff.tocsr(), gf, M=M, rtol=rtol,
                               atol=0.0, maxiter=2000,
                               callback=lambda x: it.__setitem__(
                                   0, it[0] + 1))
            self.last_iterations = it[0]
        if rescale:
            xf = d * xf
        mu[keep] = xf
        return self.recover(mu)

    def _host_amg_solve(self, Hcsr, gf, rtol):
        """Host PCG + SA-AMG V-cycle on the multiplier system — the
        scipy-side mirror of the reference's PCG+BoomerAMG inner solve
        (near-flat iteration counts in h, vs the h-dependent one-level
        facet-block Jacobi)."""
        import scipy.sparse.linalg as spla
        from parelag_tpu.solvers.sa_amg import (
            build_sa_hierarchy, HostVCycle)
        key = (Hcsr.shape[0], Hcsr.nnz)
        cache = getattr(self, "_host_amg_cache", None)
        if cache is None or cache[0] != key:
            A_l, P_l = build_sa_hierarchy(Hcsr)
            cache = (key, HostVCycle(A_l, P_l))
            self._host_amg_cache = cache
        M = spla.LinearOperator(Hcsr.shape, matvec=cache[1])
        it = [0]
        xf, info = spla.cg(Hcsr, gf, M=M, rtol=rtol, atol=0.0,
                           maxiter=2000,
                           callback=lambda x: it.__setitem__(
                               0, it[0] + 1))
        self.last_iterations = it[0]
        return xf
