"""Host-side sparse (CSR) utilities over scipy.sparse.

Equivalent of the reference's C sparse layer and TopologyTable
helpers (reference: src/hypreExtension/*.c, src/topology/TopologyTable.cpp,
src/structures/minimalIntersectionSet.cpp, src/structures/transpose.cpp).
These run in the host setup phase; the device solve phase uses
parelag_tpu.ops.device_sparse.

Conventions: "oriented tables" are CSR matrices with +-1 entries. Pattern
(boolean) products always go through absolute values so that orientation
cancellation can never silently drop structural entries.
"""

import numpy as np
import scipy.sparse as sp


def csr(A) -> sp.csr_matrix:
    """Coerce to csr_matrix (no copy when already CSR)."""
    return A if isinstance(A, sp.csr_matrix) else sp.csr_matrix(A)


def identity_csr(n, dtype=np.float64) -> sp.csr_matrix:
    """Identity (reference: hypre_IdentityCSRMatrix, hypre_CSRFactory.c:16)."""
    return sp.identity(n, dtype=dtype, format="csr")


def diagonal_csr(d) -> sp.csr_matrix:
    """Diagonal matrix from vector (reference: hypre_DiagonalCSRMatrix)."""
    d = np.asarray(d)
    return sp.diags(d, format="csr")


def drop_zeros(A, tol=0.0) -> sp.csr_matrix:
    """Drop entries with |a_ij| <= tol (hypre_ParCSRMatrixDeleteZeros,
    deleteZeros.c:16; TopologyTable::DropSmallEntries)."""
    A = csr(A).copy()
    A.data[np.abs(A.data) <= tol] = 0.0
    A.eliminate_zeros()
    return A


def orientation_transform(A, tol=1e-10) -> sp.csr_matrix:
    """Map every entry to +-1 by sign (TopologyTable::OrientationTransform,
    TopologyTable.cpp:97-111)."""
    A = csr(A).copy()
    A.data = np.where(A.data > 0, 1.0, -1.0)
    return A


def sign_transform(A) -> sp.csr_matrix:
    """Alias used for ParCSR sign transforms
    (hypre_ParCSRDataTransformationSign.c:29)."""
    return orientation_transform(A)


def pattern(A) -> sp.csr_matrix:
    """|A| with unit entries — boolean pattern matrix (BooleanMatrix.hpp:26)."""
    A = csr(A).copy()
    A.data = np.ones_like(A.data)
    return A


def abs_csr(A) -> sp.csr_matrix:
    A = csr(A).copy()
    A.data = np.abs(A.data)
    return A


def bool_mult(A, B) -> sp.csr_matrix:
    """Pattern product |A|*|B| with unit entries — cancellation-proof
    connectivity product (hypre_ParCSRMatrixMatvecBoolInt.c:17)."""
    return pattern(abs_csr(csr(A)) @ abs_csr(csr(B)))


def mult_orientation(A, B, tol=1e-10) -> sp.csr_matrix:
    """Oriented product: C = A*B, drop |c|<=tol, then sign-transform
    (TopologyTable MultOrientation, TopologyTable.cpp:131-139)."""
    C = csr(A) @ csr(B)
    return orientation_transform(drop_zeros(C, tol))


def transpose_orientation(partition, n_parts) -> sp.csr_matrix:
    """Partition vector -> (n_parts x n) table with +1 entries; entries with
    partition[i] == -1 are skipped (transpose.hpp:29-37). Column order within
    each row is ascending."""
    partition = np.asarray(partition)
    n = partition.size
    keep = partition >= 0
    rows = partition[keep]
    cols = np.nonzero(keep)[0]
    data = np.ones(cols.size)
    return sp.csr_matrix((data, (rows, cols)), shape=(n_parts, n))


def wedge_mult(table, weights) -> np.ndarray:
    """Pattern matvec with integer weights: out[i] = sum_j |T_ij|>0 w[j]
    (TopologyTable::WedgeMult)."""
    return pattern(table) @ np.asarray(weights)


def find_minimal_intersection_sets(Z, skip_diag_less_than=0.5, tol=1e-10):
    """Group entities into minimal intersection sets.

    Z is symmetric; entity i enters a MIS iff Z_ii >= skip_diag_less_than.
    Entities i,j share a MIS iff Z_jj == Z_ii and |Z_ij| == Z_ii; the entry of
    the output entity_MIS table is Z_ij/Z_ii (+-1 relative orientation).
    (reference: findMinimalIntersectionSets, minimalIntersectionSet.cpp:44-132)

    Returns entity_MIS csr (n x n_mis) with +-1 entries.
    """
    Z = csr(Z)
    n = Z.shape[0]
    diag = Z.diagonal()
    valid = (diag - skip_diag_less_than) > -tol

    # vectorized: "i ~ j iff |Z_ij| == Z_ii == Z_jj" is an equivalence on
    # valid entities (identical membership signatures), so the MIS classes
    # are the connected components of the matching-edge graph; classes are
    # numbered by their smallest member to reproduce the sequential
    # first-touch ordering of the reference loop
    coo = Z.tocoo()
    r, c, v = coo.row, coo.col, coo.data
    m = (valid[r] & valid[c]
         & (np.abs(diag[r] - diag[c]) < tol)
         & (np.abs(np.abs(v) - diag[r]) < tol))
    r, c, v = r[m], c[m], v[m]
    G = sp.csr_matrix((np.ones(r.size), (r, c)), shape=(n, n))
    n_comp, labels = sp.csgraph.connected_components(G, directed=False)

    vidx = np.nonzero(valid)[0]
    first = np.full(n_comp, n, dtype=np.int64)
    np.minimum.at(first, labels[vidx], vidx)
    comp_ids = np.nonzero(first < n)[0]
    rank = np.full(n_comp, -1, dtype=np.int64)
    rank[comp_ids[np.argsort(first[comp_ids])]] = np.arange(comp_ids.size)
    current = comp_ids.size

    mis_of = np.full(n, -1, dtype=np.int64)
    mis_of[vidx] = rank[labels[vidx]]
    # orientation: Z[rep, j] / Z[rep, rep] from the representative's row
    orient = np.zeros(n)
    sel = r == first[labels[c]]
    orient[c[sel]] = v[sel] / diag[r[sel]]

    keep = mis_of >= 0
    rows = np.nonzero(keep)[0]
    return sp.csr_matrix(
        (orient[keep], (rows, mis_of[keep])), shape=(n, current)
    )


def minimal_intersection_sets_cols(S) -> sp.csr_matrix:
    """Group the COLUMNS of S (entities) that are equal up to one global
    sign — the linear-time equivalent of find_minimal_intersection_sets(
    S.T @ S) without forming the quadratic Gram product (whose dense
    per-group cliques dominated topology-coarsening time at scale).

    Entity signatures are the sparse columns (the AE-membership /
    bdr-attribute incidence); two entities share a MIS iff their columns are
    identical up to sign; the output entry is the relative sign w.r.t. the
    group's first (lowest-index) member. Empty columns are skipped.
    Returns entity_MIS csr (ncols x n_mis) with +-1 entries."""
    from parelag_tpu.mesh.entities import unique_rows
    S = sp.csc_matrix(S)
    S.sort_indices()
    S.sum_duplicates()
    n = S.shape[1]
    counts = np.diff(S.indptr).astype(np.int64)
    valid = counts >= 1
    vidx = np.nonzero(valid)[0]
    if vidx.size == 0:
        return sp.csr_matrix((n, 0))
    w = int(counts.max())
    cnt_v = counts[vidx]
    # padded (rows, normalized signs) signature table for valid columns
    nv = vidx.size
    rows_pad = np.full((nv, w), -1, dtype=np.int64)
    vals_pad = np.zeros((nv, w), dtype=np.int64)
    nnz_v = int(cnt_v.sum())
    col_of = np.repeat(np.arange(nv, dtype=np.int64), cnt_v)
    starts = S.indptr[vidx]
    within = (np.arange(nnz_v, dtype=np.int64)
              - np.repeat(sizes_cumsum0(cnt_v), cnt_v))
    flat = np.repeat(starts, cnt_v) + within
    rows_pad[col_of, within] = S.indices[flat]
    first_sign = np.sign(S.data[starts]).astype(np.int64)
    vals_pad[col_of, within] = (np.sign(S.data[flat]).astype(np.int64)
                                * np.repeat(first_sign, cnt_v))
    key = np.concatenate([rows_pad, vals_pad], axis=1)
    _, first, inv = unique_rows(key)
    # groups numbered by their first member (sequential first-touch order)
    rank = np.empty(first.size, dtype=np.int64)
    rank[np.argsort(first)] = np.arange(first.size)
    mis_of = rank[inv]
    orient = first_sign[first][inv] * first_sign      # o_rep * o_j
    return sp.csr_matrix(
        (orient.astype(np.float64), (vidx, mis_of)),
        shape=(n, first.size))


def sizes_cumsum0(sizes):
    """Exclusive prefix sum (offsets without the trailing total)."""
    out = np.zeros(sizes.size, dtype=np.int64)
    np.cumsum(sizes[:-1], out=out[1:])
    return out


def connected_components(partition, elem_elem, elem_attrib=None):
    """Split disconnected partitions into separate parts, drop empty parts,
    renumber contiguously (connectedComponents.hpp:22). If elem_attrib is
    given, elements of different attribute never share a component
    (material-interface preservation). Modifies nothing; returns
    (new_partition, n_parts)."""
    partition = np.asarray(partition)
    elem_elem = csr(elem_elem)
    n = partition.size
    key = partition.astype(np.int64)
    if elem_attrib is not None:
        attr = np.asarray(elem_attrib, dtype=np.int64)
        key = key * (attr.max() + 1) + attr
    # mask edges that cross partitions (or attributes)
    coo = elem_elem.tocoo()
    same = key[coo.row] == key[coo.col]
    G = sp.csr_matrix(
        (np.ones(same.sum()), (coo.row[same], coo.col[same])), shape=(n, n)
    )
    n_comp, labels = sp.csgraph.connected_components(G, directed=False)
    # renumber components ordered by (original partition id, first
    # element). Ordering by partition id FIRST keeps the AE numbering
    # aligned with ascending input ids even when those are not in
    # first-touch order (unstructured partitions) — the rank-patch
    # protocol's ae_gids/ae_rank tables assume exactly this alignment
    # (parallel/patch.py; a first-touch-only order silently misassigned
    # owners for such partitions).
    comp_first = np.full(n_comp, n, dtype=np.int64)
    np.minimum.at(comp_first, labels, np.arange(n, dtype=np.int64))
    comp_part = partition.astype(np.int64)[comp_first]
    order = np.empty(n_comp, dtype=np.int64)
    order[np.lexsort((comp_first, comp_part))] = np.arange(n_comp)
    return order[labels], n_comp


def extract_submatrix(A, rows, cols) -> np.ndarray:
    """Dense submatrix A[rows][:, cols] (SubMatrixExtraction.hpp:27-85).

    Fully vectorized gather over the raw CSR arrays — scipy's fancy indexing
    allocates intermediate sparse matrices and dominates setup profiles."""
    A = csr(A)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.zeros((rows.size, cols.size))
    if rows.size == 0 or cols.size == 0:
        return out
    pos = _col_scratch(A.shape[1])
    if A.data.dtype == np.float64:
        from parelag_tpu.ops import native
        if native.available():
            native.csr_extract_dense(A.indptr, A.indices, A.data,
                                     rows, cols, pos, out)
            return out
    pos[cols] = np.arange(cols.size)
    starts = A.indptr[rows]
    counts = A.indptr[rows + 1] - starts
    total = int(counts.sum())
    if total:
        # flat nnz positions of all requested rows
        idx = np.repeat(starts - np.concatenate(
            ([0], np.cumsum(counts)[:-1])), counts) + np.arange(total)
        rowrep = np.repeat(np.arange(rows.size), counts)
        j = A.indices[idx]
        m = pos[j]
        sel = m >= 0
        out[rowrep[sel], m[sel]] = A.data[idx][sel]
    pos[cols] = -1
    return out


def extract_submatrix_many(A, rows_list, cols_list):
    """Batched extract_submatrix: all blocks from one CSR matrix in a single
    native call (per-call FFI overhead dominates when blocks are small —
    coarsening extracts ~5 small blocks per agglomerate per stage).
    Returns a list-compatible ragged.BlockList."""
    nb = len(rows_list)
    rsz = np.fromiter((len(r) for r in rows_list), np.int64, nb)
    csz = np.fromiter((len(c) for c in cols_list), np.int64, nb)
    row_off = np.zeros(nb + 1, np.int64)
    col_off = np.zeros(nb + 1, np.int64)
    np.cumsum(rsz, out=row_off[1:])
    np.cumsum(csz, out=col_off[1:])
    rows_cat = (np.concatenate(rows_list).astype(np.int64, copy=False)
                if int(row_off[-1]) else np.zeros(0, np.int64))
    cols_cat = (np.concatenate(cols_list).astype(np.int64, copy=False)
                if int(col_off[-1]) else np.zeros(0, np.int64))
    return extract_blocks_cat(A, rows_cat, row_off, cols_cat, col_off)


def extract_blocks_cat(A, rows_cat, row_off, cols_cat, col_off):
    """extract_submatrix_many over flat (cat, off) index families — the
    zero-Python-loop entry. Returns a ragged.BlockList."""
    from parelag_tpu.ops.ragged import BlockList
    A = csr(A)
    rsz = np.diff(row_off)
    csz = np.diff(col_off)
    nb = rsz.size
    out_off = np.zeros(nb + 1, np.int64)
    np.cumsum(rsz * csz, out=out_off[1:])
    vdt = A.data.dtype if A.data.dtype in (np.dtype(np.float32),
                                           np.dtype(np.float64)) \
        else np.dtype(np.float64)
    from parelag_tpu.ops import native
    use_native = A.data.dtype == vdt and native.available()
    # native path: np.empty — the kernel zeroes each block cache-hot
    # (a separate zeros pass over the output is host-phase-sensitive)
    out_cat = (np.empty if use_native else np.zeros)(
        int(out_off[-1]), dtype=vdt)

    if use_native:
        from parelag_tpu.utils.timing import TimeManager as _TM
        _tp = _TM.get_timer("extract: prep")
        _tk = _TM.get_timer("extract: kernel")
        _tp.start()
        pos = _col_scratch(A.shape[1])
        row_off = np.asarray(row_off, np.int64)
        rows_cat = np.ascontiguousarray(
            rows_cat.astype(np.int64, copy=False))
        # visit blocks sorted by their first row: at >10^6 dofs the CSR
        # arrays exceed cache and scattered block order makes extraction
        # DRAM-latency-bound (outputs still land at each block's slot)
        first = np.full(nb, -1, dtype=np.int64)
        nz = rsz > 0
        first[nz] = rows_cat[row_off[:-1][nz]]
        order = np.argsort(first, kind="stable").astype(np.int64)
        args = (A.indptr, A.indices, A.data, rows_cat,
                row_off[:-1].copy(), row_off[1:].copy(),
                np.ascontiguousarray(cols_cat.astype(np.int64, copy=False)),
                np.asarray(col_off[:-1], np.int64).copy(),
                np.asarray(col_off[1:], np.int64).copy(),
                pos, out_cat, out_off[:-1].copy(), order)
        _tp.stop()
        _tk.start()
        native.csr_extract_dense_many2(*args)
        _tk.stop()
        return BlockList(out_cat, out_off, rsz, csz)
    for b in range(nb):
        blk = extract_submatrix(A, rows_cat[row_off[b]:row_off[b + 1]],
                                cols_cat[col_off[b]:col_off[b + 1]])
        out_cat[out_off[b]:out_off[b + 1]] = blk.ravel()
    return BlockList(out_cat, out_off, rsz, csz)


def extract_blocks_cat_multi(pieces, rows_cat, row_off, cols_cat, col_off,
                             dtype=np.float64):
    """extract_blocks_cat against a ROW-DISJOINT family of full-height
    CSR pieces (the per-stage P-snapshot deltas): the native extraction
    kernel writes only entries present in each piece, so running it once
    per piece over one pre-zeroed output is equivalent to extracting from
    the merged matrix — without ever building the merge. Falls back to an
    explicit sum when the native kernels are unavailable. `dtype` is the
    caller's pipeline dtype, used only for the no-pieces degenerate
    return (with pieces present their dtype wins)."""
    from parelag_tpu.ops import native
    pieces = [p for p in pieces if p.nnz]
    if not pieces:
        from parelag_tpu.ops.ragged import BlockList
        rsz = np.diff(row_off)
        csz = np.diff(col_off)
        out_off = np.zeros(rsz.size + 1, np.int64)
        np.cumsum(rsz * csz, out=out_off[1:])
        return BlockList(np.zeros(int(out_off[-1]), dtype=dtype),
                         out_off, rsz, csz)
    ncols = max(p.shape[1] for p in pieces)
    if not native.available() or len(pieces) == 1:
        # widen to a common column count (pieces snapshot a growing P)
        wide = [p if p.shape[1] == ncols
                else sp.csr_matrix((p.data, p.indices, p.indptr),
                                   shape=(p.shape[0], ncols))
                for p in pieces]
        A = wide[0]
        for p in wide[1:]:
            A = A + p
        return extract_blocks_cat(A, rows_cat, row_off, cols_cat, col_off)
    from parelag_tpu.ops.ragged import BlockList
    from parelag_tpu.utils.timing import TimeManager as _TM
    rsz = np.diff(row_off)
    csz = np.diff(col_off)
    nb = rsz.size
    out_off = np.zeros(nb + 1, np.int64)
    np.cumsum(rsz * csz, out=out_off[1:])
    vdt = pieces[0].data.dtype
    out_cat = np.empty(int(out_off[-1]), dtype=vdt)   # first piece zeroes
    _tp = _TM.get_timer("extract: prep")
    _tk = _TM.get_timer("extract: kernel")
    _tp.start()
    pos = _col_scratch(ncols)
    row_off = np.asarray(row_off, np.int64)
    rows_cat = np.ascontiguousarray(rows_cat.astype(np.int64, copy=False))
    cols_cat = np.ascontiguousarray(cols_cat.astype(np.int64, copy=False))
    first = np.full(nb, -1, dtype=np.int64)
    nz = rsz > 0
    first[nz] = rows_cat[row_off[:-1][nz]]
    order = np.argsort(first, kind="stable").astype(np.int64)
    rb, re = row_off[:-1].copy(), row_off[1:].copy()
    cb = np.asarray(col_off[:-1], np.int64).copy()
    ce = np.asarray(col_off[1:], np.int64).copy()
    ob = out_off[:-1].copy()
    _tp.stop()
    _tk.start()
    for i, A in enumerate(pieces):
        assert A.data.dtype == vdt, "mixed piece dtypes"
        native.csr_extract_dense_many2(
            A.indptr, A.indices, A.data, rows_cat, rb, re, cols_cat,
            cb, ce, pos, out_cat, ob, order, zero_out=(i == 0))
    _tk.stop()
    return BlockList(out_cat, out_off, rsz, csz)


_SCRATCH = {}


def _col_scratch(n):
    """Reusable -1-filled scratch array for column position maps."""
    arr = _SCRATCH.get("cols")
    if arr is None or arr.size < n:
        arr = np.full(max(n, 1024), -1, dtype=np.int64)
        _SCRATCH["cols"] = arr
    return arr


def extract_block(A, r0, r1, c0, c1) -> sp.csr_matrix:
    """Contiguous-range sparse block A[r0:r1, c0:c1]."""
    return csr(A)[r0:r1, c0:c1]


def coo_builder():
    """Tiny incremental COO accumulator for building sparse matrices."""
    return _CooBuilder()


class _CooBuilder:
    """Incremental COO accumulator. Dense-block contributions are stored
    LAZILY as block families (never expanded to per-entry row/col arrays
    — the numpy repeat/tile expansion used to cost seconds per coarsening
    stage at flagship scale); the native tocsr scatters straight from the
    block structure. Repeated tocsr calls over a growing builder (the
    per-stage P-snapshot refresh) are incremental: only chunks appended
    since the previous call are converted, then row-merged into the
    cached matrix. Callers must treat returned matrices as frozen."""

    def __init__(self):
        self.chunks = []        # ('coo', r, c, v) | ('blk', rc, ro, cc, co, v)
        self._cache = None      # (csr, n_chunks_consumed, vdt)

    @staticmethod
    def _val(vals):
        v = np.asarray(vals)
        if v.dtype != np.float32:     # preserve f32 setup pipelines
            v = v.astype(np.float64, copy=False)
        return v

    def add_block(self, rows, cols, block):
        """Scatter dense block (len(rows) x len(cols))."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        block = np.asarray(block)
        if rows.size == 0 or cols.size == 0:
            return
        self.chunks.append(
            ("blk", rows, np.array([0, rows.size], dtype=np.int64),
             cols, np.array([0, cols.size], dtype=np.int64),
             self._val(block.reshape(-1))))

    def add_entries(self, rows, cols, vals):
        self.chunks.append(("coo", np.asarray(rows), np.asarray(cols),
                            self._val(vals)))

    def add_blocks_var(self, rows_cat, row_off, cols_cat, col_off, vals_cat):
        """Vectorized scatter of many dense blocks at once: block b covers
        rows_cat[row_off[b]:row_off[b+1]] x cols_cat[col_off[b]:col_off[b+1]]
        with row-major values vals_cat (concatenated block.ravel()s)."""
        self.chunks.append(("blk", np.asarray(rows_cat),
                            np.asarray(row_off), np.asarray(cols_cat),
                            np.asarray(col_off), self._val(vals_cat)))

    def _expanded(self):
        """Per-entry (rows, cols, vals) concatenated over all chunks
        (fallback / sum_duplicates / debug paths only)."""
        from parelag_tpu.ops import ragged as R
        rs, cs, vs = [], [], []
        for ch in self.chunks:
            if ch[0] == "coo":
                rs.append(ch[1]); cs.append(ch[2]); vs.append(ch[3])
            else:
                rows, cols = R.expand_blocks(
                    np.asarray(ch[1], dtype=np.int64), np.asarray(ch[2]),
                    np.asarray(ch[3], dtype=np.int64), np.asarray(ch[4]))
                rs.append(rows); cs.append(cols); vs.append(ch[5])
        return (np.concatenate(rs), np.concatenate(cs),
                np.concatenate(vs))

    def tocsr(self, shape, sum_duplicates=False) -> sp.csr_matrix:
        """COO -> CSR. Duplicate (row, col) pairs are summed (standard COO
        semantics); with sum_duplicates=False duplicates are treated as a
        caller bug — checked only under PARELAG_DEBUG=1 (the full-sort
        uniqueness scan is O(nnz log nnz) and the setup phase rebuilds
        multi-10M-nnz snapshots every stage)."""
        if not self.chunks:
            return sp.csr_matrix(shape)
        if not sum_duplicates:
            from parelag_tpu.utils.errors import _debug_enabled
            if _debug_enabled():
                r, c, _ = self._expanded()
                keys = r.astype(np.int64) * shape[1] + c
                if np.unique(keys).size != keys.size:
                    raise ValueError(
                        "duplicate (row, col) entries in COO builder; pass "
                        "sum_duplicates=True to accumulate them")
            from parelag_tpu.ops import native
            if native.available():
                # native chunked conversion: no concatenation, no scipy
                # validation copies, no de-dup pass (duplicate-free by
                # builder contract, checked above under PARELAG_DEBUG).
                # Incremental: when the builder only grew since the last
                # call (the P-snapshot refresh pattern — new chunks, and
                # possibly new columns), convert just the new chunks and
                # row-merge them into the cached previous result.
                vdt = np.result_type(
                    *[ch[-1].dtype for ch in self.chunks])
                cache = self._cache
                if (cache is not None and cache[2] == vdt
                        and cache[1] <= len(self.chunks)
                        and cache[0].shape[0] == shape[0]
                        and cache[0].shape[1] <= shape[1]):
                    if cache[1] == len(self.chunks):
                        # no new chunks: reuse the cached arrays (the
                        # shape may still have gained columns)
                        old = cache[0]
                        A = (old if old.shape == tuple(shape)
                             else sp.csr_matrix(
                                 (old.data, old.indices, old.indptr),
                                 shape=shape, copy=False))
                        self._cache = (A, len(self.chunks), vdt)
                        return A
                    delta = native.chunks_tocsr(
                        self.chunks[cache[1]:], shape)
                    A = native.csr_merge_rows(cache[0], delta, shape)
                else:
                    A = native.chunks_tocsr(self.chunks, shape)
                self._cache = (A, len(self.chunks), vdt)
                return A
        r, c, v = self._expanded()
        return sp.coo_matrix((v, (r, c)), shape=shape).tocsr()


def norm_linf(A) -> float:
    """max row sum of |A| (hypre_ParCSRMatrixNormlinf)."""
    A = abs_csr(A)
    return float(A.sum(axis=1).max()) if A.shape[0] else 0.0


def max_abs(A) -> float:
    A = csr(A)
    return float(np.abs(A.data).max()) if A.nnz else 0.0


def matrices_equal(A, B, tol=1e-9) -> bool:
    """|A - B|_max <= tol (hypre_ParCSRMatrixCompare.c:18)."""
    return max_abs(csr(A) - csr(B)) <= tol
