"""Agglomerated mesh topology across coarsening levels.

Rebuild of the reference AgglomeratedTopology
(src/topology/Topology.hpp:69-564): a level's topology is the chain of
oriented boundary operators

    B[0] : element x facet   (+-1, outward orientation)
    B[1] : facet  x ridge    (+-1, boundary traversal)
    B[2] : ridge  x peak     (+-1, head/tail)

with B[i] @ B[i+1] == 0, plus entity weights, element attributes, the
facet x boundary-attribute table, and (after coarsening) the oriented
AEntity_entity tables linking to the finer level.

Coarsening (CoarsenLocalPartitioning, reference Topology.cpp:686-828):
  1. connected-components fixup of the partition vector,
  2. AE_element = TransposeOrientation(partition),
  3. per codim: AE_fc = MultOrientation(AEntity_entity[c], B[c]); group the
     surviving fine entities into coarse entities by identical adjacency
     signature via minimal intersection sets (+ bdr-attribute signature for
     facets); coarse B[c] = MultOrientation(AE_fc, fc_AF).

Everything is serial-per-partition here; the distributed version shards the
element set over a device mesh axis (parelag_tpu.parallel).
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu.ops import csr as C
from parelag_tpu.mesh.entities import derive_entities, bdr_face_ids

# entity codims (match reference AgglomeratedTopology::Entity)
ELEMENT, FACET, RIDGE, PEAK = 0, 1, 2, 3


class AgglomeratedTopology:
    def __init__(self, dim, n_codim=None):
        self.dim = dim
        self.n_codim = dim if n_codim is None else n_codim
        self.B = [None] * self.n_codim          # oriented boundary ops
        self.weights = [None] * (self.n_codim + 1)
        self.element_attribute = None
        self.facet_bdr_attribute = None          # csr facet x nbdrattr, +-1
        self.AEntity_entity = None               # list per codim (csr, +-1)
        self.finer = None
        self.coarser = None
        self.partition = None
        self._conn = {}                          # (big, small) -> pattern csr

    # ------------------------------------------------------------------ #
    @classmethod
    def from_mesh(cls, mesh) -> "AgglomeratedTopology":
        """Fine-level topology from a mesh (reference Topology.cpp:75-157).
        In 2D facets are edges and ridges are vertices (nCodim_=2 path)."""
        topo = cls(mesh.dim)
        if mesh.dim == 2:
            from parelag_tpu.mesh.entities import (
                derive_entities_2d, bdr_edge_ids)
            ents = derive_entities_2d(mesh)
            topo.B[0] = ents.B0
            topo.B[1] = ents.B1
            counts = [mesh.num_elements, ents.num_edges, mesh.num_vertices]
            fids = bdr_edge_ids(mesh, ents)
            nf = ents.num_edges
        else:
            ents = derive_entities(mesh)
            topo.B[0] = ents.B0
            topo.B[1] = ents.B1
            topo.B[2] = ents.B2
            counts = [mesh.num_elements, ents.num_faces,
                      ents.num_edges, mesh.num_vertices]
            fids = bdr_face_ids(mesh, ents)
            nf = ents.num_faces
        topo.entities = ents
        for c, n in enumerate(counts[: topo.n_codim + 1]):
            topo.weights[c] = np.ones(n, dtype=np.int64)
        topo.element_attribute = mesh.attrib.copy()

        # facet x bdr-attribute table: entry = -B0[elem, facet] of the unique
        # adjacent element (reference generateFacetBdrAttributeTable,
        # Topology.cpp:181-238)
        nattr = int(mesh.bdr_attrib.max()) if mesh.bdr_attrib.size else 0
        B0t = topo.B[0].T.tocsr()
        vals = np.empty(fids.size)
        for i, f in enumerate(fids):
            row = slice(B0t.indptr[f], B0t.indptr[f + 1])
            assert B0t.indptr[f + 1] - B0t.indptr[f] == 1, \
                "boundary facet adjacent to more than one element"
            vals[i] = -B0t.data[row][0]
        topo.facet_bdr_attribute = sp.csr_matrix(
            (vals, (fids, mesh.bdr_attrib - 1)), shape=(nf, nattr))
        return topo

    # ------------------------------------------------------------------ #
    def num_entities(self, codim) -> int:
        if codim == 0:
            return self.B[0].shape[0]
        return self.B[codim - 1].shape[1]

    def entity_counts(self):
        return [self.num_entities(c) for c in range(self.n_codim + 1)]

    def local_element_element(self) -> sp.csr_matrix:
        """Element adjacency graph through facets (pattern, incl. diagonal)
        (reference Topology.hpp:319-329)."""
        A = C.bool_mult(self.B[0], self.B[0].T)
        return A

    def connectivity(self, big, small) -> sp.csr_matrix:
        """Pattern connectivity between entity codims, e.g. element x ridge
        (reference BuildConnectivity, Topology.cpp:240)."""
        key = (big, small)
        if key not in self._conn:
            assert small > big
            A = C.pattern(self.B[big])
            for c in range(big + 1, small):
                A = C.bool_mult(A, self.B[c])
            self._conn[key] = A
        return self._conn[key]

    def boundary_of_entity(self, big, small, ientity) -> np.ndarray:
        """Entities of codim `small` on the closure of entity `ientity` of
        codim `big` (reference Topology::GetBoundaryOfEntity)."""
        conn = self.connectivity(big, small)
        return conn.indices[conn.indptr[ientity]:conn.indptr[ientity + 1]]

    # ------------------------------------------------------------------ #
    def coarsen_local_partitioning(self, partitioning, check_topology=False,
                                   preserve_material_interfaces=False,
                                   coarsefaces_algo=0):
        """Build the next-coarser topology from an element partition vector
        (reference CoarsenLocalPartitioning, Topology.cpp:686-828).

        coarsefaces_algo=0 groups facets by minimal intersection sets (the
        default); coarsefaces_algo=2 builds one coarse facet per adjacent
        agglomerate pair / per (agglomerate, boundary attribute) pair
        (reference ComputeCoarseFacets, Topology.cpp:455-662)."""
        from parelag_tpu.topology.betti import mark_bad_agglomerates

        from parelag_tpu.utils.errors import InvalidInput
        partitioning = np.asarray(partitioning)
        if partitioning.size != self.num_entities(0):
            raise InvalidInput(
                f"partition vector has {partitioning.size} entries but the "
                f"topology has {self.num_entities(0)} elements; the vector "
                f"must assign an agglomerate id to every element of THIS "
                f"level (did you pass a finer level's partition, or grid "
                f"shape instead of coarsening factors?)")

        elem_elem = self.local_element_element()
        part, n_ae = C.connected_components(
            partitioning, elem_elem,
            self.element_attribute if preserve_material_interfaces else None)
        self.partition = part

        coarse = AgglomeratedTopology(self.dim, self.n_codim)
        coarse.finer = self
        self.coarser = coarse

        self.AEntity_entity = [None] * (self.n_codim + 1)
        self.AEntity_entity[0] = C.transpose_orientation(part, n_ae)

        if check_topology:
            bad = mark_bad_agglomerates(self, 0)
            if bad.any():
                self._deagglomerate_bad(bad)
                n_ae = self.AEntity_entity[0].shape[0]

        # facets (codim 1): include bdr-attribute signature in the grouping
        AE_fc = C.mult_orientation(self.AEntity_entity[0], self.B[0])
        if coarsefaces_algo == 2:
            fc_AF = self._compute_coarse_facets_pairs(AE_fc)
        else:
            # group facets by identical (AE-pair, bdr-attr) signature
            # columns — linear-time MIS without the quadratic Gram product
            S = (AE_fc if self.facet_bdr_attribute is None
                 else sp.vstack([AE_fc, self.facet_bdr_attribute.T]))
            fc_AF = C.minimal_intersection_sets_cols(S)
            fc_AF = self._split_disconnected(fc_AF, 1)
        self.AEntity_entity[1] = fc_AF.T.tocsr()
        if check_topology:
            # reference CheckHFacetsTopology (Topology.cpp:420-432): coarse
            # facets with holes (e.g. annular interfaces) or nonmanifold
            # boundary break the facet extensions — split them into
            # singleton fine facets
            isbad = mark_bad_agglomerates(self, 1)
            if isbad.any():
                fc_AF = self._deagglomerate_entities(fc_AF, isbad)
                self.AEntity_entity[1] = fc_AF.T.tocsr()
        # ridges / peaks, with pinched-separator repair: a fine edge/vertex
        # interiorly claimed by >= 2 agglomerated entities of the same codim
        # while represented at none (shared-vertex/edge agglomerates) breaks
        # the dof hierarchy. The reference's MIS misses these — its
        # sharedvertex/sv2 lanes are known-failing (testsuite
        # CMakeLists.txt:94-109, issue ELAG-19). Repair: deagglomerate every
        # coarse facet whose closure holds a pinched entity into singleton
        # faces and rebuild ridges/peaks; elementary entities then flow
        # through the standard machinery (incl. the degenerate-Lagrange path
        # in sequence._extension).
        self.had_pinch_repair = False
        for _repair_round in range(4):
            for icodim in range(1, self.n_codim):
                AE_fc2 = C.mult_orientation(self.AEntity_entity[icodim],
                                            self.B[icodim])
                rg_AF = C.minimal_intersection_sets_cols(AE_fc2)
                if icodim + 1 < self.dim:
                    rg_AF = self._split_disconnected(rg_AF, icodim + 1)
                self.AEntity_entity[icodim + 1] = rg_AF.T.tocsr()
                if check_topology and icodim + 1 < self.dim:
                    isbad = mark_bad_agglomerates(self, icodim + 1)
                    if isbad.any():
                        rg_AF = self._deagglomerate_entities(rg_AF, isbad)
                        self.AEntity_entity[icodim + 1] = rg_AF.T.tocsr()
            bad_facets = self._pinched_parent_facets()
            if not bad_facets.any():
                break
            self.had_pinch_repair = True
            fc_AF = self._deagglomerate_entities(fc_AF, bad_facets)
            self.AEntity_entity[1] = fc_AF.T.tocsr()

        coarse.B[0] = C.mult_orientation(AE_fc, fc_AF)
        for icodim in range(1, self.n_codim):
            AE_fc2 = C.mult_orientation(self.AEntity_entity[icodim],
                                        self.B[icodim])
            coarse.B[icodim] = C.mult_orientation(
                AE_fc2, self.AEntity_entity[icodim + 1].T.tocsr())

        if self.facet_bdr_attribute is not None:
            coarse.facet_bdr_attribute = C.mult_orientation(
                self.AEntity_entity[1], self.facet_bdr_attribute)

        for c in range(min(self.n_codim + 1, self.dim)):
            coarse.weights[c] = C.wedge_mult(
                self.AEntity_entity[c], self.weights[c]).astype(np.int64)
        if self.n_codim == self.dim:
            npk = self.AEntity_entity[self.dim].shape[0]
            coarse.weights[self.dim] = np.ones(npk, dtype=np.int64)

        # coarse element attribute: attribute of any member element
        # (reference setCoarseElementAttributes)
        AE_e = self.AEntity_entity[0]
        first = AE_e.indices[AE_e.indptr[:-1]]
        coarse.element_attribute = self.element_attribute[first]
        return coarse

    def _compute_coarse_facets_pairs(self, AE_fc):
        """Algorithm-2 coarse facets (reference ComputeCoarseFacets,
        Topology.cpp:455-662): one coarse facet per adjacent agglomerate
        pair AE1<AE2 holding ALL fine facets between the pair (oriented as
        AE1's outward side, Topology.cpp:1550-1602), followed by one per
        (agglomerate, boundary attribute) pair when facet_bdr_attribute
        exists — else one per agglomerate touching the boundary — with +1
        data (Topology.cpp:1393-1548). Serial specialization: 'shared'
        coarse facets only arise between MPI ranks; here the interface
        between device shards is handled by the sharding layer instead
        (parelag_tpu/parallel/sharding.py)."""
        AE_fc = AE_fc.tocsr()
        fc_AE = AE_fc.T.tocsr()
        n_ae, nfc = AE_fc.shape
        rowcount = np.diff(fc_AE.indptr)

        # interface facets: exactly two adjacent agglomerates
        interf = np.where(rowcount == 2)[0]
        lo = fc_AE.indices[fc_AE.indptr[interf]]
        hi = fc_AE.indices[fc_AE.indptr[interf] + 1]
        orient = fc_AE.data[fc_AE.indptr[interf]]   # AE_fc entry at (lo, f)
        keys = lo.astype(np.int64) * n_ae + hi
        _, inv = np.unique(keys, return_inverse=True)   # sorted (AE1, AE2)
        n_inner = int(inv.max()) + 1 if inv.size else 0

        rows = [interf]
        cols = [inv]
        vals = [orient.astype(np.float64)]
        nxt = n_inner

        bdr = np.where(rowcount == 1)[0]
        bdr_ae = fc_AE.indices[fc_AE.indptr[bdr]]
        if self.facet_bdr_attribute is not None and bdr.size:
            battr = self.facet_bdr_attribute.tocsr()
            attr = battr.indices[battr.indptr[bdr]]
            bkeys = bdr_ae.astype(np.int64) * battr.shape[1] + attr
            _, binv = np.unique(bkeys, return_inverse=True)
            rows.append(bdr)
            cols.append(nxt + binv)
            vals.append(np.ones(bdr.size))
            nxt += int(binv.max()) + 1
        elif bdr.size:
            _, binv = np.unique(bdr_ae, return_inverse=True)
            rows.append(bdr)
            cols.append(nxt + binv)
            vals.append(np.ones(bdr.size))
            nxt += int(binv.max()) + 1

        return sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(nfc, nxt))

    def _split_disconnected(self, ent_AF, codim):
        """Split coarse interface entities whose fine members are not
        connected through shared sub-entities (covers both disconnected and
        vertex-pinched agglomerated facets/ridges — the reference's MIS
        grouping can produce these and its local saddle solves then fail
        with 'bad topology'; cf. the LDL failure note in
        ParELAG_SaddlePointSolver.cpp:118-127). Returns the corrected
        entity x coarse-entity table with orientations preserved."""
        n_ent = ent_AF.shape[0]
        coo = ent_AF.tocoo()
        label = np.full(n_ent, -1, dtype=np.int64)    # -1: in no coarse ent
        orient = np.zeros(n_ent)
        label[coo.row] = coo.col
        orient[coo.row] = coo.data

        # one global pass: adjacency through shared sub-entities, masked to
        # same-coarse-entity pairs, then a single connected-components sweep
        from parelag_tpu.ops import native
        if native.available():
            # union-find over shared sub-entities (no B @ B.T product;
            # identical component numbering — ascending smallest member)
            ncomp, comp = native.split_components(self.B[codim].tocsr(),
                                                  label)
        else:
            B = C.pattern(self.B[codim])          # fine ent x sub-entity
            G = (B @ B.T).tocoo()
            keep = (label[G.row] >= 0) & (label[G.row] == label[G.col])
            Gm = sp.csr_matrix(
                (np.ones(int(keep.sum())), (G.row[keep], G.col[keep])),
                shape=(n_ent, n_ent))
            ncomp, comp = sp.csgraph.connected_components(Gm,
                                                          directed=False)

        sel = label >= 0
        keys = label[sel] * np.int64(ncomp) + comp[sel]
        uniq, inv = np.unique(keys, return_inverse=True)
        rows = np.where(sel)[0]
        return sp.csr_matrix((orient[sel], (rows, inv)),
                             shape=(n_ent, uniq.size))

    def _pinched_parent_facets(self) -> np.ndarray:
        """Detect pinched separators and return the boolean mask of coarse
        FACETS to deagglomerate. A fine entity of codim k is pinched when it
        is not a member of AEntity_entity[k] and, with c* the largest codim
        < k whose agglomerated closures contain it, >= 2 entities of codim
        c* contain it (e.g. a vertex interiorly claimed by two coarse
        facets: the shared-vertex agglomerate, ELAG-19)."""
        n_af = self.AEntity_entity[1].shape[0]
        bad = np.zeros(n_af, dtype=bool)
        for k in range(2, self.n_codim + 1):
            n_fine = self.B[k - 1].shape[1]
            member = np.zeros(n_fine, dtype=bool)
            member[self.AEntity_entity[k].tocsr().indices] = True

            counts, mats = [], []
            for c in range(k):
                M = C.pattern(self.AEntity_entity[c])
                for b in range(c, k):
                    M = C.bool_mult(M, C.pattern(self.B[b]))
                mats.append(M)
                counts.append(np.asarray((M > 0).sum(axis=0)).ravel())
            n_at = np.stack(counts)
            has = n_at > 0
            cstar = np.where(has.any(axis=0),
                             (np.arange(k)[:, None] * has).max(axis=0), -1)
            n_cstar = np.where(
                cstar >= 0,
                n_at[np.maximum(cstar, 0), np.arange(n_fine)], 0)
            pinched = np.where((~member) & (cstar >= 0) & (n_cstar >= 2))[0]
            if pinched.size:
                # facets whose closure contains the pinched entity
                Mf = mats[1].tocsc()         # coarse facet x fine entity
                for e in pinched:
                    bad[Mf.indices[Mf.indptr[e]:Mf.indptr[e + 1]]] = True
        return bad

    def _deagglomerate_entities(self, ent_AF, isbad):
        """Split every marked coarse entity into singleton fine entities
        (reference DeAgglomerateBadAgglomeratedEntities for codim >= 1)."""
        csc = ent_AF.tocsc()
        ncol = csc.shape[1]
        isbad = np.asarray(isbad, dtype=bool)
        colnnz = np.diff(csc.indptr)
        # each bad column expands into one singleton column per member;
        # good columns keep one column, preserving original order
        contrib = np.where(isbad, colnnz, 1)
        col_start = np.concatenate(([0], np.cumsum(contrib)[:-1]))
        nxt = int(contrib.sum())
        j_of = np.repeat(np.arange(ncol), colnnz)
        pos = np.arange(csc.nnz) - np.repeat(csc.indptr[:-1], colnnz)
        newcol = col_start[j_of] + np.where(isbad[j_of], pos, 0)
        return sp.csr_matrix((csc.data, (csc.indices, newcol)),
                             shape=(ent_AF.shape[0], nxt))

    def _deagglomerate_bad(self, isbad):
        """Split every bad agglomerate into singleton elements (reference
        Topology::DeAgglomerateBadAgglomeratedEntities, Topology.hpp:374)."""
        AE_e = self.AEntity_entity[0].tocsr()
        isbad = np.asarray(isbad, dtype=bool)
        rownnz = np.diff(AE_e.indptr)
        contrib = np.where(isbad, rownnz, 1)
        start = np.concatenate(([0], np.cumsum(contrib)[:-1]))
        nxt = int(contrib.sum())
        a_of = np.repeat(np.arange(AE_e.shape[0]), rownnz)
        pos = np.arange(AE_e.nnz) - np.repeat(AE_e.indptr[:-1], rownnz)
        part = np.empty(AE_e.shape[1], dtype=np.int64)
        part[AE_e.indices] = start[a_of] + np.where(isbad[a_of], pos, 0)
        self.AEntity_entity[0] = C.transpose_orientation(part, nxt)
        self.partition = part
