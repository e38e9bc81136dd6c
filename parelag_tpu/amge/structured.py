"""Device-resident AMGe setup for cartesian-nested hex grids.

The generic coarsening engine (amge/sequence.py) is host-resident: its
per-AE batches are tens-to-hundreds of MB per level, assembled on the
host.  This module is the device-resident answer for the structured case the
flagship benchmarks actually run (cartesian 2x2x2 agglomeration of a
hex grid, polynomial order-0 upscaling targets — bench.py lane_h1 /
lane_setup, and the SPE10 north-star grid): on a cartesian-nested
partition every agglomerate of every level has the *same* local
structure, with order-0 targets every trace/bubble SVD keeps exactly
zero extra modes (asserted at runtime, not assumed), and the coarse
de Rham sequence is again a staggered grid with one dof per coarse
entity.  Consequently

  * every stage of Coarsen() is ONE uniform batched dense operation
    (assemble -> solve -> emit) over all agglomerated entities of a
    family — no ragged shapes, no shape groups, no index CSRs;
  * the per-stage kernel shapes are LEVEL-INDEPENDENT (the coarse level
    is self-similar to the fine one), so the whole multilevel setup
    compiles a fixed, small set of XLA programs;
  * the only host->device traffic is the fine-grid geometry/coefficient
    data and int32 entity-id arrays (MBs), and the only device->host
    traffic is per-stage kept-mode counts (bytes): P, coarse D, coarse
    local masses and the level operators stay device-resident for the
    solve phase that consumes them.

Reference mapping (math identical to the generic engine, which itself
cites the C++ source): trace stage = ComputeCoarseTracesWithTargets
(DeRhamSequence.cpp:1723-2086), Lagrange extension = hFacetExtension
(DeRhamSequence.cpp:2169-2628), [M B^T; B -C] extension =
hRidgePeakExtension (DeRhamSequence.cpp:2609-2656); the batched
formulas mirror amge/sequence.py::_compute_coarse_traces/_extension
line for line (that host path is the digit-parity oracle in
tests/test_structured.py).

Conventions (self-consistent; parity with the host engine is asserted
through convention-free quantities — upscaling errors, invariants,
operator spectra — and through explicit entity remaps in the tests):
  * H1 dofs = vertex values; Hcurl = edge circulations (tangent +axis);
    Hdiv = face fluxes (normal +axis); L2 = cell values.
  * grad rows: [-1 at tail, +1 at head].  curl rows: ccw circulation
    seen from the +a normal, stored in the canonical per-face edge
    order [eb(c0), eb(c1), ec(b0), ec(b1)] (signs D1_FAMILY_SIGNS).
    div rows: (+out - in)/cell_volume.
  * entity numbering is lexicographic (x fastest) per family; face and
    edge families are ordered [x; y; z].
"""

import os
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# --------------------------------------------------------------------- #
# host index plane: entity numbering and per-level id arrays
# --------------------------------------------------------------------- #


def _lex(i, j, k, ni, nj):
    return i + ni * (j + nj * k)


def grid_counts(shape):
    """Entity counts for a (nx, ny, nz) cell grid: cells, faces (x,y,z
    families), edges (x,y,z families), vertices."""
    nx, ny, nz = shape
    nc = nx * ny * nz
    nf = ((nx + 1) * ny * nz, nx * (ny + 1) * nz, nx * ny * (nz + 1))
    ne = (nx * (ny + 1) * (nz + 1), (nx + 1) * ny * (nz + 1),
          (nx + 1) * (ny + 1) * nz)
    nv = (nx + 1) * (ny + 1) * (nz + 1)
    return nc, nf, ne, nv


def face_id(shape, axis, i, j, k):
    """Face id within the global face numbering ([x|y|z] families).
    (i, j, k) are the face's own lattice coordinates: for axis=0 the
    x-coordinate i ranges 0..nx while j, k range over cells."""
    nx, ny, nz = shape
    dims = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    off = 0
    for a in range(axis):
        off += dims[a][0] * dims[a][1] * dims[a][2]
    ni, nj, _ = dims[axis]
    return off + _lex(i, j, k, ni, nj)


def edge_id(shape, axis, i, j, k):
    """Edge id ([x|y|z] families); for axis=0 the x-coordinate i ranges
    over cells 0..nx-1 while j, k range over vertices."""
    nx, ny, nz = shape
    dims = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
            (nx + 1, ny + 1, nz))
    off = 0
    for a in range(axis):
        off += dims[a][0] * dims[a][1] * dims[a][2]
    ni, nj, _ = dims[axis]
    return off + _lex(i, j, k, ni, nj)


def vert_id(shape, i, j, k):
    nx, ny, nz = shape
    return _lex(i, j, k, nx + 1, ny + 1)


def cell_id(shape, i, j, k):
    nx, ny, nz = shape
    return _lex(i, j, k, nx, ny)


def _grid3(*ranges):
    """meshgrid of index ranges -> flat (n, len(ranges)) int array,
    x fastest (lexicographic)."""
    gs = np.meshgrid(*ranges, indexing="ij")
    return np.stack([g.transpose(2, 1, 0).ravel() for g in gs], axis=1)


# --------------------------------------------------------------------- #
# fine level: analytic local matrices on a uniform brick grid
# --------------------------------------------------------------------- #

def _m1(h):
    """1D P1 mass on an interval of length h."""
    return (h / 6.0) * np.array([[2.0, 1.0], [1.0, 2.0]])


def fine_local_masses(h, dtype=np.float64):
    """Reference local mass matrices per (codim, jform) slot for a
    uniform brick cell of size h=(hx,hy,hz).  Local dof orderings:

      M00 (8x8):  cell vertices, lexicographic (x fastest)
      M10 (4x4):  face vertices, lexicographic in the face plane (per
                  axis family: the two in-plane axes in (b, c) order
                  where (b, c) = axes != a, b < c)
      M20 (2x2):  edge endpoints (tail, head)
      M30 (1x1):  vertex
      M01 (12x12): cell edges [4 x-edges (lex in (y,z)); 4 y; 4 z]
      M11 (4x4):  face edges [2 along b (lex in c); 2 along c (lex in b)]
      M21 (1x1):  edge
      M02 (6x6):  cell faces [x(i),x(i+1); y; z]
      M12 (1x1):  face
      M03 (1x1):  cell (value dofs: mass = cell volume)

    Returns dict keyed (codim, jform); face/edge-family-dependent slots
    map to a tuple of 3 per-axis matrices.
    """
    hx, hy, hz = (float(v) for v in h)
    m = {0: _m1(hx), 1: _m1(hy), 2: _m1(hz)}
    vol = hx * hy * hz

    def kron(*ms):
        out = ms[0]
        for mm in ms[1:]:
            out = np.kron(mm, out)   # x fastest => later axes outermost
        return out

    out = {}
    out[(0, 0)] = kron(m[0], m[1], m[2])
    out[(1, 0)] = tuple(
        kron(m[b], m[c])
        for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))))
    out[(2, 0)] = (m[0], m[1], m[2])
    out[(3, 0)] = np.array([[1.0]])

    # ND0: same-axis block for axis a = (m_b x m_c) / h_a (circulation
    # dofs; dual basis carries 1/h_a), cross-axis zero.
    hh = (hx, hy, hz)
    nd_blocks = []
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        nd_blocks.append(kron(m[b], m[c]) / hh[a])
    M01 = np.zeros((12, 12))
    for a in range(3):
        M01[4 * a:4 * a + 4, 4 * a:4 * a + 4] = nd_blocks[a]
    out[(0, 1)] = M01
    # face (normal axis a, in-plane (b, c)): edges [2 along b; 2 along c]
    m11 = []
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        blk = np.zeros((4, 4))
        blk[:2, :2] = m[c] / hh[b]
        blk[2:, 2:] = m[b] / hh[c]
        m11.append(blk)
    out[(1, 1)] = tuple(m11)
    out[(2, 1)] = tuple(np.array([[1.0 / hh[a]]]) for a in range(3))

    # RT0: axis-a pair block m_a / (h_b h_c) (flux dofs).
    M02 = np.zeros((6, 6))
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        M02[2 * a:2 * a + 2, 2 * a:2 * a + 2] = m[a] / (hh[b] * hh[c])
    out[(0, 2)] = M02
    out[(1, 2)] = tuple(np.array([[1.0 / (hh[b] * hh[c])]])
                        for a, (b, c) in
                        enumerate(((1, 2), (0, 2), (0, 1))))
    out[(0, 3)] = np.array([[vol]])

    return {k: (tuple(x.astype(dtype) for x in v)
                if isinstance(v, tuple) else v.astype(dtype))
            for k, v in out.items()}


def fine_derivative_values(shape, h, dtype=np.float64):
    """Per-row value arrays of the fine D operators in the fixed column
    patterns of this module:

      D0: (n_edges, 2)  cols [tail, head] vertices       -> [-1, +1]
      D1: (n_faces, 4)  cols [eb(c0), eb(c1), ec(b0), ec(b1)]
                                      -> per-family D1_FAMILY_SIGNS
      D2: (n_cells, 6)  cols [fx0,fx1,fy0,fy1,fz0,fz1]   -> (+-1)/vol

    Values are returned (patterns are implicit in the column builders
    below); at coarse levels the same patterns carry computed values.
    """
    nc, nf, ne, nv = grid_counts(shape)
    vol = float(np.prod(h))
    d0 = np.tile(np.array([-1.0, 1.0], dtype=dtype), (sum(ne), 1))
    d1 = np.concatenate([
        np.tile(D1_FAMILY_SIGNS[a].astype(dtype), (nf[a], 1))
        for a in range(3)], axis=0)
    d2 = np.tile(
        np.array([-1.0, 1.0, -1.0, 1.0, -1.0, 1.0], dtype=dtype) / vol,
        (nc, 1))
    return d0, d1, d2


def d0_cols(shape):
    """(n_edges, 2) vertex column ids matching fine_derivative_values."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        # _grid3 columns are already (x, y, z) lattice coordinates
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        head = ijk.copy()
        head[:, a] += 1
        tail = vert_id(shape, ijk[:, 0], ijk[:, 1], ijk[:, 2])
        headv = vert_id(shape, head[:, 0], head[:, 1], head[:, 2])
        cols.append(np.stack([tail, headv], axis=1))
    return np.concatenate(cols, axis=0)


def d1_cols(shape):
    """(n_faces, 4) edge column ids of the curl rows, in the CANONICAL
    per-face edge order [eb at c0, eb at c1, ec at b0, ec at b1] with
    (b, c) the in-plane axes, b < c — the same order as the M11 blocks
    (face_edges_m), so that coarse-level curl values emitted by the
    facet extension stage land in the same pattern.  The ccw-circulation
    signs in this order are D1_FAMILY_SIGNS[a] (the (b, c) = (x, z)
    pair of the y-family is anti-cyclic, flipping its signs)."""
    return face_edges_m(shape)


# ccw circulation signs (Stokes, right-hand rule around the +a normal)
# expressed in the canonical [eb(c0), eb(c1), ec(b0), ec(b1)] order:
D1_FAMILY_SIGNS = np.array([
    [1.0, -1.0, -1.0, 1.0],     # +x: (b,c)=(y,z) cyclic
    [-1.0, 1.0, 1.0, -1.0],     # +y: (b,c)=(x,z) anti-cyclic
    [1.0, -1.0, -1.0, 1.0],     # +z: (b,c)=(x,y) cyclic
])


def d2_cols(shape):
    """(n_cells, 6) face column ids [fx(i),fx(i+1),fy(j),fy(j+1),
    fz(k),fz(k+1)]."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    return np.stack([
        face_id(shape, 0, i, j, k), face_id(shape, 0, i + 1, j, k),
        face_id(shape, 1, i, j, k), face_id(shape, 1, i, j + 1, k),
        face_id(shape, 2, i, j, k), face_id(shape, 2, i, j, k + 1),
    ], axis=1)


# --------------------------------------------------------------------- #
# entity-dof maps (host, int arithmetic; also the device gather plans)
# --------------------------------------------------------------------- #

def cell_verts(shape):
    """(n_cells, 8) vertex ids, lexicographic (x fastest) within the
    cell — matches the M00 kron ordering."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out.append(vert_id(shape, i + dx, j + dy, k + dz))
    return np.stack(out, axis=1)


def cell_edges(shape):
    """(n_cells, 12) edge ids [4 x-edges (y fastest); 4 y-edges
    (x fastest); 4 z-edges (x fastest)] — matches the M01 ordering."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        base = np.stack([i, j, k], axis=1)
        for dc in (0, 1):
            for db in (0, 1):
                co = base.copy()
                co[:, b] += db
                co[:, c] += dc
                cols.append(edge_id(shape, a, co[:, 0], co[:, 1],
                                    co[:, 2]))
    return np.stack(cols, axis=1)


def cell_faces(shape):
    """(n_cells, 6) — identical to d2_cols (matches the M02 ordering)."""
    return d2_cols(shape)


def face_verts(shape):
    """(n_faces, 4) vertex ids per face, (b, c)-lex (b fastest) —
    matches the M10 kron ordering."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for dc in (0, 1):
            for db in (0, 1):
                co = ijk.copy()
                co[:, b] += db
                co[:, c] += dc
                out.append(vert_id(shape, co[:, 0], co[:, 1], co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def face_edges_m(shape):
    """(n_faces, 4) edge ids [eb at c0, eb at c1, ec at b0, ec at b1] —
    matches the M11 block ordering (NOT the ccw d1 ordering)."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))

        def ecol(axis, db, dc):
            co = ijk.copy()
            co[:, b] += db
            co[:, c] += dc
            return edge_id(shape, axis, co[:, 0], co[:, 1], co[:, 2])

        cols.append(np.stack([ecol(b, 0, 0), ecol(b, 0, 1),
                              ecol(c, 0, 0), ecol(c, 1, 0)], axis=1))
    return np.concatenate(cols, axis=0)


def edge_verts(shape):
    """(n_edges, 2) — identical to d0_cols."""
    return d0_cols(shape)


def assemble_global(blocks, dofmap, ndofs):
    """Host CSR from per-entity local blocks.  blocks: (n, k, k) or a
    single (k, k) broadcast; dofmap: (n, k)."""
    import scipy.sparse as sp
    dofmap = np.asarray(dofmap)
    n, k = dofmap.shape
    blocks = np.broadcast_to(np.asarray(blocks), (n, k, k))
    rows = np.repeat(dofmap, k, axis=1).ravel()
    cols = np.tile(dofmap, (1, k)).ravel()
    return sp.coo_matrix(
        (blocks.ravel(), (rows, cols)), shape=(ndofs, ndofs)).tocsr()


def assemble_d_csr(dvals, dcols, shape_mat):
    """Host CSR of a derivative operator from its per-row value array
    and static column pattern."""
    import scipy.sparse as sp
    dvals = np.asarray(dvals)
    n, k = dvals.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return sp.coo_matrix(
        (dvals.ravel(), (rows, np.asarray(dcols).ravel())),
        shape=shape_mat).tocsr()


def fine_global_masses(shape, h, dtype=np.float64, coeff=None):
    """Host global mass CSRs per form (for parity tests and operator
    assembly); coeff: optional per-cell scalar weighting of the codim-0
    masses (SPE10-class heterogeneity)."""
    ref = fine_local_masses(h, dtype)
    nc, nf, ne, nv = grid_counts(shape)

    def wblk(M):
        if coeff is None:
            return M
        return np.asarray(coeff, dtype)[:, None, None] * M

    return {
        0: assemble_global(wblk(ref[(0, 0)]), cell_verts(shape), nv),
        1: assemble_global(wblk(ref[(0, 1)]), cell_edges(shape),
                           sum(ne)),
        2: assemble_global(wblk(ref[(0, 2)]), cell_faces(shape),
                           sum(nf)),
        3: assemble_global(wblk(ref[(0, 3)]),
                           np.arange(nc, dtype=np.int64)[:, None], nc),
    }


# --------------------------------------------------------------------- #
# coarse->fine child id arrays (factor-2 nesting)
# --------------------------------------------------------------------- #

def children_cells(cshape):
    """(n_coarse_cells, 8) fine cell ids, subgrid-lex (dx fastest)."""
    fshape = tuple(2 * s for s in cshape)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out.append(cell_id(fshape, 2 * ijk[:, 0] + dx,
                                   2 * ijk[:, 1] + dy, 2 * ijk[:, 2] + dz))
    return np.stack(out, axis=1)


def children_faces(cshape):
    """(n_coarse_faces, 4) fine face ids per coarse face, in-plane
    (b, c)-lex (b fastest) — the canonical facet-children order."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for dc in (0, 1):
            for db in (0, 1):
                co = 2 * ijk
                co[:, a] = 2 * ijk[:, a]          # vertex-line coord
                co[:, b] += db
                co[:, c] += dc
                out.append(face_id(fshape, a, co[:, 0], co[:, 1],
                                   co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def children_edges(cshape):
    """(n_coarse_edges, 2) fine edge ids per coarse edge, lex along the
    edge axis."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for da in (0, 1):
            co = 2 * ijk
            co[:, a] += da
            out.append(edge_id(fshape, a, co[:, 0], co[:, 1], co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def children_verts(cshape):
    """(n_coarse_verts,) fine vertex ids of the coarse lattice points."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    ijk = _grid3(range(nx + 1), range(ny + 1), range(nz + 1))
    return vert_id(fshape, 2 * ijk[:, 0], 2 * ijk[:, 1], 2 * ijk[:, 2])


# --------------------------------------------------------------------- #
# static 2x2x2-subgrid patterns (level-independent)
# --------------------------------------------------------------------- #

_S = (2, 2, 2)


def _subgrid_face_slots():
    """Canonical order of the 36 subgrid faces: [12 interior (family a
    at mid-plane, (b,c)-lex); 24 boundary grouped by coarse facet in
    [x0,x1,y0,y1,z0,z1] order, each facet's 4 children (b,c)-lex].
    Returns slot_of_face (36,): subgrid face id -> slot."""
    nc, nf, ne, nv = grid_counts(_S)
    order = []
    for a in range(3):                      # interior: axis coord == 1
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[a], co[b], co[c] = 1, db, dc
                order.append(face_id(_S, a, *co))
    for a in range(3):                      # boundary facets a0, a1
        b, c = [ax for ax in range(3) if ax != a]
        for side in (0, 2):
            for dc in (0, 1):
                for db in (0, 1):
                    co = [0, 0, 0]
                    co[a], co[b], co[c] = side, db, dc
                    order.append(face_id(_S, a, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == sum(nf) == 36
    slot = np.zeros(sum(nf), dtype=np.int64)
    slot[order] = np.arange(36)
    return slot


def _subgrid_u_faces(cshape):
    """(n_coarse_cells, 36) fine face ids of each coarse cell's subgrid
    faces, in the canonical 36-slot order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_face_slots()
    # subgrid face id -> (family, local lattice coords)
    inv = np.empty((36, 4), dtype=np.int64)
    for a in range(3):
        dims = [(3, 2, 2), (2, 3, 2), (2, 2, 3)][a]
        for x in range(dims[0]):
            for y in range(dims[1]):
                for z in range(dims[2]):
                    inv[face_id(_S, a, x, y, z)] = (a, x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 36), dtype=np.int64)
    for sf in range(36):
        a, x, y, z = inv[sf]
        out[:, slot[sf]] = face_id(
            fshape, a, 2 * ijk[:, 0] + x, 2 * ijk[:, 1] + y,
            2 * ijk[:, 2] + z)
    return out


def _cell_stage_patterns_hdiv():
    """Static patterns of the Hdiv interior (Lagrange) extension:
      fslot:  (8, 6)  child-cell face -> 36-slot (M02 local order)
    The 36-slot order puts the 12 interior faces first and the boundary
    faces facet-by-facet, so Pb rows are [4*f + i] for facet f child i."""
    slot = _subgrid_face_slots()
    return slot[cell_faces(_S)]


# --------------------------------------------------------------------- #
# level state
# --------------------------------------------------------------------- #

@dataclass
class StructuredLevel:
    """Per-level value plane (device arrays) of the structured engine.

    Local mass families follow the canonical local orders documented in
    fine_local_masses; derivative value arrays follow the d0/d1/d2
    column patterns.  At coarse (ALG) levels the PV traces are all ones
    (the reference's +-1-at-PV-dof convention with this module's
    axis-aligned orientations), so only the level-0 state carries
    nontrivial pv arrays."""
    shape: tuple
    m00: object = None      # (nc, 8, 8)
    m10: object = None      # (nf, 4, 4)
    m20: object = None      # (ne, 2, 2)
    m01: object = None      # (nc, 12, 12)
    m11: object = None      # (nf, 4, 4)
    m21: object = None      # (ne,)
    m02: object = None      # (nc, 6, 6)
    m12: object = None      # (nf,)
    m03: object = None      # (nc,)
    d0: object = None       # (ne, 2)
    d1: object = None       # (nf, 4)
    d2: object = None       # (nc, 6)
    pv1: object = None      # (ne,)
    pv2: object = None      # (nf,)
    t0: object = None       # (nv, k0)
    t1: object = None       # (ne, k1)
    t2: object = None       # (nf, k2)
    t3: object = None       # (nc, k3)


def fine_level(shape, h=None, dtype=np.float64, coeff=None,
               l2_weight=None) -> StructuredLevel:
    """Level-0 state of the structured engine on a [0,1]^3-style brick
    grid (h defaults to 1/shape per axis).  coeff: per-cell scalar
    weighting the codim-0 masses of all forms (heterogeneous media);
    l2_weight: separate per-cell weight for the L2 mass (Darcy W)."""
    if h is None:
        h = tuple(1.0 / s for s in shape)
    nc, nf, ne, nv = grid_counts(shape)
    ref = fine_local_masses(h, dtype)
    dt = np.dtype(dtype)

    def bc(M, n):
        return jnp.broadcast_to(jnp.asarray(M, dtype=dt), (n,) + M.shape)

    def fam(Ms, counts):
        return jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(M, dtype=dt),
                             (cnt,) + M.shape)
            for M, cnt in zip(Ms, counts)], axis=0)

    c = (jnp.asarray(coeff, dtype=dt) if coeff is not None
         else jnp.ones(nc, dtype=dt))
    w = (jnp.asarray(l2_weight, dtype=dt) if l2_weight is not None
         else c)
    lvl = StructuredLevel(shape=shape)
    lvl.m00 = c[:, None, None] * bc(ref[(0, 0)], nc)
    lvl.m01 = c[:, None, None] * bc(ref[(0, 1)], nc)
    lvl.m02 = c[:, None, None] * bc(ref[(0, 2)], nc)
    lvl.m03 = w * float(ref[(0, 3)][0, 0])
    lvl.m10 = fam(ref[(1, 0)], nf)
    lvl.m11 = fam(ref[(1, 1)], nf)
    lvl.m12 = jnp.concatenate([
        jnp.full(nf[a], float(ref[(1, 2)][a][0, 0]), dtype=dt)
        for a in range(3)])
    lvl.m20 = fam(ref[(2, 0)], ne)
    lvl.m21 = jnp.concatenate([
        jnp.full(ne[a], float(ref[(2, 1)][a][0, 0]), dtype=dt)
        for a in range(3)])
    d0, d1, d2 = fine_derivative_values(shape, h, dt)
    lvl.d0, lvl.d1, lvl.d2 = (jnp.asarray(x) for x in (d0, d1, d2))
    # PV traces: Hcurl = unit tangent (circulation = h_a), Hdiv = unit
    # normal (flux = area); H1/L2 = 1 (fespace.compute_pv_traces)
    lvl.pv1 = jnp.concatenate([
        jnp.full(ne[a], float(h[a]), dtype=dt) for a in range(3)])
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    lvl.pv2 = jnp.concatenate([
        jnp.full(nf[a], float(areas[a]), dtype=dt) for a in range(3)])
    # order-0 polynomial upscaling targets (SetUpscalingTargets):
    # constants for H1/L2, the three unit fields for Hcurl/Hdiv
    lvl.t0 = jnp.ones((nv, 1), dtype=dt)
    lvl.t3 = jnp.ones((nc, 1), dtype=dt)
    lvl.t1 = jnp.concatenate([
        jnp.broadcast_to(
            (jnp.eye(3, dtype=dt) * jnp.asarray(h, dtype=dt))[a],
            (ne[a], 3))
        for a in range(3)], axis=0)
    lvl.t2 = jnp.concatenate([
        jnp.broadcast_to(
            (jnp.eye(3, dtype=dt) * jnp.asarray(areas, dtype=dt))[a],
            (nf[a], 3))
        for a in range(3)], axis=0)
    return lvl


# --------------------------------------------------------------------- #
# stage cores (jittable)
# --------------------------------------------------------------------- #

_SOLVE_MODE = "direct"


class solve_mode:
    """Context manager selecting the batched-solve strategy of the
    stage kernels:

      * "direct" — jnp.linalg.solve (batched LU; the default, and the
        mode the bench and chip_smoke.py run).
      * "ns" — equilibrated f32 Newton-Schulz inverse + iterative
        refinement in pure matmuls (same recipe as
        ops/batched._ns_solve_batch but fully in-graph so the engine
        stays device-resident).  Which mode is faster on the H100 is
        not decided here: chip_smoke.py times both.  Accuracy
        is the f32 refinement floor (~1e-6 relative); the static-
        structure asserts widen their bubble threshold accordingly.
    """

    def __init__(self, mode):
        assert mode in ("direct", "ns"), mode
        self.mode = mode

    def __enter__(self):
        global _SOLVE_MODE
        self._prev = _SOLVE_MODE
        _SOLVE_MODE = self.mode
        return self

    def __exit__(self, *exc):
        global _SOLVE_MODE
        _SOLVE_MODE = self._prev
        return False


# Trace-time scratch list of per-solve relative residuals: every
# _ns_refined_solve appends one scalar; the level drivers drain it into
# a single returned/asserted diagnostic (advisor r3: a partially
# converged NS solve must not silently degrade P quality).
_NS_DIAG = []

# Refinement targets/caps of the NS solve (f32 floor is ~1e-6 relative;
# the level guard asserts an order of magnitude above it).
_NS_REFINE_TOL = 1e-6
_NS_MAX_REFINE = 24
_NS_GUARD_TOL = 1e-4


def _ns_refined_solve(A, B, iters=40):
    """In-graph equilibrated Newton-Schulz batched solve.  X0 = A^T / c
    with c = ||A||_1 ||A||_inf makes E = I - XA contract quadratically
    for ANY nonsingular A (incl. the indefinite saddle blocks), since
    the eigenvalues of A^T A / c lie in (0, 1].  Iterative refinement
    runs to a measured residual target (not a fixed count): the loop
    continues until max_n ||B_n - A_n Y_n||_F / ||B_n||_F <= 1e-6 or the
    cap, and the FINAL residual is appended to _NS_DIAG so the level
    driver can assert convergence instead of assuming it."""
    dt = A.dtype
    s = jnp.abs(A).max(axis=2)
    d = 1.0 / jnp.sqrt(jnp.where(s > 0, s, 1.0))
    Aeq = (A * d[:, :, None] * d[:, None, :]).astype(jnp.float32)
    Beq = (B * d[:, :, None]).astype(jnp.float32)
    n = Aeq.shape[1]
    a1 = jnp.abs(Aeq).sum(axis=1).max(axis=1)
    ainf = jnp.abs(Aeq).sum(axis=2).max(axis=1)
    c = jnp.maximum(a1 * ainf, 1e-30)
    X = Aeq.transpose(0, 2, 1) / c[:, None, None]
    I2 = 2.0 * jnp.eye(n, dtype=jnp.float32)[None]
    X = jax.lax.fori_loop(0, iters, lambda _, X: X @ (I2 - Aeq @ X), X)
    bn = jnp.maximum(jnp.sqrt(jnp.sum(Beq * Beq, axis=(1, 2))), 1e-30)

    def _res(Y):
        R = Beq - Aeq @ Y
        return R, jnp.max(jnp.sqrt(jnp.sum(R * R, axis=(1, 2))) / bn)

    def body(st):
        Y, _, i = st
        R, res = _res(Y)
        return (Y + X @ R, res, i + 1)

    def cond(st):
        _, res, i = st
        return (i < 2) | ((i < _NS_MAX_REFINE) & (res > _NS_REFINE_TOL))

    Y = X @ Beq
    Y, _, _ = jax.lax.while_loop(
        cond, body, (Y, jnp.asarray(jnp.inf, jnp.float32),
                     jnp.asarray(0, jnp.int32)))
    _, res = _res(Y)
    _NS_DIAG.append(res)
    return (Y * d[:, :, None]).astype(dt)


def _drain_ns_diag():
    """Max of the NS residuals accumulated since the last drain (0 when
    no NS solve ran, e.g. direct mode)."""
    if not _NS_DIAG:
        return jnp.zeros((), jnp.float32)
    out = jnp.max(jnp.stack(_NS_DIAG))
    _NS_DIAG.clear()
    return out


def _snap_zero(lam):
    """Zero-snap for structurally-zero coarse-derivative entries: exact
    arithmetic leaves them at the f64 eps floor in direct mode, but at
    the NS noise floor (~1e-6 relative) in ns mode — widen the
    threshold with the solve mode so coarse D@D=0 holds on the
    production path (advisor r3)."""
    dt = lam.dtype
    if _SOLVE_MODE == "ns":
        thr = 1e-5 * jnp.max(jnp.abs(lam), axis=-1, keepdims=True)
    else:
        thr = jnp.asarray(np.finfo(np.float64).eps, dtype=dt)
    return jnp.where(jnp.abs(lam) > thr, -lam, jnp.zeros_like(lam))


def _solve_batch(A, rhs):
    """Batched dense solve; strategy selected via solve_mode()."""
    if _SOLVE_MODE == "ns":
        return _ns_refined_solve(A, rhs)
    return jnp.linalg.solve(A, rhs)


def _trace_scalar_stage(m_children, pv_children, t_children):
    """Generic trace stage with 1x1 child blocks (L2 / Hdiv-facet /
    Hcurl-edge traces; ComputeCoarseTracesWithTargets restricted to the
    pure-PV outcome): returns (Ptr, F, cm, t_coarse, max_rel_sv) where
    max_rel_sv is the largest deflated singular value relative to the
    PV norm (must sit below the SVD keep-threshold for the static
    structure to be valid — asserted by the driver)."""
    mpv = m_children * pv_children
    dots = jnp.sum(pv_children * mpv, axis=1)
    F = mpv / dots[:, None]
    kt = t_children.shape[2]
    t_coarse = jnp.einsum("nk,nkt->nt", F, t_children)
    Td = t_children - pv_children[:, :, None] * t_coarse[:, None, :]
    w = Td * jnp.sqrt(m_children)[:, :, None]
    G = jnp.einsum("nkt,nks->nts", w, w)
    ev = jnp.linalg.eigvalsh(G)
    max_rel = jnp.max(jnp.sqrt(jnp.clip(ev, 0.0, None))
                      / dots[:, None]) if kt else jnp.zeros(())
    return pv_children, F, dots, t_coarse, max_rel


_HDIV_CELL_ROWS24 = np.arange(24)
_HDIV_CELL_COLS24 = np.repeat(np.arange(6), 4)


def _hdiv_interior_stage(m02_ch, vols_ch, d2_ch, ptr3, ptr2_cf, t2_u,
                         fslot):
    """Hdiv interior Lagrange extension (hFacetExtension for jform=2):
    per coarse cell, u = 36 subgrid faces (12 interior first), p = 8
    child cells, one PV multiplier.  Inputs are pre-gathered:
      m02_ch (n,8,6,6), vols_ch (n,8), d2_ch (n,8,6), ptr3 (n,8),
      ptr2_cf (n,6,4) facet-trace P values, t2_u (n,36,kt) Hdiv targets
      on the u dofs (slot order), fslot (8,6) static.
    Returns (Pint (n,12,6), d2c (n,6), cm (n,6,6), bub_sv_rel)."""
    n = m02_ch.shape[0]
    dt = m02_ch.dtype
    idx = (fslot[:, :, None] * 36 + fslot[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 36 * 36), dtype=dt).at[:, idx].add(
        m02_ch.reshape(n, -1)).reshape(n, 36, 36)
    Dloc = jnp.zeros((n, 8, 36), dtype=dt).at[
        :, np.arange(8)[:, None], fslot].set(d2_ch)
    B = vols_ch[:, :, None] * Dloc                  # (n, 8, 36)
    T = vols_ch * ptr3                              # (n, 8)
    Pb = jnp.zeros((n, 24, 6), dtype=dt).at[
        :, _HDIV_CELL_ROWS24, _HDIV_CELL_COLS24].set(
        ptr2_cf.reshape(n, 24))          # row 4*f + i <- facet f child i
    M_ii, M_ib = Mae[:, :12, :12], Mae[:, :12, 12:]
    B_ii, B_ib = B[:, :, :12], B[:, :, 12:]

    A = jnp.zeros((n, 21, 21), dtype=dt)
    A = A.at[:, :12, :12].set(M_ii)
    A = A.at[:, 12:20, :12].set(B_ii)
    A = A.at[:, :12, 12:20].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 20, 12:20].set(T)
    A = A.at[:, 12:20, 20].set(T)

    kt = t2_u.shape[2]
    t_int, t_bdr = t2_u[:, :12], t2_u[:, 12:]
    rhs = jnp.zeros((n, 21, 6 + kt), dtype=dt)
    rhs = rhs.at[:, :12, :6].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 12:20, :6].set(-(B_ib @ Pb))
    rhs = rhs.at[:, :12, 6:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, 12:20, 6:].set(B_ii @ t_int)

    X = _solve_batch(A, rhs)
    Pint = X[:, :12, :6]
    d2c = _snap_zero(X[:, 20, :6])
    bub = t_int - X[:, :12, 6:]
    G = jnp.einsum("nit,nis->nts", bub, bub)
    bub_sv = jnp.sqrt(jnp.clip(jnp.max(jnp.linalg.eigvalsh(G)),
                               0.0, None)) if kt else jnp.zeros(())
    basis = jnp.concatenate([Pint, Pb], axis=1)     # (n, 36, 6)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return Pint, d2c, cm, bub_sv


# --------------------------------------------------------------------- #
# level driver: Darcy chain (L2 + Hdiv) — jform_start=2 in the generic
# engine's terms
# --------------------------------------------------------------------- #

@dataclass
class DarcyLevelOut:
    """Per-level outputs of the Hdiv-L2 coarsening (device arrays +
    host id arrays for materialization)."""
    cshape: tuple
    ptr3: object            # (ncc, 8)   L2 trace P values
    f3: object              # (ncc, 8)   L2 cochain functionals
    ptr2: object            # (ncf, 4)   Hdiv facet-trace P values
    f2: object              # (ncf, 4)
    pint2: object           # (ncc, 12, 6) Hdiv interior P values
    d2c: object             # (ncc, 6)   coarse div values
    cc: object = None       # (ncc, 8)   fine cell ids (host)
    cf: object = None       # (ncf, 4)   fine face ids (host)
    cfaces: object = None   # (ncc, 6)   coarse facet ids (host)
    ufaces: object = None   # (ncc, 36)  fine face ids, slot order (host)
    max_rel_sv: float = 0.0
    bub_sv: float = 0.0
    ns_res: float = 0.0      # max NS solve residual (0 in direct mode)


def coarsen_darcy(lvl: StructuredLevel, svd_tol=1e-9):
    """One structured coarsening step of the Hdiv x L2 pair (the
    reference's form_start=2 configuration: MultigridTestDarcy /
    SPE10).  Returns (coarse_level, DarcyLevelOut)."""
    shape = lvl.shape
    assert all(s % 2 == 0 for s in shape), shape
    cshape = tuple(s // 2 for s in shape)
    cc = children_cells(cshape)
    cf = children_faces(cshape)
    cfaces = d2_cols(cshape)
    ufaces = _subgrid_u_faces(cshape)
    fslot = _cell_stage_patterns_hdiv()

    mode = _SOLVE_MODE        # capture once: stages + asserts agree
    jcc, jcf, jcfaces, jufaces = (jnp.asarray(x, dtype=jnp.int32)
                                  for x in (cc, cf, cfaces, ufaces))
    dt = lvl.m03.dtype
    pv3 = jnp.ones(lvl.m03.shape[0], dtype=dt)

    saved = list(_NS_DIAG)
    _NS_DIAG.clear()
    try:
        with jax.default_matmul_precision("float32"):
            # --- stage T3: L2 traces --------------------------------- #
            ptr3, f3, m03c, t3c, sv3 = _trace_scalar_stage(
                lvl.m03[jcc], pv3[jcc], lvl.t3[jcc])
            # --- stage T2: Hdiv facet traces ------------------------- #
            ptr2, f2, m12c, t2c, sv2 = _trace_scalar_stage(
                lvl.m12[jcf], lvl.pv2[jcf], lvl.t2[jcf])
            # --- stage E2: Hdiv interior Lagrange extension ---------- #
            pint2, d2c, m02c, bubsv = _hdiv_interior_stage(
                lvl.m02[jcc], lvl.m03[jcc], lvl.d2[jcc], ptr3,
                ptr2[jcfaces], lvl.t2[jufaces], fslot)
        nsres = float(_drain_ns_diag())
    finally:
        _NS_DIAG.clear()
        _NS_DIAG.extend(saved)

    nc, nf, ne, nv = grid_counts(cshape)
    coarse = StructuredLevel(shape=cshape)
    coarse.m03, coarse.m12, coarse.m02 = m03c, m12c, m02c
    coarse.d2 = d2c
    coarse.pv2 = jnp.ones(sum(nf), dtype=dt)
    coarse.t3, coarse.t2 = t3c, t2c

    out = DarcyLevelOut(
        cshape=cshape, ptr3=ptr3, f3=f3, ptr2=ptr2, f2=f2,
        pint2=pint2, d2c=d2c, cc=cc, cf=cf, cfaces=cfaces,
        ufaces=ufaces,
        max_rel_sv=float(jnp.maximum(sv3, sv2)),
        bub_sv=float(bubsv), ns_res=nsres)
    # noise allowance 200*eps: the deflated-trace Gram is exact-zero
    # in exact arithmetic; its f32 rounding tail measured 6.4e-6
    # (~54*eps) as the MAX over 884k entities at 96^3 on the chip,
    # while a genuinely kept mode shows >= 1e-3 (heterogeneity test)
    eff = max(svd_tol, 200.0 * float(jnp.finfo(dt).eps))
    bub_eff = max(1e2 * svd_tol, eff, 2e-4 if mode == "ns" else 0.0)
    assert out.max_rel_sv < eff, \
        (out.max_rel_sv, "trace SVD kept a mode: structure not static")
    assert out.bub_sv < bub_eff, \
        (out.bub_sv, "bubble SVD kept a mode: structure not static")
    assert out.ns_res < _NS_GUARD_TOL, \
        (out.ns_res, "NS stage solve did not converge to the "
         "refinement floor")
    return coarse, out


def materialize_P_darcy(out: DarcyLevelOut, fshape):
    """Host CSRs (P2, P3) of one structured Darcy coarsening step."""
    import scipy.sparse as sp
    ncf_, nff, nef, nvf = grid_counts(fshape)
    ncc, nfc, nec, nvc = grid_counts(out.cshape)
    ptr3 = np.asarray(out.ptr3)
    rows = out.cc.ravel()
    cols = np.repeat(np.arange(ncc), 8)
    P3 = sp.coo_matrix((ptr3.ravel(), (rows, cols)),
                       shape=(ncf_, ncc)).tocsr()
    ptr2 = np.asarray(out.ptr2)
    pint2 = np.asarray(out.pint2)
    rows = np.concatenate([out.cf.ravel(),
                           np.repeat(out.ufaces[:, :12].ravel(), 6)])
    cols = np.concatenate([
        np.repeat(np.arange(sum(nfc)), 4),
        np.tile(out.cfaces, (1, 12)).reshape(-1)])
    vals = np.concatenate([ptr2.ravel(), pint2.ravel()])
    P2 = sp.coo_matrix((vals, (rows, cols)),
                       shape=(sum(nff), sum(nfc))).tocsr()
    return P2, P3


# --------------------------------------------------------------------- #
# Hcurl stage patterns
# --------------------------------------------------------------------- #

def _subgrid_edge_slots():
    """Canonical order of the 54 subgrid edges of a 2x2x2 cell-AE:
    [6 interior (axis a through the center, a-coord lex, a = x,y,z);
     24 coarse-edge children grouped by coarse edge in the coarse
     cell_edges order, each edge's 2 children lex along the axis;
     24 facet-interior edges grouped by facet in [x0,x1,y0,y1,z0,z1]
     order, each facet's 4 interior edges in the face-subgrid interior
     order (2 along b at c-line 1, b-lex; 2 along c at b-line 1)].
    Returns slot_of_edge (54,)."""
    order = []
    for a in range(3):                      # interior: through center
        for da in (0, 1):
            co = [1, 1, 1]
            co[a] = da
            order.append(edge_id(_S, a, *co))
    # coarse-edge children: coarse edges of the unit cell in cell_edges
    # order = [x-edges (dy,dz) y-lex; y; z] with endpoints scaled by 2
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                for da in (0, 1):
                    co = [0, 0, 0]
                    co[a], co[b], co[c] = da, 2 * db, 2 * dc
                    order.append(edge_id(_S, a, *co))
    # facet interiors: facet (axis fa, side s) at a-coord 2*s; in-plane
    # (b, c): edges along b at c-line 1 (db lex), then along c at b 1
    for fa in range(3):
        b, c = [ax for ax in range(3) if ax != fa]
        for s in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[fa], co[b], co[c] = 2 * s, db, 1
                order.append(edge_id(_S, b, *co))
            for dc in (0, 1):
                co = [0, 0, 0]
                co[fa], co[b], co[c] = 2 * s, 1, dc
                order.append(edge_id(_S, c, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == 54, order
    slot = np.zeros(54, dtype=np.int64)
    slot[order] = np.arange(54)
    return slot


def _subgrid_u_edges(cshape):
    """(n_coarse_cells, 54) fine edge ids in the canonical 54-slot
    order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_edge_slots()
    inv = np.empty((54, 4), dtype=np.int64)
    for a in range(3):
        dims = [(2, 3, 3), (3, 2, 3), (3, 3, 2)][a]
        for x in range(dims[0]):
            for y in range(dims[1]):
                for z in range(dims[2]):
                    inv[edge_id(_S, a, x, y, z)] = (a, x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 54), dtype=np.int64)
    for se in range(54):
        a, x, y, z = inv[se]
        out[:, slot[se]] = edge_id(
            fshape, a, 2 * ijk[:, 0] + x, 2 * ijk[:, 1] + y,
            2 * ijk[:, 2] + z)
    return out


def _face_subgrid_edge_order():
    """For each face family a: the 12 fine edges of a coarse face's 2x2
    subgrid in the canonical face order [4 interior (2 along b at
    c-line 1, b-lex; 2 along c at b-line 1); 8 boundary grouped by
    coarse edge in M11 order (eb(c0), eb(c1), ec(b0), ec(b1)), children
    lex].  Returns, per family, a list of 12 (axis, dx, dy, dz) OFFSETS
    from the (2*fa, 2*fb, 2*fc) face origin."""
    fams = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        offs = []

        def eo(axis, ob, oc):
            o = [0, 0, 0]
            o[b], o[c] = ob, oc
            return (axis, o[0], o[1], o[2])

        for db in (0, 1):
            offs.append(eo(b, db, 1))          # interior along b
        for dc in (0, 1):
            offs.append(eo(c, 1, dc))          # interior along c
        for db in (0, 1):
            offs.append(eo(b, db, 0))          # eb(c0) children
        for db in (0, 1):
            offs.append(eo(b, db, 2))          # eb(c1) children
        for dc in (0, 1):
            offs.append(eo(c, 0, dc))          # ec(b0) children
        for dc in (0, 1):
            offs.append(eo(c, 2, dc))          # ec(b1) children
        fams.append(offs)
    return fams


def _face_u_edges(cshape):
    """(n_coarse_faces, 12) fine edge ids of each coarse face's subgrid
    in the canonical face order (all three families concatenated)."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    fams = _face_subgrid_edge_order()
    cols = []
    for a in range(3):
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        out = np.empty((len(ijk), 12), dtype=np.int64)
        for s, (axis, ox, oy, oz) in enumerate(fams[a]):
            out[:, s] = edge_id(fshape, axis, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
        cols.append(out)
    return np.concatenate(cols, axis=0)


def _face_child_edge_slots():
    """(4, 4) per face family: child face (db, dc) local M11 edges ->
    face-subgrid slots.  The local M11 order and the face order above
    are family-independent in (b, c) terms, so one table serves all
    three families."""
    # face subgrid edge keyed by (along_b?, b-coord, c-line) for b-edges
    # and (along_b?, b-line, c-coord) for c-edges, mirroring the order
    # in _face_subgrid_edge_order
    key2slot = {}
    slotlist = [("b", db, 1) for db in (0, 1)] + \
               [("c", 1, dc) for dc in (0, 1)] + \
               [("b", db, 0) for db in (0, 1)] + \
               [("b", db, 2) for db in (0, 1)] + \
               [("c", 0, dc) for dc in (0, 1)] + \
               [("c", 2, dc) for dc in (0, 1)]
    for s, k in enumerate(slotlist):
        key2slot[k] = s
    out = np.empty((4, 4), dtype=np.int64)
    for dc in (0, 1):
        for db in (0, 1):
            ch = dc * 2 + db          # children order: b fastest
            # child's M11 edge order: eb(c0), eb(c1), ec(b0), ec(b1)
            out[ch] = [key2slot[("b", db, dc)],
                       key2slot[("b", db, dc + 1)],
                       key2slot[("c", db, dc)],
                       key2slot[("c", db + 1, dc)]]
    return out


def _cell_child_edge_slots():
    """(8, 12) child cell -> 54-slot positions of its cell_edges-order
    local edges."""
    slot = _subgrid_edge_slots()
    return slot[cell_edges(_S)]


def _cell_facet_edge_positions():
    """(6, 4) positions of each facet's 4 coarse edges (M11 order)
    within the coarse cell's 12-edge list (cell_edges order)."""
    ce = cell_edges((1, 1, 1))[0]                 # 12 ids
    pos = {int(e): i for i, e in enumerate(ce)}
    fe = face_edges_m((1, 1, 1))                  # (6, 4) in family order
    # reorder rows into the facet order [x0,x1,y0,y1,z0,z1]: family
    # order of face ids on (1,1,1) is [x0,x1,y0,y1,z0,z1] already
    return np.vectorize(pos.get)(fe)


_E1F_ROWS8 = np.arange(8)
_E1F_COLS8 = np.repeat(np.arange(4), 2)


def _hcurl_facet_stage(m11_ch, m12_ch, d1_ch, ptr2_f, ptr1_ce, t1_u,
                       eslot):
    """Hcurl facet Lagrange extension (hFacetExtension for jform=1):
    per coarse face, u = 12 subgrid edges (4 interior first), p = 4
    child faces, one PV multiplier (the facet's Hdiv PV).
      m11_ch (n,4,4,4), m12_ch (n,4), d1_ch (n,4,4), ptr2_f (n,4)
      facet-trace P2 values of THIS face, ptr1_ce (n,4,2) edge-trace P1
      values of the face's 4 coarse edges (M11 order), t1_u (n,12,kt),
      eslot (4,4) static child-edge -> face-slot.
    Returns (Pf1 (n,4,4), d1c (n,4), cm (n,4,4), bub_sv)."""
    n = m11_ch.shape[0]
    dt = m11_ch.dtype
    idx = (eslot[:, :, None] * 12 + eslot[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 12 * 12), dtype=dt).at[:, idx].add(
        m11_ch.reshape(n, -1)).reshape(n, 12, 12)
    Dloc = jnp.zeros((n, 4, 12), dtype=dt).at[
        :, np.arange(4)[:, None], eslot].set(d1_ch)
    B = m12_ch[:, :, None] * Dloc                   # (n, 4, 12)
    T = m12_ch * ptr2_f                             # (n, 4)
    Pb = jnp.zeros((n, 8, 4), dtype=dt).at[
        :, _E1F_ROWS8, _E1F_COLS8].set(ptr1_ce.reshape(n, 8))
    M_ii, M_ib = Mae[:, :4, :4], Mae[:, :4, 4:]
    B_ii, B_ib = B[:, :, :4], B[:, :, 4:]

    A = jnp.zeros((n, 9, 9), dtype=dt)
    A = A.at[:, :4, :4].set(M_ii)
    A = A.at[:, 4:8, :4].set(B_ii)
    A = A.at[:, :4, 4:8].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 8, 4:8].set(T)
    A = A.at[:, 4:8, 8].set(T)

    kt = t1_u.shape[2]
    t_int, t_bdr = t1_u[:, :4], t1_u[:, 4:]
    rhs = jnp.zeros((n, 9, 4 + kt), dtype=dt)
    rhs = rhs.at[:, :4, :4].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 4:8, :4].set(-(B_ib @ Pb))
    rhs = rhs.at[:, :4, 4:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, 4:8, 4:].set(B_ii @ t_int)

    X = _solve_batch(A, rhs)
    Pf1 = X[:, :4, :4]
    d1c = _snap_zero(X[:, 8, :4])
    bub = t_int - X[:, :4, 4:]
    G = jnp.einsum("nit,nis->nts", bub, bub)
    bub_sv = jnp.sqrt(jnp.clip(jnp.max(jnp.linalg.eigvalsh(G)),
                               0.0, None)) if kt else jnp.zeros(())
    basis = jnp.concatenate([Pf1, Pb], axis=1)      # (n, 12, 4)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return Pf1, d1c, cm, bub_sv


_E1C_ROWS24 = np.arange(24)
_E1C_COLS24 = np.repeat(np.arange(12), 2)


def _hcurl_interior_stage(m01_ch, m02_ch, vols_ch, d1_u, d2_ch,
                          ptr1_ce, pf1_cf, pint2, ptr2_cf, d1c_cf, t1_u,
                          eslot_cell, fslot, fe_slot, fep):
    """Hcurl interior extension ([M B^T; B -C], hRidgePeakExtension for
    jform=1, with null targets): per coarse cell, u = 54 subgrid edges
    (6 interior first), p = 36 subgrid faces (12 interior first),
    e2 = 8 child cells.
      m01_ch (n,8,12,12), m02_ch (n,8,6,6), vols_ch (n,8),
      d1_u (n,36,4) fine curl values of the subgrid faces (slot order),
      d2_ch (n,8,6), ptr1_ce (n,12,2), pf1_cf (n,6,4,4),
      pint2 (n,12,6) this AE's Hdiv interior P block,
      ptr2_cf (n,6,4), d1c_cf (n,6,4) coarse curl values of the 6
      facets, t1_u (n,54,kt); static: eslot_cell (8,12), fslot (8,6),
      fe_slot (36,4), fep (6,4).
    Returns (Pc1 (n,6,12), cm (n,12,12), bub_sv)."""
    n = m01_ch.shape[0]
    dt = m01_ch.dtype
    idx = (eslot_cell[:, :, None] * 54
           + eslot_cell[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 54 * 54), dtype=dt).at[:, idx].add(
        m01_ch.reshape(n, -1)).reshape(n, 54, 54)
    fidx = (fslot[:, :, None] * 36 + fslot[:, None, :]).reshape(-1)
    Wae = jnp.zeros((n, 36 * 36), dtype=dt).at[:, fidx].add(
        m02_ch.reshape(n, -1)).reshape(n, 36, 36)
    D1loc = jnp.zeros((n, 36, 54), dtype=dt).at[
        :, np.arange(36)[:, None], fe_slot].set(d1_u)
    B = (Wae @ D1loc)[:, :12, :]                    # (n, 12, 54)
    D2loc = jnp.zeros((n, 8, 36), dtype=dt).at[
        :, np.arange(8)[:, None], fslot].set(d2_ch)
    D2i = D2loc[:, :, :12]
    C = jnp.einsum("nki,nk,nkj->nij", D2i, vols_ch, D2i)

    # PDc = P2 @ D1c within the AE: (n, 36, 12)
    D1c_cell = jnp.zeros((n, 6, 12), dtype=dt).at[
        :, np.arange(6)[:, None], fep].set(d1c_cf)
    pd_int = pint2 @ D1c_cell                       # (n, 12, 12)
    pd_bdr = (ptr2_cf[:, :, :, None]
              * D1c_cell[:, :, None, :]).reshape(n, 24, 12)
    dPcs = jnp.concatenate([pd_int, pd_bdr], axis=1)

    Pb = jnp.zeros((n, 48, 12), dtype=dt)
    Pb = Pb.at[:, _E1C_ROWS24, _E1C_COLS24].set(ptr1_ce.reshape(n, 24))
    # facet-interior rows 24 + 4f + j, cols fep[f]
    rows = (24 + 4 * np.arange(6)[:, None]
            + np.arange(4)[None, :])                        # (6, 4)
    Pb = Pb.at[:, rows[:, :, None], fep[:, None, :]].set(pf1_cf)

    M_ii, M_ib = Mae[:, :6, :6], Mae[:, :6, 6:]
    B_ii, B_ib = B[:, :, :6], B[:, :, 6:]
    A = jnp.zeros((n, 18, 18), dtype=dt)
    A = A.at[:, :6, :6].set(M_ii)
    A = A.at[:, 6:, :6].set(B_ii)
    A = A.at[:, :6, 6:].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 6:, 6:].set(-C)

    kt = t1_u.shape[2]
    t_int, t_bdr = t1_u[:, :6], t1_u[:, 6:]
    rhs = jnp.zeros((n, 18, 12 + kt), dtype=dt)
    rhs = rhs.at[:, :6, :12].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 6:, :12].set(-(B_ib @ Pb)
                                 + Wae[:, :12, :] @ dPcs)
    rhs = rhs.at[:, :6, 12:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, 6:, 12:].set(B_ii @ t_int)

    X = _solve_batch(A, rhs)
    Pc1 = X[:, :6, :12]
    bub = t_int - X[:, :6, 12:]
    G = jnp.einsum("nit,nis->nts", bub, bub)
    bub_sv = jnp.sqrt(jnp.clip(jnp.max(jnp.linalg.eigvalsh(G)),
                               0.0, None)) if kt else jnp.zeros(())
    basis = jnp.concatenate([Pc1, Pb], axis=1)      # (n, 54, 12)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return Pc1, cm, bub_sv


# --------------------------------------------------------------------- #
# full-chain level driver
# --------------------------------------------------------------------- #

@dataclass
class LevelOut:
    """Per-level outputs of the structured coarsening (device arrays
    plus host id arrays for materialization and diagnostics)."""
    cshape: tuple
    # L2 / Hdiv (set when jform_start <= 2)
    ptr3: object = None
    f3: object = None
    ptr2: object = None
    f2: object = None
    pint2: object = None
    d2c: object = None
    # Hcurl (jform_start <= 1)
    ptr1: object = None
    f1: object = None
    pf1: object = None
    pc1: object = None
    d1c: object = None
    # H1 (jform_start == 0)
    pe0: object = None
    pf0: object = None
    pc0: object = None
    d0c: object = None
    # host id arrays
    cc: object = None        # (ncc, 8) child cells
    cf: object = None        # (ncf, 4) child faces
    ce: object = None        # (nce, 2) child edges
    cv: object = None        # (ncv,)  child vertices
    cfaces: object = None    # (ncc, 6) coarse facet ids
    cedges: object = None    # (ncc, 12) coarse edge ids
    cverts: object = None    # (ncc, 8) coarse vertex ids
    fedges: object = None    # (ncf, 4) coarse edge ids per coarse face
    fverts: object = None    # (ncf, 4) coarse vertex ids per coarse face
    everts: object = None    # (nce, 2) coarse vertex ids per coarse edge
    ufaces: object = None    # (ncc, 36)
    uedges: object = None    # (ncc, 54)
    uverts: object = None    # (ncc, 27)
    fuedges: object = None   # (ncf, 12)
    fuverts: object = None   # (ncf, 9)
    euverts: object = None   # (nce, 3)
    max_rel_sv: float = 0.0
    bub_sv: float = 0.0
    ns_res: float = 0.0      # max NS solve residual (0 in direct mode)


def _level_ids(cshape, jform_start):
    """Host id arrays of one coarsening step (the only host-computed
    inputs of the jitted core)."""
    ids = dict(cc=children_cells(cshape), cf=children_faces(cshape),
               cfaces=d2_cols(cshape), ufaces=_subgrid_u_faces(cshape))
    if jform_start <= 1:
        ids.update(ce=children_edges(cshape),
                   fedges=face_edges_m(cshape),
                   cedges=cell_edges(cshape),
                   fuedges=_face_u_edges(cshape),
                   uedges=_subgrid_u_edges(cshape))
    if jform_start <= 0:
        ids.update(cv=children_verts(cshape), everts=d0_cols(cshape),
                   fverts=face_verts(cshape), cverts=cell_verts(cshape),
                   euverts=_edge_u_verts(cshape),
                   fuverts=_face_u_verts(cshape),
                   uverts=_subgrid_u_verts(cshape))
    return ids


def _coarsen_core(arrs, ids, cshape, jform_start, mode="direct"):
    """Pure-jnp body of one coarsening step: ONE jitted XLA program per
    level shape (the eager stage-by-stage dispatch would compile ~a
    hundred kernels per level; this compiles one, persisted by the
    compilation cache).  `mode` is a static jit argument: the
    stage kernels read the solve strategy at trace time, so it must be
    part of the executable-cache key and set during (re)tracing.

    The whole core traces under matmul precision 'float32': a
    default-precision f32 matmul on an accelerator may run in reduced
    precision (TF32 on the GPU, ~1e-3 relative error), which trips the
    static-structure guards.  The setup stages are small dense blocks,
    so full-f32 passes are cheap (chip_smoke.py prints both errors)."""
    global _SOLVE_MODE
    prev, _SOLVE_MODE = _SOLVE_MODE, mode
    saved = list(_NS_DIAG)
    _NS_DIAG.clear()
    try:
        with jax.default_matmul_precision("float32"):
            co, out, maxsv, maxbub = _coarsen_core_body(
                arrs, ids, cshape, jform_start)
        return co, out, maxsv, maxbub, _drain_ns_diag()
    finally:
        _NS_DIAG.clear()
        _NS_DIAG.extend(saved)
        _SOLVE_MODE = prev


def _coarsen_core_body(arrs, ids, cshape, jform_start):
    dt = arrs["m03"].dtype
    nc, nf, ne, nv = grid_counts(cshape)
    out, co = {}, {}
    svs, bubs = [], []
    jcc, jcf, jcfaces, jufaces = (ids["cc"], ids["cf"], ids["cfaces"],
                                  ids["ufaces"])

    # ---- L2 + Hdiv ---------------------------------------------------
    pv3 = jnp.ones(arrs["m03"].shape[0], dtype=dt)
    out["ptr3"], out["f3"], co["m03"], co["t3"], sv3 = \
        _trace_scalar_stage(arrs["m03"][jcc], pv3[jcc], arrs["t3"][jcc])
    out["ptr2"], out["f2"], co["m12"], co["t2"], sv2 = \
        _trace_scalar_stage(arrs["m12"][jcf], arrs["pv2"][jcf],
                            arrs["t2"][jcf])
    out["pint2"], out["d2c"], co["m02"], bub2 = _hdiv_interior_stage(
        arrs["m02"][jcc], arrs["m03"][jcc], arrs["d2"][jcc],
        out["ptr3"], out["ptr2"][jcfaces], arrs["t2"][jufaces],
        _cell_stage_patterns_hdiv())
    co["d2"] = out["d2c"]
    co["pv2"] = jnp.ones(sum(nf), dtype=dt)
    svs += [sv3, sv2]
    bubs += [bub2]

    # ---- Hcurl --------------------------------------------------------
    if jform_start <= 1:
        jce, jfedges, jcedges, jfuedges, juedges = (
            ids[k] for k in ("ce", "fedges", "cedges", "fuedges",
                             "uedges"))
        out["ptr1"], out["f1"], co["m21"], co["t1"], sv1 = \
            _trace_scalar_stage(arrs["m21"][jce], arrs["pv1"][jce],
                                arrs["t1"][jce])
        out["pf1"], out["d1c"], co["m11"], bub1f = _hcurl_facet_stage(
            arrs["m11"][jcf], arrs["m12"][jcf], arrs["d1"][jcf],
            out["ptr2"], out["ptr1"][jfedges], arrs["t1"][jfuedges],
            _face_child_edge_slots())
        out["pc1"], co["m01"], bub1c = _hcurl_interior_stage(
            arrs["m01"][jcc], arrs["m02"][jcc], arrs["m03"][jcc],
            arrs["d1"][jufaces], arrs["d2"][jcc],
            out["ptr1"][jcedges], out["pf1"][jcfaces], out["pint2"],
            out["ptr2"][jcfaces], out["d1c"][jcfaces],
            arrs["t1"][juedges],
            _cell_child_edge_slots(), _cell_stage_patterns_hdiv(),
            _cell_face_edge_slots(), _cell_facet_edge_positions())
        co["d1"] = out["d1c"]
        co["pv1"] = jnp.ones(sum(ne), dtype=dt)
        svs += [sv1]
        bubs += [bub1f, bub1c]

    # ---- H1 -----------------------------------------------------------
    if jform_start <= 0:
        jeuverts, jfuverts, juverts = (
            ids[k] for k in ("euverts", "fuverts", "uverts"))
        out["pe0"], out["d0c"], co["m20"], bub0e = _h1_edge_stage(
            arrs["m20"][jce], arrs["m21"][jce], arrs["d0"][jce],
            out["ptr1"], arrs["t0"][jeuverts])
        out["pf0"], co["m10"], bub0f = _h1_facet_stage(
            arrs["m10"][jcf], arrs["m11"][jcf], arrs["m12"][jcf],
            arrs["d0"][jfuedges], arrs["d1"][jcf],
            out["ptr1"][jfedges], out["pe0"][jfedges],
            out["d0c"][jfedges], out["pf1"], arrs["t0"][jfuverts],
            _face_child_vert_slots(), _face_child_edge_slots(),
            _face_edge_vert_slots())
        out["pc0"], co["m00"] = _h1_interior_stage(
            arrs["m00"][jcc], arrs["m01"][jcc], arrs["m02"][jcc],
            arrs["d0"][juedges], arrs["d1"][jufaces],
            out["ptr1"][jcedges], out["pe0"][jcedges],
            out["d0c"][jcedges], out["pf1"][jcfaces], out["pc1"],
            out["pf0"][jcfaces],
            _cell_child_vert_slots(), _cell_child_edge_slots(),
            _cell_stage_patterns_hdiv(), _cell_edge_vert_slots(),
            _cell_face_edge_slots(), _cell_facet_edge_positions(),
            _cell_edge_vert_positions(), _cell_facet_vert_positions())
        co["d0"] = out["d0c"]
        co["t0"] = arrs["t0"][ids["cv"]]
        bubs += [bub0e, bub0f]

    maxsv = jnp.max(jnp.stack(svs))
    maxbub = (jnp.max(jnp.stack(bubs)) if bubs
              else jnp.zeros((), dtype=dt))
    return co, out, maxsv, maxbub


_CORE_JIT = None

# Chunked-stage execution (HBM bound): levels whose coarse-cell count
# exceeds the threshold run stage-by-stage in fixed-size entity chunks
# instead of one whole-level XLA program — the whole-level program
# materializes O(ncc * 54^2) scatter/gather tensors for several stages
# at once.  One chunk holds < ~200 MB of stage tensors at the default
# size.  The threshold and chunk size were set for a 16 GB device; the
# right values for an 80 GB H100 are not measured.
_CHUNK_THRESHOLD = int(os.environ.get("PARELAG_STRUCT_CHUNK_THRESHOLD",
                                      16384))
_CHUNK_SIZE = int(os.environ.get("PARELAG_STRUCT_CHUNK", 8192))

_STAGE_CHUNK_JITS = {}


#: per-stage wall-clock accounting for the chunked driver:
#: name -> [seconds, n_chunks, n_calls].  Dispatch-only times unless
#: PARELAG_STC_SYNC=1 forces a device round-trip per stage (true
#: attribution; perturbs pipelining — diagnostics only).
STAGE_TIMES = {}


def reset_stage_times():
    STAGE_TIMES.clear()


def _stc_dispatch_mode():
    """Chunk dispatch strategy (PARELAG_STC_DISPATCH):
      loop  — one jitted call per chunk, index chunks shipped per call;
      slice — index tables shipped ONCE per stage; each chunk call
              dynamic-slices them on device (one traced scalar per
              dispatch — removes the per-chunk h2d index transfers);
      map   — the whole chunk loop runs as ONE lax.map dispatch per
              stage (fewest dispatches; recompiles per level since the
              chunk count is baked into the program)."""
    return os.environ.get("PARELAG_STC_DISPATCH", "slice")


def _run_stage_chunked(name, fn, spec, n, chunk, mode):
    """Run a batched stage over n entities in fixed-size device chunks.

    spec entries (in the stage's positional-argument order):
      ("g", array, idx)  — gathered input arr[idx], idx host int array
                           with leading dim n;
      ("d", array)       — per-entity device array (leading dim n),
                           treated as a gather with an identity index;
      ("s", const)       — static pattern table (np array, captured in
                           the chunk executable).

    Gathers happen INSIDE the per-chunk jitted program, so only one
    chunk of gathered stage tensors is live in HBM at a time.  The last
    chunk pads its index rows by repeating row 0 (valid math, duplicate
    outputs that are sliced away; max-reductions are unaffected because
    entity 0's true contribution is already present).  Per-entity
    outputs concatenate to length n; scalar outputs max-reduce."""
    t_begin = time.perf_counter()
    chunk = max(1, min(int(chunk), int(n)))   # never pad past n
    spec = [("g", e[1], np.arange(n, dtype=np.int64)) if e[0] == "d"
            else e for e in spec]
    kinds = tuple(e[0] for e in spec)
    statics = tuple(e[1] for e in spec if e[0] == "s")
    dispatch = _stc_dispatch_mode() if n > chunk else "loop"
    n_chunks = -(-n // chunk)

    def make_args(gfull, idx_c):
        args, gi, si = [], 0, 0
        for k in kinds:
            if k == "g":
                args.append(gfull[gi][idx_c[gi]])
                gi += 1
            else:
                args.append(statics[si])
                si += 1
        return args

    class _mode_ctx:
        def __enter__(self):
            global _SOLVE_MODE
            self.prev, _SOLVE_MODE = _SOLVE_MODE, mode
            self.saved = list(_NS_DIAG)
            _NS_DIAG.clear()

        def __exit__(self, *exc):
            global _SOLVE_MODE
            _NS_DIAG.clear()
            _NS_DIAG.extend(self.saved)
            _SOLVE_MODE = self.prev

    gfull = [e[1] for e in spec if e[0] == "g"]
    gidx = [np.asarray(e[2]) for e in spec if e[0] == "g"]

    def padded(ix):
        pad = n_chunks * chunk - n
        if pad:
            ix = np.concatenate(
                [ix, np.repeat(ix[:1], pad, axis=0)], axis=0)
        return ix.astype(np.int32)

    if dispatch == "map":
        key = (name, mode, "map", n_chunks)
        if key not in _STAGE_CHUNK_JITS:
            def run_map(gfull, gidx_st):
                with _mode_ctx(), jax.default_matmul_precision(
                        "float32"):
                    def body(idx_c):
                        _NS_DIAG.clear()
                        outs = fn(*make_args(gfull, idx_c))
                        return outs, _drain_ns_diag()
                    return jax.lax.map(body, tuple(gidx_st))
            _STAGE_CHUNK_JITS[key] = jax.jit(run_map)
        gidx_st = [jnp.asarray(padded(ix).reshape(
            (n_chunks, chunk) + ix.shape[1:])) for ix in gidx]
        merged, ns_st = _STAGE_CHUNK_JITS[key](gfull, gidx_st)

        def unstack(leaf):
            if leaf.ndim == 1:                   # stacked scalars
                return jnp.max(leaf)
            return leaf.reshape((-1,) + leaf.shape[2:])[:n]

        merged = jax.tree_util.tree_map(unstack, merged)
        ns_max = jnp.max(ns_st)
    else:
        if dispatch == "slice":
            # the chunk length is baked into the traced dynamic_slice
            key = (name, mode, "slice", chunk)
            if key not in _STAGE_CHUNK_JITS:
                def run_slice(gfull, gidx_dev, start):
                    with _mode_ctx(), jax.default_matmul_precision(
                            "float32"):
                        idx_c = [jax.lax.dynamic_slice_in_dim(
                            ix, start, chunk, axis=0)
                            for ix in gidx_dev]
                        outs = fn(*make_args(gfull, idx_c))
                        return outs, _drain_ns_diag()
                _STAGE_CHUNK_JITS[key] = jax.jit(run_slice)
            runj = _STAGE_CHUNK_JITS[key]
            # one h2d per index table per stage, not one per chunk
            gidx_dev = [jnp.asarray(padded(ix)) for ix in gidx]
            calls = [(lambda s=s: runj(gfull, gidx_dev,
                                       jnp.int32(s * chunk)))
                     for s in range(n_chunks)]
        else:
            key = (name, mode, "loop")
            if key not in _STAGE_CHUNK_JITS:
                def run(gfull, idx_c):
                    with _mode_ctx(), jax.default_matmul_precision(
                            "float32"):
                        outs = fn(*make_args(gfull, idx_c))
                        return outs, _drain_ns_diag()
                _STAGE_CHUNK_JITS[key] = jax.jit(run)
            runj = _STAGE_CHUNK_JITS[key]
            gpad = [padded(ix) for ix in gidx]

            def call(s):
                idx_c = [jnp.asarray(ix[s * chunk:(s + 1) * chunk])
                         for ix in gpad]
                return runj(gfull, idx_c)
            calls = [(lambda s=s: call(s)) for s in range(n_chunks)]

        chunks, ns_parts = [], []
        for c in calls:
            outs, ns = c()
            chunks.append(outs)
            ns_parts.append(ns)

        def merge(*leaves):
            if leaves[0].ndim == 0:
                return jnp.max(jnp.stack(leaves))
            return jnp.concatenate(leaves, axis=0)[:n]

        merged = jax.tree_util.tree_map(merge, *chunks)
        ns_max = jnp.max(jnp.stack(ns_parts))

    if os.environ.get("PARELAG_STC_SYNC", "") == "1":
        jax.tree_util.tree_map(
            lambda x: np.asarray(x[..., :1]) if x.ndim else
            np.asarray(x), merged)
    dt = time.perf_counter() - t_begin
    rec = STAGE_TIMES.setdefault(name, [0.0, 0, 0])
    rec[0] += dt
    rec[1] += n_chunks
    rec[2] += 1
    return merged, ns_max


def _coarsen_core_chunked(arrs, ids, cshape, jform_start, mode, chunk):
    """Chunked mirror of _coarsen_core_body: the same stage sequence,
    each stage executed through _run_stage_chunked.  Used for levels
    too large for the single whole-level program (HBM)."""
    dt = arrs["m03"].dtype
    nc, nf, ne, nv = grid_counts(cshape)
    out, co = {}, {}
    svs, bubs, nss = [], [], []
    cc, cf, cfaces, ufaces = (ids["cc"], ids["cf"], ids["cfaces"],
                              ids["ufaces"])
    ncc, ncf = cc.shape[0], cf.shape[0]
    pv3 = jnp.ones(arrs["m03"].shape[0], dtype=dt)

    def stage(name, fn, spec, n):
        outs, ns = _run_stage_chunked(name, fn, spec, n, chunk, mode)
        nss.append(ns)
        return outs

    # ---- L2 + Hdiv ---------------------------------------------------
    out["ptr3"], out["f3"], co["m03"], co["t3"], sv3 = stage(
        "t3", _trace_scalar_stage,
        [("g", arrs["m03"], cc), ("g", pv3, cc), ("g", arrs["t3"], cc)],
        ncc)
    out["ptr2"], out["f2"], co["m12"], co["t2"], sv2 = stage(
        "t2", _trace_scalar_stage,
        [("g", arrs["m12"], cf), ("g", arrs["pv2"], cf),
         ("g", arrs["t2"], cf)], ncf)
    out["pint2"], out["d2c"], co["m02"], bub2 = stage(
        "e2", _hdiv_interior_stage,
        [("g", arrs["m02"], cc), ("g", arrs["m03"], cc),
         ("g", arrs["d2"], cc), ("d", out["ptr3"]),
         ("g", out["ptr2"], cfaces), ("g", arrs["t2"], ufaces),
         ("s", _cell_stage_patterns_hdiv())], ncc)
    co["d2"] = out["d2c"]
    co["pv2"] = jnp.ones(sum(nf), dtype=dt)
    svs += [sv3, sv2]
    bubs += [bub2]

    # ---- Hcurl --------------------------------------------------------
    if jform_start <= 1:
        ce, fedges, cedges, fuedges, uedges = (
            ids[k] for k in ("ce", "fedges", "cedges", "fuedges",
                             "uedges"))
        nce = ce.shape[0]
        out["ptr1"], out["f1"], co["m21"], co["t1"], sv1 = stage(
            "t1", _trace_scalar_stage,
            [("g", arrs["m21"], ce), ("g", arrs["pv1"], ce),
             ("g", arrs["t1"], ce)], nce)
        out["pf1"], out["d1c"], co["m11"], bub1f = stage(
            "e1f", _hcurl_facet_stage,
            [("g", arrs["m11"], cf), ("g", arrs["m12"], cf),
             ("g", arrs["d1"], cf), ("d", out["ptr2"]),
             ("g", out["ptr1"], fedges), ("g", arrs["t1"], fuedges),
             ("s", _face_child_edge_slots())], ncf)
        out["pc1"], co["m01"], bub1c = stage(
            "e1c", _hcurl_interior_stage,
            [("g", arrs["m01"], cc), ("g", arrs["m02"], cc),
             ("g", arrs["m03"], cc), ("g", arrs["d1"], ufaces),
             ("g", arrs["d2"], cc), ("g", out["ptr1"], cedges),
             ("g", out["pf1"], cfaces), ("d", out["pint2"]),
             ("g", out["ptr2"], cfaces), ("g", out["d1c"], cfaces),
             ("g", arrs["t1"], uedges),
             ("s", _cell_child_edge_slots()),
             ("s", _cell_stage_patterns_hdiv()),
             ("s", _cell_face_edge_slots()),
             ("s", _cell_facet_edge_positions())], ncc)
        co["d1"] = out["d1c"]
        co["pv1"] = jnp.ones(sum(ne), dtype=dt)
        svs += [sv1]
        bubs += [bub1f, bub1c]

    # ---- H1 -----------------------------------------------------------
    if jform_start <= 0:
        everts_u, fuverts, uverts = (
            ids[k] for k in ("euverts", "fuverts", "uverts"))
        out["pe0"], out["d0c"], co["m20"], bub0e = stage(
            "e0e", _h1_edge_stage,
            [("g", arrs["m20"], ce), ("g", arrs["m21"], ce),
             ("g", arrs["d0"], ce), ("d", out["ptr1"]),
             ("g", arrs["t0"], everts_u)], nce)
        out["pf0"], co["m10"], bub0f = stage(
            "e0f", _h1_facet_stage,
            [("g", arrs["m10"], cf), ("g", arrs["m11"], cf),
             ("g", arrs["m12"], cf), ("g", arrs["d0"], fuedges),
             ("g", arrs["d1"], cf), ("g", out["ptr1"], fedges),
             ("g", out["pe0"], fedges), ("g", out["d0c"], fedges),
             ("d", out["pf1"]), ("g", arrs["t0"], fuverts),
             ("s", _face_child_vert_slots()),
             ("s", _face_child_edge_slots()),
             ("s", _face_edge_vert_slots())], ncf)
        out["pc0"], co["m00"] = stage(
            "e0c", _h1_interior_stage,
            [("g", arrs["m00"], cc), ("g", arrs["m01"], cc),
             ("g", arrs["m02"], cc), ("g", arrs["d0"], uedges),
             ("g", arrs["d1"], ufaces), ("g", out["ptr1"], cedges),
             ("g", out["pe0"], cedges), ("g", out["d0c"], cedges),
             ("g", out["pf1"], cfaces), ("d", out["pc1"]),
             ("g", out["pf0"], cfaces),
             ("s", _cell_child_vert_slots()),
             ("s", _cell_child_edge_slots()),
             ("s", _cell_stage_patterns_hdiv()),
             ("s", _cell_edge_vert_slots()),
             ("s", _cell_face_edge_slots()),
             ("s", _cell_facet_edge_positions()),
             ("s", _cell_edge_vert_positions()),
             ("s", _cell_facet_vert_positions())], ncc)
        co["d0"] = out["d0c"]
        co["t0"] = jnp.asarray(arrs["t0"])[
            jnp.asarray(ids["cv"], dtype=jnp.int32)]
        bubs += [bub0e, bub0f]

    maxsv = jnp.max(jnp.stack(svs))
    maxbub = (jnp.max(jnp.stack(bubs)) if bubs
              else jnp.zeros((), dtype=dt))
    return co, out, maxsv, maxbub, jnp.max(jnp.stack(nss))


def coarsen_structured(lvl: StructuredLevel, jform_start=0,
                       svd_tol=1e-9, jit=True, chunk=None):
    """One cartesian 2x2x2 coarsening step of the de Rham chain from
    L2 down to `jform_start` (the generic engine's Coarsen() loop,
    jform = 3..jform_start).  Returns (coarse_level, LevelOut).  Small
    levels run as one jitted XLA program per level shape; levels above
    the chunk threshold run stage-by-stage in fixed-size entity chunks
    to bound HBM (see _run_stage_chunked).  chunk: None = auto, 0 =
    force the whole-level program, >0 = force that chunk size."""
    global _CORE_JIT
    mode = _SOLVE_MODE        # capture once: core + asserts see the same
    shape = lvl.shape
    assert all(s % 2 == 0 for s in shape), shape
    cshape = tuple(s // 2 for s in shape)
    ids_np = _level_ids(cshape, jform_start)
    arrs = {k: v for k, v in vars(lvl).items()
            if k != "shape" and v is not None}
    ncc = int(np.prod(cshape))
    if chunk is None:
        chunk = _CHUNK_SIZE if ncc > _CHUNK_THRESHOLD else 0
    if chunk:
        co, outd, maxsv, maxbub, nsres = _coarsen_core_chunked(
            arrs, ids_np, cshape, jform_start, mode, chunk)
    else:
        ids = {k: jnp.asarray(v, dtype=jnp.int32)
               for k, v in ids_np.items()}
        if jit:
            if _CORE_JIT is None:
                _CORE_JIT = jax.jit(
                    _coarsen_core,
                    static_argnames=("cshape", "jform_start", "mode"))
            co, outd, maxsv, maxbub, nsres = _CORE_JIT(
                arrs, ids, cshape=cshape, jform_start=jform_start,
                mode=mode)
        else:
            co, outd, maxsv, maxbub, nsres = _coarsen_core(
                arrs, ids, cshape, jform_start, mode=mode)

    coarse = StructuredLevel(shape=cshape, **co)
    out = LevelOut(cshape=cshape, **outd, **ids_np)
    out.max_rel_sv = float(maxsv)
    out.bub_sv = float(maxbub)
    out.ns_res = float(nsres)
    dt = lvl.m03.dtype
    # noise allowance 200*eps: the deflated-trace Gram is exact-zero
    # in exact arithmetic; its f32 rounding tail measured 6.4e-6
    # (~54*eps) as the MAX over 884k entities at 96^3 on the chip,
    # while a genuinely kept mode shows >= 1e-3 (heterogeneity test)
    eff = max(svd_tol, 200.0 * float(jnp.finfo(dt).eps))
    # in ns mode the extensions carry the f32 refinement floor, so the
    # bubble residual can't be distinguished below ~1e-5 relative
    bub_eff = max(1e2 * svd_tol, eff, 2e-4 if mode == "ns" else 0.0)
    assert out.max_rel_sv < eff, \
        (out.max_rel_sv, "trace SVD kept a mode: structure not static")
    assert out.bub_sv < bub_eff, \
        (out.bub_sv, "bubble SVD kept a mode: structure not static")
    assert out.ns_res < _NS_GUARD_TOL, \
        (out.ns_res, "NS stage solve did not converge to the "
         "refinement floor")
    return coarse, out


def _cell_face_edge_slots():
    """(36, 4) subgrid face (slot order) -> 54-slot positions of its 4
    edges in the canonical M11 order."""
    slot_f = _subgrid_face_slots()
    slot_e = _subgrid_edge_slots()
    fe = face_edges_m(_S)                  # (36, 4) subgrid edge ids
    out = np.empty((36, 4), dtype=np.int64)
    out[slot_f] = slot_e[fe]
    return out


def materialize_P(out: LevelOut, fshape, jform):
    """Host CSR of the structured P for one form at one level."""
    import scipy.sparse as sp
    ncf_, nff, nef, nvf = grid_counts(fshape)
    ncc, nfc, nec, nvc = grid_counts(out.cshape)
    if jform == 3:
        rows = out.cc.ravel()
        cols = np.repeat(np.arange(ncc), 8)
        return sp.coo_matrix(
            (np.asarray(out.ptr3).ravel(), (rows, cols)),
            shape=(ncf_, ncc)).tocsr()
    if jform == 2:
        rows = np.concatenate([
            out.cf.ravel(),
            np.repeat(out.ufaces[:, :12].ravel(), 6)])
        cols = np.concatenate([
            np.repeat(np.arange(sum(nfc)), 4),
            np.tile(out.cfaces, (1, 12)).reshape(-1)])
        vals = np.concatenate([np.asarray(out.ptr2).ravel(),
                               np.asarray(out.pint2).ravel()])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(sum(nff), sum(nfc))).tocsr()
    if jform == 1:
        rows = np.concatenate([
            out.ce.ravel(),
            np.repeat(out.fuedges[:, :4].ravel(), 4),
            np.repeat(out.uedges[:, :6].ravel(), 12)])
        cols = np.concatenate([
            np.repeat(np.arange(sum(nec)), 2),
            np.tile(out.fedges, (1, 4)).reshape(-1),
            np.tile(out.cedges, (1, 6)).reshape(-1)])
        vals = np.concatenate([np.asarray(out.ptr1).ravel(),
                               np.asarray(out.pf1).ravel(),
                               np.asarray(out.pc1).ravel()])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(sum(nef), sum(nec))).tocsr()
    if jform == 0:
        rows = np.concatenate([
            out.cv,
            np.repeat(out.euverts[:, 0], 2),
            np.repeat(out.fuverts[:, 0], 4),
            np.repeat(out.uverts[:, 0], 8)])
        cols = np.concatenate([
            np.arange(nvc), out.everts.ravel(), out.fverts.ravel(),
            out.cverts.ravel()])
        vals = np.concatenate([
            np.ones(nvc, dtype=np.asarray(out.pe0).dtype),
            np.asarray(out.pe0).ravel(), np.asarray(out.pf0).ravel(),
            np.asarray(out.pc0).ravel()])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(nvf, nvc)).tocsr()
    raise ValueError(jform)


# --------------------------------------------------------------------- #
# H1 stage patterns
# --------------------------------------------------------------------- #

def _subgrid_vert_slots():
    """Canonical order of the 27 subgrid vertices of a cell-AE:
    [1 interior (center); 8 corners (cell_verts order, coords x2);
     12 coarse-edge midpoints (cell_edges coarse order);
     6 facet centers ([x0,x1,y0,y1,z0,z1])].
    Returns slot_of_vert (27,)."""
    order = [vert_id(_S, 1, 1, 1)]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                order.append(vert_id(_S, 2 * dx, 2 * dy, 2 * dz))
    for a in range(3):                      # edge midpoints
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[a], co[b], co[c] = 1, 2 * db, 2 * dc
                order.append(vert_id(_S, *co))
    for a in range(3):                      # facet centers
        for s in (0, 2):
            co = [1, 1, 1]
            co[a] = s
            order.append(vert_id(_S, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == 27
    slot = np.zeros(27, dtype=np.int64)
    slot[order] = np.arange(27)
    return slot


def _subgrid_u_verts(cshape):
    """(n_coarse_cells, 27) fine vertex ids in the canonical order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_vert_slots()
    inv = np.empty((27, 3), dtype=np.int64)
    for x in range(3):
        for y in range(3):
            for z in range(3):
                inv[vert_id(_S, x, y, z)] = (x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 27), dtype=np.int64)
    for sv in range(27):
        x, y, z = inv[sv]
        out[:, slot[sv]] = vert_id(fshape, 2 * ijk[:, 0] + x,
                                   2 * ijk[:, 1] + y, 2 * ijk[:, 2] + z)
    return out


def _face_u_verts(cshape):
    """(n_coarse_faces, 9) fine vertex ids of a coarse face's subgrid:
    [center; 4 corners (M10 (b,c)-lex); 4 coarse-edge midpoints (M11
    order)]."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        offs = []
        o = [0, 0, 0]
        o[b], o[c] = 1, 1
        offs.append(tuple(o))                       # center
        for dc in (0, 1):
            for db in (0, 1):                       # corners
                o = [0, 0, 0]
                o[b], o[c] = 2 * db, 2 * dc
                offs.append(tuple(o))
        for (ob, oc) in ((1, 0), (1, 2), (0, 1), (2, 1)):  # mids, M11
            o = [0, 0, 0]
            o[b], o[c] = ob, oc
            offs.append(tuple(o))
        out = np.empty((len(ijk), 9), dtype=np.int64)
        for s, (ox, oy, oz) in enumerate(offs):
            out[:, s] = vert_id(fshape, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
        cols.append(out)
    return np.concatenate(cols, axis=0)


def _edge_u_verts(cshape):
    """(n_coarse_edges, 3) fine vertex ids [mid, tail, head]."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        mid = base.copy()
        mid[:, a] += 1
        head = base.copy()
        head[:, a] += 2
        cols.append(np.stack([
            vert_id(fshape, mid[:, 0], mid[:, 1], mid[:, 2]),
            vert_id(fshape, base[:, 0], base[:, 1], base[:, 2]),
            vert_id(fshape, head[:, 0], head[:, 1], head[:, 2]),
        ], axis=1))
    return np.concatenate(cols, axis=0)


def _cell_child_vert_slots():
    """(8, 8) child cell -> 27-slot positions of its cell_verts."""
    return _subgrid_vert_slots()[cell_verts(_S)]


def _face_child_vert_slots():
    """(4, 4) child face -> 9-slot positions of its M10-order verts
    (family-independent in (b, c) terms)."""
    # 9-slot keyed by (b-coord, c-coord) in {0,1,2}^2
    key2slot = {(1, 1): 0, (0, 0): 1, (2, 0): 2, (0, 2): 3, (2, 2): 4,
                (1, 0): 5, (1, 2): 6, (0, 1): 7, (2, 1): 8}
    out = np.empty((4, 4), dtype=np.int64)
    for dc in (0, 1):
        for db in (0, 1):
            ch = dc * 2 + db
            out[ch] = [key2slot[(db + eb, dc + ec)]
                       for ec in (0, 1) for eb in (0, 1)]
    return out


def _cell_edge_vert_slots():
    """(54, 2) subgrid edge (slot order) -> 27-slot [tail, head]."""
    slot_e = _subgrid_edge_slots()
    slot_v = _subgrid_vert_slots()
    ev = edge_verts(_S)                    # (54, 2) subgrid vert ids
    out = np.empty((54, 2), dtype=np.int64)
    out[slot_e] = slot_v[ev]
    return out


def _face_edge_vert_slots():
    """(12, 2) face-subgrid edge (face order) -> 9-slot [tail, head]
    (family-independent)."""
    key2slot = {(1, 1): 0, (0, 0): 1, (2, 0): 2, (0, 2): 3, (2, 2): 4,
                (1, 0): 5, (1, 2): 6, (0, 1): 7, (2, 1): 8}
    fams = _face_subgrid_edge_order()
    # interpret offsets in (b, c) terms using family 0 ((b,c)=(1,2))
    out = np.empty((12, 2), dtype=np.int64)
    for s, (axis, ox, oy, oz) in enumerate(fams[0]):
        ob, oc = oy, oz
        if axis == 1:      # along b
            out[s] = [key2slot[(ob, oc)], key2slot[(ob + 1, oc)]]
        else:              # along c
            out[s] = [key2slot[(ob, oc)], key2slot[(ob, oc + 1)]]
    return out


# facet -> corner-vertex positions among the cell's 8 (cell_verts order)
def _cell_facet_vert_positions():
    cv = cell_verts((1, 1, 1))[0]
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.vectorize(pos.get)(face_verts((1, 1, 1)))


# coarse edge -> endpoint positions among the cell's 8
def _cell_edge_vert_positions():
    cv = cell_verts((1, 1, 1))[0]
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.vectorize(pos.get)(edge_verts((1, 1, 1)))


# face coarse edge (M11 order) -> endpoint positions among the face's
# 4 corners (M10 order): eb(c0): (0,1); eb(c1): (2,3); ec(b0): (0,2);
# ec(b1): (1,3)
_FACE_EDGE_VERT_POS = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])


def _h1_edge_stage(m20_ch, m21_ch, d0_ch, ptr1_e, t0_u):
    """H1 edge Lagrange extension (hFacetExtension for jform=0):
    per coarse edge, u = [mid, tail, head] vertices (1 interior), p = 2
    child edges, one PV multiplier (the coarse edge's Hcurl PV).
      m20_ch (n,2,2,2), m21_ch (n,2), d0_ch (n,2,2), ptr1_e (n,2) this
      edge's Hcurl trace values, t0_u (n,3,kt).
    Returns (pe0 (n,1,2), d0c (n,2), cm (n,2,2), bub_sv)."""
    n = m20_ch.shape[0]
    dt = m20_ch.dtype
    vslots = np.array([[1, 0], [0, 2]])
    idx = (vslots[:, :, None] * 3 + vslots[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 9), dtype=dt).at[:, idx].add(
        m20_ch.reshape(n, -1)).reshape(n, 3, 3)
    Dloc = jnp.zeros((n, 2, 3), dtype=dt).at[
        :, np.arange(2)[:, None], vslots].set(d0_ch)
    B = m21_ch[:, :, None] * Dloc                   # (n, 2, 3)
    T = m21_ch * ptr1_e                             # (n, 2)
    Pb = jnp.broadcast_to(jnp.eye(2, dtype=dt), (n, 2, 2))
    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]

    A = jnp.zeros((n, 4, 4), dtype=dt)
    A = A.at[:, :1, :1].set(M_ii)
    A = A.at[:, 1:3, :1].set(B_ii)
    A = A.at[:, :1, 1:3].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 3, 1:3].set(T)
    A = A.at[:, 1:3, 3].set(T)

    kt = t0_u.shape[2]
    t_int, t_bdr = t0_u[:, :1], t0_u[:, 1:]
    rhs = jnp.zeros((n, 4, 2 + kt), dtype=dt)
    rhs = rhs.at[:, :1, :2].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 1:3, :2].set(-(B_ib @ Pb))
    rhs = rhs.at[:, :1, 2:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, 1:3, 2:].set(B_ii @ t_int)

    X = _solve_batch(A, rhs)
    pe0 = X[:, :1, :2]
    d0c = _snap_zero(X[:, 3, :2])
    bub = t_int - X[:, :1, 2:]
    G = jnp.einsum("nit,nis->nts", bub, bub)
    bub_sv = jnp.sqrt(jnp.clip(jnp.max(jnp.linalg.eigvalsh(G)),
                               0.0, None)) if kt else jnp.zeros(())
    basis = jnp.concatenate([pe0, Pb], axis=1)      # (n, 3, 2)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return pe0, d0c, cm, bub_sv


def _h1_facet_stage(m10_ch, m11_ch, m12_ch, d0_fu, d1_ch, ptr1_fe,
                    pe0_fe, d0c_fe, pf1_f, t0_u, vslot, eslot, evslot):
    """H1 facet extension ([M B^T; B -C] with null targets,
    hRidgePeakExtension for jform=0 at codim 1): per coarse face,
    u = 9 subgrid vertices (1 interior), p = 12 subgrid edges (4
    interior), e2 = 4 child faces.
      m10_ch (n,4,4,4), m11_ch (n,4,4,4), m12_ch (n,4),
      d0_fu (n,12,2) fine grad values of the 12 subgrid edges,
      d1_ch (n,4,4) fine curl of the child faces, ptr1_fe (n,4,2)
      Hcurl edge-trace values of the face's coarse edges, pe0_fe
      (n,4,1,2) H1 edge-stage blocks of those edges, d0c_fe (n,4,2)
      coarse grad values of those edges, pf1_f (n,4,4) this face's
      Hcurl facet-stage block, t0_u (n,9,kt); static: vslot (4,4),
      eslot (4,4), evslot (12,2).
    Returns (pf0 (n,1,4), cm (n,4,4), bub_sv)."""
    n = m10_ch.shape[0]
    dt = m10_ch.dtype
    vidx = (vslot[:, :, None] * 9 + vslot[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 81), dtype=dt).at[:, vidx].add(
        m10_ch.reshape(n, -1)).reshape(n, 9, 9)
    eidx = (eslot[:, :, None] * 12 + eslot[:, None, :]).reshape(-1)
    Wae = jnp.zeros((n, 144), dtype=dt).at[:, eidx].add(
        m11_ch.reshape(n, -1)).reshape(n, 12, 12)
    D0loc = jnp.zeros((n, 12, 9), dtype=dt).at[
        :, np.arange(12)[:, None], evslot].set(d0_fu)
    B = (Wae @ D0loc)[:, :4, :]                     # (n, 4, 9)
    D1loc = jnp.zeros((n, 4, 12), dtype=dt).at[
        :, np.arange(4)[:, None], eslot].set(d1_ch)
    D1i = D1loc[:, :, :4]
    C = jnp.einsum("nki,nk,nkj->nij", D1i, m12_ch, D1i)

    # PDc = P1 @ D0c within the face: (n, 12, 4)
    D0c_face = jnp.zeros((n, 4, 4), dtype=dt).at[
        :, np.arange(4)[:, None], _FACE_EDGE_VERT_POS].set(d0c_fe)
    pd_int = pf1_f @ D0c_face                       # (n, 4, 4)
    pd_bdr = (ptr1_fe[:, :, :, None]
              * D0c_face[:, :, None, :]).reshape(n, 8, 4)
    dPcs = jnp.concatenate([pd_int, pd_bdr], axis=1)

    Pb = jnp.zeros((n, 8, 4), dtype=dt)
    Pb = Pb.at[:, np.arange(4), np.arange(4)].set(1.0)
    Pb = Pb.at[:, np.repeat(4 + np.arange(4), 2),
               _FACE_EDGE_VERT_POS.reshape(-1)].set(
        pe0_fe.reshape(n, 8))

    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]
    A = jnp.zeros((n, 5, 5), dtype=dt)
    A = A.at[:, :1, :1].set(M_ii)
    A = A.at[:, 1:, :1].set(B_ii)
    A = A.at[:, :1, 1:].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 1:, 1:].set(-C)

    kt = t0_u.shape[2]
    t_int, t_bdr = t0_u[:, :1], t0_u[:, 1:]
    rhs = jnp.zeros((n, 5, 4 + kt), dtype=dt)
    rhs = rhs.at[:, :1, :4].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 1:, :4].set(-(B_ib @ Pb) + Wae[:, :4, :] @ dPcs)
    rhs = rhs.at[:, :1, 4:].set(-(M_ib @ t_bdr))
    rhs = rhs.at[:, 1:, 4:].set(B_ii @ t_int)

    X = _solve_batch(A, rhs)
    pf0 = X[:, :1, :4]
    bub = t_int - X[:, :1, 4:]
    G = jnp.einsum("nit,nis->nts", bub, bub)
    bub_sv = jnp.sqrt(jnp.clip(jnp.max(jnp.linalg.eigvalsh(G)),
                               0.0, None)) if kt else jnp.zeros(())
    basis = jnp.concatenate([pf0, Pb], axis=1)      # (n, 9, 4)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return pf0, cm, bub_sv


def _h1_interior_stage(m00_ch, m01_ch, m02_ch, d0_u, d1_u, ptr1_ce,
                       pe0_ce, d0c_ce, pf1_cf, pc1, pf0_cf,
                       vslot_cell, eslot_cell, fslot, ev_slot, fe_slot,
                       fep, evp, fvp):
    """H1 interior extension ([M B^T; B -C], no null targets): per
    coarse cell, u = 27 subgrid vertices (1 interior), p = 54 subgrid
    edges (6 interior), e2 = 36 subgrid faces.
    Returns (pc0 (n,1,8), cm (n,8,8))."""
    n = m00_ch.shape[0]
    dt = m00_ch.dtype
    vidx = (vslot_cell[:, :, None] * 27
            + vslot_cell[:, None, :]).reshape(-1)
    Mae = jnp.zeros((n, 27 * 27), dtype=dt).at[:, vidx].add(
        m00_ch.reshape(n, -1)).reshape(n, 27, 27)
    eidx = (eslot_cell[:, :, None] * 54
            + eslot_cell[:, None, :]).reshape(-1)
    Wae = jnp.zeros((n, 54 * 54), dtype=dt).at[:, eidx].add(
        m01_ch.reshape(n, -1)).reshape(n, 54, 54)
    fidx = (fslot[:, :, None] * 36 + fslot[:, None, :]).reshape(-1)
    W2ae = jnp.zeros((n, 36 * 36), dtype=dt).at[:, fidx].add(
        m02_ch.reshape(n, -1)).reshape(n, 36, 36)
    D0loc = jnp.zeros((n, 54, 27), dtype=dt).at[
        :, np.arange(54)[:, None], ev_slot].set(d0_u)
    B = (Wae @ D0loc)[:, :6, :]                     # (n, 6, 27)
    D1loc = jnp.zeros((n, 36, 54), dtype=dt).at[
        :, np.arange(36)[:, None], fe_slot].set(d1_u)
    D1i = D1loc[:, :, :6]
    C = jnp.einsum("nki,nkl,nlj->nij", D1i, W2ae, D1i)

    # PDc = P1 @ D0c within the AE: rows = 54 edges in slot order
    D0c_cell = jnp.zeros((n, 12, 8), dtype=dt).at[
        :, np.arange(12)[:, None], evp].set(d0c_ce)
    pd_int = pc1 @ D0c_cell                         # (n, 6, 8)
    pd_ce = (ptr1_ce[:, :, :, None]
             * D0c_cell[:, :, None, :]).reshape(n, 24, 8)
    # facet-interior rows: pf1[f] (4x4 coarse-edge cols) @ D0c rows of
    # the facet's coarse edges
    d0c_fcells = D0c_cell[:, fep, :]                # (n, 6, 4, 8)
    pd_fi = jnp.einsum("nfij,nfjk->nfik", pf1_cf,
                       d0c_fcells).reshape(n, 24, 8)
    dPcs = jnp.concatenate([pd_int, pd_ce, pd_fi], axis=1)

    Pb = jnp.zeros((n, 26, 8), dtype=dt)
    Pb = Pb.at[:, np.arange(8), np.arange(8)].set(1.0)
    Pb = Pb.at[:, np.repeat(8 + np.arange(12), 2),
               evp.reshape(-1)].set(pe0_ce.reshape(n, 24))
    Pb = Pb.at[:, np.repeat(20 + np.arange(6), 4),
               fvp.reshape(-1)].set(pf0_cf.reshape(n, 24))

    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]
    A = jnp.zeros((n, 7, 7), dtype=dt)
    A = A.at[:, :1, :1].set(M_ii)
    A = A.at[:, 1:, :1].set(B_ii)
    A = A.at[:, :1, 1:].set(B_ii.transpose(0, 2, 1))
    A = A.at[:, 1:, 1:].set(-C)

    rhs = jnp.zeros((n, 7, 8), dtype=dt)
    rhs = rhs.at[:, :1, :].set(-(M_ib @ Pb))
    rhs = rhs.at[:, 1:, :].set(-(B_ib @ Pb) + Wae[:, :6, :] @ dPcs)

    X = _solve_batch(A, rhs)
    pc0 = X[:, :1, :8]
    basis = jnp.concatenate([pc0, Pb], axis=1)      # (n, 27, 8)
    cm = jnp.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    cm = 0.5 * (cm + cm.transpose(0, 2, 1))
    return pc0, cm


# --------------------------------------------------------------------- #
# multilevel driver + global host views (parity tests, bench, solve)
# --------------------------------------------------------------------- #

def coarsen_chain(lvl: StructuredLevel, nlevels, jform_start=0,
                  svd_tol=1e-9):
    """Chain of structured coarsenings (the generic engine's level loop,
    DeRhamSequence.cpp:572-692 applied nlevels-1 times).  Returns
    (levels, outs) with len(levels) == nlevels, fine level first."""
    levels, outs = [lvl], []
    for _ in range(nlevels - 1):
        lvl, out = coarsen_structured(lvl, jform_start=jform_start,
                                      svd_tol=svd_tol)
        levels.append(lvl)
        outs.append(out)
    return levels, outs


def global_mass(lvl: StructuredLevel, jform):
    """Host CSR global mass of one form assembled from the level's
    codim-0 local blocks (ComputeMassOperator analog)."""
    import scipy.sparse as sp
    shape = lvl.shape
    nc, nf, ne, nv = grid_counts(shape)
    if jform == 0:
        return assemble_global(lvl.m00, cell_verts(shape), nv)
    if jform == 1:
        return assemble_global(lvl.m01, cell_edges(shape), sum(ne))
    if jform == 2:
        return assemble_global(lvl.m02, cell_faces(shape), sum(nf))
    if jform == 3:
        return sp.diags(np.asarray(lvl.m03)).tocsr()
    raise ValueError(jform)


def global_derivative(lvl: StructuredLevel, jform):
    """Host CSR derivative operator D_jform of the level."""
    shape = lvl.shape
    nc, nf, ne, nv = grid_counts(shape)
    if jform == 0:
        return assemble_d_csr(lvl.d0, d0_cols(shape), (sum(ne), nv))
    if jform == 1:
        return assemble_d_csr(lvl.d1, d1_cols(shape), (sum(nf), sum(ne)))
    if jform == 2:
        return assemble_d_csr(lvl.d2, d2_cols(shape), (nc, sum(nf)))
    raise ValueError(jform)


def boundary_entity_marker(shape, jform):
    """Boolean marker of grid-boundary entities in the global numbering
    (verts jform=0, edges jform=1, faces jform=2) — the structured-grid
    analog of mark_dofs_on_bndr over all 6 attributes (reference
    DeRhamSequence MarkDofsOnSelectedBndr role for the lowest-order
    structured chain).  An edge/vertex is boundary when any transverse
    lattice coordinate sits at its extreme; a face when its normal
    coordinate does."""
    nx, ny, nz = shape

    def fam(dims, bnd_axes):
        ni, nj, nk = dims
        m = np.zeros((nk, nj, ni), dtype=bool)
        for ax, extent in bnd_axes:
            sl = [slice(None)] * 3
            sl[2 - ax] = 0
            m[tuple(sl)] = True
            sl[2 - ax] = extent
            m[tuple(sl)] = True
        return m.ravel()

    if jform == 0:
        return fam((nx + 1, ny + 1, nz + 1),
                   [(0, nx), (1, ny), (2, nz)])
    if jform == 1:
        dims = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz))
        tr = ([(1, ny), (2, nz)], [(0, nx), (2, nz)], [(0, nx), (1, ny)])
        return np.concatenate([fam(dims[a], tr[a]) for a in range(3)])
    if jform == 2:
        dims = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
        nr = ([(0, nx)], [(1, ny)], [(2, nz)])
        return np.concatenate([fam(dims[a], nr[a]) for a in range(3)])
    raise ValueError(jform)


def _cell_edge_endpoint_slots(shape):
    """(12, 2) local vertex slot of each cell edge's (tail, head) in the
    cell_verts ordering — uniform across cells on the lexicographic
    grid (derived from cell 0)."""
    cv = cell_verts(shape)[0]
    ev = edge_verts(shape)[cell_edges(shape)[0]]     # (12, 2) vert ids
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.array([[pos[int(a)], pos[int(b)]] for a, b in ev],
                    dtype=np.int64)


def h1_stiffness_blocks(lvl: StructuredLevel):
    """(nc, 8, 8) per-cell blocks of A = M0 + D0^T M1 D0 (the flagship
    H1 operator, bench lane_h1 / MultigridTest0Form): the cell-local
    gradient G (12x8) is the cell's d0 rows scattered to local vertex
    slots, so A_cell = m00 + G^T m01 G — one batched einsum per level,
    no global spgemm anywhere (Galerkin-exact by locality of m01)."""
    shape = lvl.shape
    ce = jnp.asarray(cell_edges(shape), dtype=jnp.int32)
    slots = _cell_edge_endpoint_slots(shape)
    dvals = lvl.d0[ce]                               # (nc, 12, 2)
    nc = dvals.shape[0]
    G = jnp.zeros((nc, 12, 8), dtype=dvals.dtype)
    G = G.at[:, np.arange(12)[:, None], slots].set(dvals)
    with jax.default_matmul_precision("float32"):
        A = lvl.m00 + jnp.einsum("nei,nef,nfj->nij", G, lvl.m01, G)
    return 0.5 * (A + A.transpose(0, 2, 1))


def h1_stiffness(lvl: StructuredLevel):
    """Host CSR of A = M0 + D0^T M1 D0 assembled from the level's
    blocks."""
    nv = grid_counts(lvl.shape)[3]
    return assemble_global(h1_stiffness_blocks(lvl),
                           cell_verts(lvl.shape), nv)


def h1_uniform_cell_block(shape, h=None, dtype=np.float64):
    """(8, 8) per-cell block of M0 + G^T M1 G on the homogeneous fine
    level — identical for every cell of the uniform grid, so the fine
    operator assembles host-side from one broadcast block with zero
    device->host traffic."""
    if h is None:
        h = tuple(1.0 / s for s in shape)
    ref = fine_local_masses(h, np.dtype(dtype))
    d0, _, _ = fine_derivative_values(shape, h, np.dtype(dtype))
    ce0 = cell_edges(shape)[0]
    slots = _cell_edge_endpoint_slots(shape)
    G = np.zeros((12, 8), dtype=dtype)
    G[np.arange(12)[:, None], slots] = d0[ce0]
    A = np.asarray(ref[(0, 0)]) + G.T @ np.asarray(ref[(0, 1)]) @ G
    return 0.5 * (A + A.T)


_FORCE_JIT = None


def force_outputs(*objs):
    """Force every device array hanging off the given level/out
    dataclasses: one scalar reduction over everything, fetched to the
    host (a single jitted kernel, not one dispatch per array)."""
    global _FORCE_JIT
    arrs = [v for o in objs for v in vars(o).values()
            if isinstance(v, jax.Array)]
    if not arrs:
        return 0.0
    if _FORCE_JIT is None:
        _FORCE_JIT = jax.jit(
            lambda xs: sum(jnp.sum(jnp.abs(x).astype(jnp.float32))
                           for x in xs))
    return float(_FORCE_JIT(arrs))
