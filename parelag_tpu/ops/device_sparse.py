"""Device sparse-matrix substrate (JAX).

Replacement for hypre ParCSR matvec machinery (reference hypreExtension +
mfem::SparseMatrix::Mult throughout the solve phase): the solve-phase
operators live on device in ELL (padded-row) layout, so SpMV is a dense
gather + row reduction — static shapes and vmappable.

Every f32 contraction below passes precision=HIGHEST: on the GPU a
default-precision f32 contraction may run in TF32 (~3 digits), which caps
the Krylov A-matvec near a 1e-3 residual floor.  bf16 operands (the
preconditioner cast) are unaffected by the flag.

ELL layout: indices (n, k) int32, values (n, k) dtype, with padding entries
pointing at column 0 with value 0. k = max row nnz (optionally rounded up to
a lane multiple).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclass
class EllMatrix:
    indices: jnp.ndarray    # (n, k) int32
    values: jnp.ndarray     # (n, k)
    shape: tuple            # (n, m) static

    def tree_flatten(self):
        return (self.indices, self.values), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    @property
    def dtype(self):
        return self.values.dtype

    def matvec(self, x):
        return ell_matvec(self, x)

    def __matmul__(self, x):
        return ell_matvec(self, x)


def from_scipy(A, dtype=None, pad_to=None) -> EllMatrix:
    """Convert scipy sparse to device ELL."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    dtype = dtype or A.dtype
    nnz_per_row = np.diff(A.indptr)
    k = int(nnz_per_row.max()) if n else 0
    k = max(k, 1)
    if pad_to:
        k = -(-k // pad_to) * pad_to
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=dtype)
    if A.nnz:
        rows = np.repeat(np.arange(n), nnz_per_row)
        within = (np.arange(A.nnz)
                  - np.repeat(A.indptr[:-1], nnz_per_row))
        indices[rows, within] = A.indices
        values[rows, within] = A.data
    return EllMatrix(jnp.asarray(indices), jnp.asarray(values), (n, m))


@jax.jit
def ell_matvec(A: EllMatrix, x):
    """y_i = sum_k vals[i,k] * x[idx[i,k]] — gather + row reduce.
    x may be (m,) or (m, s) for multi-RHS (one gather, s-wide reduce)."""
    if x.ndim == 2:
        return jnp.einsum("nk,nks->ns", A.values, x[A.indices],
                          precision=_HIGHEST)
    return jnp.einsum("nk,nk->n", A.values, x[A.indices],
                      precision=_HIGHEST)


def ell_matvec_T(A: EllMatrix, x):
    """y = A^T x via scatter-add (for restriction when only P is stored)."""
    contrib = A.values * x[:, None]
    return jnp.zeros(A.shape[1], dtype=A.values.dtype).at[
        A.indices].add(contrib)


@jax.tree_util.register_pytree_node_class
@dataclass
class BcsrMatrix:
    """Block-sparse row layout.

    Rows grouped in BR-blocks, columns in 128-blocks; per row-block a padded
    list of column-block ids plus dense (BR x 128) value tiles. SpMV becomes
    block gathers of x plus a dense contraction — no element gathers.  The
    8 x 128 tile shape is inherited and not measured on the H100.
    """
    col_blocks: jnp.ndarray    # (nbr, kb) int32 column-block ids
    tiles: jnp.ndarray         # (nbr, kb, BR, 128)
    shape: tuple               # logical (n, m)
    padded: tuple              # (n_pad, m_pad)

    BR = 8
    BC = 128

    @property
    def dtype(self):
        return self.tiles.dtype

    def tree_flatten(self):
        return (self.col_blocks, self.tiles), (self.shape, self.padded)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])

    def matvec(self, x):
        """x of logical length m, or (m, s) for multi-RHS: the contraction
        becomes a batched matmul (nbr, 8, kb*128) @ (nbr, kb*128, s)."""
        m_pad = self.padded[1]
        if x.ndim == 2:
            s = x.shape[1]
            xp = jnp.zeros((m_pad, s), x.dtype).at[: x.shape[0]].set(x)
            xb = xp.reshape(-1, self.BC, s)
            gathered = xb[self.col_blocks]          # (nbr, kb, 128, s)
            y = jnp.einsum("nkrc,nkcs->nrs", self.tiles, gathered,
                           precision=_HIGHEST)
            return y.reshape(-1, s)[: self.shape[0]]
        xp = jnp.zeros(m_pad, x.dtype).at[: x.shape[0]].set(x)
        xb = xp.reshape(-1, self.BC)
        gathered = xb[self.col_blocks]              # (nbr, kb, 128)
        # elementwise multiply + reduce, not dot_general: an 8-row batched
        # matvec is a poor fit for a matrix unit (not measured on the H100)
        y = (self.tiles * gathered[:, :, None, :]).sum(axis=(1, 3))
        return y.reshape(-1)[: self.shape[0]]

    def __matmul__(self, x):
        return self.matvec(x)


def to_bcsr(A, dtype=np.float32, br=8, bc=128) -> BcsrMatrix:
    """Convert scipy sparse to the BCSR device layout (vectorized)."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    n_pad = -(-n // br) * br
    m_pad = -(-m // bc) * bc
    nbr = n_pad // br
    nbc = m_pad // bc
    coo = A.tocoo()
    rb = coo.row.astype(np.int64) // br
    cbid = coo.col.astype(np.int64) // bc
    key = rb * nbc + cbid
    uk, inv = np.unique(key, return_inverse=True)
    urb = uk // nbc
    ucb = uk % nbc
    counts = np.bincount(urb, minlength=nbr)
    kb = int(max(counts.max() if counts.size else 1, 1))
    start = np.zeros(nbr + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    slot_of_uk = np.arange(uk.size, dtype=np.int64) - start[urb]
    col_blocks = np.zeros((nbr, kb), dtype=np.int32)
    col_blocks[urb, slot_of_uk] = ucb
    tiles = np.zeros(nbr * kb * br * bc, dtype=dtype)
    flat = (((rb * kb + slot_of_uk[inv]) * br
             + coo.row.astype(np.int64) % br) * bc
            + coo.col.astype(np.int64) % bc)
    tiles[flat] = coo.data
    return BcsrMatrix(jnp.asarray(col_blocks),
                      jnp.asarray(tiles.reshape(nbr, kb, br, bc)),
                      (n, m), (n_pad, m_pad))


@jax.tree_util.register_pytree_node_class
@dataclass
class TileCooMatrix:
    """COO-of-tiles: only the NONEMPTY (8 x 128) tiles are stored, with
    their (row-block, col-block) coordinates; the matvec is a block gather
    of x, a VPU multiply+reduce per tile, and a sorted segment-sum over
    row blocks.

    This removes BcsrMatrix's kb-padding: BCSR pads every row block to the
    DENSEST row block's column count, which explodes on transfer operators
    whose worst rows touch many column blocks (restrictions of
    agglomerate-spread fine dofs). The scatter (segment_sum) costs more
    than BCSR's dense write, so this format only wins when the tile count
    is well below nbr * kb — hierarchy.build_hierarchy picks per operator
    from the host-side structure stats (bcsr_stats).
    """
    row_blocks: jnp.ndarray    # (ntiles,) int32, SORTED ascending
    col_blocks: jnp.ndarray    # (ntiles,) int32
    tiles: jnp.ndarray         # (ntiles, BR, BC)
    shape: tuple               # logical (n, m)
    padded: tuple              # (n_pad, m_pad)

    BR = 8
    BC = 128

    @property
    def dtype(self):
        return self.tiles.dtype

    def tree_flatten(self):
        return (self.row_blocks, self.col_blocks, self.tiles), (
            self.shape, self.padded)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], aux[1])

    def matvec(self, x):
        n, m = self.shape
        m_pad = self.padded[1]
        nbr = self.padded[0] // self.BR
        if x.ndim == 2:
            s = x.shape[1]
            xp = jnp.zeros((m_pad, s), x.dtype).at[:m].set(x)
            xb = xp.reshape(-1, self.BC, s)
            g = xb[self.col_blocks]                  # (t, 128, s)
            part = jnp.einsum("trc,tcs->trs", self.tiles, g,
                              precision=_HIGHEST)
            y = jax.ops.segment_sum(part, self.row_blocks,
                                    num_segments=nbr,
                                    indices_are_sorted=True)
            return y.reshape(-1, s)[:n]
        xp = jnp.zeros(m_pad, x.dtype).at[:m].set(x)
        xb = xp.reshape(-1, self.BC)
        g = xb[self.col_blocks]                      # (t, 128)
        part = (self.tiles * g[:, None, :]).sum(axis=2)    # (t, BR)
        y = jax.ops.segment_sum(part, self.row_blocks, num_segments=nbr,
                                indices_are_sorted=True)
        return y.reshape(-1)[:n]

    def __matmul__(self, x):
        return self.matvec(x)


def bcsr_stats(A, br=8, bc=128):
    """Host-side structure stats for format selection WITHOUT building the
    tiles: returns (nbr, kb, ntiles) — BCSR stores nbr*kb tiles padded to
    the densest row block, TileCoo stores exactly ntiles."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo = A.tocoo()
    nbc = -(-m // bc)
    key = (coo.row.astype(np.int64) // br) * nbc + coo.col // bc
    uk = np.unique(key)
    nbr = -(-n // br)
    counts = np.bincount((uk // nbc).astype(np.int64), minlength=nbr)
    kb = int(counts.max()) if counts.size else 1
    return nbr, max(kb, 1), int(uk.size)


def to_tilecoo(A, dtype=np.float32, br=8, bc=128) -> TileCooMatrix:
    """Convert scipy sparse to COO-of-tiles (sorted by row block)."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    n_pad = -(-n // br) * br
    m_pad = -(-m // bc) * bc
    coo = A.tocoo()
    nbc = m_pad // bc
    rb = coo.row.astype(np.int64) // br
    cb = coo.col.astype(np.int64) // bc
    key = rb * nbc + cb
    uk, inv = np.unique(key, return_inverse=True)
    tiles = np.zeros((max(uk.size, 1), br, bc), dtype)
    tiles[inv, coo.row % br, coo.col % bc] = coo.data
    urb = (uk // nbc).astype(np.int32) if uk.size else np.zeros(1, np.int32)
    ucb = (uk % nbc).astype(np.int32) if uk.size else np.zeros(1, np.int32)
    return TileCooMatrix(jnp.asarray(urb), jnp.asarray(ucb),
                         jnp.asarray(tiles), (n, m), (n_pad, m_pad))


@jax.tree_util.register_pytree_node_class
@dataclass
class DiaMatrix:
    """Diagonal (shift) layout: GATHER-FREE SpMV.

    y[i] = sum_d data[d, i] * x[i + offsets[d]], i.e. the matvec is nd
    shifted elementwise multiply-adds over the padded x — STATIC slices
    only, no gathers and no block-fill waste (BCSR tiles are ~1% full on
    stencil-like operators). Offsets are static aux data, so the shift sum
    unrolls and XLA can fuse all nd shifted multiply-adds (and a caller's
    Jacobi update around them) into one elementwise loop. Best used with
    RCM-permuted operators (tight bandwidth -> few distinct offsets); see
    solvers.hierarchy.build_hierarchy(reorder).
    """
    data: jnp.ndarray      # (nd, n) row-aligned coefficients
    offs: tuple            # (nd,) STATIC column offsets (col - row)
    shape: tuple           # (n, m) static
    span: tuple            # (lo, hi) static: -min(offs,0), max(offs,0)

    def tree_flatten(self):
        return (self.data,), (self.offs, self.shape, self.span)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2])

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        n, m = self.shape
        lo, hi = self.span
        pad_shape = (lo + m + hi,) + x.shape[1:]
        xpad = jnp.zeros(pad_shape, x.dtype).at[lo:lo + m].set(x)
        out_dtype = jnp.result_type(self.data.dtype, x.dtype)
        y = jnp.zeros((n,) + x.shape[1:], out_dtype)
        for d, off in enumerate(self.offs):
            w = jax.lax.slice_in_dim(xpad, lo + off, lo + off + n, axis=0)
            row = self.data[d]
            y = y + (row[:, None] * w if x.ndim == 2 else row * w)
        return y

    def __matmul__(self, x):
        return self.matvec(x)


def to_dia(A, dtype=np.float32) -> DiaMatrix:
    """Convert scipy sparse to the row-aligned diagonal layout."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo = A.tocoo()
    off = coo.col.astype(np.int64) - coo.row
    offsets = np.unique(off)
    slot = np.searchsorted(offsets, off)
    data = np.zeros((max(offsets.size, 1), n), dtype=dtype)
    np.add.at(data, (slot, coo.row), coo.data.astype(dtype))
    if offsets.size == 0:
        offsets = np.zeros(1, dtype=np.int64)
    lo = int(max(-offsets.min(), 0))
    hi = int(max(offsets.max() + n - m, 0))
    return DiaMatrix(jnp.asarray(data), tuple(int(o) for o in offsets),
                     (n, m), (lo, hi))


@jax.tree_util.register_pytree_node_class
@dataclass
class CooMatrix:
    """Padded COO: y = zeros.at[rows].add(vals * x[cols]).

    For a sparse REMAINDER with nnz << n*k, the gather+scatter touches
    2*nnz elements where an ELL table would gather n*k (padding
    included) — the right format for the straggler entries of a
    DiaEllMatrix split.  Padding entries carry rows=cols=0, vals=0.
    """
    rows: jnp.ndarray      # (nnz_pad,) int32
    cols: jnp.ndarray      # (nnz_pad,) int32
    vals: jnp.ndarray      # (nnz_pad,)
    shape: tuple

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x):
        n = self.shape[0]
        contrib = self.vals * x[self.cols]
        out_shape = (n,) + x.shape[1:]
        return jnp.zeros(out_shape, contrib.dtype).at[self.rows].add(
            contrib)

    def __matmul__(self, x):
        return self.matvec(x)


def to_coo(A, dtype=np.float32, pad_to=8192) -> CooMatrix:
    """Convert scipy sparse to padded device COO."""
    A = sp.coo_matrix(A)
    nnz = max(int(A.nnz), 1)
    npad = -(-nnz // pad_to) * pad_to
    rows = np.zeros(npad, np.int32)
    cols = np.zeros(npad, np.int32)
    vals = np.zeros(npad, dtype)
    rows[:A.nnz] = A.row
    cols[:A.nnz] = A.col
    vals[:A.nnz] = A.data
    return CooMatrix(jnp.asarray(rows), jnp.asarray(cols),
                     jnp.asarray(vals), A.shape)


@jax.tree_util.register_pytree_node_class
@dataclass
class DiaEllMatrix:
    """Hybrid split A = D + R: the high-occupancy diagonals go in DIA
    (gather-free shifted-slice adds) and the stragglers in a narrow ELL.

    Facet multiplier systems on structured meshes put 95%+ of nnz on a
    few dozen diagonals; moving those out of the element gather leaves a
    narrow remainder.  Whether this beats plain ELL on the H100 is not
    measured.
    """
    dia: "DiaMatrix"
    ell: "EllMatrix"
    shape: tuple

    def tree_flatten(self):
        return (self.dia, self.ell), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    @property
    def dtype(self):
        return self.dia.dtype

    def matvec(self, x):
        return self.dia @ x + self.ell @ x

    def __matmul__(self, x):
        return self.matvec(x)


def to_dia_ell(A, dtype=np.float32, min_fill=0.05, max_diags=64,
               ell_pad_to=4):
    """Split scipy sparse A into DiaEllMatrix: offsets filled on at least
    `min_fill` of the rows (up to `max_diags` of them, densest first)
    become DIA; the rest an ELL remainder.  Break-even fill is ~1%: a
    DIA lane costs one n-long slice-add (~7 us of HBM traffic at
    n=131072) against ~7.7 ns per gathered ELL element."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo = A.tocoo()
    off = coo.col.astype(np.int64) - coo.row
    offs, cnt = np.unique(off, return_counts=True)
    dense = offs[np.argsort(-cnt)[:max_diags]]
    dense = np.sort(dense[np.isin(dense, offs[cnt >= min_fill * n])])
    in_dia = np.isin(off, dense)
    D = sp.coo_matrix((coo.data[in_dia],
                       (coo.row[in_dia], coo.col[in_dia])), shape=(n, m))
    R = sp.coo_matrix((coo.data[~in_dia],
                       (coo.row[~in_dia], coo.col[~in_dia])), shape=(n, m))
    # remainder as padded COO: touches 2*nnz_r elements instead of an
    # n*k ELL gather over mostly-padding rows
    return DiaEllMatrix(to_dia(D, dtype=dtype), to_coo(R, dtype=dtype),
                        (n, m))


@jax.tree_util.register_pytree_node_class
class BlockDiagInverse:
    """Block-diagonal inverse in block-contiguous ordering: apply is
    static slices + batched (k, s, s) einsum — zero gathers.  Caller
    permutes the system so same-size blocks sit in contiguous segments;
    singleton buckets degenerate to an elementwise multiply."""

    def __init__(self, tensors, sizes):
        self.tensors = tuple(tensors)  # (k,) vectors for s==1, else (k,s,s)
        self.sizes = tuple(sizes)

    def tree_flatten(self):
        return self.tensors, self.sizes

    @classmethod
    def tree_unflatten(cls, sizes, tensors):
        return cls(tensors, sizes)

    @property
    def dtype(self):
        return self.tensors[0].dtype

    def matvec(self, r):
        outs, o = [], 0
        for s, B in zip(self.sizes, self.tensors):
            k = B.shape[0]
            seg = jax.lax.slice_in_dim(r, o, o + k * s)
            if s == 1:
                outs.append(B * seg)
            else:
                outs.append(jnp.einsum(
                    "kij,kj->ki", B, seg.reshape(k, s),
                    precision=_HIGHEST).reshape(-1))
            o += k * s
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs)

    def __matmul__(self, r):
        return self.matvec(r)


def dia_ell_fill(A, min_fill=0.05, max_diags=64):
    """Fraction of nnz the DIA part of to_dia_ell would capture."""
    A = sp.coo_matrix(A)
    if A.nnz == 0:
        return 1.0
    n = A.shape[0]
    off = A.col.astype(np.int64) - A.row
    offs, cnt = np.unique(off, return_counts=True)
    keep = cnt[np.argsort(-cnt)[:max_diags]]
    return float(keep[keep >= min_fill * n].sum()) / A.nnz


def dia_n_offsets(A) -> int:
    """Distinct (col - row) offsets — the DIA storage multiplier."""
    coo = sp.coo_matrix(A)
    return int(np.unique(coo.col.astype(np.int64) - coo.row).size)


def diag_of(A_scipy) -> np.ndarray:
    return sp.csr_matrix(A_scipy).diagonal()


def l1_row_weights(A_scipy) -> np.ndarray:
    """l1-Jacobi weights: d_i = sum_j |a_ij| (reference Weightedl1Smoother
    row weights, ParELAG_MatrixUtils.hpp:40-142); spectrally safe diagonal
    smoother, the data-parallel substitute for hypre's sequential L1-GS."""
    A = sp.csr_matrix(A_scipy)
    return np.asarray(np.abs(A).sum(axis=1)).ravel()
