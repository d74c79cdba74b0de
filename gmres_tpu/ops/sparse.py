"""Sparse-matrix formats and SpMV.

The reference has **no** sparse-matrix code at all — its only operator
paths are the dense Fortran ``matmul`` (gmres_hh.f90:37,48) and the
hand-written 5-point stencil (poisson.f90:33-77); SURVEY §2 C13 notes
that CSR/COO SpMV is a build requirement beyond the reference
(BASELINE.json north star).

* **ELL (ELLPACK)**: every row stores a fixed ``k = max nnz/row`` of
  (value, column) pairs, padded with zeros. Static shapes, one XLA
  gather + one dense reduction — no data-dependent control flow, fully
  fusible, shards by rows.
* **CSR** / **COO** use XLA ``segment_sum`` (sorted segments) — kept for
  interop and for matrices whose row occupancy is too skewed for ELL.
* **BSR (block-sparse rows)** with dense (bs × bs) blocks: a gather of x
  blocks and one batched block matvec.
* **HYB = DIA + ELL residue** (``csr_to_hyb``): every well-occupied
  (generalized) diagonal goes into DIA — vector shifts, no gathers —
  and only the stragglers stay in a small-k gather ELL. PDE
  discretizations, banded systems, and reordered (RCM) meshes are
  near-100% diagonal; fully random matrices degrade gracefully to the
  gather path.

All containers are registered pytrees, so a sparse matrix can close
over a ``LinearOperator`` and flow through ``jit`` untouched.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )


@functools.partial(
    _register,
    data_fields=["data", "indices", "indptr"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse rows: data (nnz,), indices (nnz,) column ids,
    indptr (nrows+1,) row offsets."""

    data: jnp.ndarray
    indices: jnp.ndarray
    indptr: jnp.ndarray
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@functools.partial(
    _register, data_fields=["data", "row", "col"], meta_fields=["shape"]
)
@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate format: data/row/col all (nnz,). Rows must be sorted
    (ascending) for the segment-sum SpMV fast path."""

    data: jnp.ndarray
    row: jnp.ndarray
    col: jnp.ndarray
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@functools.partial(
    _register, data_fields=["data", "cols"], meta_fields=["shape"]
)
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: data (nrows, k), cols (nrows, k); padding entries have
    value 0 and column 0 (they contribute nothing)."""

    data: jnp.ndarray
    cols: jnp.ndarray
    shape: tuple

    @property
    def row_width(self) -> int:
        return self.data.shape[1]


@functools.partial(
    _register, data_fields=["data"], meta_fields=["offsets", "shape"]
)
@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal format: data (ndiags, n) holds each diagonal aligned to
    ROW index (data[k, i] = A[i, i + offsets[k]], zero where out of
    range). The format for banded matrices (every stencil
    discretization): SpMV is a shift + multiply per diagonal — no
    gathers, no segments, fully vectorizable, shards by rows."""

    data: jnp.ndarray
    offsets: tuple
    shape: tuple

    @property
    def ndiags(self) -> int:
        return self.data.shape[0]


@functools.partial(
    _register, data_fields=["dia", "ell"], meta_fields=["shape"]
)
@dataclasses.dataclass(frozen=True)
class HYBMatrix:
    """Hybrid DIA + ELL: well-occupied generalized diagonals in ``dia``
    (vector-shift SpMV, no gathers), straggler entries in a small-k
    ``ell`` residue (``None`` when the matrix is fully diagonal).
    Built by ``csr_to_hyb``/``coo_to_hyb``."""

    dia: DIAMatrix
    ell: ELLMatrix | None
    shape: tuple

    @property
    def nnz_dia(self) -> int:
        import numpy as _np

        return int((_np.asarray(self.dia.data) != 0).sum())


@functools.partial(
    _register, data_fields=["data", "block_cols"], meta_fields=["shape"]
)
@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse rows with dense (bs, bs) blocks in ELL layout:
    data (n_block_rows, k, bs, bs), block_cols (n_block_rows, k) —
    padding blocks are all-zero with block-column 0."""

    data: jnp.ndarray
    block_cols: jnp.ndarray
    shape: tuple

    @property
    def block_size(self) -> int:
        return self.data.shape[-1]


# ---------------------------------------------------------------------------
# Construction.
# ---------------------------------------------------------------------------


def csr_from_dense(a, tol: float = 0.0) -> CSRMatrix:
    """Build CSR from a dense matrix (host-side; numpy)."""
    a = np.asarray(a)
    mask = np.abs(a) > tol
    row_counts = mask.sum(axis=1)
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int32)
    np.cumsum(row_counts, out=indptr[1:])
    rows, cols = np.nonzero(mask)
    return CSRMatrix(
        data=jnp.asarray(a[rows, cols]),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr),
        shape=a.shape,
    )


def coo_from_dense(a, tol: float = 0.0) -> COOMatrix:
    a = np.asarray(a)
    rows, cols = np.nonzero(np.abs(a) > tol)  # row-major ⇒ rows sorted
    return COOMatrix(
        data=jnp.asarray(a[rows, cols]),
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        shape=a.shape,
    )


def ell_from_dense(a, tol: float = 0.0) -> ELLMatrix:
    a = np.asarray(a)
    mask = np.abs(a) > tol
    k = max(int(mask.sum(axis=1).max()), 1)
    nrows = a.shape[0]
    data = np.zeros((nrows, k), dtype=a.dtype)
    cols = np.zeros((nrows, k), dtype=np.int32)
    for i in range(nrows):
        (nz,) = np.nonzero(mask[i])
        data[i, : nz.size] = a[i, nz]
        cols[i, : nz.size] = nz
    return ELLMatrix(
        data=jnp.asarray(data), cols=jnp.asarray(cols), shape=a.shape
    )


def csr_to_ell(a: CSRMatrix, row_width: int | None = None) -> ELLMatrix:
    """Repack CSR as ELL (host-side)."""
    data = np.asarray(a.data)
    indices = np.asarray(a.indices)
    indptr = np.asarray(a.indptr)
    counts = np.diff(indptr)
    k = int(row_width if row_width is not None else max(counts.max(), 1))
    nrows = a.shape[0]
    out_d = np.zeros((nrows, k), dtype=data.dtype)
    out_c = np.zeros((nrows, k), dtype=np.int32)
    for i in range(nrows):
        lo, hi = indptr[i], indptr[i + 1]
        out_d[i, : hi - lo] = data[lo:hi]
        out_c[i, : hi - lo] = indices[lo:hi]
    return ELLMatrix(
        data=jnp.asarray(out_d), cols=jnp.asarray(out_c), shape=a.shape
    )


def poisson_csr(nsize: int, dtype=jnp.float64) -> CSRMatrix:
    """5-point Laplacian (poisson.f90:13-30 sparsity, C-order
    flattening) assembled directly in CSR — never densified, so this
    scales to the ≥90k-variable benchmark grids."""
    n = nsize * nsize
    idx = np.arange(n)
    i, j = idx // nsize, idx % nsize
    diags = []  # (offset, values, valid-mask)
    diags.append((0, np.full(n, 4.0), np.ones(n, bool)))
    diags.append((-nsize, np.full(n, -1.0), i > 0))
    diags.append((-1, np.full(n, -1.0), j > 0))
    diags.append((1, np.full(n, -1.0), j < nsize - 1))
    diags.append((nsize, np.full(n, -1.0), i < nsize - 1))
    rows, cols, vals = [], [], []
    for off, v, m in diags:
        rows.append(idx[m])
        cols.append(idx[m] + off)
        vals.append(v[m])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRMatrix(
        data=jnp.asarray(vals, dtype=dtype),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr.astype(np.int32)),
        shape=(n, n),
    )


def dia_from_dense(a, tol: float = 0.0) -> DIAMatrix:
    """Extract every nonzero diagonal (host-side)."""
    a = np.asarray(a)
    n = a.shape[0]
    offsets = []
    rows = []
    for off in range(-(n - 1), n):
        d = np.diagonal(a, offset=off)
        if np.any(np.abs(d) > tol):
            row = np.zeros(n, dtype=a.dtype)
            if off >= 0:
                row[: n - off] = d
            else:
                row[-off:] = d
            offsets.append(off)
            rows.append(row)
    return DIAMatrix(
        data=jnp.asarray(np.stack(rows) if rows else np.zeros((1, n))),
        offsets=tuple(offsets) if offsets else (0,),
        shape=a.shape,
    )


def csr_to_hyb(
    a: CSRMatrix,
    min_occupancy: float = 0.25,
    max_diags: int = 64,
) -> HYBMatrix:
    """Split CSR into DIA (diagonals occupied on ≥ min_occupancy of
    eligible rows; when more than max_diags qualify, the most-covered
    — highest entry count — are kept) + an ELL residue for the
    leftovers (host-side).

    The split is exact — every nonzero lands in exactly one part — so
    ``hyb_spmv`` reproduces ``csr_spmv`` to roundoff. For a structured
    matrix (stencils, banded systems, RCM-reordered meshes) the residue
    is empty and SpMV runs entirely on the shift-based DIA path; a
    fully random matrix keeps everything in the gather residue."""
    n_rows, n_cols = a.shape
    data = np.asarray(a.data)
    indices = np.asarray(a.indices)
    indptr = np.asarray(a.indptr)
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    offs = indices.astype(np.int64) - rows
    uniq, counts = np.unique(offs, return_counts=True)
    # Occupancy relative to the diagonal's maximum possible length.
    max_len = np.minimum(n_rows - np.maximum(uniq, 0),
                         n_cols + np.minimum(uniq, 0))
    occ = counts / np.maximum(max_len, 1)
    eligible = occ >= min_occupancy
    chosen = uniq[eligible]
    if chosen.size > max_diags:
        # most-COVERED first: a DIA diagonal costs a full n_rows slot
        # regardless of its length, so with a fixed max_diags budget
        # the objective is total nnz moved off the gather path —
        # raw counts, not occupancy (occupancy is only the entry bar).
        order = np.argsort(-counts[eligible])
        chosen = chosen[order[:max_diags]]
    dia_offsets = tuple(int(o) for o in np.sort(chosen))
    dia_data = np.zeros((max(len(dia_offsets), 1), n_rows),
                        dtype=data.dtype)
    in_dia = np.isin(offs, chosen)
    if dia_offsets:
        k_idx = np.searchsorted(np.asarray(dia_offsets), offs[in_dia])
        dia_data[k_idx, rows[in_dia]] = data[in_dia]

    res_mask = ~in_dia
    ell = None
    if res_mask.any():
        r_rows = rows[res_mask]  # sorted (CSR order)
        r_cols = indices[res_mask]
        r_data = data[res_mask]
        counts_r = np.bincount(r_rows, minlength=n_rows)
        k = int(counts_r.max())
        ell_d = np.zeros((n_rows, k), dtype=data.dtype)
        ell_c = np.zeros((n_rows, k), dtype=np.int32)
        # slot index = position within the row = running index minus
        # the row's start (vectorized cumcount over sorted rows)
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts_r, out=starts[1:])
        slot = np.arange(r_rows.size) - starts[r_rows]
        ell_d[r_rows, slot] = r_data
        ell_c[r_rows, slot] = r_cols
        ell = ELLMatrix(
            data=jnp.asarray(ell_d), cols=jnp.asarray(ell_c),
            shape=a.shape,
        )
    dia = DIAMatrix(
        data=jnp.asarray(dia_data),
        offsets=dia_offsets if dia_offsets else (0,),
        shape=a.shape,
    )
    return HYBMatrix(dia=dia, ell=ell, shape=a.shape)


def coo_to_hyb(
    a: COOMatrix, min_occupancy: float = 0.25, max_diags: int = 64
) -> HYBMatrix:
    """COO → HYB via the CSR splitter (host-side; rows must be
    sorted, the COOMatrix contract)."""
    row = np.asarray(a.row)
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    np.cumsum(indptr, out=indptr)
    csr = CSRMatrix(
        data=a.data, indices=a.col,
        indptr=jnp.asarray(indptr.astype(np.int32)), shape=a.shape,
    )
    return csr_to_hyb(csr, min_occupancy=min_occupancy,
                      max_diags=max_diags)


def poisson_dia(nsize: int, dtype=jnp.float64) -> DIAMatrix:
    """5-point Laplacian directly in DIA (never densified): offsets
    (−N, −1, 0, 1, N) — the natural sparse form of poisson.f90:13-30."""
    n = nsize * nsize
    j = np.arange(n) % nsize
    main = np.full(n, 4.0)
    west = np.where(j > 0, -1.0, 0.0)    # A[i, i-1]
    east = np.where(j < nsize - 1, -1.0, 0.0)  # A[i, i+1]
    north = np.full(n, -1.0)
    north[n - nsize:] = 0.0              # A[i, i+N] valid for i < n-N
    south = np.full(n, -1.0)
    south[:nsize] = 0.0                  # A[i, i-N] valid for i >= N
    data = np.stack([south, west, main, east, north]).astype(
        np.dtype(dtype)
    )
    return DIAMatrix(
        data=jnp.asarray(data),
        offsets=(-nsize, -1, 0, 1, nsize),
        shape=(n, n),
    )


# ---------------------------------------------------------------------------
# SpMV (jnp / XLA paths).
# ---------------------------------------------------------------------------


def dia_spmv(a: DIAMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y_i = Σ_k data[k, i] · x[i + off_k]: one roll + multiply-add per
    diagonal, all static — zero gathers. Out-of-range positions carry
    zero coefficients by construction, so plain jnp.roll wrap-around is
    harmless."""
    xf = x.reshape(-1)
    y = jnp.zeros_like(xf)
    for k, off in enumerate(a.offsets):
        y = y + a.data[k] * jnp.roll(xf, -off)
    return y


def csr_row_ids(a: CSRMatrix) -> jnp.ndarray:
    """Per-nnz row ids from indptr (one searchsorted). Loop-invariant
    for a fixed matrix — precompute and pass to ``csr_spmv`` when the
    SpMV runs inside a solver loop (``sparse_operator`` does this)."""
    return (
        jnp.searchsorted(
            a.indptr, jnp.arange(a.nnz, dtype=a.indptr.dtype),
            side="right",
        )
        - 1
    )


def csr_spmv(
    a: CSRMatrix, x: jnp.ndarray, rows: jnp.ndarray | None = None
) -> jnp.ndarray:
    """y = A x via sorted segment-sum — the XLA pattern that lowers to
    a single scan-free reduction. ``rows`` (from ``csr_row_ids``) is
    recomputed when not supplied."""
    if rows is None:
        rows = csr_row_ids(a)
    prod = a.data * x.reshape(-1)[a.indices]
    return jax.ops.segment_sum(
        prod, rows, num_segments=a.shape[0], indices_are_sorted=True
    )


def coo_spmv(a: COOMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prod = a.data * x.reshape(-1)[a.col]
    return jax.ops.segment_sum(
        prod, a.row, num_segments=a.shape[0], indices_are_sorted=True
    )


def ell_spmv(a: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x: one gather (nrows, k) + one dense row reduction.
    The general SpMV — everything static, no segments."""
    return jnp.sum(a.data * x.reshape(-1)[a.cols], axis=1)


def bsr_spmv(a: BSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """jnp reference path for BSR: gather x blocks, batched block
    matvec (einsum), row-sum."""
    bs = a.block_size
    xb = x.reshape(-1, bs)  # (n_block_cols, bs)
    gathered = xb[a.block_cols]  # (nbr, k, bs)
    return jnp.einsum(
        "rkab,rkb->ra", a.data, gathered,
        preferred_element_type=x.dtype,
    ).reshape(-1)


def hyb_spmv(a: HYBMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x for the hybrid format: shift-based DIA part plus the
    gather-ELL residue (empty for structured matrices)."""
    y = dia_spmv(a.dia, x)
    if a.ell is not None:
        y = y + ell_spmv(a.ell, x)
    return y


def bsr_from_dense(a, block_size: int, tol: float = 0.0) -> BSRMatrix:
    """Blocked ELL from dense (host-side). Rows/cols must divide by
    block_size; a block is kept if any entry is nonzero."""
    a = np.asarray(a)
    bs = block_size
    nbr, nbc = a.shape[0] // bs, a.shape[1] // bs
    blocks = a.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    occupied = np.abs(blocks).max(axis=(2, 3)) > tol  # (nbr, nbc)
    k = max(int(occupied.sum(axis=1).max()), 1)
    data = np.zeros((nbr, k, bs, bs), dtype=a.dtype)
    cols = np.zeros((nbr, k), dtype=np.int32)
    for i in range(nbr):
        (nz,) = np.nonzero(occupied[i])
        data[i, : nz.size] = blocks[i, nz]
        cols[i, : nz.size] = nz
    return BSRMatrix(
        data=jnp.asarray(data), block_cols=jnp.asarray(cols), shape=a.shape
    )


# ---------------------------------------------------------------------------
# Operator adapters.
# ---------------------------------------------------------------------------


def sparse_operator(a) -> Callable:
    """Wrap any sparse container as a LinearOperator closure (the
    same inversion-of-control contract as the stencil operators,
    interfaces.f90:12-18)."""
    if isinstance(a, CSRMatrix):
        rows = csr_row_ids(a)
        return lambda x: csr_spmv(a, x, rows=rows)
    if isinstance(a, COOMatrix):
        return lambda x: coo_spmv(a, x)
    if isinstance(a, ELLMatrix):
        return lambda x: ell_spmv(a, x)
    if isinstance(a, BSRMatrix):
        return lambda x: bsr_spmv(a, x)
    if isinstance(a, HYBMatrix):
        return lambda x: hyb_spmv(a, x)
    if isinstance(a, DIAMatrix):
        return lambda x: dia_spmv(a, x)
    raise TypeError(f"not a sparse matrix: {type(a)}")
