"""SPAI — sparse approximate inverse preconditioner (Grote–Huckle 1997).

The reference's only preconditioner is the Chebyshev polynomial
(``src/chebyshev.f90:8-38``), which needs spectral bounds and a
real-axis spectrum; the library's multigrid cycles need a grid. SPAI is
the classic GENERAL-sparse complement: choose a sparsity pattern for M
(here: the pattern of A itself), then minimize ‖A m_j − e_j‖₂
independently for every column j of M over its allowed support. No
spectrum estimate, no grid, no symmetry assumption — and applying M is
one gather-based SpMV (`ops/sparse.py:ell_spmv`), so it composes with
every solver in the library as a right preconditioner.

Accelerator-first construction: unlike the classic implementations (per-column
sparse QR on a CPU, irregular and sequential), every local problem here
is embedded in FIXED shapes derived from the ELL widths of A — support
S_j padded to the max column count w_c, residual rows T_j padded to
w_c² — and all n of them are solved in ONE `vmap`-batched pass of dense
(w_c × w_c) normal-equation solves: gather → one-hot contraction → a
batched Cholesky-sized `linalg.solve` that XLA maps onto matmuls.
Duplicated residual rows (the unions T_j overlap) are deduplicated by a
sort + first-occurrence mask; padded slots are zeroed, and a Tikhonov
term λ·tr(G)/w_c keeps the masked normal matrix invertible (it also
regularizes genuinely rank-deficient local problems; the padded columns
of M it would produce are re-masked to exactly zero).

Cost model: the batched one-hot gather materializes
(n, w_c², w_r, w_c) booleans — fine through w ≈ 16 at n ≈ 10⁵; for
wider stencils construct in column chunks (``chunk=``).  Quality: with
pattern(M) = pattern(A), SPAI reproduces A⁻¹ EXACTLY whenever A⁻¹'s
support lies inside A's (e.g. block-diagonal A — pinned by
``tests/test_spai.py``, alongside a complex least-squares oracle and a
sharded-apply parity test), and on irregular general matrices it is
the standard fallback when nothing structural is known.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.ops.sparse import CSRMatrix, ELLMatrix, ell_spmv


def _to_host_csr(a) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple]:
    """Normalize CSRMatrix / dense input to host numpy CSR triples."""
    if isinstance(a, CSRMatrix):
        return (
            np.asarray(a.data),
            np.asarray(a.indices),
            np.asarray(a.indptr),
            tuple(a.shape),
        )
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"spai needs a square matrix, got {a.shape}")
    mask = a != 0
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    rows, cols = np.nonzero(mask)
    return a[rows, cols], cols.astype(np.int32), indptr, a.shape


def _padded_ell(data, indices, indptr, n, with_data=True):
    """Host-side ELL arrays (values, cols, valid-mask) at max width.

    Fully vectorized (no per-row Python loop): the slot of nnz entry t
    within its row is t − indptr[row(t)], a single scatter."""
    counts = np.diff(indptr)
    w = max(int(counts.max()) if counts.size else 1, 1)
    d = np.zeros((n, w), dtype=data.dtype)
    c = np.zeros((n, w), dtype=np.int32)
    v = np.zeros((n, w), dtype=bool)
    nnz = len(indices)
    if nnz:
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(nnz) - indptr[rows]
        if with_data:
            d[rows, slot] = data
        c[rows, slot] = indices
        v[rows, slot] = True
    return d, c, v


@functools.partial(jax.jit, static_argnames=("n", "reg"))
def _solve_columns(a_d, a_c, a_v, at_c, at_v, cols, *, n, reg):
    """Batched local least squares: for each requested column j, the
    values of m_j on its support S_j = nonzero rows of A's column j.

    Shapes (w_r = max row width of A, w_c = max column width):
      a_d/a_c/a_v : (n, w_r) row-ELL of A (+ validity)
      at_c/at_v   : (n, w_c) row-ELL pattern of Aᵀ (+ validity)
      cols        : (k,) column indices to solve
    Returns (k, w_c) values aligned with at_c[cols].
    """
    w_c = at_c.shape[1]
    hi = jax.lax.Precision.HIGHEST
    eye = jnp.eye(w_c, dtype=a_d.dtype)

    def solve_col(j):
        s = at_c[j]
        s_valid = at_v[j]
        # Residual rows T_j = ∪_{k∈S_j} (nonzero rows of column k),
        # padded to w_c² and deduplicated: sort (invalid pushed past n)
        # and keep first occurrences — duplicate copies are identical
        # gathered rows, so dropping repeats reproduces the exact
        # unduplicated least-squares problem.
        t = at_c[s].reshape(-1)
        t_valid = (at_v[s] & s_valid[:, None]).reshape(-1)
        key = jnp.where(t_valid, t, n)
        order = jnp.argsort(key)
        ts = t[order]
        tvs = t_valid[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), ts[1:] != ts[:-1]]
        )
        row_valid = tvs & first
        # Gather Â = A[T_j, S_j] by one-hot contraction of the ELL rows.
        rd = a_d[ts]  # (m, w_r)
        onehot = (
            (a_c[ts][:, :, None] == s[None, None, :])
            & a_v[ts][:, :, None]
            & s_valid[None, None, :]
        )
        ahat = jnp.einsum(
            "mt,mtb->mb", rd, onehot.astype(rd.dtype), precision=hi
        )
        ahat = ahat * row_valid[:, None].astype(rd.dtype)
        e = ((ts == j) & row_valid).astype(rd.dtype)
        # Regularized CONJUGATE-transpose normal equations G = ÂᴴÂ,
        # rhs = Âᴴe — for complex A the plain transpose minimizes the
        # wrong functional and misses the Grote–Huckle least-squares
        # minimizer (the conj is a no-op XLA elides for real dtypes).
        # G is PSD Hermitian with zero rows/cols at padded support
        # slots; λ·(tr G / w_c) makes it HPD without perturbing the
        # solution beyond O(λ) relative.
        g = jnp.matmul(ahat.conj().T, ahat, precision=hi)
        scale = jnp.maximum(
            jnp.trace(g).real / w_c, jnp.finfo(rd.dtype).tiny
        )
        g = g + (reg * scale) * eye
        rhs = jnp.matmul(ahat.conj().T, e, precision=hi)
        m = jnp.linalg.solve(g, rhs)
        return m * s_valid.astype(rd.dtype)

    return jax.vmap(solve_col)(cols)


def spai_matrix(
    a: Union[CSRMatrix, jnp.ndarray, np.ndarray],
    *,
    reg: float = 1e-12,
    chunk: Optional[int] = None,
) -> ELLMatrix:
    """Build the SPAI approximate inverse M ≈ A⁻¹ with
    pattern(M) = pattern(A), returned as a row-ELL matrix ready for
    `ell_spmv`.

    reg: relative Tikhonov weight for the local normal equations.
    chunk: solve columns in chunks of this size (bounds the
      (chunk, w_c², w_r, w_c) one-hot buffer for wide patterns);
      default solves all n at once.
    """
    data, indices, indptr, shape = _to_host_csr(a)
    n = shape[0]
    a_d, a_c, a_v = _padded_ell(data, indices, indptr, n)
    # Pattern of Aᵀ (column supports of A), host transpose.
    order = np.argsort(indices, kind="stable")
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    t_indices = rows[order]
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=t_indptr[1:])
    _, at_c, at_v = _padded_ell(
        data[order], t_indices, t_indptr, n, with_data=False
    )
    dev = (
        jnp.asarray(a_d), jnp.asarray(a_c), jnp.asarray(a_v),
        jnp.asarray(at_c), jnp.asarray(at_v),
    )
    step = int(chunk) if chunk else n
    vals = np.concatenate(
        [
            np.asarray(
                _solve_columns(
                    *dev, jnp.arange(lo, min(lo + step, n)),
                    n=n, reg=float(reg),
                )
            )
            for lo in range(0, n, step)
        ]
    )
    # Scatter column values (vals[j, b] = M[at_c[j, b], j]) into the
    # row-ELL of M. pattern(M) = pattern(A) ⇒ row counts match A's.
    # Vectorized: stable-sort the valid (row, col, val) triples by row,
    # then each entry's slot is its rank within the row group (index
    # minus the group's first occurrence, via searchsorted).
    w_r = a_c.shape[1]
    m_d = np.zeros((n, w_r), dtype=vals.dtype)
    m_c = np.zeros((n, w_r), dtype=np.int32)
    jj, bb = np.nonzero(at_v)
    i_arr = at_c[jj, bb]
    order = np.argsort(i_arr, kind="stable")
    i_sorted = i_arr[order]
    slot = np.arange(len(i_sorted)) - np.searchsorted(
        i_sorted, i_sorted, side="left"
    )
    m_d[i_sorted, slot] = vals[jj, bb][order]
    m_c[i_sorted, slot] = jj[order]
    return ELLMatrix(
        data=jnp.asarray(m_d), cols=jnp.asarray(m_c), shape=shape
    )


def spai_preconditioner(
    a: Union[CSRMatrix, jnp.ndarray, np.ndarray],
    *,
    reg: float = 1e-12,
    chunk: Optional[int] = None,
) -> Callable:
    """SPAI as a preconditioner callable: v ↦ M v (one ELL SpMV),
    shape-preserving over any array the flat length matches."""
    m = spai_matrix(a, reg=reg, chunk=chunk)

    def apply(v: jnp.ndarray) -> jnp.ndarray:
        return ell_spmv(m, v.reshape(-1)).reshape(v.shape)

    return apply
