"""Block CG: s right-hand sides, one Krylov iteration (O'Leary 1980).

The SPD counterpart of solvers/block_gmres.py and the same hardware
argument (docs/DESIGN.md §4c): a single-RHS CG iteration is
HBM-bandwidth-bound — stream x, r, p, Ap once per iteration for two
dots. With s stacked RHS every long-vector op becomes an (s, n)
batched op and the reductions become (s, s) Gram MATMULS, amortizing the stream across the block. Algorithmically the
block also converges FASTER per iteration: each RHS draws on the
union block-Krylov space, so clustered/shared spectral content is
paid for once (tests pin block iterations strictly under the worst
single-RHS count).

Robustness, fixed-shape: the search-direction block is re-whitened by
clamped SVQB every iteration (shared with block_gmres/lobpcg). Block
CG's recurrence is invariant under right-multiplication of P by any
invertible transform — only span(P) matters, the (s, s) Gram solves
re-derive the coefficients — so whitening costs nothing
algorithmically and keeps PᵀAP well-conditioned where textbook block
CG breaks down on rank-deficient blocks (duplicate RHS: pinned).
Linearly dependent directions are clamped to orthonormalized noise
with ~zero weight (block_gmres._svqb), the fixed-shape substitute
for O'Leary's explicit deflation-by-column-dropping.

Per iteration: ONE batched operator dispatch (s matvecs), two (s, s)
Gram matmuls + their fused all-reduce, two replicated (s, s) Cholesky
solves. Exit: every RHS must pass, and the returned residuals are the
certified true ‖bᵢ − A xᵢ‖ (PARITY.md quirk 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.solvers.block_gmres import _orthonormalize_block
from gmres_tpu.types import Preconditioner, SolverStatus


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockCGResult:
    """Result of :func:`block_cg`.

    Attributes:
      x: (s, *shape) stacked solutions.
      iterations: block iterations performed (int32).
      residuals: (s,) certified true ‖bᵢ − A xᵢ‖ per RHS (absolute,
        cg.f90:37 semantics).
      residual: max over ``residuals``.
      status: SolverStatus int32 (CONVERGED iff every RHS converged).
    """

    x: Any
    iterations: jnp.ndarray
    residuals: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


def block_cg(
    A,
    B: jnp.ndarray,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    X0: Optional[jnp.ndarray] = None,
) -> BlockCGResult:
    """Solve A xᵢ = bᵢ (A SPD) for the s stacked right-hand sides B[i].

    Args:
      A: single-vector SPD operator callable (vmapped internally) or
        dense (n, n) matrix.
      B: (s, *shape) stacked right-hand sides (duplicates/zeros fine —
        the clamped whitening absorbs rank deficiency).
      tol: per-RHS ABSOLUTE ‖bᵢ − A xᵢ‖₂ target.
      max_iterations: block-iteration cap.
      M: optional SPD preconditioner (single-vector callable).
      X0: optional (s, *shape) initial guesses.
    """
    if hasattr(A, "ndim") and getattr(A, "ndim", 0) == 2:
        amat = A
        A = lambda v: amat @ v  # noqa: E731
    a_block = jax.vmap(A)
    m_block = jax.vmap(M) if M is not None else (lambda r: r)
    s = B.shape[0]
    dtype = B.dtype
    eps = float(jnp.finfo(dtype).eps)
    baxes = tuple(range(1, B.ndim))

    def bdot(u, v):
        return jnp.tensordot(u, v, axes=(baxes, baxes))  # (s, s)

    def comb(c, blk):
        return jnp.tensordot(c, blk, axes=(0, 0))

    def rownorms(blk):
        return jnp.sqrt(jnp.sum(blk.reshape(s, -1) ** 2, axis=1))

    x = jnp.zeros_like(B) if X0 is None else X0
    r = B - a_block(x) if X0 is not None else B
    z = m_block(r)
    p, _ = _orthonormalize_block(z, eps)
    res0 = rownorms(r)
    status0 = jnp.where(
        jnp.max(res0) < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    def solve_spd(g, rhs):
        # Clamped-SVQB keeps g ≈ I; jitter guards the residue of a
        # fully dependent direction.
        gj = g + (eps * jnp.max(jnp.abs(jnp.diagonal(g)))
                  + jnp.finfo(dtype).tiny) * jnp.eye(s, dtype=dtype)
        c = jax.scipy.linalg.cho_factor(0.5 * (gj + gj.T))
        return jax.scipy.linalg.cho_solve(c, rhs)

    def cond(carry):
        (i, *_), status = carry
        return (i < max_iterations) & (
            status == SolverStatus.MAX_ITERATIONS
        )

    def body(carry):
        (i, x, r, p), status = carry
        q = a_block(p)
        g = bdot(p, q)                      # PᵀAP (s, s)
        alpha = solve_spd(g, bdot(p, r))    # Galerkin: PᵀR_new = 0
        x = x + comb(alpha, p)
        r = r - comb(alpha, q)
        zn = m_block(r)
        beta = -solve_spd(g, bdot(q, zn))   # A-orthogonalize vs P
        p_new, _ = _orthonormalize_block(zn + comb(beta, p), eps)
        resn = rownorms(r)
        status = jnp.where(
            jnp.max(resn) < tol,
            jnp.int32(SolverStatus.CONVERGED),
            status,
        )
        status = jnp.where(
            ~jnp.all(jnp.isfinite(resn)),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return ((i + 1, x, r, p_new), status)

    (i, x, r, _), status = jax.lax.while_loop(
        cond, body, ((jnp.int32(0), x, r, p), status0)
    )

    # Certified per-RHS true residuals.
    res_true = rownorms(B - a_block(x))
    status = jnp.where(
        (status == SolverStatus.CONVERGED)
        & (jnp.max(res_true) >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    return BlockCGResult(
        x=x,
        iterations=i,
        residuals=res_true,
        residual=jnp.max(res_true),
        status=status,
    )
