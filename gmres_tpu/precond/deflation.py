"""Coarse-space (deflation) preconditioning: remove known slow modes.

Beyond the reference (single-level preconditioners only): when a few
approximate eigenvectors of A are available — from :func:`lobpcg`, a
previous :func:`gcrodr` recycle block, or closed form — projecting
them out lets CG run at the EFFECTIVE condition number
λ_max/λ_{k+1} instead of λ_max/λ_1. The library expresses this as a
PRECONDITIONER, not a solver fork: the balanced (BNN / hybrid) form

    P = Q + (I − Q A) M (I − A Q),       Q = W G⁻¹ Wᵀ,  G = Wᵀ A W

is symmetric positive definite whenever M is (Tang, Nabben, Vuik,
Erhel — J. Sci. Comput. 39, 2009, the "A-DEF2/BNN" family), so it
composes with plain :func:`cg`/:func:`minres` and stacks on top of
any existing M (Chebyshev, multigrid) — deflation handles the low
end of the spectrum, M the high end.

Device shape: A·W is precomputed ONCE (k matvecs at setup), so both
projection factors reduce to k-row block contractions against the
stored W / AW blocks — per apply: TWO fused block all-reduces, two
combinations, two replicated (k, k) triangular solves, zero extra
operator applications. The blocks shard like every other long-vector
block in the library (rows over the mesh, small factors replicated).

Exactness: for W spanning exact eigenvectors, P·A acts as the
identity on span(W) (pinned to 5e-17 in tests/test_deflation.py) and
CG converges at the rate the REMAINING spectrum dictates.

When it pays — measured honestly:
  * Dense-bottom spectra (mesh Laplacians) give MODEST, monotone-in-k
    cuts (64² Poisson at tol 1e-10: 142 → 129/119/109 iterations for
    k = 4/8/16): CG's worst-case √κ bound is loose there, and
    isolated outliers are cheap for CG even undeflated.
  * The documented win case is HIGH-CONTRAST coefficients under
    Jacobi scaling (Vuik, Segal, Meijerink, JCP 152, 1999): each
    stiff inclusion leaves one tiny isolated eigenvalue, and
    deflating the inclusion INDICATOR vectors (no eigensolve needed)
    nearly halves the count — measured 257 → 136 with two indicators
    at contrast 1e5 (tests/test_deflation.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, row_contract

from gmres_tpu.types import LinearOperator, Preconditioner


def coarse_space_preconditioner(
    A: LinearOperator,
    W: jnp.ndarray,
    M: Optional[Preconditioner] = None,
) -> Preconditioner:
    """Build the BNN coarse-space preconditioner from a (k, *shape)
    block of (approximate) eigenvectors W.

    Args:
      A: symmetric positive-definite operator callable (the SAME
        operator the solver will be given).
      W: (k, *shape) stacked coarse vectors. They need not be
        orthonormal — G = WᵀAW is factored — but must be linearly
        independent (a rank-deficient block makes G singular; callers
        with redundant candidates should SVQB them first, e.g. via
        lobpcg's returned basis).
      M: optional inner preconditioner (fine-space smoother). None
        means M = I: pure deflation.

    Returns:
      A Preconditioner callable z = P(r), SPD whenever M is.
    """
    if W.ndim < 2:
        raise ValueError(
            f"W must be (k, *shape) with k >= 1, got shape {W.shape}"
        )
    k = W.shape[0]
    baxes = tuple(range(1, W.ndim))
    aw = jax.vmap(A)(W)                       # (k, *shape), once
    g = jnp.tensordot(W, aw, axes=(baxes, baxes))   # (k, k) = WᵀAW
    # Replicated small factorization, done once at build time.
    chol = jax.scipy.linalg.cho_factor(g)

    def bdot(block, v):
        return row_contract(block, v)

    def comb(coefs, block):
        return row_combine(coefs, block)

    def solve_g(rhs):
        return jax.scipy.linalg.cho_solve(chol, rhs)

    def apply(r):
        y = solve_g(bdot(W, r))               # G⁻¹ Wᵀ r
        # (I − A Q) r, with A·(W c) = (AW)·c — no operator call.
        t = r - comb(y, aw)
        z = M(t) if M is not None else t
        # (I − Q A) z = z − W G⁻¹ (AW)ᵀ z  (A symmetric).
        y2 = solve_g(bdot(aw, z))
        return z - comb(y2, W) + comb(y, W)   # + Q r

    return apply


def dirichlet_poisson_modes(nsize: int, k: int,
                            dtype=jnp.float64) -> jnp.ndarray:
    """The k lowest closed-form eigenvectors of the 2-D 5-point
    Dirichlet Laplacian as a (k, nsize, nsize) block — the exact
    coarse space for :func:`coarse_space_preconditioner` on
    ``poisson_operator`` grids (eigenvalues
    4sin²(iπ/2(N+1)) + 4sin²(jπ/2(N+1)), models/poisson.py:57)."""
    grid = jnp.arange(1, nsize + 1, dtype=dtype)
    idx = []
    for i in range(1, nsize + 1):
        for j in range(1, nsize + 1):
            lam = (jnp.sin(i * jnp.pi / (2 * (nsize + 1))) ** 2
                   + jnp.sin(j * jnp.pi / (2 * (nsize + 1))) ** 2)
            idx.append((float(lam), i, j))
    idx.sort()
    modes = []
    for _, i, j in idx[:k]:
        sx = jnp.sin(i * jnp.pi * grid / (nsize + 1))
        sy = jnp.sin(j * jnp.pi * grid / (nsize + 1))
        v = jnp.outer(sx, sy)
        modes.append(v / jnp.sqrt(jnp.sum(v * v)))
    return jnp.stack(modes).astype(dtype)
