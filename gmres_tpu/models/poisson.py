"""2-D Poisson model problem: 5-point Laplacian with homogeneous
Dirichlet boundaries (by truncation).

Reference: ``src/problems/poisson.f90`` — dense assembly
(``generate_matrix``, poisson.f90:13-30, coefficients diag=4 ndiag=-1 at
poisson.f90:9-10) and the hand-optimized matrix-free stencil ``stvec``
(poisson.f90:33-77) that splits interior / edges / corners into separate
OpenMP loops. In JAX the whole stencil is one fused elementwise
expression over the (N, N) grid — XLA performs the interior/boundary
specialization, and under a sharded-input ``jit`` the row shifts become
collective-permutes (the halo exchange). An explicit ``shard_map`` +
halo-exchange version lives in ``gmres_tpu.parallel.halo``.

Index-ordering note: the reference flattens the grid column-major
(idx = i + (j-1)·N). We operate on (N, N) arrays directly (C-order when
flattened); this is a symmetric permutation of the reference matrix, so
spectra, residual norms and Krylov convergence are identical.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from gmres_tpu.ops.stencil import stencil_5pt_apply


def poisson_apply(x: jnp.ndarray) -> jnp.ndarray:
    """y = A·x for the 5-point Laplacian; x is (N, N) or flat (N²,).

    Matches ``stvec`` (poisson.f90:33-77): y = 4·x − (W + E + N + S)
    with zero (Dirichlet) neighbors outside the grid.
    """
    if x.ndim == 1:
        n = int(round(x.shape[0] ** 0.5))
        return stencil_5pt_apply(x.reshape(n, n)).reshape(-1)
    return stencil_5pt_apply(x)


def poisson_operator(nsize: int, flat: bool = False) -> Callable:
    """Return the matrix-free operator closure for an nsize×nsize grid.

    Unlike the reference — which infers nsize from sqrt(len(x)) inside
    every solver (gmres_hh.f90:231 etc., SURVEY §1) — the grid shape
    lives in this closure; solvers never see it.
    """
    if flat:
        def apply_flat(x: jnp.ndarray) -> jnp.ndarray:
            return stencil_5pt_apply(x.reshape(nsize, nsize)).reshape(-1)
        return apply_flat
    return stencil_5pt_apply


def poisson_spectral_bounds(nsize: int) -> tuple:
    """Exact extreme eigenvalues of the N²×N² 5-point Laplacian:
    λ = 4 sin²(iπ/2(N+1)) + 4 sin²(jπ/2(N+1)), i,j ∈ 1..N."""
    import math

    s_min = math.sin(math.pi / (2 * (nsize + 1)))
    s_max = math.sin(nsize * math.pi / (2 * (nsize + 1)))
    return 8.0 * s_min * s_min, 8.0 * s_max * s_max


def tuned_poisson_preconditioner(
    nsize: int, aggressiveness: float = 30.0, use_pallas: str = "auto"
):
    """Deep Chebyshev preconditioner auto-sized for an nsize×nsize
    Poisson grid — the tuned-headline recipe made grid-independent.

    Rule: target the Chebyshev interval at lo ≈ aggressiveness·λ_min
    (leaving only a handful of low modes for the Krylov iteration) with
    order ≈ 1.6·√(λ_max/lo), which drives the iteration count to a few
    dozen regardless of N. ``use_pallas`` as in
    ``chebyshev_stencil_preconditioner``. Returns (M, order, lo, hi).
    """
    import math

    from gmres_tpu.precond.chebyshev import (
        chebyshev_stencil_preconditioner,
    )

    lam_min, lam_max = poisson_spectral_bounds(nsize)
    lo = min(aggressiveness * lam_min, lam_max / 16.0)
    order = max(2, int(math.ceil(1.6 * math.sqrt(lam_max / lo))))
    m = chebyshev_stencil_preconditioner(
        lo, lam_max, order=order, use_pallas=use_pallas
    )
    return m, order, lo, lam_max


def poisson_matrix(nsize: int, dtype=jnp.float64) -> jnp.ndarray:
    """Dense N²×N² 5-point Laplacian (generate_matrix, poisson.f90:13-30).

    Built as A = I⊗K + K⊗I with K = tridiag(−1, 2, −1), which is the
    same matrix as the reference's up to the symmetric row/column
    permutation induced by C-order vs Fortran-order flattening.
    """
    k = (
        2.0 * jnp.eye(nsize, dtype=dtype)
        - jnp.eye(nsize, k=1, dtype=dtype)
        - jnp.eye(nsize, k=-1, dtype=dtype)
    )
    eye = jnp.eye(nsize, dtype=dtype)
    return jnp.kron(eye, k) + jnp.kron(k, eye)
