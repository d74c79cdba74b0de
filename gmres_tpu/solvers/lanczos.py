"""Lanczos spectral-bound estimation.

The reference README claims "spectral radius estimation via Lanczos
iteration" (README.md:11) but no such code exists in the repo — every
driver hardcodes Chebyshev params (8.2, 0.2) (test_poisson_mf.f90:38,
SURVEY §2 C10). BASELINE.json makes it a build requirement, so here it
is for real: k-step Lanczos tridiagonalization with the extreme Ritz
values as bounds, plus a cheap power-iteration λ_max estimate.

Device shape: the k-step loop is a ``lax.fori_loop`` of operator
applications + 2 all-reduces per step over sharded vectors; the (k, k)
tridiagonal eigenproblem is replicated host-side math via
``jnp.linalg.eigh`` on a tiny matrix.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, row_contract, tree_vdot
from gmres_tpu.types import LinearOperator


def lanczos_bounds(
    A: LinearOperator,
    probe: jnp.ndarray,
    steps: int = 20,
    rigorous: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Estimate (λ_min, λ_max) of symmetric A by k-step Lanczos.

    probe: any nonzero start vector (deterministic — no RNG inside, so
    results are reproducible and jit-friendly).

    The extreme Ritz values are widened by the per-pair residual bound
    β_k·|last eigenvector component| — the rigorous Ritz-pair error
    bound (widening by the full β_k, a common shortcut, collapses the
    lower bound to 0 whenever β_k ≳ λ_min, which is always the case
    for discrete Laplacians).

    rigorous=False replaces the widened lower bound with the raw
    smallest Ritz value — an ESTIMATE (may exceed the true λ_min), the
    right quantity for sizing preconditioner intervals.

    Breakdown (β = 0: invariant subspace exhausted) freezes the
    recurrence and pads the remaining tridiagonal diagonal with the
    first Rayleigh quotient — a value guaranteed inside the spectral
    interval, so padding never widens the extremes (a zero-padded
    diagonal would inject spurious 0 eigenvalues).
    """
    dtype = probe.dtype
    eps = jnp.finfo(dtype).eps
    v = probe / jnp.sqrt(tree_vdot(probe, probe))
    v_prev = jnp.zeros_like(v)

    alphas = jnp.zeros((steps,), dtype=dtype)
    betas = jnp.zeros((steps,), dtype=dtype)  # betas[i] couples i→i+1

    def body(i, carry):
        v, v_prev, beta_prev, alphas, betas, dead, scale = carry
        w = A(v) - beta_prev * v_prev
        alpha = tree_vdot(w, v)
        w = w - alpha * v
        beta = jnp.sqrt(tree_vdot(w, w))
        scale = jnp.maximum(scale, jnp.abs(alpha) + beta)
        broke = beta <= 16.0 * eps * scale
        alpha_eff = jnp.where(dead, alphas[0], alpha)
        beta_eff = jnp.where(dead | broke, 0.0, beta)
        v_next = jnp.where(
            dead | broke,
            jnp.zeros_like(v),
            w / jnp.where(beta > 0, beta, 1.0),
        )
        alphas = alphas.at[i].set(alpha_eff)
        betas = betas.at[i].set(beta_eff)
        return (v_next, v, beta_eff, alphas, betas, dead | broke, scale)

    _, _, beta_last, alphas, betas, _, _ = jax.lax.fori_loop(
        0, steps, body,
        (v, v_prev, jnp.zeros((), dtype), alphas, betas,
         jnp.array(False), jnp.zeros((), dtype)),
    )

    tri = (
        jnp.diag(alphas)
        + jnp.diag(betas[:-1], k=1)
        + jnp.diag(betas[:-1], k=-1)
    )
    ritz, vecs = jnp.linalg.eigh(tri)
    resid = beta_last * jnp.abs(vecs[-1, :])
    if rigorous:
        lo = jnp.maximum(ritz[0] - resid[0], 0.0)
    else:
        # Estimate mode: the raw smallest Ritz value. Lanczos converges
        # to λ_min slowly, so the rigorous lower bound is often 0 ("not
        # provable from k steps") while the Ritz value itself is the
        # useful target for preconditioner intervals.
        lo = ritz[0]
    hi = ritz[-1] + resid[-1]
    return lo, hi


def power_iteration_bound(
    A: LinearOperator,
    probe: jnp.ndarray,
    steps: int = 50,
) -> jnp.ndarray:
    """Spectral-radius estimate by power iteration: |Rayleigh quotient|
    of the converged iterate (abs: a dominant NEGATIVE eigenvalue must
    still yield a positive radius)."""
    v = probe / jnp.sqrt(tree_vdot(probe, probe))

    def body(_, v):
        w = A(v)
        return w / jnp.sqrt(tree_vdot(w, w))

    v = jax.lax.fori_loop(0, steps, body, v)
    return jnp.abs(tree_vdot(v, A(v)) / tree_vdot(v, v))


def arnoldi_expand(
    A: LinearOperator,
    basis: jnp.ndarray,
    hmat: jnp.ndarray,
    start: int,
):
    """Continue an Arnoldi(-like) factorization from column `start`:
    rows [0, start] of `basis` must already be orthonormal and columns
    [0, start) of `hmat` filled; columns [start, steps) are computed by
    CGS2 over the FULL masked buffer (one fused all-reduce per pass
    under sharding). With start=0 this is plain Arnoldi; a Krylov-Schur
    restart (solvers/arnoldi.py) passes the truncated Schur basis plus
    its residual direction at row `start` — the spike row the
    truncation leaves in `hmat` is untouched, only new columns are
    written."""
    steps = hmat.shape[1]
    dtype = basis.dtype

    def body(j, carry):
        basis, hmat = carry
        v_j = jax.lax.dynamic_index_in_dim(basis, j, 0, keepdims=False)
        w = A(v_j)
        mask = (jnp.arange(steps + 1) <= j).astype(dtype)

        def cgs_pass(w):
            # conj for complex bases (identity for real): h = ⟨vᵢ, w⟩
            # (row_contract/row_combine, ops/blas.py)
            h = row_contract(basis, w, conj=True) * mask
            return h, w - row_combine(h, basis)

        h1, w = cgs_pass(w)
        h2, w = cgs_pass(w)
        beta = jnp.sqrt(tree_vdot(w, w))
        hcol = (h1 + h2).at[j + 1].add(beta)
        basis = basis.at[j + 1].set(
            w / jnp.where(beta > 0, beta, 1.0)
        )
        hmat = jax.lax.dynamic_update_slice(
            hmat, hcol[:, None], (0, j)
        )
        return basis, hmat

    return jax.lax.fori_loop(start, steps, body, (basis, hmat))


def arnoldi_factorization(
    A: LinearOperator,
    probe: jnp.ndarray,
    steps: int = 20,
):
    """k-step Arnoldi factorization A·V_k = V_{k+1}·H̄: returns
    (basis, hmat) with basis (steps+1, *shape) orthonormal and hmat the
    (steps+1, steps) Hessenberg. Shared core of
    :func:`arnoldi_hessenberg` (spectral estimation) and
    :func:`gmres_tpu.solvers.arnoldi.arnoldi_eigs` (Ritz eigenpairs,
    which needs the basis to reconstruct eigenvectors)."""
    dtype = probe.dtype
    nrm = jnp.sqrt(tree_vdot(probe, probe))
    v0 = probe / jnp.where(nrm > 0, nrm, 1.0)
    basis = jnp.zeros((steps + 1,) + probe.shape, dtype=dtype)
    basis = basis.at[0].set(v0)
    hmat = jnp.zeros((steps + 1, steps), dtype=dtype)
    return arnoldi_expand(A, basis, hmat, 0)


def arnoldi_hessenberg(
    A: LinearOperator,
    probe: jnp.ndarray,
    steps: int = 20,
) -> jnp.ndarray:
    """k-step Arnoldi Hessenberg A·V_k ≈ V_{k+1}·H — the NONSYMMETRIC
    extension of :func:`lanczos_bounds`, estimating the spectrum/field
    of values of operators like convection-diffusion where Lanczos'
    three-term recurrence does not apply.

    CGS2 orthogonalization over a fixed (steps+1, …) basis buffer with
    masked contractions (one pass = ONE all-reduce under sharding, same
    design as the cgs2 GMRES variant, solvers/gmres.py) inside a
    ``lax.fori_loop`` — jit-friendly, deterministic. Returns the full
    (steps+1, steps) Hessenberg; breakdown (invariant subspace) leaves
    a zero subdiagonal, which the eigensolver handles naturally.
    """
    _, hmat = arnoldi_factorization(A, probe, steps)
    return hmat


def arnoldi_ritz_values(
    A: LinearOperator,
    probe: jnp.ndarray,
    steps: int = 20,
):
    """Complex Ritz values (numpy array, host-side) of A from k-step
    Arnoldi. The (k, k) nonsymmetric eigenproblem is solved on host
    (numpy) — a tiny setup-time cost."""
    import numpy as np

    h = np.asarray(arnoldi_hessenberg(A, probe, steps))[:steps, :steps]
    return np.linalg.eigvals(h)


def estimate_jacobi_omega(
    A: LinearOperator,
    probe: jnp.ndarray,
    diag: float,
    steps: int = 12,
    band: float = 4.0,
):
    """Auto-size the damped-Jacobi damping ω for a smoother on A with
    constant diagonal ``diag`` from the Arnoldi-estimated spectrum —
    replacing the hand-tuned ω (the reference has no estimation code at
    all despite README.md:11's claim; this extends the build's C10
    answer beyond SPD).

    Smoothing analysis: the smoother must contract the HIGH-frequency
    error modes (the coarse grid owns the rest), so ω minimizes
    max |1 − (ω/diag)·λ| over the Ritz values with
    Re λ ≥ max Re λ / band — the complex-spectrum analogue of the
    Poisson cycle's Chebyshev band [λmax/band, λmax]. Host-side grid
    search (the objective is piecewise-smooth in ω; a 1-D grid at
    setup time is simpler than the formal two-disc optimum and within
    1% of it on the tested operators).

    Returns (omega, ritz) — ritz exposed for diagnostics/tests.
    """
    import numpy as np

    ritz = arnoldi_ritz_values(A, probe, steps)
    re_max = float(np.max(ritz.real))
    upper = ritz[ritz.real >= re_max / band]
    if upper.size == 0:  # degenerate probe; fall back to the default
        return 0.7, ritz
    grid = np.linspace(0.05, 1.5, 146)
    rho = np.abs(
        1.0 - np.outer(grid, upper / diag)
    ).max(axis=1)
    return float(grid[int(np.argmin(rho))]), ritz


def chebyshev_ellipse_interval(
    ritz,
    band: float | None = 4.0,
    im_safety: float = 1.1,
    re_safety: float = 1.02,
):
    """Manteuffel's ellipse-corrected Chebyshev interval for a COMPLEX
    spectrum (TOMS 1977): enclose the target Ritz values in an ellipse
    with center d on the real axis, semi-axes (a, b); when it is wider
    than tall (a > b) the foci d ± c, c = √(a² − b²), are REAL and the
    standard real-interval Chebyshev recurrence on (d − c, d + c) is
    the asymptotically optimal polynomial for the whole ellipse — the
    existing scan/Pallas kernels work unchanged on a foci-shrunk
    interval. Returns None when the spectrum region is taller than
    wide (b ≥ a: no real-foci member; caller falls back to damped
    Jacobi) or the interval would touch zero.

    band: target the high-frequency smoothing band
    [re_max/band, re_max] (the multigrid smoother case); None targets
    the FULL spectrum (the coarse-solve case).

    Measured on the upwind convection-diffusion levels (32² dense
    assembly, order-3 smoothing): ρ(I − SA) 0.25 / 0.09 / 0.03 at
    γ = (3.2, 1.6) / (6.4, 3.2) / (12.8, 6.4) vs damped Jacobi's
    0.50 / 0.38 / 0.30 — the upwind diagonal keeps b/a ≤ 0.7 at every
    Péclet number, so the ellipse route stays available exactly where
    the hierarchy lives (tests/test_multigrid.py pins the comparison).
    """
    import numpy as np

    ritz = np.asarray(ritz)
    re_max = float(ritz.real.max()) * re_safety
    if band is None:
        lo = max(float(ritz.real.min()), 0.0) * 0.8
    else:
        lo = re_max / band
    sub = ritz[ritz.real >= lo / re_safety]
    if sub.size == 0 or re_max <= lo:
        return None
    b = float(np.abs(sub.imag).max()) * im_safety
    a = (re_max - lo) / 2.0
    d = (re_max + lo) / 2.0
    if b >= 0.95 * a:
        return None
    c = (a * a - b * b) ** 0.5
    if d - c <= 0.0:
        return None
    return d - c, d + c
