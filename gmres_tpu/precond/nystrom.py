"""Randomized Nyström preconditioner (Frangella, Tropp, Udell —
SIMAX 44(2), 2023).

The modern sketch-based SPD preconditioner: a randomized rank-r
Nyström approximation Â = U diag(λ̂) Uᵀ of A is built from ONE batched
sketch A·Ω (r matvecs — a single vmapped dispatch), and the
preconditioner

    P⁻¹ = (λ̂_r + μ)·U (diag(λ̂) + μ)⁻¹ Uᵀ + (I − U Uᵀ)

caps the effective condition number at roughly (λ̂_r + μ)/μ ·
(1 + ‖A − Â‖/μ): the r sketched directions are rescaled to the
regularized shift μ and everything orthogonal to them is left alone.
Unlike the deflation coarse space (precond/deflation.py) it needs NO
known modes and no mesh hierarchy — the sketch finds the top of the
spectrum by itself — making it the general-purpose option for SPD
operators with fast spectral decay where nothing better is known
(kernel/Gram matrices, regularized normal equations).

Device shape: construction is r batched matvecs + one tall QR-free
stabilized eigendecomposition (shift-regularized Cholesky of ΩᵀAΩ,
(n, r)·(r, r) matmuls, one replicated (r, r) eigh — the
small-replicated/large-sharded split of DESIGN.md §2); application is
TWO tall (r, n) contractions (one fused all-reduce) and elementwise
work. Both shard like every block op in the library.

When it does NOT pay, measured honestly: mesh Laplacians have slowly
DECAYING spectra top-down (the sketch captures the largest
eigenvalues, but CG's trouble is the smallest) — for those use
multigrid or deflation. And CG itself SUPERCONVERGES on decaying
spectra, so wins are smaller than condition-number arithmetic
suggests: measured 104 → 40 iterations (2.6×) on a 1/i² spectrum at
κ = 1e4, 591 → 88 (6.7×) on 1/i³ at κ = 1e8
(tests/test_nystrom.py pins the latter).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.types import LinearOperator, Preconditioner


def nystrom_preconditioner(
    A: LinearOperator,
    x_like: jnp.ndarray,
    rank: int = 20,
    mu: float = 0.0,
    power_iters: int = 1,
    key=None,
):
    """Build the rank-``rank`` randomized Nyström preconditioner.

    Args:
      A: SPD operator callable.
      x_like: array of A's operand shape/dtype (sizes the sketch).
      rank: sketch size r (the preconditioner stores r long vectors —
        same memory as a restart-r Krylov basis).
      mu: regularization shift. 0 (default) = pure head deflation —
        the right choice for UNREGULARIZED solves of A itself (head
        modes map to ≈ λ̂_r, the top of the untouched complement;
        measured: the paper's μ = λ̂_r choice re-inflates the head to
        ~2λ̂_r and cost 20% extra iterations here). Pass the ridge
        parameter when solving a regularized system A + μI (the
        paper's setting, where μ ≈ λ_min makes its choice optimal).
      power_iters: subspace-iteration passes refining the sketch
        range (each costs ``rank`` extra matvecs). 0 = the plain
        single-pass sketch — measured to underestimate the head by
        ~20% on a 1/i² spectrum and halve the PCG win; 1 (default)
        recovers the head to a few percent.
      key: PRNG key for the Gaussian sketch (deterministic default).

    Returns:
      (preconditioner, eigenvalues): the SPD callable P⁻¹ and the
      (rank,) Nyström eigenvalue estimates λ̂ (largest first) — useful
      as a free spectral diagnostic.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    shape = x_like.shape
    dtype = x_like.dtype
    eps = jnp.finfo(dtype).eps
    omega = jax.random.normal(key, (rank,) + shape, dtype)
    # Orthonormalize the sketch block (SVQB², shared machinery) —
    # stabilizes the Nyström core inversion.
    from gmres_tpu.solvers.block_gmres import _orthonormalize_block

    omega, _ = _orthonormalize_block(omega, float(eps))
    # Subspace iteration: align the sketch with the dominant
    # eigenspace before the Nyström core (Halko-Martinsson-Tropp §4.5).
    for _ in range(power_iters):
        omega, _ = _orthonormalize_block(
            jax.vmap(A)(omega), float(eps)
        )
    y = jax.vmap(A)(omega)                      # the r matvecs
    baxes = tuple(range(1, omega.ndim))
    # Shifted core for numerical stability (FTU Alg. 2.1): nu absorbs
    # roundoff in A·Ω so the Cholesky stays positive.
    ynorm = jnp.sqrt(jnp.sum(y * y))
    nu = jnp.sqrt(jnp.asarray(rank, dtype)) * eps * ynorm
    y_nu = y + nu * omega
    core = jnp.tensordot(omega, y_nu, axes=(baxes, baxes))  # (r, r)
    core = 0.5 * (core + core.T)
    c = jnp.linalg.cholesky(core)
    # B = Y C^{-T}: solve C Bᵀ = Yᵀ row-block-wise.
    yflat = y_nu.reshape(rank, -1)
    bflat = jax.scipy.linalg.solve_triangular(c, yflat, lower=True)
    # Thin SVD of Bᵀ via the (r, r) Gram: Bᵀ = U Σ Vᵀ with
    # U = Bᵀ V Σ⁻¹; eigenvalues λ̂ = Σ² − ν.
    g = bflat @ bflat.T
    sig2, v = jnp.linalg.eigh(0.5 * (g + g.T))      # ascending
    sig2 = jnp.maximum(sig2[::-1], 0.0)             # descending
    v = v[:, ::-1]
    lam_hat = jnp.maximum(sig2 - nu, 0.0)           # (r,) descending
    sig_inv = jnp.where(sig2 > 0, 1.0 / jnp.sqrt(jnp.where(
        sig2 > 0, sig2, 1.0)), 0.0)
    u = jnp.tensordot(
        (v * sig_inv[None, :]).T, bflat.reshape((rank,) + shape),
        axes=(1, 0),
    )                                               # (r, *shape)

    # Floor keeps P SPD even at mu=0 with a rank-deficient sketch
    # (lam_hat[-1] = 0): the head is then scaled by ~eps rather than
    # divided by zero.
    mu_v = jnp.maximum(
        jnp.asarray(mu, dtype), eps * jnp.maximum(lam_hat[0], 1.0)
    )
    scale = lam_hat[-1] + mu_v

    def apply(rvec: jnp.ndarray) -> jnp.ndarray:
        cu = jnp.tensordot(u, rvec, axes=(baxes, tuple(
            range(rvec.ndim))))                     # (r,)
        inside = scale / (lam_hat + mu_v) * cu
        return (rvec
                + jnp.tensordot(inside - cu, u, axes=(0, 0)))

    return apply, lam_hat
