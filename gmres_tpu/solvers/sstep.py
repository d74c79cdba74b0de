"""Communication-avoiding (s-step) GMRES.

Standard GMRES pays 1-2 all-reduces per Arnoldi step (SURVEY §3.1-3.2:
every projection is a dot); on a multi-chip mesh the solve is
latency-bound by those collectives. The s-step reformulation does a whole cycle
with TWO reduction points:

  1. generate the monomial Krylov block Z = [z₀, Bz₀, …, B^s z₀] with
     B = M∘A — s operator applications, ZERO communication;
  2. solve min_y ‖w − Z₁ y‖ (Z₁ = columns 1..s) via its Gram system
     G y = c, G = Z₁Z₁ᵀ, c = Z₁w — ONE stacked all-reduce for (G, c,
     ‖w‖²), then a replicated (s, s) Cholesky;
  3. x ← x + Z₀ y (local), recompute the true residual (the second
     reduction), restart.

In exact arithmetic each cycle produces the SAME iterate as s steps of
GMRES(s) (both minimize the residual over the Krylov subspace — the
Arnoldi QR is just a stable basis for the identical least-squares
problem). In floating point the Gram approach squares the basis
condition number, κ(G) = κ(Z)², so it needs EITHER small s or a
preconditioner that clusters the spectrum. The intended pairing is the
deep Chebyshev preconditioner (precond/chebyshev.py, order ≥ 16): it
maps the spectrum near 1, the monomial basis stays well-conditioned,
and s = 8-16 converges iteration-for-iteration with Householder GMRES
while issuing ~s× fewer collectives. A Tikhonov ridge (rel_ridge·‖G‖)
keeps the Cholesky robust when the basis degenerates; convergence is
certified ONLY by the recomputed true residual at cycle boundaries
(the same certification mixed-precision GMRES-IR uses), so a sloppy
cycle can slow convergence but never produce a false CONVERGED.

This is the build's answer to SURVEY §3.1's "core performance problem
of the Householder variant" — not a port of anything in the reference,
which has no communication-avoiding machinery at all.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, tree_vdot
from gmres_tpu.types import (
    GmresResult,
    LinearOperator,
    Preconditioner,
    SolverStatus,
)


def sstep_gmres(
    A: LinearOperator,
    b: jnp.ndarray,
    *,
    s: int = 8,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    x0: Optional[jnp.ndarray] = None,
    inner_dtype=None,
    rel_ridge: float = 0.0,
) -> GmresResult:
    """Solve A x = b by restarted s-step GMRES (see module docstring).

    Args:
      s: Krylov block size per cycle (the restart length). Keep ≤ ~16
        unless the preconditioned spectrum is tightly clustered.
      tol: relative tolerance on the TRUE preconditioned residual
        ‖M(b − Ax)‖/‖M b‖... precisely: measured against β₀ = ‖b‖ with
        x₀ = 0, matching gmres()'s criterion so results compare 1:1.
      M: left preconditioner; strongly recommended (see docstring).
      inner_dtype: dtype for the Krylov block generation (float32 for
        the fast path); the Gram solve, x updates and residual
        certification always run in b's dtype.
      rel_ridge: Tikhonov ridge relative to the equilibrated Gram's
        unit diagonal. 0 (default) selects 100·eps(work dtype) — the
        Gram carries O(s·eps) noise from the block products, so the
        ridge must sit above the WORK precision's floor (measured: an
        f32 block needs ~1e-5; 1e-7 still fails the Cholesky). Any
        positive value is used verbatim, above or below that floor.
    """
    op = A if callable(A) else (lambda v, m=jnp.asarray(A): m @ v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    dtype = b.dtype
    shape = b.shape
    work_dtype = jnp.dtype(inner_dtype) if inner_dtype is not None \
        else dtype
    tiny = jnp.finfo(dtype).tiny

    beta0 = jnp.sqrt(tree_vdot(b, b))

    def precond_residual(x):
        r = b - op(x)
        w = M(r) if M is not None else r
        return w, jnp.sqrt(tree_vdot(w, w))

    def apply_b(v):
        z = op(v)
        return M(z) if M is not None else z

    def cycle(x, w, beta):
        # Krylov block: Z[i] = B^i (w/β), generated in work dtype with
        # NO reductions (the β normalization reuses the outer norm).
        z0 = (w / jnp.where(beta > 0, beta, 1.0)).astype(work_dtype)

        def gen(carry, _):
            z = apply_b(carry).astype(work_dtype)
            return z, z

        _, z_rest = jax.lax.scan(gen, z0, None, length=s)
        z_full = jnp.concatenate([z0[None], z_rest], axis=0)  # (s+1, …)
        zf = z_full.reshape(s + 1, -1)

        # ONE all-reduce: the (s+1, s+1) Gram of the whole block gives
        # G = Z₁Z₁ᵀ, c = Z₁z₀ (recall w = β z₀) in its sub-blocks.
        gram = (zf @ zf.T).astype(dtype)
        g_mat = gram[1:, 1:]
        c_vec = gram[1:, 0]
        # Diagonal equilibration from the (already-reduced) Gram
        # diagonal: solving (DGD)(D⁻¹y) = Dc is free and removes the
        # monomial growth ‖B^i z₀‖ ≈ ρ(B)^i from the conditioning —
        # exactly what per-vector normalization would buy, without its
        # s extra all-reduces.
        d = 1.0 / jnp.sqrt(
            jnp.maximum(jnp.diagonal(g_mat), jnp.finfo(dtype).tiny)
        )
        g_scaled = g_mat * d[:, None] * d[None, :]
        ridge = (rel_ridge if rel_ridge > 0.0
                 else 100.0 * float(jnp.finfo(work_dtype).eps))
        g_scaled = g_scaled + ridge * jnp.eye(s, dtype=dtype)
        chol, low = jax.scipy.linalg.cho_factor(g_scaled, lower=True)
        y = d * jax.scipy.linalg.cho_solve((chol, low), d * c_vec)
        # guard a failed factorization (NaN y): skip the update.
        y_ok = jnp.all(jnp.isfinite(y))
        y = jnp.where(y_ok, y, jnp.zeros_like(y))

        # x ← x + β · Z₀ y (local matvec over the block).
        dx = row_combine(y.astype(work_dtype), z_full[:s]).reshape(
            shape
        )
        x = x + (beta * dx.astype(dtype))
        # cycle residual estimate (exact in exact arithmetic):
        # ‖w − βZ₁y‖² = β²(1 − 2yᵀc + yᵀGy) — no extra reduction.
        est_sq = 1.0 - 2.0 * (y @ c_vec) + y @ (gram[1:, 1:] @ y)
        est = beta * jnp.sqrt(jnp.maximum(est_sq, 0.0))
        return x, est, y_ok

    w_init, beta_init = precond_residual(x0)
    # Same norm as the loop criterion (and as gmres._restarted):
    # preconditioned residual over β₀.
    rel0 = beta_init / jnp.maximum(beta0, tiny)
    converged0 = (beta0 == 0) | (rel0 < tol)

    def cond(carry):
        _, k, _, _, converged, stalled, _, _ = carry
        return (k < max_restarts) & (~converged) & (~stalled)

    def body(carry):
        x, k, w, beta, _, _, _, hist = carry
        x_new, est, y_ok = cycle(x, w, beta)
        w_new, beta_new = precond_residual(x_new)
        rel = beta_new / jnp.maximum(beta0, tiny)
        converged = rel < tol
        # Per-cycle certified residual — a genuine history, not a fill
        # (the certification reduction already happened; recording it
        # is free).
        hist = hist.at[k].set(rel)
        # Stagnation/breakdown: no progress and failed factorization,
        # or non-finite residual.
        stalled = (~y_ok) | (~jnp.isfinite(beta_new)) | (
            (beta_new >= beta) & (k > 0) & (est >= beta)
        )
        stalled = stalled & (~converged)
        return (x_new, k + 1, w_new, beta_new, converged, stalled, rel,
                hist)

    hist0 = jnp.zeros((max_restarts,), dtype=dtype)
    carry0 = (x0, jnp.int32(0), w_init, beta_init, converged0,
              jnp.array(False), rel0, hist0)
    x, k, _, _, converged, stalled, rel, hist = jax.lax.while_loop(
        cond, body, carry0
    )
    # Pad past the final cycle with the final residual (cg/bicgstab's
    # documented residual_history contract).
    hist = jnp.where(jnp.arange(max_restarts) < k, hist, rel)
    status = jnp.where(
        converged,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            stalled,
            jnp.int32(SolverStatus.BREAKDOWN),
            jnp.int32(SolverStatus.MAX_ITERATIONS),
        ),
    )
    return GmresResult(
        x=x,
        # Inner iterations of the final cycle. Unlike adaptive GMRES, an
        # s-step cycle ALWAYS performs exactly s operator applications
        # (that is the algorithm: the block is generated before any
        # reduction can test convergence), so this is the true count —
        # total inner iterations = restarts·s, consistent with gmres()'s
        # (restarts−1)·m + iterations accounting. 0 when converged at x0
        # without running any cycle.
        iterations=jnp.where(k > 0, jnp.int32(s), jnp.int32(0)),
        restarts=k,
        residual=rel,
        status=status,
        # (max_restarts,) per-CYCLE certified relative residual (each
        # entry covers s inner iterations), padded past convergence with
        # the final value. Cycle granularity is the only one the
        # algorithm observes — there is no per-inner-iteration residual
        # without adding the very reductions s-step exists to avoid.
        residual_history=hist,
        v_err=jnp.zeros((s + 1,), dtype=dtype),
    )
