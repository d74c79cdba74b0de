"""TFQMR (Freund 1993): transpose-free quasi-minimal residual.

Beyond the reference (its nonsymmetric set is BiCGSTAB only,
src/bicgstab.f90): TFQMR smooths the CGS iteration with a
quasi-minimization — per full iteration the SAME budget as BiCGSTAB
(2 operator + 2 preconditioner applications) buys a residual bound
τ_j·√(j+1) that decreases monotonically, where BiCGSTAB's ‖r‖ swings
by orders of magnitude on stiff spectra (those spikes are what feeds
its attainable-accuracy drift — solvers/bicgstab.py docstring).

Device shape (house rules): one ``lax.while_loop``, both half-steps of
Freund's iteration unrolled in the body (fixed two matvecs per trip),
all scalars replicated, two reduction points per half-step with the
even half's ‖w‖ and ρ fused into one all-reduce (batched_vdot).
Preconditioning is right-applied like the reference's BiCGSTAB style:
the recurrence runs on A∘M while M(u) is threaded into the solution
recurrence d — so d lives in x-space and NO extra M applications are
needed beyond the two the matvecs require.

Convergence on the QUASI-residual bound τ·√(j+1) < tol (absolute,
cg.f90:37 semantics — the bound majorizes ‖r‖, so this test is
conservative); exit certification recomputes b − Ax and downgrades a
lying CONVERGED to BREAKDOWN (PARITY.md quirk 8), same as every
short-recurrence solver here.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import (
    batched_vdot,
    tree_axpy,
    tree_norm,
    tree_sub,
    tree_vdot,
    tree_zeros_like,
)
from gmres_tpu.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def tfqmr(
    A: LinearOperator,
    b: Any,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[Any] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by (right-preconditioned) TFQMR.

    `iterations` counts FULL iterations (two half-steps, two matvecs
    each — the same accounting as bicgstab). The residual history
    records the quasi-residual bound after each full iteration; the
    returned `residual` is the certified true ‖b − Ax‖₂.
    """
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))
    r0 = r  # shadow vector r̃₀ = r₀ (the reference's BiCGSTAB choice)

    dtype = jnp.result_type(*jax.tree.leaves(b))
    rdtype = jnp.finfo(dtype).dtype  # real counterpart (norms, bounds)
    history = jnp.zeros((max_iterations,), dtype=rdtype)
    tiny = jnp.finfo(dtype).tiny

    def m_apply(v):
        return M(v) if M is not None else v

    mu1_0 = m_apply(r)
    v0 = A(mu1_0)
    tau0 = tree_norm(r)
    rho0 = tree_vdot(r0, r)
    zeros = tree_zeros_like(b)

    status0 = jnp.where(
        tau0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    def cond(carry):
        (i, *_), status, _ = carry
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def half_update(wnorm, tau, theta, eta, alpha, d_m, mu, x):
        """Shared quasi-minimization bookkeeping of one half-step:
        given ‖w‖ of the just-updated w and the x-space direction mu,
        rotate (τ, θ, η), extend d, update x."""
        theta_n = wnorm / jnp.maximum(tau, tiny)
        c = 1.0 / jnp.sqrt(1.0 + theta_n * theta_n)
        tau_n = tau * theta_n * c
        eta_n = c * c * alpha
        gamma = (theta * theta * eta) / jnp.where(
            jnp.abs(alpha) > 0, alpha, jnp.ones_like(alpha)
        )
        d_n = tree_axpy(gamma, d_m, mu)
        x_n = tree_axpy(eta_n, d_n, x)
        return x_n, d_n, tau_n, theta_n, eta_n

    def body(carry):
        (i, x, w, u1, mu1, au1, v, d_m, tau, theta, eta, rho), status, \
            hist = carry
        # ODD half-step: matvec-free — A·u_odd (au1) and the search
        # direction v were both computed at the tail of the previous
        # even half (Freund's v-recurrence; au1 ≠ v except at startup).
        sigma = tree_vdot(r0, v)
        alpha = rho / jnp.where(jnp.abs(sigma) > 0, sigma,
                                jnp.ones_like(sigma))
        u2 = tree_axpy(-alpha, v, u1)
        w = tree_axpy(-alpha, au1, w)
        wnorm = tree_norm(w)
        x, d_m, tau, theta, eta = half_update(
            wnorm, tau, theta, eta, alpha, d_m, mu1, x
        )

        # EVEN half-step: one matvec on M(u_even); ‖w‖ and the CGS
        # coupling ρ = (r̃₀, w) ride ONE fused all-reduce.
        mu2 = m_apply(u2)
        au2 = A(mu2)
        w = tree_axpy(-alpha, au2, w)
        wsq, rho_n = batched_vdot([(w, w), (r0, w)])
        x, d_m, tau, theta, eta = half_update(
            jnp.sqrt(jnp.real(wsq)), tau, theta, eta, alpha, d_m, mu2, x
        )
        beta = rho_n / jnp.where(jnp.abs(rho) > 0, rho,
                                 jnp.ones_like(rho))
        u1_n = tree_axpy(beta, u2, w)
        mu1_n = m_apply(u1_n)
        au1_n = A(mu1_n)  # second matvec; also next odd half's v
        v_n = tree_axpy(beta, tree_axpy(beta, v, au2), au1_n)

        # Quasi-residual bound after j = 2(i+1) half-steps:
        # ‖r_j‖ ≤ τ_j √(j+1).
        j = 2.0 * (i.astype(rdtype) + 1.0)
        bound = tau * jnp.sqrt(j + 1.0)
        hist = hist.at[i].set(bound)
        status = jnp.where(
            bound < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        # ρ ≈ 0 (serious breakdown of the underlying CGS) or NaN: stop
        # honestly instead of iterating on garbage.
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & (~jnp.isfinite(bound) | (jnp.abs(rho_n) < tiny)),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return ((i + 1, x, w, u1_n, mu1_n, au1_n, v_n, d_m, tau, theta,
                 eta, rho_n), status, hist)

    # At startup u₀ = r₀ and v₀ = A·u₀, so au1 and v coincide.
    carry0 = (
        (jnp.int32(0), x, r, r, mu1_0, v0, v0, zeros, tau0,
         jnp.zeros((), rdtype), jnp.zeros((), dtype), rho0),
        status0,
        history,
    )
    (i, x, *_), status, history = jax.lax.while_loop(cond, body, carry0)

    # Certify the true residual (one extra matvec); downgrade a lying
    # CONVERGED to BREAKDOWN.
    r_true = tree_sub(b, A(x))
    true_res = tree_norm(r_true)
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (true_res >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, true_res, tau0)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
