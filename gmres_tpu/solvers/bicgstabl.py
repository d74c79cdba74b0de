"""BiCGstab(ℓ) — Sleijpen & Fokkema (ETNA 1, 1993).

Beyond the reference (which ships only ℓ=1 BiCGSTAB,
``src/bicgstab.f90``): plain BiCGSTAB closes each BiCG step with a
DEGREE-1 minimal-residual polynomial (1 − ωA), whose real root makes it
stall or break down when the spectrum has large imaginary parts — the
same real-axis-vs-complex-spectrum failure mode as Chebyshev smoothing
(precond/multigrid.py). BiCGstab(ℓ) performs ℓ BiCG steps and closes
them with ONE degree-ℓ MR polynomial fitted by a least-squares solve
over the ℓ residual directions, which can place complex-conjugate root
pairs; ℓ = 2 is the standard production choice.

Device shape:

* ℓ is static; the BiCG and MR parts are Python-unrolled at trace time
  (2ℓ stencil applications per outer cycle) inside one
  ``lax.while_loop`` over cycles.
* Reduction batching (same design as solvers/bicgstab.py): the MR
  part's Gram/projection dots are packed into 2 batched all-reduces
  per cycle (for ℓ = 2), the BiCG part needs 2 per step — ~(2ℓ+2)
  all-reduce points per 2ℓ matvecs, the same reduction density as
  ℓ = 1.
* Right preconditioning: the recurrence runs on A∘M and the solution
  is mapped through M once at exit — so M enters exactly 1:1 with A
  applications, matching pbicgstab's cost structure
  (bicgstab.f90:121-138) without interleaving special cases.
  CONSEQUENCE (measured): M's internal precision bounds the attainable
  accuracy, because its rounding is part of the operator being solved
  — a multigrid cycle with ``internal_dtype=float32`` stalls this
  solver at ~f32-level absolute residuals (1024² convdiff: 2e-4),
  while plain ``bicgstab``'s interleaved form tolerates it (M there
  only steers search directions; its residual recurrence applies the
  exact A). Keep M at solve precision for tight tolerances.
* Exit certification on the TRUE residual b − A x (one extra matvec),
  as everywhere in this library: a CONVERGED claim that fails
  re-verification is downgraded to BREAKDOWN.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import (
    batched_vdot,
    tree_axpy,
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


def bicgstabl(
    A: LinearOperator,
    b: Any,
    *,
    ell: int = 2,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[Any] = None,
    reliable: bool = True,
    replace_delta: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b by BiCGstab(ℓ) with optional right preconditioning.

    max_iterations counts OUTER cycles; each cycle applies A (and M)
    2ℓ times, so ℓ = 1 at k cycles does the work of 2k plain-BiCGSTAB
    half-iterations. Convergence: absolute ‖r‖₂ < tol checked at cycle
    boundaries (the MR update lands there).

    reliable: van der Vorst–Ye residual replacement at δ‖r‖ drift-bound
    crossings, exactly as in solvers/bicgstab.py (measured necessary
    here too: the unpreconditioned γ=(0.9, 0.9) convection problem
    drifts to a true residual of ~0.13 while the recurrence claims
    1e-9). ρ is recomputed from the current residual at each BiCG step,
    so replacement needs no scalar repair beyond the bound reset.
    """
    if ell < 1:
        raise ValueError(f"ell must be >= 1, got {ell}")

    if M is None:
        op = A
    else:
        def op(v):
            return A(M(v))

    if x0 is None:
        y = tree_zeros_like(b)
        r = b
    else:
        # run the y-recurrence from 0 and fold x0 into the rhs residual
        y = tree_zeros_like(b)
        r = tree_sub(b, A(x0))
    r_tilde = r

    dtype = jnp.result_type(*jax.tree.leaves(b))
    history = jnp.zeros((max_iterations,), dtype=dtype)
    eps = jnp.finfo(dtype).tiny
    mach_eps = float(jnp.finfo(dtype).eps)
    delta = (float(replace_delta) if replace_delta is not None
             else mach_eps ** 0.5)
    r_init = r
    if reliable:
        ar0 = op(r)
        norm_A = jnp.sqrt(tree_vdot(ar0, ar0)
                          / jnp.maximum(tree_vdot(r, r), eps))

    def body(carry):
        ((k, y, r0v, u0v, rho0, alpha, omega, drift, below),
         status, hist) = carry
        rho0 = -omega * rho0
        # ---- BiCG part: build u_0..u_ell, r_0..r_ell (unrolled) ----
        us = [u0v] + [None] * ell
        rs = [r0v] + [None] * ell
        ok = jnp.asarray(True)
        for j in range(ell):
            rho1 = tree_vdot(rs[j], r_tilde)
            ok = ok & (jnp.abs(rho0) > eps)
            beta = alpha * rho1 / jnp.where(jnp.abs(rho0) > eps,
                                            rho0, 1.0)
            rho0 = rho1
            for i in range(j + 1):
                us[i] = tree_axpy(-beta, us[i], rs[i])
            us[j + 1] = op(us[j])
            gamma = tree_vdot(us[j + 1], r_tilde)
            ok = ok & (jnp.abs(gamma) > eps)
            alpha = rho0 / jnp.where(jnp.abs(gamma) > eps, gamma, 1.0)
            for i in range(j + 1):
                rs[i] = tree_axpy(-alpha, us[i + 1], rs[i])
            rs[j + 1] = op(rs[j])
            y = tree_axpy(alpha, us[0], y)
        # ---- MR part: MGS of r_1..r_ell, project r_0 ----
        # For each j: orthogonalize r_j against r_1..r_{j-1}, then one
        # batched reduce gives sigma_j, (r_0, r_j), and the projections
        # of the REMAINING r_i on r_j — (ell - j + 2) dots fused.
        tau = [[None] * (ell + 1) for _ in range(ell + 1)]
        sigma = [None] * (ell + 1)
        gamma_p = [None] * (ell + 1)
        for j in range(1, ell + 1):
            pairs = [(rs[j], rs[j]), (rs[0], rs[j])] + [
                (rs[i], rs[j]) for i in range(j + 1, ell + 1)
            ]
            dots = batched_vdot(pairs)
            sigma[j] = dots[0]
            safe = jnp.where(jnp.abs(sigma[j]) > eps, sigma[j], 1.0)
            ok = ok & (jnp.abs(sigma[j]) > eps)
            gamma_p[j] = dots[1] / safe
            for idx, i in enumerate(range(j + 1, ell + 1)):
                tau[j][i] = dots[2 + idx] / safe
                rs[i] = tree_axpy(-tau[j][i], rs[j], rs[i])
        # back-substitute the polynomial coefficients
        gam = [None] * (ell + 1)
        gam[ell] = gamma_p[ell]
        for j in range(ell - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, ell + 1):
                acc = acc - tau[j][i] * gam[i]
            gam[j] = acc
        gam_pp = [None] * ell
        for j in range(1, ell):
            acc = gam[j + 1]
            for i in range(j + 1, ell):
                acc = acc + tau[j][i] * gam[i + 1]
            gam_pp[j] = acc
        omega = gam[ell]
        # ---- updates ----
        y = tree_axpy(gam[1], rs[0], y)
        for j in range(1, ell):
            y = tree_axpy(gam_pp[j], rs[j], y)
        for j in range(1, ell + 1):
            rs[0] = tree_axpy(-gamma_p[j], rs[j], rs[0])
            us[0] = tree_axpy(-gam[j], us[j], us[0])
        if reliable:
            res_sq, y_sq = batched_vdot([(rs[0], rs[0]), (y, y)])
        else:
            res_sq = tree_vdot(rs[0], rs[0])
        res = jnp.sqrt(res_sq)
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        breakdown = ~jnp.isfinite(res) | (~ok & (res >= tol))
        status = jnp.where(
            breakdown & (status != SolverStatus.CONVERGED),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        hist = hist.at[k].set(res)
        r0_next = rs[0]
        if reliable:
            drift = drift + mach_eps * (
                norm_A * jnp.sqrt(y_sq) + res
            )

            def replace(_):
                r_t = tree_sub(r_init, op(y))
                d_t = mach_eps * (
                    norm_A * jnp.sqrt(y_sq)
                    + jnp.sqrt(tree_vdot(r_t, r_t))
                )
                return r_t, d_t

            trigger = (
                below
                & (drift >= delta * res)
                & (res >= tol)
                & jnp.isfinite(res)
                & (status == SolverStatus.MAX_ITERATIONS)
            )
            r0_next, drift = jax.lax.cond(
                trigger, replace, lambda _: (rs[0], drift), None
            )
            below = drift < delta * res
        return ((k + 1, y, r0_next, us[0], rho0, alpha, omega, drift,
                 below), status, hist)

    def cond(carry):
        (k, *_), status, _ = carry
        return (k < max_iterations) & (
            status == SolverStatus.MAX_ITERATIONS
        )

    res0 = jnp.sqrt(tree_vdot(r, r))
    status0 = jnp.where(
        res0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    carry = (
        (jnp.int32(0), y, r, tree_zeros_like(b),
         jnp.ones((), dtype), jnp.zeros((), dtype),
         jnp.ones((), dtype), jnp.zeros((), dtype),
         jnp.asarray(True)),
        status0,
        history,
    )
    ((k, y, r, *_), status, history) = jax.lax.while_loop(
        cond, body, carry
    )
    # map through the right preconditioner and certify the TRUE residual
    x = M(y) if M is not None else y
    if x0 is not None:
        x = tree_axpy(1.0, x0, x)
    r_true = tree_sub(b, A(x))
    true_res = jnp.sqrt(tree_vdot(r_true, r_true))
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (true_res >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(k > 0, true_res, res0)
    history = jnp.where(jnp.arange(max_iterations) < k, history, res)
    return SolveResult(
        x=x,
        iterations=k,
        residual=res,
        status=status,
        residual_history=history,
    )
