"""CGS (Sonneveld 1989) — conjugate gradient squared, the transpose-free
parent of the reference's BiCGSTAB family.

The reference ships BiCGSTAB (``src/bicgstab.f90:91-182``) precisely
because CGS's squared contraction polynomial makes its residual history
erratic; we ship CGS alongside it because on a device mesh it is the
CHEAPEST member of the family per iteration: 2 matvecs + 2 M applies
like BiCGSTAB, but only TWO reduction points per iteration instead of
BiCGSTAB's three —

    σ   = (v, r0)                      [one all-reduce]
    ‖r‖², ρ_next = (r,r), (r,r0)       [one fused all-reduce]

versus bicgstab.f90's (ap,r0) / (as,s)+(as,as) / (r,r)+(r,r0).  When
latency (interconnect hops, or per-dispatch host round trips)
dominates the
per-iteration cost, CGS trades residual smoothness for one fewer
synchronization — and when it converges it tends to do so in ~half the
iterations of BiCG because the contraction polynomial is applied twice.

Structure per iteration (right preconditioning, matching pbicgstab's
z-vector placement, bicgstab.f90:49-89):

    β  = ρ / ρ_prev
    u  = r + β·q
    p  = u + β·(q + β·p)
    v  = A·M·p ;  σ = (v, r0) ;  α = ρ/σ
    q  = u − α·v
    z  = M·(u + q)
    x += α·z ;  r −= α·A·z
    ‖r‖², ρ_next fused

Convergence: ABSOLUTE ‖r‖₂ < tol (the reference family's semantics,
bicgstab.f90:40), with the library-wide ``rtol`` scale-free option on
top.  The recursive residual of CGS drifts WORSE than BiCGSTAB's
(squared intermediates), so the exit is certified on the true
b − Ax exactly as in solvers/bicgstab.py — a CONVERGED claim that fails
re-verification is downgraded to BREAKDOWN with the true norm reported.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import (
    batched_vdot,
    tree_add,
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


def cgs(
    A: LinearOperator,
    b: Any,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[Any] = None,
    rtol: Optional[float] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by (preconditioned) CGS.

    Same call contract as :func:`gmres_tpu.bicgstab`; prefer BiCGSTAB
    or TFQMR when the residual trajectory matters, CGS when
    per-iteration synchronization latency does.
    """
    if rtol is not None:
        nb = jnp.sqrt(jnp.real(tree_vdot(b, b)))
        tol = jnp.maximum(jnp.asarray(tol, nb.dtype), rtol * nb)
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))
    r0 = r
    q = tree_zeros_like(b)
    p = tree_zeros_like(b)

    dtype = jnp.result_type(*jax.tree.leaves(b))
    rdtype = jnp.finfo(dtype).dtype  # real counterpart (norms)
    history = jnp.zeros((max_iterations,), dtype=rdtype)
    eps = jnp.finfo(dtype).tiny

    def cond(carry):
        (i, *_), status, _ = carry
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        (i, x, r, p, q, rho, rho_prev), status, hist = carry
        # ρ was folded into the previous iteration's tail reduction
        # (first iteration: computed below the loop).  ρ_prev = 1 and
        # q = p = 0 at i = 0 make the β-recurrences collapse to the
        # textbook u = r, p = r start regardless of β's value.
        safe_rho_prev = jnp.where(
            jnp.abs(rho_prev) > eps, rho_prev, jnp.ones((), rho_prev.dtype)
        )
        beta = rho / safe_rho_prev
        u = tree_axpy(beta, q, r)
        p = tree_axpy(beta, tree_axpy(beta, p, q), u)
        zp = M(p) if M is not None else p
        v = A(zp)
        # Shadow-side conjugation (σ = ⟨r0, v⟩ = Σ conj(r0)·v, the
        # scipy.sparse.linalg.cgs convention): the squared-polynomial
        # identities CGS is built on need ρ and σ conjugate-linear in
        # the SHADOW vector, not the iterate — the flipped convention
        # converges for real operators but diverges for complex ones.
        sigma = tree_vdot(r0, v)
        safe_sigma = jnp.where(
            jnp.abs(sigma) > eps, sigma, jnp.ones((), sigma.dtype)
        )
        alpha = rho / safe_sigma
        q = tree_axpy(-alpha, v, u)
        uq = tree_add(u, q)
        z = M(uq) if M is not None else uq
        x = tree_axpy(alpha, z, x)
        r = tree_axpy(-alpha, A(z), r)
        res_sq, rho_next = batched_vdot([(r, r), (r0, r)])
        res = jnp.sqrt(jnp.real(res_sq))
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        # σ ≈ 0 (pivot breakdown) or ρ ≈ 0 (Lanczos breakdown: r ⟂ r0
        # before convergence) or a non-finite residual all end the run
        # honestly — the reference family has no restart-from-breakdown
        # path either (bicgstab.f90 trusts the recurrence throughout).
        breakdown = (
            ~jnp.isfinite(res)
            | (jnp.abs(sigma) <= eps)
            | (jnp.abs(rho_next) <= eps)
        )
        status = jnp.where(
            breakdown & (status != SolverStatus.CONVERGED),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        hist = hist.at[i].set(res)
        return ((i + 1, x, r, p, q, rho_next, rho), status, hist)

    rho_init = tree_vdot(r0, r)
    status0 = jnp.where(
        jnp.sqrt(jnp.real(rho_init)) < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    carry = (
        (jnp.int32(0), x, r, p, q, rho_init,
         jnp.ones((), rho_init.dtype)),
        status0,
        history,
    )
    (i, x, r, p, q, _, _), status, history = jax.lax.while_loop(
        cond, body, carry
    )
    res = jnp.where(i > 0, history[jnp.maximum(i - 1, 0)],
                    jnp.sqrt(jnp.real(rho_init)))
    # Certify on the true residual (solvers/bicgstab.py contract): the
    # squared contraction polynomial makes CGS's recursive r the least
    # trustworthy in the family, so the CONVERGED claim must survive
    # one fresh b − Ax before being reported.
    r_true = tree_sub(b, A(x))
    true_res = jnp.sqrt(jnp.real(tree_vdot(r_true, r_true)))
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (true_res >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, true_res, res)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
