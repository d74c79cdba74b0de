"""MINRES for symmetric (possibly INDEFINITE) systems.

No reference counterpart: the reference covers SPD with CG
(src/cg.f90) and general nonsymmetric with GMRES/BiCGSTAB
(src/gmres_hh.f90, src/bicgstab.f90), leaving the symmetric-indefinite
class — e.g. the Helmholtz model (models/helmholtz.py) — to
full-recurrence GMRES, which pays O(m) basis storage and O(m) dots per
iteration for a matrix whose symmetry permits a three-term recurrence.
MINRES (Paige & Saunders 1975) is that recurrence: the Lanczos
tridiagonalization plus a running Givens QR of T, minimizing ‖b − Ax‖₂
over the Krylov space with O(1) vectors and ONE fused all-reduce point
per iteration.

Device shape, same design rules as CG (solvers/cg.py):

* one ``lax.while_loop``; every carried quantity is either a pytree
  vector (7 long vectors) or a replicated scalar;
* the two dots per iteration (α = v·Av before the orthogonalization,
  β² = r·z after) are each single all-reduces; α and the previous β
  never appear in the same reduction so no extra latency is added —
  per iteration: 1 operator, 1 preconditioner, 2 reduction points
  (vs CG's 2);
* convergence on the ABSOLUTE residual estimate φ̄ = ‖b − Ax‖ (exact
  in exact arithmetic), matching CG's absolute-`tol` semantics
  (cg.f90:37). With a preconditioner, φ̄ tracks the M-norm
  ‖b − Ax‖_M (M ≈ A⁻¹, the norm in which preconditioned MINRES
  minimizes) — documented divergence from CG, whose plain-2-norm test
  survives preconditioning because it reduces r directly.
* exit certification in the TESTED norm: one extra A (and M)
  application recomputes the true residual; a CONVERGED claim whose
  certified norm fails `tol` downgrades to BREAKDOWN, the same
  protection every short-recurrence solver here carries
  (PARITY.md quirk 8).

The preconditioner must be symmetric positive definite — e.g. the
shifted-Laplacian V-cycle
(precond/multigrid.py:helmholtz_shifted_laplacian_preconditioner),
whose equal pre/post polynomial smoothers make the cycle a symmetric
operator. An indefinite or nonsymmetric M silently breaks the Lanczos
relation (β² = r·Mr < 0 → BREAKDOWN via the NaN guard).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import (
    tree_axpy,
    tree_scale,
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


def minres(
    A: LinearOperator,
    b: Any,
    *,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[Any] = None,
) -> SolveResult:
    """Solve A x = b (A symmetric/Hermitian, definite or not) by
    (preconditioned) MINRES.

    A is a callable over pytree vectors and must be symmetric (real)
    or Hermitian (complex — every Lanczos/Givens scalar is then still
    exactly real, so the same loop serves both); M, if given, must be
    SPD/HPD (it defines the inner product of the Lanczos process).
    Starts from zeros like every solver here (cg.f90:27) unless x0 is
    given.
    """
    if x0 is None:
        x = tree_zeros_like(b)
        r1 = b
    else:
        x = x0
        r1 = tree_sub(b, A(x0))

    z = M(r1) if M is not None else r1
    dtype = jnp.result_type(*jax.tree.leaves(b))
    # Every Lanczos/Givens scalar is REAL even for complex HERMITIAN
    # A/M ((r, Mr) and (v, Av) are exactly real; jnp.real keeps the
    # complex dtype out of the rotations and comparisons, conjugation
    # lives in tree_vdot). Real dtypes are untouched.
    rdtype = jnp.finfo(dtype).dtype
    beta1_sq = jnp.real(tree_vdot(r1, z))
    # beta1² = (r, Mr) < 0 ⇔ M is not positive definite on r — an
    # invalid preconditioner; surfaces as NaN → BREAKDOWN below.
    beta1 = jnp.sqrt(beta1_sq)

    history = jnp.zeros((max_iterations,), dtype=rdtype)
    zeros = tree_zeros_like(b)

    status0 = jnp.where(
        beta1 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    eps = jnp.asarray(jnp.finfo(dtype).tiny, rdtype) ** 0.5

    def cond(carry):
        i = carry[0]
        status = carry[-2]
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        (i, x, r1, r2, z, w1, w2, beta, oldb, dbar, epsln, phibar,
         cs, sn, status, hist) = carry
        # Lanczos step in the M-inner product: v = z/β, y = A v
        # orthogonalized against the two previous M-orthonormal
        # directions (the three-term recurrence symmetry buys).
        v = tree_scale(1.0 / beta, z)
        y = A(v)
        first = i == 0
        y = tree_axpy(jnp.where(first, 0.0, -beta / oldb), r1, y)
        alfa = jnp.real(tree_vdot(v, y))  # reduction point 1
        y = tree_axpy(-alfa / beta, r2, y)
        r1_n, r2_n = r2, y
        z_n = M(y) if M is not None else y
        oldb_n = beta
        beta_sq = jnp.real(tree_vdot(r2_n, z_n))  # reduction point 2
        beta_n = jnp.sqrt(beta_sq)

        # Running Givens QR of the tridiagonal (Paige-Saunders): apply
        # the previous rotation to the new column, form and apply the
        # new one. All replicated-scalar work.
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta_sq), eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        # Solution update along the rotated direction.
        w = tree_scale(
            1.0 / gamma,
            tree_axpy(-oldeps, w1, tree_axpy(-delta, w2, v)),
        )
        x = tree_axpy(phi, w, x)

        res = jnp.abs(phibar_n)
        hist = hist.at[i].set(res)
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        # NaN lands here from two sources: β² = (r, Mr) < 0 (indefinite
        # M) or an exact β = 0 on the PREVIOUS step (Krylov space
        # exhausted unconverged — possible only for singular A; a
        # lucky breakdown with res < tol exits as CONVERGED above
        # before the 1/β is ever taken).
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS) & ~jnp.isfinite(res),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (i + 1, x, r1_n, r2_n, z_n, w2, w, beta_n, oldb_n,
                dbar_n, epsln_n, phibar_n, cs_n, sn_n, status, hist)

    one = jnp.asarray(1.0, rdtype)
    zero = jnp.asarray(0.0, rdtype)
    carry = (
        jnp.int32(0), x, r1, r1, z, zeros, zeros,
        beta1, one, zero, zero, beta1,
        -one, zero,
        status0, history,
    )
    (i, x, *_, status, history) = jax.lax.while_loop(cond, body, carry)

    # Certify in the tested norm (M-norm when preconditioned — see
    # module docstring): one extra A (+M) application.
    r_true = tree_sub(b, A(x))
    z_true = M(r_true) if M is not None else r_true
    true_res = jnp.sqrt(jnp.real(tree_vdot(r_true, z_true)))
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (true_res >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, true_res, beta1)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
