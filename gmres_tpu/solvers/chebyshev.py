"""Chebyshev iteration: the reduction-free SPD solver.

Beyond the reference (which uses Chebyshev only as a degree-2
preconditioner, chebyshev.f90:8-38): with known spectral bounds the
Chebyshev semi-iteration is itself an optimal STATIONARY solver — no
inner products in the recurrence at all. On a multi-chip mesh that is
the whole game: CG pays 2 all-reduce latencies per operator
application (SURVEY §3.3); Chebyshev iteration pays exactly ONE per
``order`` applications (the per-cycle convergence check), and on a
single GPU the entire cycle rides the fused smoother kernel
(ops/smoother.py) when the operator is a 5-point stencil.

Structure: restarted correction form. Each cycle applies the order-k
Chebyshev polynomial approximation of A⁻¹ (the SAME polynomial the
preconditioners use — precond/chebyshev.py) to the true residual:

    x ← x + p_k(A)(b − A x)

so each cycle's residual is TRUE by construction (no drift to
certify), contracting by the classic factor ≈ 2ρᵏ with
ρ = (√κ − 1)/(√κ + 1). Spectral bounds come from the closed forms the
models export or from ``lanczos_bounds`` (solvers/lanczos.py) — the
estimate-then-iterate pattern the reference README describes.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import tree_axpy, tree_norm, tree_sub, \
    tree_zeros_like
from gmres_tpu.precond.chebyshev import (
    chebyshev_preconditioner,
    chebyshev_stencil_preconditioner,
)
from gmres_tpu.types import LinearOperator, SolveResult, SolverStatus


def chebyshev_solve(
    A: LinearOperator,
    b: Any,
    lam_min: float,
    lam_max: float,
    *,
    order: int = 16,
    tol: float = 1e-9,
    max_cycles: int = 1000,
    x0: Optional[Any] = None,
    coefs=None,
    use_pallas: str = "auto",
) -> SolveResult:
    """Solve A x = b (A SPD with spectrum ⊂ [lam_min, lam_max]) by
    restarted order-``order`` Chebyshev iteration.

    coefs: optional 5-point stencil coefficients (center, W, E, S, N);
      when given, the polynomial application routes through the fused
      smoother kernel (single-GPU f32) instead of the generic operator
      recurrence — A itself is still used for the per-cycle true
      residual.
    `iterations` counts cycles (order operator applications each + one
    residual); `residual` is the absolute true ‖b − Ax‖₂, matching
    CG's convergence semantics (cg.f90:37).
    """
    if coefs is not None:
        p_k = chebyshev_stencil_preconditioner(
            lam_min, lam_max, order=order, coefs=coefs,
            use_pallas=use_pallas,
        )
    else:
        p_k = chebyshev_preconditioner(
            A, lam_min, lam_max, order=order, reference_form=False
        )

    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))

    dtype = jnp.result_type(*jax.tree.leaves(b))
    rdtype = jnp.finfo(dtype).dtype  # real norms/history (house rule)
    history = jnp.zeros((max_cycles,), dtype=rdtype)
    res0 = tree_norm(r)
    status0 = jnp.where(
        res0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    def cond(carry):
        i, _, _, _, status, _ = carry
        return (i < max_cycles) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        i, x, r, res_prev, status, hist = carry
        x = tree_axpy(1.0, p_k(r), x)
        r = tree_sub(b, A(x))
        # The cycle's ONLY reduction: the true-residual check.
        res = tree_norm(r)
        hist = hist.at[i].set(res)
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        # Non-contraction ⇒ the bounds do not enclose the spectrum
        # (polynomial diverges outside [lam_min, lam_max]) or NaN:
        # stop honestly rather than oscillate to max_cycles.
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & (~jnp.isfinite(res) | (res > 2.0 * res_prev)),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (i + 1, x, r, res, status, hist)

    i, x, r, res, status, history = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x, r, res0, status0, history)
    )
    res = jnp.where(i > 0, res, res0)
    history = jnp.where(jnp.arange(max_cycles) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
