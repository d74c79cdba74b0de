"""LSQR (Paige & Saunders 1982): least squares min ‖Ax − b‖₂.

A new problem class beyond the reference (whose operators are all
square, src/interfaces.f90:12-18): rectangular / rank-deficient
operators, solved through Golub-Kahan bidiagonalization — analytically
CG on the normal equations AᵀA x = Aᵀb, but without ever forming or
squaring the conditioning of AᵀA.

The JAX-native part: the adjoint is DERIVED, not hand-written.
``jax.linear_transpose`` transposes the operator's jaxpr, so any
linear callable — a stencil, a sparse SpMV, a sharded shard_map
operator — gets its exact transpose mechanically, with XLA reversing
the collectives (a transposed psum becomes the identity on replicated
outputs, a transposed halo-permute flips direction). The reference
world would require hand-maintaining a second Fortran routine per
operator. For complex operators the ADJOINT (conjugate transpose) is
the composition conj ∘ transpose ∘ conj, handled here.

Device shape: one ``lax.while_loop``; two long-vector operator
applications (A, Aᴴ) and two norm reductions per iteration; all
rotation scalars replicated and real. Per-iteration recurrences touch
4 long vectors (u, v, w, x).

Stopping (Paige-Saunders S1/S2, absolute): ‖r‖ < tol (consistent
systems) or ‖Aᴴr‖ < tol·‖A‖_est·‖r‖-free form — here the absolute
‖Aᴴr‖ < atol, the quantity that is zero EXACTLY at a least-squares
solution. Exit certification recomputes both norms from b − Ax and
downgrades a lying claim (PARITY.md quirk 8).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import tree_norm, tree_zeros_like
from gmres_tpu.types import SolveResult, SolverStatus


def lsqr(
    A: Callable,
    b: Any,
    *,
    x_like: Optional[Any] = None,
    AH: Optional[Callable] = None,
    tol: float = 1e-9,
    atol: Optional[float] = None,
    max_iterations: int = 10_000,
    damp: float = 0.0,
) -> SolveResult:
    """Minimize ‖A x − b‖₂ (+ damp²‖x‖² Tikhonov when damp > 0).

    A: linear callable; may map between DIFFERENT shapes (rectangular
      operator). x_like: an example input of A (defines the solution
      shape/dtype); required when A is not square-shaped on b.
    AH: optional adjoint callable; derived via jax.linear_transpose
      when omitted (exact, including sharded operators).
    tol: absolute ‖r‖ stop for consistent systems.
    atol: absolute ‖Aᴴr‖ stop at a least-squares solution (defaults
      to tol).
    `iterations` counts bidiagonalization steps; `residual` is the
    certified ‖b − Ax‖₂; `residual_history` records ‖r‖ estimates.
    """
    if x_like is None:
        x_like = b
    if atol is None:
        atol = tol
    dtype = jnp.result_type(*jax.tree.leaves(b))
    rdtype = jnp.finfo(dtype).dtype
    is_complex = jnp.issubdtype(dtype, jnp.complexfloating)

    if AH is None:
        transpose = jax.linear_transpose(A, x_like)

        def AH(u):  # adjoint = conj ∘ transpose ∘ conj
            if is_complex:
                (out,) = transpose(jax.tree.map(jnp.conj, u))
                return jax.tree.map(jnp.conj, out)
            (out,) = transpose(u)
            return out

    tiny = jnp.finfo(rdtype).tiny

    def normalize(v):
        n = tree_norm(v)
        safe = jnp.where(n > 0, n, jnp.ones_like(n))
        return jax.tree.map(lambda x: x / safe, v), n

    x = tree_zeros_like(x_like)
    u, beta = normalize(b)
    v, alfa = normalize(AH(u))
    w = v
    phibar = beta
    rhobar = alfa
    arnorm0 = alfa * beta  # ‖Aᴴr₀‖

    history = jnp.zeros((max_iterations,), dtype=rdtype)
    status0 = jnp.where(
        (beta < tol) | (arnorm0 < atol),
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    dampr = jnp.asarray(damp, rdtype)

    def cond(carry):
        i = carry[0]
        status = carry[-2]
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        (i, x, u, v, w, alfa, beta, phibar, rhobar, res2_sq, status,
         hist) = carry
        # Golub-Kahan step: β u ← A v − α u ; α v ← Aᴴ u − β v.
        au = A(v)
        u_new = jax.tree.map(lambda a, b_: a - alfa * b_, au, u)
        u_new, beta_n = normalize(u_new)
        av = AH(u_new)
        v_new = jax.tree.map(lambda a, b_: a - beta_n * b_, av, v)
        v_new, alfa_n = normalize(v_new)

        # Eliminate the damping row first (Paige-Saunders eqn 4.10),
        # then the subdiagonal β via the standard rotation.
        rhobar1 = jnp.hypot(rhobar, dampr)
        c1 = rhobar / jnp.maximum(rhobar1, tiny)
        s1 = dampr / jnp.maximum(rhobar1, tiny)
        # ψ is the residual component the damping rotation moves into
        # the regularization rows — it stays in the AUGMENTED residual
        # ‖(b − Ax; damp·x)‖ permanently (Paige-Saunders eqn 4.10);
        # dropping it would make |phibar| alone decay by c1 < 1 every
        # step regardless of actual progress and trip the stop test
        # prematurely. Zero when damp = 0.
        psi = s1 * phibar
        res2_sq = res2_sq + psi * psi
        phibar1 = c1 * phibar
        rho = jnp.hypot(rhobar1, beta_n)
        c = rhobar1 / jnp.maximum(rho, tiny)
        s = beta_n / jnp.maximum(rho, tiny)
        theta = s * alfa_n
        rhobar_n = -c * alfa_n
        phi = c * phibar1
        phibar_n = s * phibar1

        t1 = phi / jnp.maximum(rho, tiny)
        t2 = -theta / jnp.maximum(rho, tiny)
        x = jax.tree.map(lambda xx, ww: xx + t1 * ww, x, w)
        w = jax.tree.map(lambda vv, ww: vv + t2 * ww, v_new, w)

        # |·|: the recurrence carries phibar SIGNED (the sign lives in
        # c1 = ρ̄/ρ̄₁ and must propagate into phi), the estimates are
        # magnitudes. With damp > 0 this is the AUGMENTED residual
        # ‖(b − Ax; damp·x)‖ (= ‖b − Ax‖ exactly when damp = 0).
        res_est = jnp.sqrt(phibar_n * phibar_n + res2_sq)
        arnorm = jnp.abs(phibar_n * alfa_n * c)  # ‖Aᴴr‖ estimate
        hist = hist.at[i].set(res_est)
        status = jnp.where(
            (res_est < tol) | (arnorm < atol),
            jnp.int32(SolverStatus.CONVERGED),
            status,
        )
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & ~jnp.isfinite(res_est),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (i + 1, x, u_new, v_new, w, alfa_n, beta_n, phibar_n,
                rhobar_n, res2_sq, status, hist)

    carry0 = (jnp.int32(0), x, u, v, w, alfa, beta, phibar, rhobar,
              jnp.zeros((), rdtype), status0, history)
    (i, x, *_, status, history) = jax.lax.while_loop(cond, body, carry0)

    # Certify both stopping quantities from the true residual.
    r_true = jax.tree.map(
        lambda bb, aa: bb - aa, b, A(x)
    )
    res_true = tree_norm(r_true)
    # Gradient of ½‖Ax−b‖² + ½damp²‖x‖²: Aᴴr − damp²x = 0 at optimum.
    grad = jax.tree.map(
        lambda g, xx: g - dampr * dampr * xx, AH(r_true), x
    )
    lsq_ok = (res_true < tol) | (tree_norm(grad) < atol)
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & ~lsq_ok,
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, res_true, beta)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
