"""LSMR (Fong & Saunders 2011): least squares min ‖Ax − b‖₂ with
monotone ‖Aᴴr‖.

Companion to LSQR (solvers/lsqr.py) on the same Golub-Kahan
bidiagonalization: LSQR is CG on the normal equations AᴴA x = Aᴴb,
LSMR is MINRES on them — so ‖Aᴴr_k‖ decreases MONOTONICALLY, which is
the quantity the least-squares stopping test watches. On
inconsistent/ill-conditioned problems LSQR's ‖Aᴴr‖ oscillates by
orders of magnitude and can only be stopped safely far past the point
LSMR stops; LSMR is therefore the default recommendation of its own
authors for rectangular systems. Both solvers here share conventions:
the adjoint is derived by ``jax.linear_transpose`` (exact for any
linear callable, including sharded shard_map operators — XLA reverses
the collectives), complex operators get conj ∘ transpose ∘ conj, and
damp ≥ 0 solves the Tikhonov problem min ‖Ax−b‖² + damp²‖x‖².

Beyond-reference component: the reference's operators are all square
(src/interfaces.f90:12-18); this covers the rectangular/rank-deficient
problem class.

Device shape: one ``lax.while_loop``; per iteration two long-vector
operator applications (A, Aᴴ) and two norm reductions; the double
QR (Q against the bidiagonal, Q̄ against R) and the residual-estimate
rotations (Fong-Saunders §5.1-5.3) are all replicated scalars.
Long-vector state is 5 vectors (u, v, h, h̄, x) vs LSQR's 4 — the
price of the second QR factorization.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import tree_norm, tree_zeros_like
from gmres_tpu.types import SolveResult, SolverStatus


def lsmr(
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
    tol: absolute ‖r‖ stop for consistent systems (with damp > 0 the
      estimate tracks the AUGMENTED residual ‖(b − Ax; damp·x)‖).
    atol: absolute ‖Aᴴr − damp²x‖ stop at a least-squares optimum
      (defaults to tol). LSMR's estimate of this norm is |ζ̄|, exact
      in exact arithmetic and monotone.
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

    def safe(x):
        return jnp.maximum(x, tiny)

    def normalize(v):
        n = tree_norm(v)
        s = jnp.where(n > 0, n, jnp.ones_like(n))
        return jax.tree.map(lambda x: x / s, v), n

    x = tree_zeros_like(x_like)
    u, beta1 = normalize(b)
    v, alpha1 = normalize(AH(u))

    zetabar0 = alpha1 * beta1  # ‖Aᴴr₀‖
    history = jnp.zeros((max_iterations,), dtype=rdtype)
    status0 = jnp.where(
        (beta1 < tol) | (zetabar0 < atol),
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    lam = jnp.asarray(damp, rdtype)
    one = jnp.ones((), rdtype)
    zero = jnp.zeros((), rdtype)

    # Scalar state, Fong-Saunders Alg. 1 + §5 residual recurrences.
    scal0 = dict(
        alpha=alpha1, alphabar=alpha1, zetabar=zetabar0, zeta=zero,
        rho=one, rhobar=one, cbar=one, sbar=zero,
        # ‖r‖ estimate machinery (§5.2): the rotated rhs components.
        betadd=beta1, betad=zero, rhodold=one, tautildeold=zero,
        thetatilde=zero, d=zero,
    )

    def cond(carry):
        i, status = carry[0], carry[-2]
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        i, x, u, v, h, hbar, s_, status, hist = carry
        # Golub-Kahan step: β u ← A v − α u ; α v ← Aᴴ u − β v.
        au = A(v)
        u_n = jax.tree.map(lambda a, b_: a - s_["alpha"] * b_, au, u)
        u_n, beta = normalize(u_n)
        av = AH(u_n)
        v_n = jax.tree.map(lambda a, b_: a - beta * b_, av, v)
        v_n, alpha_n = normalize(v_n)

        # Rotation Q̂ folds the damping row into the bidiagonal.
        alphahat = jnp.hypot(s_["alphabar"], lam)
        chat = s_["alphabar"] / safe(alphahat)
        shat = lam / safe(alphahat)

        # Rotation Q_k eliminates β against the (damped) diagonal.
        rhoold = s_["rho"]
        rho = jnp.hypot(alphahat, beta)
        c = alphahat / safe(rho)
        s = beta / safe(rho)
        thetanew = s * alpha_n
        alphabar_n = c * alpha_n

        # Rotation Q̄_k (the MINRES-side QR against R).
        rhobarold = s_["rhobar"]
        zetaold = s_["zeta"]
        thetabar = s_["sbar"] * rho
        rhotemp = s_["cbar"] * rho
        rhobar = jnp.hypot(rhotemp, thetanew)
        cbar_n = rhotemp / safe(rhobar)
        sbar_n = thetanew / safe(rhobar)
        zeta = cbar_n * s_["zetabar"]
        zetabar_n = -sbar_n * s_["zetabar"]

        # Long-vector updates.
        coef_hbar = thetabar * rho / safe(rhoold * rhobarold)
        hbar = jax.tree.map(lambda hh, hb: hh - coef_hbar * hb, h, hbar)
        coef_x = zeta / safe(rho * rhobar)
        x = jax.tree.map(lambda xx, hb: xx + coef_x * hb, x, hbar)
        coef_h = thetanew / safe(rho)
        h = jax.tree.map(lambda vv, hh: vv - coef_h * hh, v_n, h)

        # ‖r‖ estimate (Fong-Saunders §5.2): rotate the rhs through
        # Q̂, Q, then the tilde-rotations that track the lower-bidiagonal
        # factor of R̄.
        betaacute = chat * s_["betadd"]
        betacheck = -shat * s_["betadd"]  # component lost to damping rows
        betahat = c * betaacute
        betadd_n = -s * betaacute

        thetatildeold = s_["thetatilde"]
        rhotildeold = jnp.hypot(s_["rhodold"], thetabar)
        ctildeold = s_["rhodold"] / safe(rhotildeold)
        stildeold = thetabar / safe(rhotildeold)
        thetatilde_n = stildeold * rhobar
        rhodold_n = ctildeold * rhobar
        betad_n = -stildeold * s_["betad"] + ctildeold * betahat

        tautildeold_n = (
            zetaold - thetatildeold * s_["tautildeold"]
        ) / safe(rhotildeold)
        taud = (zeta - thetatilde_n * tautildeold_n) / safe(rhodold_n)
        d_n = s_["d"] + betacheck * betacheck
        res_est = jnp.sqrt(
            d_n + (betad_n - taud) ** 2 + betadd_n * betadd_n
        )
        arnorm = jnp.abs(zetabar_n)  # monotone ‖Aᴴr − damp²x‖ estimate

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
        s_n = dict(
            alpha=alpha_n, alphabar=alphabar_n, zetabar=zetabar_n,
            zeta=zeta, rho=rho, rhobar=rhobar, cbar=cbar_n, sbar=sbar_n,
            betadd=betadd_n, betad=betad_n, rhodold=rhodold_n,
            tautildeold=tautildeold_n, thetatilde=thetatilde_n, d=d_n,
        )
        return (i + 1, x, u_n, v_n, h, hbar, s_n, status, hist)

    carry0 = (jnp.int32(0), x, u, v, v, tree_zeros_like(x), scal0,
              status0, history)
    (i, x, *_, status, history) = jax.lax.while_loop(cond, body, carry0)

    # Certify both stopping quantities from the true residual
    # (PARITY.md quirk 8, same contract as lsqr).
    r_true = jax.tree.map(lambda bb, aa: bb - aa, b, A(x))
    res_true = tree_norm(r_true)
    grad = jax.tree.map(lambda g, xx: g - lam * lam * xx, AH(r_true), x)
    lsq_ok = (res_true < tol) | (tree_norm(grad) < atol)
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & ~lsq_ok,
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, res_true, beta1)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
