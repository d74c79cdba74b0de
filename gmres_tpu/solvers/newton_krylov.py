"""Jacobian-free Newton-Krylov (JFNK) for nonlinear systems F(x) = 0.

Beyond the reference (linear solvers only, src/interfaces.f90:12-28):
JFNK is the standard production wrapper that turns a Krylov linear
solver library into a nonlinear PDE solver (Knoll & Keyes, JCP 2004).
It belongs in THIS library more naturally than in the Fortran original
because the hard part — the Jacobian action J(x)·v — is exact and free
under JAX: ``jax.linearize(F, x)`` differentiates the traced residual
once per Newton step and returns the linear tangent map, where a
Fortran/C implementation must approximate J·v by a finite-difference
stencil (F(x+εv) − F(x))/ε with all its ε-selection fragility.

Device shape: the ENTIRE nonlinear solve — Newton loop, per-step
linearization, inner restarted GMRES, Armijo backtracking — is one
jittable program (outer ``lax.while_loop`` whose body traces the inner
solver), so a full solve is ONE dispatch. The linearized tangent graph is what the inner
GMRES applies per matvec: for stencil residuals XLA fuses it to the
same fused-stencil cost as the primal.

Algorithm:
  * Inexact Newton with Eisenstat-Walker choice-2 forcing terms
    (SISC 1996): the inner GMRES solves ‖F + J d‖ ≤ η_k ‖F‖ with
    η_k = γ(‖F_k‖/‖F_{k-1}‖)^α, α = (1+√5)/2 — loose solves far from
    the root, tight near it, preserving q-quadratic convergence
    without oversolving.
  * Globalization by Armijo backtracking on ‖F‖: accept x + t d when
    ‖F(x + t d)‖ ≤ (1 − σ t)‖F‖, halving t otherwise. A failed line
    search (no decrease down to 2^-max_backtracks, or NaN) exits with
    BREAKDOWN and the last good iterate.
  * `residual` is always the freshly evaluated ‖F(x)‖ at the returned
    point — the nonlinear analogue of exit certification (PARITY.md
    quirk 8) holds by construction.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import tree_norm
from gmres_tpu.types import (
    NewtonResult,
    Preconditioner,
    SolverStatus,
)

_ALPHA_EW = (1.0 + 5.0 ** 0.5) / 2.0  # Eisenstat-Walker choice-2 power


def newton_krylov(
    F: Callable,
    x0: jnp.ndarray,
    *,
    tol: float = 1e-9,
    max_newton: int = 50,
    M: Optional[Preconditioner] = None,
    inner: str = "gmres",
    recycle_k: int = 10,
    restart: int = 30,
    max_restarts: int = 40,
    variant: str = "householder",
    inner_dtype=None,
    forcing: str = "ew",
    eta0: float = 0.5,
    eta_fixed: float = 1e-4,
    eta_min: float = 1e-10,
    eta_max: float = 0.9,
    gamma: float = 0.9,
    line_search: bool = True,
    max_backtracks: int = 25,
    armijo: float = 1e-4,
) -> NewtonResult:
    """Solve F(x) = 0 by inexact Newton with GMRES inner solves.

    Args:
      F: residual callable y = F(x), JAX-traceable (it is differentiated
        with ``jax.linearize``); x an array of any shape.
      x0: initial guess (convergence is local — for hard problems supply
        a physically sensible start).
      tol: absolute nonlinear tolerance ‖F(x)‖₂.
      max_newton: Newton-step cap.
      M: optional preconditioner for the inner solve — typically a
        frozen approximate-Jacobian inverse (e.g. the Poisson multigrid
        cycle when F = A u + low-order nonlinearity; models/bratu.py).
        Applied on the RIGHT via FGMRES (inner="gmres"), so the inner
        stop test is the UNPRECONDITIONED ‖J d + F‖ ≤ η‖F‖ that
        Eisenstat-Walker theory requires (see the in-line note for the
        measured left-preconditioned failure mode this prevents). The
        gcrodr inner still applies M on the left.
      inner: "gmres" (default) or "gcrodr" — the recycling inner
        solver (solvers/gcrodr.py) carries a recycle_k-dimensional
        deflation subspace ACROSS Newton steps: successive Jacobians
        J(x_i) differ only by the drifting diagonal, exactly the
        sequence-of-systems scenario GCRO-DR exists for. Measured on
        UNpreconditioned 64² Bratu λ=6: 208 total inner matvecs
        (incl. per-step import) vs GMRES's 1052 (5.1×), and one fewer
        Newton step. With a strong frozen M the plain GMRES inner is
        already cheap — recycling pays when no good preconditioner is
        available.
      recycle_k: recycle-space dimension for inner="gcrodr".
      restart / max_restarts / variant / inner_dtype: passed to the
        inner :func:`gmres_tpu.solvers.gmres.gmres` (inner_dtype=f32
        with f64 x gives the mixed-precision fast path; the inner
        forcing tolerance keeps Newton's convergence theory intact).
      forcing: "ew" (Eisenstat-Walker choice 2, default) or "fixed"
        (η = eta_fixed every step).
      eta0: first-step forcing term (EW mode).
      eta_min / eta_max / gamma: EW safeguards — η clipped to
        [eta_min, eta_max]; the γ·η_{k-1}^α safeguard prevents
        over-tightening after a lucky step; an oversolve guard floors
        η at 0.5·tol/‖F‖ so the last inner solve is no tighter than
        the nonlinear target.
      line_search: Armijo backtracking on ‖F‖ (disable only for
        problems known to be in the Newton convergence basin).
      max_backtracks: halvings before declaring BREAKDOWN.
      armijo: sufficient-decrease parameter σ.
    """
    from gmres_tpu.solvers.fgmres import fgmres
    from gmres_tpu.solvers.gmres import gmres

    if forcing not in ("ew", "fixed"):
        raise ValueError(f"unknown forcing {forcing!r}")
    if inner not in ("gmres", "gcrodr"):
        raise ValueError(f"unknown inner {inner!r}")
    use_recycling = inner == "gcrodr"
    if use_recycling and inner_dtype is not None:
        raise ValueError(
            "inner_dtype (mixed precision) applies to the gmres inner "
            "only"
        )
    if use_recycling:
        from gmres_tpu.solvers.gcrodr import gcrodr

    dtype = x0.dtype
    rdtype = jnp.finfo(dtype).dtype
    f0 = F(x0)
    if f0.shape != x0.shape:
        raise ValueError(
            f"F must map x to a residual of the same shape; got "
            f"{x0.shape} -> {f0.shape}"
        )
    fnorm0 = tree_norm(f0)
    history = jnp.zeros((max_newton,), dtype=rdtype)
    status0 = jnp.where(
        fnorm0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    def forcing_term(i, fnorm, fnorm_prev, eta_prev):
        if forcing == "fixed":
            return jnp.asarray(eta_fixed, rdtype)
        ratio = fnorm / jnp.maximum(fnorm_prev, jnp.finfo(rdtype).tiny)
        eta_raw = gamma * ratio ** _ALPHA_EW
        safeguard = gamma * eta_prev ** _ALPHA_EW
        eta = jnp.where(
            safeguard > 0.1, jnp.maximum(eta_raw, safeguard), eta_raw
        )
        eta = jnp.where(i == 0, jnp.asarray(eta0, rdtype), eta)
        # Oversolve guard (Eisenstat-Walker §6): never solve the inner
        # system tighter than what reaching tol requires.
        eta = jnp.maximum(eta, 0.5 * tol / jnp.maximum(fnorm, tol))
        return jnp.clip(eta, eta_min, eta_max)

    def cond(carry):
        (i, *_), status, _ = carry
        return (i < max_newton) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        (i, x, fx, fnorm, fnorm_prev, eta_prev, inner_tot, u_rec), \
            status, hist = carry

        # Exact Jacobian action by linearization: one differentiation
        # per Newton step, then J·v per inner matvec. The linearized
        # map is dtype-strict, but in mixed inner_dtype mode GMRES
        # applies the operator to its work-dtype basis — cast at the
        # boundary (J·v itself runs at residual precision; the mixed
        # win is in the basis storage/orthogonalization bandwidth).
        _, jvp_fn = jax.linearize(F, x)

        def j_apply(v):
            return jvp_fn(v.astype(dtype)).astype(v.dtype)

        eta = forcing_term(i, fnorm, fnorm_prev, eta_prev)
        if use_recycling:
            # The deflation subspace recycles across Newton steps: an
            # all-zero block imports as "no recycle yet" (gcrodr seeds
            # U from its first cycle's Hessenberg), so the first step
            # bootstraps itself inside the while_loop carry.
            res = gcrodr(
                j_apply, -fx, k=recycle_k, restart=restart, tol=eta,
                max_restarts=max_restarts, M=M, recycle=u_rec,
            )
            u_rec = res.recycle
            # + recycle_k: the per-step import cost (op·U to rebuild C).
            inner_tot = inner_tot + recycle_k + (
                jnp.maximum(res.restarts - 1, 0)
                * (restart - recycle_k)
                + res.iterations
            )
        elif M is not None:
            # RIGHT-preconditioned inner solve (FGMRES): Eisenstat-
            # Walker theory requires ‖J d + F‖ ≤ η‖F‖ in the
            # UNPRECONDITIONED norm, and right preconditioning makes
            # the solver's own residual exactly that norm at zero extra
            # cost. A LEFT-preconditioned inner (the round-3 form)
            # stops on the M-norm, which can accept directions whose
            # true linear residual is large when the inner least-
            # squares is ill-determined — measured on 1024² Bratu f64:
            # two backends reached the SAME M-norm estimate (0.2215
            # vs 0.2214) while the true relative residuals were 0.063
            # vs 15.8; on the second the "direction" failed every
            # backtrack and Newton died at ‖F(x₀)‖. (Left + certify="true" also
            # fixes it but pays ~3× inner iterations; right
            # preconditioning minimizes the correct norm directly.)
            res = fgmres(
                j_apply,
                -fx,
                restart=restart,
                tol=eta,
                max_restarts=max_restarts,
                M=M,
                inner_dtype=inner_dtype,
                # same lucky-breakdown misfire as the gmres inner: the
                # ABSOLUTE h_val vs the LOOSE forcing eta exits cycles
                # at t~3 and flags BREAKDOWN (measured: the 1024^2 f64
                # row stalled at ||F0|| on every backend).
                breakdown_check=False,
            )
        else:
            res = gmres(
                j_apply,
                -fx,
                restart=restart,
                tol=eta,
                max_restarts=max_restarts,
                variant=variant,
                inner_dtype=inner_dtype,
                compute_v_err=False,
                # The lucky-breakdown heuristic compares the ABSOLUTE
                # subdiagonal h_val against tol (gmres_mgsr.f90:69
                # semantics) — sound for tiny tolerances, but a loose
                # forcing term η ~ 0.5 makes it misfire on ordinary
                # Hessenberg entries. Inexact Newton never needs it.
                breakdown_check=False,
            )
        if not use_recycling:
            inner_tot = inner_tot + (
                jnp.maximum(res.restarts - 1, 0) * restart
                + res.iterations
            )
        d = res.x

        def trial(t):
            xt = x + t.astype(dtype) * d
            ft = F(xt)
            return xt, ft, tree_norm(ft)

        one = jnp.asarray(1.0, rdtype)
        if line_search:
            def ls_cond(st):
                t, k, _, _, nt = st
                ok = (nt <= (one - armijo * t) * fnorm) & jnp.isfinite(nt)
                return (~ok) & (k < max_backtracks)

            def ls_body(st):
                t, k, *_ = st
                t = t * 0.5
                xt, ft, nt = trial(t)
                return (t, k + 1, xt, ft, nt)

            t, _, xt, ft, nt = jax.lax.while_loop(
                ls_cond, ls_body, (one, jnp.int32(0), *trial(one))
            )
            accepted = (nt <= (one - armijo * t) * fnorm) & \
                jnp.isfinite(nt)
        else:
            _, xt, ft, nt = (one, *trial(one))
            accepted = jnp.isfinite(nt)

        x = jnp.where(accepted, xt, x)
        fx = jnp.where(accepted, ft, fx)
        fnorm_new = jnp.where(accepted, nt, fnorm)
        hist = hist.at[i].set(fnorm_new)
        status = jnp.where(
            fnorm_new < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS) & ~accepted,
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (
            (i + 1, x, fx, fnorm_new, fnorm, eta, inner_tot, u_rec),
            status,
            hist,
        )

    u_rec0 = (
        jnp.zeros((recycle_k,) + x0.shape, dtype)
        if use_recycling else jnp.zeros((0,), dtype)
    )
    carry0 = (
        (
            jnp.int32(0), x0, f0, fnorm0, fnorm0,
            jnp.asarray(eta0, rdtype), jnp.int32(0), u_rec0,
        ),
        status0,
        history,
    )
    (i, x, _, fnorm, _, _, inner_tot, _), status, history = \
        jax.lax.while_loop(cond, body, carry0)
    history = jnp.where(jnp.arange(max_newton) < i, history, fnorm)
    return NewtonResult(
        x=x,
        iterations=i,
        residual=fnorm,
        status=status,
        residual_history=history,
        inner_iterations=inner_tot,
    )
