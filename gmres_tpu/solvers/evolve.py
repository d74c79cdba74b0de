"""Implicit θ-method time integration driven by the library's solvers.

Beyond the reference (steady solves only, one program per system —
src/tests/*.f90 each solve ONE system and exit): time-dependent PDEs
    u_t + L u = f(t),   u(0) = u0
are the production workload that issues a SEQUENCE of linear systems —
one per step, every step sharing the shifted operator S = I + θΔt·L.
The θ-method update is

    (I + θΔt·L) u_{n+1} = (I − (1−θ)Δt·L) u_n + Δt·(θ f_{n+1} + (1−θ) f_n)

with θ=1 backward Euler (L-stable, first order), θ=1/2
Crank–Nicolson (A-stable, second order).

Device shape: the ENTIRE trajectory is one jittable program — a
``lax.scan`` over steps whose body runs a while_loop Krylov solver —
so a 1000-step integration is ONE dispatch, with no host round-trips
between steps.

Sequence synergies the step loop exploits:
  * Warm starts: every step seeds its solver with x0 = u_n — the
    solution moves O(Δt) per step, so the initial residual is already
    O(Δt·‖L u‖) instead of O(‖u‖).
  * solver="gcrodr": the recycle block rides the scan carry, so step
    n+1 starts with the slow modes of S deflated by step n's
    harmonic-Ritz extraction (solvers/gcrodr.py) — the steady operator
    across steps is the ideal recycling scenario (the subspace import
    is exact, no re-derivation loss).

The spatial operator L follows the library's sign convention: the
POSITIVE (semi-)definite discrete −Δ (models/poisson.py:42,
``poisson_spectral_bounds``'s λ > 0), so pure diffusion decays:
an eigenmode φ with L φ = λ φ evolves as
u_n = ρ(λ)^n u0, ρ = (1 − (1−θ)Δt λ)/(1 + θΔt λ) — the exact check
tests/test_evolve.py pins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import jax
import jax.numpy as jnp

from gmres_tpu.types import Preconditioner, SolverStatus


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EvolveResult:
    """Trajectory-level result of :func:`theta_evolve`.

    Attributes:
      u: state after n_steps.
      iterations: (n_steps,) int32 — solver iterations per step (inner
        iterations for gmres/gcrodr, including the recycle import
        cost for gcrodr).
      residuals: (n_steps,) per-step final solver residual (absolute
        for cg/bicgstab — reference cg.f90:37 semantics — relative for
        gmres/gcrodr).
      statuses: (n_steps,) int32 per-step SolverStatus.
      status: scalar int32 — the WORST per-step status (CONVERGED only
        when every step converged; certification is per-step, so one
        failed step poisons the trajectory verdict rather than hiding
        in an average).
      inner_total: int32 total solver iterations across the
        trajectory (the cost number recycling/warm starts reduce).
      trajectory: (n_steps, *shape) per-step states when
        ``save_trajectory=True``; a (0,) placeholder otherwise (kept
        shape-static for jit).
    """

    u: Any
    iterations: jnp.ndarray
    residuals: jnp.ndarray
    statuses: jnp.ndarray
    status: jnp.ndarray
    inner_total: jnp.ndarray
    trajectory: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


def theta_evolve(
    L,
    u0: jnp.ndarray,
    *,
    dt: float,
    n_steps: int,
    theta: float = 0.5,
    forcing: Optional[Union[jnp.ndarray, Callable]] = None,
    t0: float = 0.0,
    solver: str = "cg",
    M: Optional[Preconditioner] = None,
    tol: float = 1e-10,
    max_iterations: int = 500,
    restart: int = 40,
    max_restarts: int = 50,
    recycle_k: int = 10,
    save_trajectory: bool = False,
    explicit: Optional[Callable] = None,
    explicit_order: int = 2,
) -> EvolveResult:
    """Integrate u_t + L u + C(u) = f from u0 over n_steps of size dt
    (C = 0 unless ``explicit`` is given).

    Args:
      L: spatial operator callable (positive-definite convention, see
        module docstring) — e.g. ``poisson_operator(n)``,
        ``convection_diffusion_operator(n, gx, gy)``.
      u0: initial state (any array shape; solvers treat it as a
        vector).
      dt: step size (Δt·λ_max(L) may be arbitrarily large — the
        θ ≥ 1/2 methods are unconditionally stable; accuracy, not
        stability, sizes Δt).
      n_steps: number of steps (static — the scan length).
      theta: 1.0 backward Euler, 0.5 Crank–Nicolson (default), any
        θ ∈ [1/2, 1] is A-stable.
      forcing: None (f = 0), a constant array f, or a callable
        t ↦ f(t) evaluated at t_n and t_{n+1} for the θ-weighted
        average.
      t0: initial time (only meaningful with callable forcing).
      solver: "cg" (SPD L — heat equation), "bicgstab" or "gmres"
        (nonsymmetric L — convection-diffusion), or "gcrodr"
        (nonsymmetric with cross-step subspace recycling).
      M: optional preconditioner for S = I + θΔt·L (NOT for L — for
        moderate Δt·λ, S is well-conditioned and unpreconditioned
        iterations stay low). For STIFF steps (Δt·λmax ≫ 1) on the
        Poisson L, the library already owns the right cycle: with
        σ = 1/(θΔt), S = θΔt·(L + σI), and
        ``helmholtz_shifted_laplacian_preconditioner(n, kh2=σ,
        shift=1.0)`` is multigrid for (L + σI) with closed-form
        per-level smoothing bounds — pass
        ``M = lambda r: cycle(r) / (theta * dt)`` (the scalar keeps
        M ≈ S⁻¹; tests/test_evolve.py pins flat per-step iteration
        counts under it).
      tol / max_iterations / restart / max_restarts / recycle_k:
        passed through to the per-step solver (tol keeps each
        solver's own semantics — absolute for cg/bicgstab, relative
        for gmres/gcrodr).
      save_trajectory: stack every step's state into
        ``result.trajectory`` (n_steps × state memory — opt-in; the
        scan emits it as an output so there is still only ONE
        dispatch).
      explicit: optional term C(u) — possibly NONLINEAR (Burgers'
        u·∇u) or nonsymmetric (convection) — treated EXPLICITLY, so
        the implicit solve keeps only L: split convection-diffusion
        runs on CG with the SPD diffusion instead of
        BiCGSTAB/GMRES on the full operator (the classic IMEX trade;
        C is CFL-limited at Δt ≲ h/|b| where the implicit diffusion
        is not, usually the acceptable constraint).
      explicit_order: 2 (default) = Adams-Bashforth-2 on C
        (−Δt(3/2·C(uₙ) − 1/2·C(uₙ₋₁)); with θ = 1/2 this is the
        standard CNAB scheme, second order overall; the FIRST step
        falls back to explicit Euler on C), or 1 = explicit Euler
        every step.
    """
    if solver not in ("cg", "bicgstab", "gmres", "gcrodr"):
        raise ValueError(f"unknown solver {solver!r}")
    if not 0.0 <= theta <= 1.0:
        raise ValueError(f"theta must be in [0, 1], got {theta}")
    if explicit_order not in (1, 2):
        raise ValueError(f"explicit_order must be 1 or 2, got "
                         f"{explicit_order}")

    from gmres_tpu.solvers.bicgstab import bicgstab
    from gmres_tpu.solvers.cg import cg
    from gmres_tpu.solvers.gcrodr import gcrodr
    from gmres_tpu.solvers.gmres import gmres

    dtype = u0.dtype
    rdtype = jnp.finfo(dtype).dtype
    dt_c = jnp.asarray(dt, rdtype)
    th = jnp.asarray(theta, rdtype)

    def shifted(v):
        return v + (th * dt_c).astype(v.dtype) * L(v)

    if forcing is None:
        def f_avg(t_n):
            return jnp.zeros((), dtype)
    elif callable(forcing):
        def f_avg(t_n):
            return th * forcing(t_n + dt_c) + (1.0 - th) * forcing(t_n)
    else:
        f_const = jnp.asarray(forcing, dtype)

        def f_avg(t_n):
            return f_const

    def step(carry, xs):
        t_n, idx = xs
        u, rec, c_prev = carry
        # Explicit part: skip the wasted matvec for backward Euler.
        if theta == 1.0:
            rhs = u + dt_c * f_avg(t_n)
        else:
            rhs = u - ((1.0 - th) * dt_c) * L(u) + dt_c * f_avg(t_n)
        if explicit is not None:
            c_now = explicit(u)
            if explicit_order == 2:
                # AB2; first step has no history — explicit Euler.
                c_hat = jnp.where(
                    idx == 0, c_now, 1.5 * c_now - 0.5 * c_prev
                )
            else:
                c_hat = c_now
            rhs = rhs - dt_c * c_hat
            c_prev = c_now
        if solver == "cg":
            res = cg(shifted, rhs, tol=tol,
                     max_iterations=max_iterations, M=M, x0=u)
            inner = res.iterations
        elif solver == "bicgstab":
            res = bicgstab(shifted, rhs, tol=tol,
                           max_iterations=max_iterations, M=M, x0=u)
            inner = res.iterations
        elif solver == "gmres":
            res = gmres(shifted, rhs, restart=restart, tol=tol,
                        max_restarts=max_restarts, M=M, x0=u,
                        compute_v_err=False)
            inner = (jnp.maximum(res.restarts - 1, 0) * restart
                     + res.iterations)
        else:  # gcrodr — recycle rides the scan carry
            res = gcrodr(shifted, rhs, k=recycle_k, restart=restart,
                         tol=tol, max_restarts=max_restarts, M=M,
                         x0=u, recycle=rec)
            rec = res.recycle
            inner = recycle_k + (
                jnp.maximum(res.restarts - 1, 0)
                * (restart - recycle_k)
                + res.iterations
            )
        snap = res.x if save_trajectory else jnp.zeros((0,), dtype)
        return (res.x, rec, c_prev), (
            jnp.int32(inner),
            jnp.asarray(res.residual, rdtype),
            jnp.int32(res.status),
            snap,
        )

    # An all-zero block means "no recycle yet" (gcrodr seeds from its
    # first cycle); shape-static placeholder otherwise.
    rec0 = (
        jnp.zeros((recycle_k,) + u0.shape, dtype)
        if solver == "gcrodr" else jnp.zeros((0,), dtype)
    )
    c0 = (jnp.zeros_like(u0) if explicit is not None
          else jnp.zeros((0,), dtype))
    ts = t0 + dt_c * jnp.arange(n_steps, dtype=rdtype)
    (u, _, _), (iters, resids, statuses, traj) = jax.lax.scan(
        step, (u0, rec0, c0), (ts, jnp.arange(n_steps))
    )
    return EvolveResult(
        u=u,
        iterations=iters,
        residuals=resids,
        statuses=statuses,
        status=jnp.max(statuses),
        inner_total=jnp.sum(iters),
        trajectory=(traj if save_trajectory
                    else jnp.zeros((0,), dtype)),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ExpEvolveResult:
    """Result of :func:`exponential_evolve`.

    Attributes:
      u: state after n_steps.
      error_estimates: (n_steps,) per-step Saad indicators from the
        propagator's Krylov approximation (solvers/funm.py) — the
        TIME discretization itself is exact.
      trajectory: (n_steps, *shape) states when requested, else (0,).
    """

    u: Any
    error_estimates: jnp.ndarray
    trajectory: jnp.ndarray


def exponential_evolve(
    L,
    u0: jnp.ndarray,
    *,
    dt: float,
    n_steps: int,
    steps: int = 30,
    forcing: Optional[jnp.ndarray] = None,
    save_trajectory: bool = False,
) -> ExpEvolveResult:
    """Integrate u_t + L u = f (L symmetric positive definite, f
    CONSTANT or zero) by the exponential-Euler rule

        u_{n+1} = e^{−Δt·L} u_n + Δt·φ₁(−Δt·L) f,

    which is EXACT for this problem class — no O(Δt²) step error
    (contrast :func:`theta_evolve`; tests pin a single exponential
    step beating 32 Crank–Nicolson steps). Accuracy is set entirely
    by the per-step Krylov approximation of the semigroup action
    (``steps``, solvers/funm.py — superlinear in steps).

    Device shape: the forcing propagator g = Δt·φ₁(−ΔtL)f =
    (I − e^{−ΔtL})L⁻¹f is a FIXED vector — ONE Lanczos factorization
    at setup — so each scan step costs exactly one semigroup action
    (one CGS2-Arnoldi build + small eigh). Whole trajectory, one
    dispatch.

    Use theta_evolve instead when L is nonsymmetric, f varies in
    time, or a preconditioned solver is the cheaper per-step engine.
    """
    from gmres_tpu.solvers.funm import expm_multiply, funm_lanczos

    dtype = u0.dtype
    rdtype = jnp.finfo(dtype).dtype
    if forcing is None:
        g = jnp.zeros_like(u0)
    else:
        # Δt·φ₁(−Δt·λ) = (1 − e^{−Δt·λ})/λ, evaluated at Ritz values.
        g = funm_lanczos(
            L, jnp.asarray(forcing, dtype),
            lambda s: (1.0 - jnp.exp(-dt * s)) / s,
            steps=steps,
        ).y

    def step(u, _):
        r = expm_multiply(L, u, dt, steps=steps)
        u_new = r.y + g
        snap = u_new if save_trajectory else jnp.zeros((0,), dtype)
        return u_new, (jnp.asarray(r.error_estimate, rdtype), snap)

    u, (ests, traj) = jax.lax.scan(
        step, u0, None, length=n_steps
    )
    return ExpEvolveResult(
        u=u,
        error_estimates=ests,
        trajectory=(traj if save_trajectory
                    else jnp.zeros((0,), dtype)),
    )
