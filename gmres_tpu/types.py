"""Core result/status types shared by every solver.

The reference library returns solver state through out-arguments
(``final_err(:)``, ``v_err(:)``, ``n_out``, ``stages_out`` in
``src/gmres_hh.f90:10-18``; ``iter``/``res`` inout/out in
``src/cg.f90:11-17``). Here every solver returns a single pytree
dataclass so results flow through ``jit``/``vmap`` untouched.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import jax
import jax.numpy as jnp

# A linear operator is any callable y = A(x) mapping a vector (array or
# pytree of arrays) to a vector of the same structure. This is the JAX
# analogue of the reference's abstract `stencil_vector` interface
# (src/interfaces.f90:12-18): shape travels in the closure, not as an
# `n` argument inferred from sqrt(len(x)) (reference quirk, SURVEY §1).
LinearOperator = Callable[[Any], Any]

# A preconditioner is z = M⁻¹(r): same contract as the operator. The
# reference's `precond` interface (src/interfaces.f90:19-28) additionally
# threads the A-operator, a scratch buffer and a params array; in JAX all
# of that lives in the closure (see precond/chebyshev.py).
Preconditioner = Callable[[Any], Any]


class SolverStatus(enum.IntEnum):
    """Termination status. Stored as an int32 so it can live inside jit.

    The reference has no status concept — breakdown handling is the
    `h_val < tol` early exit (src/gmres_mgsr.f90:69) and non-convergence
    is silent (and leaves `iters` undefined in pbicgstab_omp,
    src/bicgstab.f90:106,181 — a quirk we deliberately fix, SURVEY §7
    quirk 1).
    """

    CONVERGED = 0
    MAX_ITERATIONS = 1
    BREAKDOWN = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Result of a CG / BiCGSTAB solve.

    Attributes:
      x: solution vector (same structure as b).
      iterations: number of iterations performed (int32).
      residual: final residual norm ‖r‖₂ (absolute, matching the
        reference's convergence test `res < tol` at src/cg.f90:37,
        src/bicgstab.f90:40).
      status: SolverStatus as int32.
      residual_history: per-iteration ‖r‖₂, length = max_iterations,
        padded with the final value past convergence (the reference
        prints only the final residual for CG/BiCGSTAB; the history is
        an addition for observability, SURVEY §5).
    """

    x: Any
    iterations: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray
    residual_history: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GmresResult:
    """Result of a restarted GMRES(m) solve.

    Mirrors the reference out-argument set of gmres_hh_prec_omp
    (src/gmres_hh.f90:388-397) / gmres_mgsr_omp (src/gmres_mgsr.f90:277):

    Attributes:
      x: solution vector.
      iterations: inner iterations in the final restart cycle
        (reference `n_out`).
      restarts: restart cycles performed (reference `stages_out` /
        `restart_out`).
      residual: final relative residual |g(j+1)|/β₀.
      status: SolverStatus int32.
      residual_history: (m,) per-inner-iteration relative residual of the
        *last* restart cycle — the reference's `final_err(:)` semantics
        (it is reset every restart, src/gmres_hh.f90:421 `g=0;P=0;H=0`).
      v_err: (m+1,) orthogonality-error audit; definition differs by
        variant exactly as in the reference (SURVEY §7 quirk 5):
        Householder uses Σ 2(Vᵢ·Vⱼ)² off-diagonal (gmres_hh.f90:587-591),
        MGSR uses the cumulative sqrt chain incl. diagonal deviation
        (gmres_mgsr.f90:414-420).
    """

    x: Any
    iterations: jnp.ndarray
    restarts: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray
    residual_history: jnp.ndarray
    v_err: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EigResult:
    """Result of a block eigensolve (solvers/lobpcg.py).

    No reference counterpart — the reference README claims Lanczos
    estimation it never implemented (README.md:11, SURVEY C10); this
    library's answer grew from bound estimation (solvers/lanczos.py)
    to a full preconditioned eigensolver.

    Attributes:
      eigenvalues: (k,) Ritz values, ascending.
      x: (k, *shape) orthonormal Ritz vectors (rows).
      iterations: LOBPCG iterations performed (int32).
      residuals: (k,) final ‖A xᵢ − λᵢ xᵢ‖₂ (xᵢ unit-norm, so this is
        an absolute per-pair residual).
      status: SolverStatus int32 (CONVERGED iff every pair converged).
    """

    eigenvalues: jnp.ndarray
    x: Any
    iterations: jnp.ndarray
    residuals: jnp.ndarray
    status: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NewtonResult:
    """Result of a Jacobian-free Newton-Krylov solve
    (solvers/newton_krylov.py).

    No reference counterpart — the reference is linear-solves-only
    (src/interfaces.f90:12-28 has no nonlinear contract); JFNK exists
    here because JAX's ``jax.linearize`` gives the exact Jacobian
    action J(x)·v of any traceable residual for free, which a Fortran
    library must approximate by finite differences.

    Attributes:
      x: solution with ‖F(x)‖₂ ≤ tol (on CONVERGED).
      iterations: Newton steps performed (int32).
      residual: final ‖F(x)‖₂ — always the freshly evaluated nonlinear
        residual at the returned x (no recurrence to certify).
      status: SolverStatus int32; BREAKDOWN = the Armijo line search
        could not find a decreasing step (stagnation / NaN).
      residual_history: per-Newton-step ‖F‖₂, length = max_newton,
        padded with the final value.
      inner_iterations: total linear (GMRES) inner iterations summed
        over all Newton steps — the matvec ≈ J·v application count.
    """

    x: Any
    iterations: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray
    residual_history: jnp.ndarray
    inner_iterations: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockSolveResult:
    """Result of a block (multi-RHS) solve.

    No reference counterpart (the reference is single-RHS throughout,
    src/interfaces.f90:12-18); block solvers exist here because a block
    of s right-hand sides turns the HBM-bound basis streaming into
    batched matmuls (docs/DESIGN.md §4c).

    Attributes:
      x: (s, *shape) stacked solutions.
      restarts: restart cycles performed (int32).
      residuals: (s,) final relative residual per right-hand side.
      residual: max over `residuals` (the convergence gate).
      status: SolverStatus int32 (CONVERGED iff every RHS converged).
    """

    x: Any
    restarts: jnp.ndarray
    residuals: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED
