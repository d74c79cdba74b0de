"""Flexible GMRES (FGMRES, Saad '93) — right preconditioning with a
possibly NONLINEAR / iteration-varying preconditioner.

Beyond the reference: its only preconditioning hook is a fixed linear
left application (``precond`` contract, interfaces.f90:19-28), under
which GMRES's Krylov-space theory requires M to be the SAME linear
operator at every application. FGMRES stores the preconditioned
directions z_t = M(v_t) in their own basis Z and minimizes the TRUE
residual over span(Z): M may be an inner iterative solve (CG/GMRES
with a fixed step budget — nonlinear in its input), a cycling
preconditioner, or anything else callable.

Design notes (same playbook as solvers/gmres.py):

* Two fixed-size bases — V (m+1, shape) for the Arnoldi vectors and
  Z (m, shape) for the preconditioned directions — zero-initialized so
  the CGS2 sweeps need no masks. Memory is 2× left-preconditioned
  GMRES; that is the algorithmic price of flexibility.
* The restart driver is the SHARED ``_restarted`` machinery of
  gmres.py (called with M=None: FGMRES's restart residual is the raw
  unpreconditioned one, and the Givens estimate |g(t+1)|/β₀ IS the
  true relative residual, since right preconditioning minimizes
  ‖b − A x‖ directly).
* CGS2 orthogonalization (one all-reduce per pass).
* Mixed precision (``inner_dtype=float32``): basis work in f32 with
  β-normalized casts (scale invariance), x/residuals in f64,
  restart-boundary convergence decided by the f64 true residual, and
  the inner loop floored at the work dtype's per-cycle progress limit
  (same floor as gmres.py — without it, cycles spin full restart
  length on f32 noise).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, tree_vdot
from gmres_tpu.ops.givens import givens_init, givens_step
from gmres_tpu.ops.tri import masked_back_substitution
from gmres_tpu.solvers.gmres import (
    _as_operator,
    _cgs_pass,
    _restarted,
    _v_err_mgsr,
)
from gmres_tpu.types import (
    GmresResult,
    Preconditioner,
    SolverStatus,
)


def fgmres(
    A,
    b: jnp.ndarray,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    inner_dtype=None,
    x0: Optional[jnp.ndarray] = None,
    compute_v_err: bool = False,
    breakdown_check: bool = True,
) -> GmresResult:
    """Solve A x = b by restarted FGMRES(restart) (module docstring).

    Args:
      M: right preconditioner applied to the Arnoldi vector each step,
        z_t = M(v_t). May be nonlinear / iteration-varying (an inner
        solver with a fixed step budget is the canonical use). None
        reduces to plain (unpreconditioned) GMRES.
      inner_dtype: work dtype for the V/Z bases and M/A applications
        inside the cycle (float32 = the fast path); convergence is
        then certified by the f64 true residual at restart boundaries.
      compute_v_err: orthogonality audit of V (‖I − VᵀV‖-style metric,
        same definition as the MGSR variant's).
    """
    op = _as_operator(A)
    dtype = b.dtype
    if b.size == 1:
        # Degenerate 1×1 system (same semantics as gmres's guard): the
        # machinery needs n ≥ m+1 ≥ 2; solve directly. FGMRES certifies
        # the unpreconditioned residual, so M never enters the norm.
        a_val = op(jnp.ones_like(b))
        singular = a_val == 0
        x = jnp.where(~singular, b / jnp.where(~singular, a_val, 1.0),
                      jnp.zeros_like(b))
        if x0 is not None:
            x = jnp.where(~singular, x, x0)
        r = b - op(x)
        residual = jnp.sqrt(tree_vdot(r, r)) / jnp.maximum(
            jnp.sqrt(tree_vdot(b, b)), jnp.finfo(dtype).tiny
        )
        status = jnp.where(
            residual < tol,
            jnp.int32(SolverStatus.CONVERGED),
            jnp.where(
                jnp.squeeze(singular),
                jnp.int32(SolverStatus.BREAKDOWN),
                jnp.int32(SolverStatus.MAX_ITERATIONS),
            ),
        )
        return GmresResult(
            x=x, iterations=jnp.int32(1), restarts=jnp.int32(1),
            residual=residual, status=status,
            residual_history=jnp.full((1,), residual, dtype=dtype),
            v_err=jnp.zeros((2,), dtype=dtype),
        )
    if x0 is None:
        x0 = jnp.zeros_like(b)
    shape = b.shape
    m = min(restart, b.size - 1)
    work_dtype = jnp.dtype(inner_dtype) if inner_dtype is not None \
        else dtype
    mixed = work_dtype != dtype
    tiny = jnp.finfo(dtype).tiny
    beta0 = jnp.sqrt(tree_vdot(b, b))
    inner_gain = float(jnp.finfo(work_dtype).eps) * 10.0

    def cycle(x, r, beta, beta0_arg, rel_prev):
        # rel_prev (the shared _restarted driver's boundary-certified
        # residual) is unused here: FGMRES is right-preconditioned, so
        # its Givens estimate already lives in the TRUE residual norm
        # and needs no cross-norm projection.
        del rel_prev
        bsafe = jnp.where(beta > 0, beta, jnp.ones_like(beta))
        v_basis = jnp.zeros((m + 1,) + shape, dtype=work_dtype)
        v_basis = v_basis.at[0].set((r / bsafe).astype(work_dtype))
        z_basis = jnp.zeros((m,) + shape, dtype=work_dtype)
        giv = givens_init(m, jnp.zeros((m + 1,), dtype).at[0].set(beta))
        giv = giv._replace(beta0=jnp.maximum(beta0_arg, tiny))
        hmat = jnp.zeros((m + 1, m), dtype=dtype)
        ferr = jnp.zeros((m,), dtype=dtype)
        # Same per-cycle progress floor as gmres.py: below ~ε_work of
        # the cycle-start residual, the f32 estimate no longer tracks
        # the true residual — stop the cycle instead of spinning.
        if mixed:
            inner_floor = jnp.maximum(
                jnp.asarray(tol, dtype),
                (beta / jnp.maximum(beta0_arg, tiny)) * inner_gain,
            )
        else:
            inner_floor = jnp.asarray(tol, dtype)

        def body(st):
            (t, v_basis, z_basis, hmat, giv, h_val_p, n_out, ferr), _ = st
            v_t = jax.lax.dynamic_index_in_dim(
                v_basis, t, axis=0, keepdims=False
            )
            with jax.named_scope("fgmres.precond"):
                # Cast M's output to work_dtype ONCE, and use the SAME
                # value for both the stored z_basis and op(z_t): if
                # they differ (cast only on store), the Arnoldi
                # relation and the solution-update basis disagree by
                # the rounding of the cast — harmless for correctness
                # (restarts certify the f64 true residual) but it costs
                # restarts and runs A at f64 inside a 'mixed' cycle.
                z_t = (M(v_t) if M is not None else v_t).astype(
                    work_dtype
                )
            z_basis = z_basis.at[t].set(z_t)
            with jax.named_scope("fgmres.spmv"):
                w = op(z_t).astype(work_dtype)
            with jax.named_scope("fgmres.orthogonalize"):
                h1, w = _cgs_pass(v_basis, w)
                h2, w = _cgs_pass(v_basis, w)
            h_val = jnp.sqrt(tree_vdot(w, w))
            hcol = (h1 + h2).astype(dtype).at[t + 1].set(
                h_val.astype(dtype)
            )
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat = jax.lax.dynamic_update_slice(
                hmat, col[:, None], (jnp.zeros((), t.dtype), t)
            )
            rel = jnp.abs(g_next) / giv.beta0
            ferr = ferr.at[t].set(rel)
            v_basis = v_basis.at[t + 1].set(
                w / jnp.where(h_val > 0, h_val, 1.0)
            )
            converged = rel < inner_floor
            if breakdown_check:
                # reference lucky-breakdown semantics: h_val is an
                # ABSOLUTE subdiagonal compared against a RELATIVE tol
                # — sound for tiny tolerances, a misfire at loose ones
                # (inexact-Newton forcing eta ~ 0.5 exits cycles at
                # t=3 and the outer then declares BREAKDOWN; measured
                # on 1024^2 Bratu). Gate it like gmres does.
                converged = converged | (h_val.astype(dtype) < tol)
            return (
                (t + 1, v_basis, z_basis, hmat, giv,
                 h_val.astype(dtype), t + 1, ferr),
                converged,
            )

        def cond(st):
            (t, *_), converged = st[0], st[1]
            return (t < m) & (~converged)

        st0 = (
            (jnp.int32(0), v_basis, z_basis, hmat, giv,
             jnp.zeros((), dtype), jnp.int32(0), ferr),
            jnp.array(False),
        )
        (t, v_basis, z_basis, hmat, giv, h_val, n_out, ferr), _ = (
            jax.lax.while_loop(cond, body, st0)
        )
        y = masked_back_substitution(hmat, giv.g, n_out)
        # x += Z y (β-normalized cast, f64 rescale — scale invariance).
        dx = row_combine((y / bsafe).astype(work_dtype), z_basis)
        x = x + bsafe * dx.astype(dtype)
        return x, n_out, ferr, h_val, v_basis

    # Shared restart driver with M=None: the restart residual IS the
    # unpreconditioned one (right preconditioning), and mixed-mode
    # certification uses the f64 true residual — exactly _restarted's
    # M=None semantics.
    basis_init = jnp.zeros((m + 1,) + shape, dtype=work_dtype)
    x, k, n_out, ferr, v_basis, status, residual = _restarted(
        cycle, op, b, x0, m, tol, max_restarts, None, mixed,
        breakdown_check=breakdown_check, basis_init=basis_init,
        certify_true=False, work_dtype=work_dtype,
    )

    if compute_v_err:
        gram = (
            v_basis.reshape(m + 1, -1) @ v_basis.reshape(m + 1, -1).T
        ).astype(dtype)
        v_err = _v_err_mgsr(gram, n_out, dtype)
    else:
        v_err = jnp.zeros((m + 1,), dtype=dtype)
    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err,
    )
