"""LGMRES — "loose" GMRES with augmented restarts (Baker, Jessup &
Manteuffel, SIMAX 2005).

Beyond the reference: its restarted GMRES throws away the whole Krylov
space at each restart (gmres_hh.f90:563-571 rebuilds from the bare
residual), which is what creates the restart "valley" the reference
tunes around (README.md:20, m ≈ 95) — successive restart cycles tend to
alternate between two polynomial patterns and stall. LGMRES(m, k)
appends the last k outer-iteration error approximations
z_i = x_i − x_{i−1} to each new Krylov space, approximately restoring
the information the restart discarded; small k (2-3) with modest m
typically tracks full GMRES convergence where GMRES(m) stagnates.

Design notes (same playbook as fgmres.py, whose flexible-Arnoldi
cycle this generalizes):

* One cycle = m Krylov steps followed by up to k augmentation steps in
  a single fixed-trip ``lax.while_loop`` — the solution space is
  span{K_m(A M⁻¹, r)} ∪ {z's} exactly as in the paper, built through
  the flexible relation A Z = V H̄ so the Givens least-squares
  machinery (ops/givens.py) is unchanged.
* The augmentation pairs (z_i, A z_i) live in fixed (k, …) circular
  buffers carried through the restart ``while_loop``; A z_i is obtained
  for FREE from the restart boundary's residuals (A Δx = r_prev −
  r_new — no extra matvec, no extra preconditioner application), and
  augmented steps inside the cycle apply neither A nor M
  (``lax.cond`` keeps the skipped operator out of the executed path).
  Pairs are stored ‖A z‖-normalized in the OUTER dtype.
* A dependent augmentation direction (CGS2 remainder ≈ 0) must not
  poison the basis or masquerade as breakdown: its basis slot and
  Hessenberg subdiagonal are zeroed (a zero vector is CGS2-neutral)
  and the happy-breakdown exit applies to Krylov steps only.
* Mixed precision (``inner_dtype=float32``): identical contract to
  fgmres — work-dtype bases with β-normalized casts, f64 x/residuals,
  restart-boundary certification on the f64 true residual.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, tree_vdot
from gmres_tpu.ops.givens import givens_init, givens_step
from gmres_tpu.ops.tri import masked_back_substitution
from gmres_tpu.solvers.gmres import _as_operator, _cgs_pass, _v_err_mgsr
from gmres_tpu.types import (
    GmresResult,
    Preconditioner,
    SolverStatus,
)


def lgmres(
    A,
    b: jnp.ndarray,
    *,
    restart: int = 30,
    aug: int = 3,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    inner_dtype=None,
    x0: Optional[jnp.ndarray] = None,
    compute_v_err: bool = False,
) -> GmresResult:
    """Solve A x = b by LGMRES(restart, aug) (module docstring).

    Args:
      restart: Krylov dimension m per cycle (cycle subspace is m + aug).
      aug: number of previous outer corrections appended per cycle;
        ``aug=0`` is exactly restarted FGMRES.
      M: right preconditioner (may be nonlinear / iteration-varying,
        same contract as :func:`gmres_tpu.fgmres`).
      inner_dtype: work dtype for the cycle (float32 = fast path);
        convergence is then certified on the f64 true residual.
      compute_v_err: orthogonality audit of the last cycle's V basis.
    """
    op = _as_operator(A)
    dtype = b.dtype
    if b.size == 1:
        # Degenerate 1×1 system (same semantics as fgmres's guard).
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
    k_aug = max(int(aug), 0)
    s = m + k_aug
    work_dtype = jnp.dtype(inner_dtype) if inner_dtype is not None \
        else dtype
    mixed = work_dtype != dtype
    tiny = jnp.finfo(dtype).tiny
    eps_work = float(jnp.finfo(work_dtype).eps)
    beta0 = jnp.sqrt(tree_vdot(b, b))
    inner_gain = eps_work * 10.0

    def cycle(x, r, beta, aug_z, aug_w, n_aug):
        bsafe = jnp.where(beta > 0, beta, jnp.ones_like(beta))
        v_basis = jnp.zeros((s + 1,) + shape, dtype=work_dtype)
        v_basis = v_basis.at[0].set((r / bsafe).astype(work_dtype))
        z_basis = jnp.zeros((s,) + shape, dtype=work_dtype)
        giv = givens_init(s, jnp.zeros((s + 1,), dtype).at[0].set(beta))
        giv = giv._replace(beta0=jnp.maximum(beta0, tiny))
        hmat = jnp.zeros((s + 1, s), dtype=dtype)
        ferr = jnp.zeros((s,), dtype=dtype)
        # Same floors as fgmres: right preconditioning keeps the Givens
        # estimate in the true residual norm, so tol is a valid floor;
        # mixed mode adds the work-dtype per-cycle progress limit.
        if mixed:
            inner_floor = jnp.maximum(
                jnp.asarray(tol, dtype),
                (beta / jnp.maximum(beta0, tiny)) * inner_gain,
            )
        else:
            inner_floor = jnp.asarray(tol, dtype)

        def krylov_dir(t, v_basis):
            v_t = jax.lax.dynamic_index_in_dim(
                v_basis, t, axis=0, keepdims=False
            )
            with jax.named_scope("lgmres.precond"):
                z_t = (M(v_t) if M is not None else v_t).astype(
                    work_dtype
                )
            with jax.named_scope("lgmres.spmv"):
                w = op(z_t).astype(work_dtype)
            return z_t, w

        def aug_dir(t, _v_basis):
            j = t - m
            z_t = jax.lax.dynamic_index_in_dim(
                aug_z, j, axis=0, keepdims=False
            ).astype(work_dtype)
            w = jax.lax.dynamic_index_in_dim(
                aug_w, j, axis=0, keepdims=False
            ).astype(work_dtype)
            return z_t, w

        def body(st):
            (t, v_basis, z_basis, hmat, giv, hb, n_out, ferr), _ = st
            is_krylov = t < m
            if k_aug > 0:
                z_t, w = jax.lax.cond(
                    is_krylov, krylov_dir, aug_dir, t, v_basis
                )
            else:
                z_t, w = krylov_dir(t, v_basis)
            z_basis = z_basis.at[t].set(z_t)
            with jax.named_scope("lgmres.orthogonalize"):
                h1, w = _cgs_pass(v_basis, w)
                h2, w = _cgs_pass(v_basis, w)
            h_val = jnp.sqrt(tree_vdot(w, w))
            # Dependent augmentation direction: zero its basis slot and
            # subdiagonal instead of normalizing CGS2 noise into the
            # basis (a zero vector contributes nothing to later CGS2
            # passes; the LS columns stay exact). Stored A z pairs have
            # unit f64 norm, so eps_work scales the remainder test.
            dependent = (~is_krylov) & (
                h_val.astype(dtype) < 100.0 * eps_work
            )
            h_sub = jnp.where(dependent, jnp.zeros_like(h_val), h_val)
            hcol = (h1 + h2).astype(dtype).at[t + 1].set(
                h_sub.astype(dtype)
            )
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat = jax.lax.dynamic_update_slice(
                hmat, col[:, None], (jnp.zeros((), t.dtype), t)
            )
            rel = jnp.abs(g_next) / giv.beta0
            ferr = ferr.at[t].set(rel)
            v_next = jnp.where(
                dependent,
                jnp.zeros_like(w),
                w / jnp.where(h_val > 0, h_val, 1.0),
            )
            v_basis = v_basis.at[t + 1].set(v_next)
            # Happy breakdown exits on Krylov steps only — an exhausted
            # augmentation direction is routine, not termination.
            converged = (rel < inner_floor) | (
                is_krylov & (h_val.astype(dtype) < tol)
            )
            hb = jnp.where(is_krylov, h_val.astype(dtype), hb)
            return (
                (t + 1, v_basis, z_basis, hmat, giv, hb, t + 1, ferr),
                converged,
            )

        def cond(st):
            (t, *_), converged = st[0], st[1]
            return (t < m + n_aug) & (~converged)

        st0 = (
            (jnp.int32(0), v_basis, z_basis, hmat, giv,
             jnp.ones((), dtype), jnp.int32(0), ferr),
            jnp.array(False),
        )
        (t, v_basis, z_basis, hmat, giv, hb, n_out, ferr), _ = (
            jax.lax.while_loop(cond, body, st0)
        )
        y = masked_back_substitution(hmat, giv.g, n_out)
        # Δx = Z y (β-normalized cast, f64 rescale — scale invariance).
        dx = row_combine((y / bsafe).astype(work_dtype), z_basis)
        return bsafe * dx.astype(dtype), n_out, ferr, hb, v_basis

    # ------------------------------------------------------------------
    # Restart driver. Mirrors gmres._restarted's contract but carries
    # the augmentation circular buffers; A z comes from the residual
    # difference at the boundary (A Δx = r_prev − r_new), so each outer
    # iteration harvests one pair at zero operator cost.
    # ------------------------------------------------------------------
    def true_residual(x):
        r = b - op(x)
        beta = jnp.sqrt(tree_vdot(r, r))
        return r, beta, beta / jnp.maximum(beta0, tiny)

    r_init, beta_init, rel_init = true_residual(x0)
    converged0 = (beta0 == 0) | (rel_init < tol)
    buf = max(k_aug, 1)
    aug_z0 = jnp.zeros((buf,) + shape, dtype=dtype)
    aug_w0 = jnp.zeros((buf,) + shape, dtype=dtype)

    def _set_rel(ferr, n_out, rel):
        if mixed:
            return ferr.at[jnp.maximum(n_out - 1, 0)].set(rel)
        return ferr

    def cond(carry):
        k, converged, breakdown = carry[1], carry[4], carry[5]
        return (k < max_restarts) & (~converged) & (~breakdown)

    def body(carry):
        (x, k, r, beta, _, _, _, _, basis, aug_z, aug_w, n_aug) = carry
        dx, n_out, ferr, hb, basis = cycle(x, r, beta, aug_z, aug_w,
                                           n_aug)
        x_new = x + dx
        r_new, beta_new, rel_new = true_residual(x_new)
        if mixed:
            converged = rel_new < tol
        else:
            # Right preconditioning: the Givens estimate IS the true
            # relative residual — trust it (reference semantics,
            # gmres_hh.f90:563).
            converged = ferr[jnp.maximum(n_out - 1, 0)] < tol
        breakdown = (hb < tol) & (~converged)
        breakdown = breakdown | ~jnp.isfinite(beta_new)
        if k_aug > 0:
            az = r - r_new
            az_norm = jnp.sqrt(tree_vdot(az, az))
            ok = (az_norm > 0) & jnp.isfinite(az_norm)
            nz = jnp.where(ok, az_norm, jnp.ones_like(az_norm))
            aug_z = jnp.where(
                ok,
                jnp.roll(aug_z, 1, axis=0).at[0].set(dx / nz),
                aug_z,
            )
            aug_w = jnp.where(
                ok,
                jnp.roll(aug_w, 1, axis=0).at[0].set(az / nz),
                aug_w,
            )
            n_aug = jnp.where(
                ok, jnp.minimum(n_aug + 1, k_aug), n_aug
            )
        return (x_new, k + 1, r_new, beta_new, converged, breakdown,
                n_out, _set_rel(ferr, n_out, rel_new), basis,
                aug_z, aug_w, n_aug)

    carry0 = (
        x0, jnp.int32(0), r_init, beta_init, converged0,
        jnp.array(False), jnp.int32(0), jnp.zeros((s,), dtype=dtype),
        jnp.zeros((s + 1,) + shape, dtype=work_dtype),
        aug_z0, aug_w0, jnp.int32(0),
    )
    (x, k, _, beta_last, converged, breakdown, n_out, ferr, v_basis,
     _, _, _) = jax.lax.while_loop(cond, body, carry0)
    status = jnp.where(
        converged,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            breakdown,
            jnp.int32(SolverStatus.BREAKDOWN),
            jnp.int32(SolverStatus.MAX_ITERATIONS),
        ),
    )
    if mixed:
        residual = jnp.where(
            k > 0, ferr[jnp.maximum(n_out - 1, 0)], rel_init
        )
    else:
        residual = jnp.where(
            k > 0, ferr[jnp.maximum(n_out - 1, 0)],
            beta_last / jnp.maximum(beta0, tiny),
        )

    if compute_v_err:
        gram = (
            v_basis.reshape(s + 1, -1) @ v_basis.reshape(s + 1, -1).T
        ).astype(dtype)
        v_err = _v_err_mgsr(gram, n_out, dtype)
    else:
        v_err = jnp.zeros((s + 1,), dtype=dtype)
    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err,
    )
