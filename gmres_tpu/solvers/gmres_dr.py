"""GMRES-DR — GMRES with deflated restarting (Morgan, SIMAX 2002).

Beyond the reference: restarted GMRES (gmres_hh.f90:563-571) discards
the whole Krylov space at every restart, so convergence is throttled by
the operator's smallest eigenvalues being re-discovered cycle after
cycle — the effect behind the reference's restart-size tuning
(README.md:20). GMRES-DR(m, k) carries the k harmonic Ritz vectors of
smallest modulus across the restart: each new cycle minimizes over
span{y_1, …, y_k, r, A M⁻¹ r, …, (A M⁻¹)^{m-k-1} r}, which for matrices
with a few small outlying eigenvalues converges at close to full-GMRES
rate with restarted-GMRES memory.

Design (what makes this implementation different from the usual
LAPACK-coupled ones):

* The whole solve — including the per-restart harmonic Ritz
  eigenproblem — is ONE jitted ``lax.while_loop``: the small dense
  nonsymmetric eigensolve uses :mod:`gmres_tpu.ops.hessenberg_eig`
  (in-jit Householder reduction + shifted complex QR), not a host
  callback, so there are no per-restart host round-trips.
* The deflated lead block makes H̄ non-Hessenberg in its first k+1
  rows. Instead of special-casing the least-squares update, the dense
  lead transform Q₀ᵀ (QR of the lead block) is EMBEDDED into the
  accumulated-rotation matrix Ω that ops/givens.py already carries:
  after that, every Arnoldi column flows through the unmodified
  ``givens_step`` machinery and |g[t+1]| remains the running residual.
* Conjugate harmonic Ritz pairs are realified with fixed shapes: k+1
  column slots, Re/Im of one pair member per slot, and the effective
  count k_eff ∈ {k, k+1} handles a pair straddling the cut (Morgan's
  k±1 adjustment) without dynamic shapes.
* All small-matrix work (eig, QR, projections) is replicated on every
  chip — O(m³) with m ≤ ~100 is microseconds and communication-free;
  the long-vector work per restart is k+2 basis contractions, i.e. one
  (m+1)×(m+1) tensordot.
* An unusable deflation (eig non-converged, non-finite projection, or
  an early-exit cycle with < m columns) falls back to an undeflated
  restart (k_eff = 0) for that cycle — the first cycle IS that case,
  so the code path is uniform and always exercised.

M must be LINEAR (fixed): the solution update applies M once to the
combined correction (M⁻¹V y = M(V y)); use fgmres for nonlinear or
iteration-varying preconditioners.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.tri import solve_small
from gmres_tpu.ops.blas import row_combine, tree_vdot
from gmres_tpu.ops.givens import GivensState, givens_step
from gmres_tpu.ops.hessenberg_eig import (
    eig_select,
    smallest_invariant_subspace,
)
from gmres_tpu.ops.tri import masked_back_substitution
from gmres_tpu.solvers.gmres import _as_operator, _cgs_pass, _v_err_mgsr
from gmres_tpu.types import (
    GmresResult,
    Preconditioner,
    SolverStatus,
)


def gmres_dr(
    A,
    b: jnp.ndarray,
    *,
    restart: int = 30,
    deflate: int = 10,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    x0: Optional[jnp.ndarray] = None,
    compute_v_err: bool = False,
    deflation: str = "eig",
) -> GmresResult:
    """Solve A x = b by GMRES-DR(restart, deflate) (module docstring).

    Args:
      restart: total subspace dimension m per cycle (deflated vectors
        plus new Krylov directions).
      deflate: number k of smallest-modulus harmonic Ritz vectors kept
        across restarts (clamped to m-2; 0 = plain restarted GMRES with
        right preconditioning).
      M: LINEAR right preconditioner (fixed operator).
      compute_v_err: orthogonality audit of the last cycle's basis.
      deflation: "eig" (exact harmonic-Ritz eigenvectors, default) or
        "subspace" (real-only inverse subspace iteration,
        ops/hessenberg_eig.py:smallest_invariant_subspace).
    """
    op = _as_operator(A)
    dtype = b.dtype
    if b.size == 1:
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
    k = max(min(int(deflate), m - 2), 0)
    if deflation not in ("eig", "subspace"):
        raise ValueError(f"unknown deflation {deflation!r}")
    kb = k + 1  # realification slot budget (pair may straddle the cut)
    tiny = jnp.finfo(dtype).tiny
    eps = jnp.finfo(dtype).eps
    beta0 = jnp.sqrt(tree_vdot(b, b))

    def apply_m(v):
        return M(v) if M is not None else v

    # ------------------------------------------------------------------
    # One deflated cycle. Inputs: solution x, carried basis slots
    # v_init (m+1, *shape) with slots 0..keff holding V_new, raw lead
    # block hlead (m+1, m) with cols 0..keff-1 set, rhs coordinates
    # c_ext (m+1,), effective deflation count keff (traced).
    # ------------------------------------------------------------------
    def cycle(v_init, hlead, c_ext, keff):
        # Lead-block triangularization: Q0 from the QR of the square
        # (kb+1)x(kb+1) lead matrix whose inactive columns are identity
        # columns (keff=0 => A0=I => Q0=I: the undeflated first cycle
        # flows through the same path untouched).
        lead = hlead[: kb + 1, :kb]
        cols_kb = jnp.arange(kb)
        eye_kb1 = jnp.eye(kb + 1, dtype=dtype)
        a0 = jnp.where(
            cols_kb[None, :] < keff, lead, eye_kb1[:, :kb]
        )
        a0 = jnp.concatenate([a0, eye_kb1[:, kb:]], axis=1)
        q0, r0 = jnp.linalg.qr(a0, mode="complete")
        omega = jnp.eye(m + 1, dtype=dtype)
        omega = omega.at[: kb + 1, : kb + 1].set(q0.T)
        giv = GivensState(
            omega=omega, g=omega @ c_ext,
            beta0=jnp.maximum(beta0, tiny),
        )
        hmat = jnp.zeros((m + 1, m), dtype=dtype)
        hmat = hmat.at[: kb + 1, :kb].set(
            jnp.where(cols_kb[None, :] < keff, r0[:, :kb], 0.0)
        )
        hraw = jnp.zeros((m + 1, m), dtype=dtype)
        hraw = hraw.at[:, :kb].set(
            jnp.where(cols_kb[None, :] < keff, hlead[:, :kb], 0.0)
        )
        ferr = jnp.zeros((m,), dtype=dtype)

        def body(st):
            (t, v_basis, hraw, hmat, giv, hb, ferr), _ = st
            v_t = jax.lax.dynamic_index_in_dim(
                v_basis, t, axis=0, keepdims=False
            )
            with jax.named_scope("gmres_dr.precond"):
                z_t = apply_m(v_t)
            with jax.named_scope("gmres_dr.spmv"):
                w = op(z_t)
            with jax.named_scope("gmres_dr.orthogonalize"):
                h1, w = _cgs_pass(v_basis, w)
                h2, w = _cgs_pass(v_basis, w)
            h_val = jnp.sqrt(tree_vdot(w, w))
            hcol = (h1 + h2).at[t + 1].set(h_val)
            hraw = jax.lax.dynamic_update_slice(
                hraw, hcol[:, None], (jnp.zeros((), t.dtype), t)
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
            converged = (rel < tol) | (h_val < tol)
            return (
                (t + 1, v_basis, hraw, hmat, giv, h_val, ferr),
                converged,
            )

        def cond(st):
            (t, *_), converged = st[0], st[1]
            return (t < m) & (~converged)

        st0 = (
            (keff.astype(jnp.int32), v_init, hraw, hmat, giv,
             jnp.ones((), dtype), ferr),
            jnp.array(False),
        )
        (t, v_basis, hraw, hmat, giv, hb, ferr), _ = jax.lax.while_loop(
            cond, body, st0
        )
        n_out = t
        y = masked_back_substitution(hmat, giv.g, n_out)
        with jax.named_scope("gmres_dr.update"):
            combo = row_combine(y, v_basis[:m])
            dx = apply_m(combo)
        # LS residual in V_{m+1} coordinates (drives the next cycle).
        c_resid = c_ext - hraw @ y
        return dx, n_out, ferr, hraw, hmat, c_resid, v_basis, hb

    # ------------------------------------------------------------------
    # Harmonic Ritz deflation: next cycle's carried quantities.
    # ------------------------------------------------------------------
    def deflation(hraw, c_resid, v_basis, usable):
        hm = hraw[:m, :m]
        h2 = hraw[m, m - 1] ** 2
        em = jnp.zeros((m,), dtype).at[m - 1].set(1.0)
        # Harmonic problem: (H + h_{m+1,m}^2 f e_m^T) g = theta g with
        # f = H^{-T} e_m  — only the LAST column is modified.
        f = solve_small(hm.T, em)  # pure-jnp LU (ops/tri.py)
        cmat = hm.at[:, m - 1].add(h2 * f)
        if deflation == "subspace":
            # REAL-only extraction (see gcrodr's deflation doc): an
            # orthonormal k-dim span from inverse subspace iteration;
            # no conjugate-pair bookkeeping — a straddling pair is
            # mixed into the span, which deflates its modulus class.
            if k > 0:
                zsub, ok = smallest_invariant_subspace(cmat, k)
            else:
                zsub = jnp.zeros((m, 0), dtype)
                ok = jnp.array(True)
            keff = jnp.int32(k)
            cols = jnp.zeros((m, kb), dtype)
            if k > 0:
                cols = cols.at[:, :k].set(zsub.astype(dtype))
        else:
            vals, vecs, ok = eig_select(cmat, kb, which="smallest")
            # Realify: slot i takes Re(g_i), or Im(g_{i-1}) when
            # theta_i is the conjugate partner of theta_{i-1}
            # (equal-modulus adjacency after the sort).
            ptol = 64.0 * eps
            prev = jnp.roll(vals[:kb], 1)
            mods = jnp.abs(vals[:kb])
            pair_second = (
                (jnp.arange(kb) >= 1)
                & (jnp.abs(vals[:kb] - jnp.conj(prev))
                   <= ptol * (mods + 1.0))
                & (jnp.abs(vals[:kb].imag) > ptol * (mods + 1.0))
            )
            if k > 0:
                keff = jnp.int32(k) + pair_second[k].astype(jnp.int32)
            else:
                keff = jnp.int32(0)
            cols = jnp.where(
                pair_second[None, :],
                jnp.roll(vecs, 1, axis=1).imag,
                vecs.real,
            ).astype(dtype)
            cols = jnp.where(jnp.arange(kb)[None, :] < keff, cols, 0.0)
        p_m, _ = jnp.linalg.qr(cols)  # (m, kb)
        p_m = jnp.where(jnp.arange(kb)[None, :] < keff, p_m, 0.0)
        pbar = jnp.zeros((m + 1, kb + 1), dtype).at[:m, :kb].set(p_m)
        # Residual direction -> slot keff (CGS2 against the P columns;
        # zero columns are neutral).
        cperp = c_resid - pbar @ (pbar.T @ c_resid)
        cperp = cperp - pbar @ (pbar.T @ cperp)
        cnorm = jnp.sqrt(jnp.sum(cperp * cperp))
        cunit = cperp / jnp.where(cnorm > 0, cnorm, 1.0)
        pbar = jax.lax.dynamic_update_slice(
            pbar, cunit[:, None], (jnp.zeros((), jnp.int32), keff)
        )
        # Projected lead block and rhs coordinates for the next cycle.
        hp = hraw @ p_m                       # (m+1, kb)
        hlead_small = pbar.T @ hp             # (kb+1, kb)
        hlead = jnp.zeros((m + 1, m), dtype)
        hlead = hlead.at[: kb + 1, :kb].set(hlead_small)
        c_ext = jnp.zeros((m + 1,), dtype)
        c_ext = c_ext.at[: kb + 1].set(pbar.T @ c_resid)
        # Transform the long basis: one (m+1)x(m+1) contraction.
        tmat = jnp.zeros((m + 1, m + 1), dtype)
        tmat = tmat.at[: kb + 1, :].set(pbar.T)
        valid = (
            usable & ok
            & jnp.all(jnp.isfinite(hlead_small))
            & jnp.all(jnp.isfinite(c_ext))
            & jnp.all(jnp.isfinite(p_m))
            & (cnorm > 0)
        )
        # Fallback: undeflated restart from the coordinate residual.
        crn = jnp.sqrt(jnp.sum(c_resid * c_resid))
        cr_unit = c_resid / jnp.where(crn > 0, crn, 1.0)
        tmat_fb = jnp.zeros((m + 1, m + 1), dtype).at[0, :].set(cr_unit)
        c_ext_fb = jnp.zeros((m + 1,), dtype).at[0].set(crn)
        keff = jnp.where(valid, keff, 0)
        tmat = jnp.where(valid, tmat, tmat_fb)
        hlead = jnp.where(valid, hlead, jnp.zeros_like(hlead))
        c_ext = jnp.where(valid, c_ext, c_ext_fb)
        v_init = row_combine(tmat.T, v_basis)
        return v_init, hlead, c_ext, keff

    def true_residual(x):
        r = b - op(x)
        beta = jnp.sqrt(tree_vdot(r, r))
        return r, beta, beta / jnp.maximum(beta0, tiny)

    r_init, beta_init, rel_init = true_residual(x0)
    bsafe = jnp.where(beta_init > 0, beta_init, jnp.ones_like(beta_init))
    converged0 = (beta0 == 0) | (rel_init < tol)
    v_init0 = jnp.zeros((m + 1,) + shape, dtype=dtype)
    v_init0 = v_init0.at[0].set(r_init / bsafe)
    hlead0 = jnp.zeros((m + 1, m), dtype=dtype)
    c_ext0 = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta_init)

    def cond(carry):
        kcount, converged, breakdown = carry[1], carry[3], carry[4]
        return (kcount < max_restarts) & (~converged) & (~breakdown)

    def body(carry):
        (x, kcount, _, _, _, _, _, basis,
         v_init, hlead, c_ext, keff) = carry
        dx, n_out, ferr, hraw, hmat, c_resid, basis, hb = cycle(
            v_init, hlead, c_ext, keff
        )
        x_new = x + dx
        # Right preconditioning: the Givens estimate tracks the true
        # residual (reference trust semantics, gmres_hh.f90:563); the
        # exit certification below guards the deflated coordinates.
        last_rel = ferr[jnp.maximum(n_out - 1, 0)]
        converged = last_rel < tol
        breakdown = (hb < tol) & (~converged)
        breakdown = breakdown | ~jnp.all(jnp.isfinite(c_resid))
        # Deflation usable only from a full-length, continuing cycle.
        usable = (n_out == m) & (~converged) & (~breakdown) & (k > 0)
        v_init, hlead, c_ext, keff = deflation(
            hraw, c_resid, basis, usable
        )
        return (x_new, kcount + 1, last_rel, converged, breakdown,
                n_out, ferr, basis, v_init, hlead, c_ext, keff)

    carry0 = (
        x0, jnp.int32(0), rel_init, converged0,
        jnp.array(False), jnp.int32(0), jnp.zeros((m,), dtype=dtype),
        v_init0, v_init0, hlead0, c_ext0, jnp.int32(0),
    )
    (x, kcount, last_rel, converged, breakdown, n_out, ferr, v_basis,
     *_) = jax.lax.while_loop(cond, body, carry0)
    # Exit certification on the f64-true residual (PARITY quirk 8
    # disposition): deflated coordinate recurrences must not be trusted
    # for the final claim.
    _, _, rel_true = true_residual(x)
    certified = rel_true < tol * 10.0
    status = jnp.where(
        converged & certified,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            breakdown | (converged & ~certified),
            jnp.int32(SolverStatus.BREAKDOWN),
            jnp.int32(SolverStatus.MAX_ITERATIONS),
        ),
    )
    residual = jnp.where(kcount > 0, rel_true, rel_init)

    if compute_v_err:
        gram = (
            v_basis.reshape(m + 1, -1) @ v_basis.reshape(m + 1, -1).T
        ).astype(dtype)
        v_err = _v_err_mgsr(gram, n_out, dtype)
    else:
        v_err = jnp.zeros((m + 1,), dtype=dtype)
    return GmresResult(
        x=x, iterations=n_out, restarts=kcount, residual=residual,
        status=status, residual_history=ferr, v_err=v_err,
    )
