"""Restarted GMRES(m) with Householder (Walker '84) and MGS-with-
reorthogonalization Arnoldi variants, plus a mixed-precision
iterative-refinement mode.

Reference: ``src/gmres_hh.f90`` (Householder: dense 10-112, omp 211-385,
preconditioned omp 388-566) and ``src/gmres_mgsr.f90`` (MGSR: dense
11-95, matrix-free 98-199, omp 277-421). This is a ground-up
accelerator design of the same algorithms:

* Fixed-size basis buffers (m+1, *shape), zero-initialized so that the
  j-dependent sweeps need no masks — zero rows contribute nothing.
  Everything under jit is static-shape matmul/elementwise work.
* Householder reflector products are kept in compact-WY form
  (ops/householder.py): applying j reflectors is two matmuls with
  ONE all-reduce instead of the reference's sequential 2j-dot sweep
  (gmres_hh.f90:453-485).
* Gram-Schmidt offers "mgs2" (faithful: sequential modified GS run
  exactly twice, gmres_mgsr.f90:341-360, as a lax.scan) and "cgs2"
  (classical GS twice: each pass is one V·w matmul + one rank-update —
  one all-reduce per pass instead of j; CGS2 ≈ MGS2 numerically, the
  deliberate trade documented in SURVEY §3.2).
* Givens least-squares updates on a replicated accumulated-rotation
  matrix (ops/givens.py); back-substitution via a masked static
  triangular solve (ops/tri.py). The small-matrix state (H, g, Ω, y)
  is always kept in the outer dtype.
* **Mixed precision (``inner_dtype=float32``)**: f32 halves the bytes
  of every basis and operator pass (and runs the fused f32 smoother
  kernel). Restarted GMRES *is* iterative refinement: each cycle solves a
  correction equation, and the restart recomputes the true residual.
  So the basis work of each cycle runs in f32
  while residuals, Hessenberg/Givens state, and solution updates stay
  f64; convergence is certified ONLY by the f64 true residual at
  restart boundaries (Carson-Higham GMRES-IR). Reaches the same 1e-8
  relative residual as pure f64; whether it is faster than native f64
  on a given card is a benchmark question.
* Convergence: relative residual |g(j+1)|/β₀ with β₀ = ‖b‖ (x₀ = 0),
  gmres_hh.f90:237,339; lucky-breakdown exit on h_val < tol
  (gmres_mgsr.f90:69). `check_inner=False` reproduces the reference
  quirk where gmres_hh_omp only tests at restart boundaries
  (gmres_hh.f90:340-344, SURVEY §7 quirk 2).
* Orthogonality audits reproduce each variant's own metric
  (calculate_verr gmres_hh.f90:568-593; the cumulative sqrt chain
  gmres_mgsr.f90:414-420). In mixed mode the audit reflects the f32
  basis (≈1e-14 floor instead of 1e-28).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops import householder as wy
from gmres_tpu.ops.blas import row_combine, row_contract, tree_vdot
from gmres_tpu.ops.flat import flat_get, flat_iota, mask_ge
from gmres_tpu.ops.givens import GivensState, givens_init, givens_step
from gmres_tpu.ops.tri import masked_back_substitution
from gmres_tpu.types import (
    GmresResult,
    LinearOperator,
    Preconditioner,
    SolverStatus,
)


def _as_operator(A) -> LinearOperator:
    """Accept a dense matrix (reference dense path, gmres_hh.f90:37) —
    jax OR numpy — or a callable operator."""
    import numpy as _np

    if isinstance(A, (jnp.ndarray, _np.ndarray)):
        mat = jnp.asarray(A)
        return lambda v: (mat.astype(v.dtype) @ v if v.dtype != mat.dtype
                          else mat @ v)
    if not callable(A):
        raise TypeError(
            f"A must be a dense matrix or a callable operator, got "
            f"{type(A)}"
        )
    return A


def _fortran_sign(a, b):
    """Fortran sign(a, b) = |a| * sign(b), with sign(0) = +."""
    return jnp.where(b >= 0, jnp.abs(a), -jnp.abs(a))


# ---------------------------------------------------------------------------
# Orthogonalization passes (MGSR variant).
# ---------------------------------------------------------------------------


def _cgs_pass(v_basis: jnp.ndarray, w: jnp.ndarray):
    """Classical Gram-Schmidt pass: h = V̄·w (one all-reduce), then
    w ← w − Vᵀh. Zero basis rows self-mask. The conjugate makes the
    same pass serve complex operators (elided for real dtypes).
    row_contract/row_combine pin HIGHEST precision (ops/blas.py)."""
    h = row_contract(v_basis, w, conj=True)
    w = w - row_combine(h, v_basis)
    return h, w


def _mgs_pass(v_basis: jnp.ndarray, w: jnp.ndarray):
    """Modified Gram-Schmidt pass, faithful to gmres_mgsr.f90:341-360:
    sequential over basis rows (lax.scan), one all-reduce per row.
    Zero rows are no-ops, so scanning the full buffer needs no mask."""

    def step(w, v_row):
        h = tree_vdot(v_row, w)  # ⟨v, w⟩: conjugate-linear in v
        return w - h * v_row, h

    w, h = jax.lax.scan(step, w, v_basis)
    return h, w


# ---------------------------------------------------------------------------
# Orthogonality audits.
# ---------------------------------------------------------------------------


def _v_err_mgsr(gram: jnp.ndarray, n_out, dtype) -> jnp.ndarray:
    """Cumulative orthogonality chain of gmres_mgsr.f90:414-420:
    v_err(j+1)² = v_err(j)² + Σ_{i≤j} 2(Vi·V_{j+1})² + ((V_{j+1}·V_{j+1})−1)².
    |·|² keeps the metric real for complex bases (identical for real)."""
    mp1 = gram.shape[0]
    rows = jnp.arange(mp1)[:, None]
    cols = jnp.arange(mp1)[None, :]
    off = jnp.where(cols < rows, jnp.abs(gram) ** 2, 0.0)
    a = 2.0 * jnp.sum(off, axis=1) + jnp.abs(jnp.diagonal(gram) - 1.0) ** 2
    active = (jnp.arange(mp1) >= 1) & (jnp.arange(mp1) <= n_out)
    a = jnp.where(active, a, 0.0)
    return jnp.sqrt(jnp.cumsum(a)).astype(dtype) * active.astype(dtype)


def _v_err_householder(gram: jnp.ndarray, n_out, dtype) -> jnp.ndarray:
    """v_err(i) = Σ_{j<i} 2(Vi·Vj)², i = 2..n_iter (calculate_verr,
    gmres_hh.f90:587-591). Returned (m+1,) with reference indexing
    (entry r ↔ Fortran v_err(r+1))."""
    mm = gram.shape[0]
    rows = jnp.arange(mm)[:, None]
    cols = jnp.arange(mm)[None, :]
    off = jnp.where(cols < rows, gram**2, 0.0)
    v = 2.0 * jnp.sum(off, axis=1)
    active = jnp.arange(mm) < n_out
    v = jnp.where(active, v, 0.0)
    return jnp.concatenate([v, jnp.zeros((1,), dtype=dtype)]).astype(dtype)


# ---------------------------------------------------------------------------
# Unified restarted driver.
#
# Each restart: (1) start from the preconditioned true residual w, β —
# computed in the OUTER dtype by the previous iteration (or the prologue);
# (2) run one Arnoldi cycle in the WORK dtype; (3) update x in the outer
# dtype; (4) compute the next true residual and decide convergence —
# from the inner Givens estimate in pure mode (reference semantics,
# gmres_hh.f90:563) or from the f64 true residual in mixed mode.
# ---------------------------------------------------------------------------


def _restarted(
    cycle: Callable,
    A: LinearOperator,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    mixed: bool,
    breakdown_check: bool,
    basis_init,
    certify_true: bool = False,
    work_dtype=None,
):
    dtype = b.dtype
    rdtype = jnp.finfo(dtype).dtype  # real counterpart (norms, history)
    beta0 = jnp.sqrt(jnp.real(tree_vdot(b, b)))
    tiny = jnp.finfo(dtype).tiny

    def true_residual(x):
        r = b - A(x)
        if M is None:
            w = r
        elif mixed and work_dtype is not None:
            # The preconditioned direction only SEEDS the next cycle,
            # which works in work_dtype anyway — so apply M at work
            # precision (taking its Pallas route: the f64 multigrid
            # V-cycle costs 38 ms at 4096² vs 2.9 ms in f32, per
            # restart). The r used for certify_true's norm stays f64.
            # NORMALIZE IN f64 BEFORE THE CAST: casting the raw
            # residual would break GMRES's scale invariance (‖b‖ ~
            # 1e39 overflows f32 → spurious BREAKDOWN; ‖b‖ ~ 1e-40
            # flushes to zero → false convergence). M is linear, so
            # M(r) = ‖r‖·M(r/‖r‖) exactly.
            r_norm = jnp.sqrt(jnp.real(tree_vdot(r, r)))
            scale = jnp.where(r_norm > 0, r_norm, jnp.ones_like(r_norm))
            w = M((r / scale).astype(work_dtype)).astype(dtype) * scale
        else:
            w = M(r)
        beta_w = jnp.sqrt(jnp.real(tree_vdot(w, w)))
        if certify_true:
            # Certification norm: the UNPRECONDITIONED residual — the
            # quantity benchmarks and users actually care about; with
            # a deep polynomial M the preconditioned norm can be a
            # large factor off in either direction.
            rel = jnp.sqrt(jnp.real(tree_vdot(r, r))) / jnp.maximum(
                beta0, tiny
            )
        else:
            rel = beta_w / jnp.maximum(beta0, tiny)
        return w, beta_w, rel

    w_init, beta_init, rel_init = true_residual(x0)
    converged0 = (beta0 == 0) | (rel_init < tol)

    def _set_rel(ferr, n_out, rel):
        """Fold the certified residual into the last active history
        slot (only when certification overrides the inner estimate —
        pure reference mode keeps final_err untouched)."""
        if mixed or certify_true:
            return ferr.at[jnp.maximum(n_out - 1, 0)].set(rel)
        return ferr

    def cond(carry):
        _, k, _, _, converged, breakdown, *_ = carry
        return (k < max_restarts) & (~converged) & (~breakdown)

    def body(carry):
        x, k, w, beta, _, _, _, _, _, rel_prev = carry
        x_new, n_out, ferr, h_val, basis = cycle(
            x, w, beta, beta0, rel_prev
        )
        w_new, beta_new, rel_new = true_residual(x_new)
        if mixed or certify_true:
            converged = rel_new < tol
        else:
            # Reference semantics: trust the inner Givens estimate
            # (gmres_hh.f90:563, gmres_mgsr.f90:409).
            converged = ferr[jnp.maximum(n_out - 1, 0)] < tol
        breakdown = (
            (h_val < tol) if breakdown_check else jnp.array(False)
        )
        breakdown = breakdown & (~converged)
        # NaN/Inf escaping the operator or preconditioner must not run
        # silently to max_restarts (the reference's non-convergence is
        # silent — SURVEY §7 quirk 1).
        breakdown = breakdown | ~jnp.isfinite(beta_new)
        return (x_new, k + 1, w_new, beta_new, converged, breakdown,
                n_out, _set_rel(ferr, n_out, rel_new), basis, rel_new)

    carry0 = (
        x0,
        jnp.int32(0),
        w_init,
        beta_init,
        converged0,
        jnp.array(False),
        jnp.int32(0),
        jnp.zeros((m,), dtype=rdtype),
        basis_init,
        rel_init,
    )
    (x, k, _, beta_last, converged, breakdown, n_out, ferr, basis,
     _) = jax.lax.while_loop(cond, body, carry0)
    status = jnp.where(
        converged,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            breakdown,
            jnp.int32(SolverStatus.BREAKDOWN),
            jnp.int32(SolverStatus.MAX_ITERATIONS),
        ),
    )
    if mixed or certify_true:
        # The inner estimate is not trustworthy below f32 resolution
        # (and certify_true reports the unpreconditioned norm) — the
        # final certified value was folded into ferr by the body.
        residual = jnp.where(
            k > 0, ferr[jnp.maximum(n_out - 1, 0)], rel_init
        )
    else:
        residual = jnp.where(
            k > 0, ferr[jnp.maximum(n_out - 1, 0)],
            beta_last / jnp.maximum(beta0, tiny),
        )
    return x, k, n_out, ferr, basis, status, residual


# ---------------------------------------------------------------------------
# MGSR variant.
# ---------------------------------------------------------------------------


def _gmres_mgsr(
    A: LinearOperator,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    orthogonalization: str,
    check_inner: bool,
    compute_v_err: bool,
    work_dtype,
    certify_true: bool,
) -> GmresResult:
    dtype = b.dtype
    rdtype = jnp.finfo(dtype).dtype  # real counterpart for norms
    shape = b.shape
    mixed = work_dtype != dtype
    ortho = _cgs_pass if orthogonalization == "cgs2" else _mgs_pass
    # In mixed mode the inner estimate below ~ε_work of the cycle-start
    # residual no longer tracks the true residual — stop the cycle there.
    inner_gain = float(jnp.finfo(work_dtype).eps) * 10.0

    def inner_cond(st):
        (t, *_), converged = st[0], st[1]
        return (t < m) & (~converged)

    def make_inner_body(inner_floor):
        def inner_body(st):
            (t, v_basis, hmat, giv, h_val_prev, n_out, ferr), _ = st
            v_t = jax.lax.dynamic_index_in_dim(
                v_basis, t, axis=0, keepdims=False
            )
            with jax.named_scope("gmres.spmv"):
                z = A(v_t)
                w = M(z) if M is not None else z
            # MGS/CGS run exactly twice with H accumulation
            # (gmres_mgsr.f90:343 `do k=1,2`).
            with jax.named_scope("gmres.orthogonalize"):
                h1, w = ortho(v_basis, w)
                h2, w = ortho(v_basis, w)
            h_val = jnp.sqrt(jnp.real(tree_vdot(w, w)))
            hcol = (h1 + h2).astype(dtype).at[t + 1].set(
                h_val.astype(dtype)
            )
            giv, col, g_next = givens_step(giv, hcol, t)
            hmat = jax.lax.dynamic_update_slice(
                hmat, col[:, None], (jnp.zeros((), t.dtype), t)
            )
            rel = jnp.abs(g_next) / jnp.abs(giv.beta0)
            ferr = ferr.at[t].set(rel)
            # V(:,j+1) is written unconditionally, matching
            # gmres_mgsr_omp (gmres_mgsr.f90:384).
            v_new = w / jnp.where(h_val > 0, h_val, 1.0).astype(
                work_dtype
            )
            v_basis = v_basis.at[t + 1].set(v_new)
            if check_inner or mixed:
                converged = (rel < inner_floor) | (
                    h_val.astype(rdtype) < tol
                )
            else:
                converged = jnp.array(False)
            return (
                (t + 1, v_basis, hmat, giv, h_val.astype(rdtype), t + 1,
                 ferr),
                converged,
            )

        return inner_body

    def cycle(x, w, beta, beta0, rel_prev):
        w_work = (w / jnp.where(beta > 0, beta, 1.0)).astype(work_dtype)
        v_basis = jnp.zeros((m + 1,) + shape, dtype=work_dtype)
        v_basis = v_basis.at[0].set(w_work)
        g0 = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta)
        giv = givens_init(m, g0)
        giv = giv._replace(beta0=beta0.astype(dtype))
        hmat = jnp.zeros((m + 1, m), dtype=dtype)
        ferr = jnp.zeros((m,), dtype=rdtype)
        if certify_true:
            # Certification happens in a DIFFERENT norm (the
            # unpreconditioned residual) — the inner preconditioned
            # estimate must not treat tol as its own floor, or cycles
            # degenerate to single iterations once the preconditioned
            # residual dips below tol while the true residual is still
            # above it (observed: 1000 spinning restarts). Two floors:
            # (a) per-cycle PROGRESS — stop when the work dtype can no
            # longer improve this cycle's correction; (b) the TARGET
            # projected through the preconditioned/true norm ratio
            # measured at the restart boundary (beta/beta0 vs
            # rel_prev): stop near where certification will succeed
            # instead of burning the whole f32 progress budget
            # (measured at 2048² mg, tol 1e-8: the progress-only floor
            # overshot to a 1e-13 true residual, 29 inner iterations
            # where ~20 suffice; safety 0.1 biases toward one extra
            # cycle rather than a rejected certification).
            inner_floor = (beta / beta0) * jnp.maximum(
                inner_gain,
                0.1 * tol / jnp.maximum(
                    rel_prev, jnp.finfo(dtype).tiny
                ),
            )
        elif mixed:
            inner_floor = jnp.maximum(
                jnp.asarray(tol, rdtype), (beta / beta0) * inner_gain
            )
        else:
            inner_floor = jnp.asarray(tol, rdtype)

        st0 = (
            (jnp.int32(0), v_basis, hmat, giv, beta, jnp.int32(0), ferr),
            jnp.array(False),
        )
        (t, v_basis, hmat, giv, h_val, n_out, ferr), _ = (
            jax.lax.while_loop(
                inner_cond, make_inner_body(inner_floor), st0
            )
        )
        y = masked_back_substitution(hmat, giv.g, n_out)
        # x += Σ y_r V_r : one matmul over the basis
        # (gmres_mgsr.f90:400-406). y is β-scaled — normalize before
        # the work-dtype cast, rescale in f64 (scale invariance).
        bsafe = jnp.where(beta > 0, beta, jnp.ones_like(beta))
        dx = row_combine((y / bsafe).astype(work_dtype), v_basis[:m])
        x = x + bsafe * dx.astype(dtype)
        return x, n_out, ferr, h_val, v_basis

    basis_init = jnp.zeros((m + 1,) + shape, dtype=work_dtype)
    x, k, n_out, ferr, v_basis, status, residual = _restarted(
        cycle, A, b, x0, m, tol, max_restarts, M, mixed,
        breakdown_check=True, basis_init=basis_init,
        certify_true=certify_true, work_dtype=work_dtype,
    )

    if compute_v_err:
        vf = v_basis.reshape(m + 1, -1)
        gram = (jnp.conj(vf) @ vf.T).astype(dtype)  # Hermitian Gram
        v_err = _v_err_mgsr(gram, n_out, rdtype)
    else:
        v_err = jnp.zeros((m + 1,), dtype=rdtype)

    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err,
    )


# ---------------------------------------------------------------------------
# Householder (compact-WY) variant.
# ---------------------------------------------------------------------------


def _gmres_householder(
    A: LinearOperator,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    m: int,
    tol: float,
    max_restarts: int,
    M: Optional[Preconditioner],
    check_inner: bool,
    compute_v_err: bool,
    breakdown_check: bool,
    work_dtype,
    certify_true: bool,
) -> GmresResult:
    dtype = b.dtype
    shape = b.shape
    n = b.size
    mixed = work_dtype != dtype
    fidx = flat_iota(b)
    inner_gain = float(jnp.finfo(work_dtype).eps) * 10.0

    def inner_cond(st):
        (t, *_), converged = st[0], st[1]
        return (t < m) & (~converged)

    def make_inner_body(inner_floor):
        def inner_body(st):
            (t, p_basis, t_mat, hmat, giv, h_val_prev, n_out, ferr), _ = st
            # v_t = Q e_t (reference reflector sweep gmres_hh.f90:453-467
            # → compact-WY: P e_t is column t of P, so this is ONE
            # expand pass, no contraction).
            with jax.named_scope("gmres.basis_vector"):
                v_t = wy.wy_basis_vector(p_basis, t_mat, t)
            with jax.named_scope("gmres.spmv"):
                z = A(v_t)
                w = M(z) if M is not None else z
            # w ← Qᵀ w (gmres_hh.f90:471-485).
            with jax.named_scope("gmres.orthogonalize"):
                w = wy.wy_apply_transpose(p_basis, t_mat, w)

            # Hessenberg column: H[0:t+1, t] = w_flat[0:t+1]; H[t+1, t]
            # from the tail norm, Walker sign choice
            # (gmres_hh.f90:487-502).
            whead = jax.lax.slice(w.reshape(-1), (0,), (m + 1,))
            w_t1 = whead[t + 1]
            tail_sq = jnp.sum(jnp.where(fidx > t, w * w, 0.0))
            tmp = jnp.sqrt(tail_sq)
            h_sub = jnp.where(w_t1 > 0, -tmp, tmp)
            h_val = tmp.astype(dtype)
            idx = jnp.arange(m + 1)
            hcol = jnp.where(idx <= t, whead, 0.0)
            hcol = jnp.where(idx == t + 1, h_sub, hcol).astype(dtype)

            # New reflector: zero prefix, subtract H(t+1,t) at position
            # t+1, normalize (gmres_hh.f90:495-501). On lucky breakdown
            # (unorm == 0) the appended reflector is the zero vector,
            # which contributes exactly nothing in compact-WY algebra.
            u = mask_ge(w, t + 1)
            u = u - jnp.where(fidx == t + 1, h_sub, jnp.zeros_like(u))
            unorm = jnp.sqrt(tree_vdot(u, u))
            p_new = u / jnp.where(unorm > 0, unorm, 1.0)
            p_basis, t_mat = wy.wy_append(p_basis, t_mat, p_new, t + 1)

            giv, col, g_next = givens_step(giv, hcol, t)
            hmat = jax.lax.dynamic_update_slice(
                hmat, col[:, None], (jnp.zeros((), t.dtype), t)
            )
            rel = jnp.abs(g_next) / giv.beta0
            ferr = ferr.at[t].set(rel)
            if check_inner or mixed:
                converged = rel < inner_floor
                if breakdown_check:
                    converged = converged | (h_val < tol)
            else:
                converged = jnp.array(False)
            return (
                (t + 1, p_basis, t_mat, hmat, giv, h_val, t + 1, ferr),
                converged,
            )

        return inner_body

    def cycle(x, w, beta, beta0, rel_prev):
        # Initial reflector from w (gmres_hh.f90:433-436): g(1) =
        # −sign(β, w₁); w₁ += sign(β, w₁); P₁ = w/‖w‖.
        w0 = flat_get(w, 0)
        s = _fortran_sign(beta, w0)
        g0 = jnp.zeros((m + 1,), dtype=dtype).at[0].set(-s)
        # Normalize by β (in the OUTER dtype) before the work-dtype
        # cast: u is immediately normalized to P₁ anyway, and casting
        # the raw β-scaled vector would overflow/flush f32 for
        # ‖b‖ outside f32 range (scale invariance).
        u = (
            (w + jnp.where(fidx == 0, s, jnp.zeros_like(w)))
            / jnp.where(beta > 0, beta, jnp.ones_like(beta))
        ).astype(work_dtype)
        unorm = jnp.sqrt(tree_vdot(u, u))
        p_basis = jnp.zeros((m + 1,) + shape, dtype=work_dtype)
        p_basis = p_basis.at[0].set(u / jnp.where(unorm > 0, unorm, 1.0))
        t_mat = jnp.zeros((m + 1, m + 1), dtype=work_dtype)
        t_mat = t_mat.at[0, 0].set(2.0)
        giv = givens_init(m, g0)
        giv = giv._replace(beta0=beta0)
        hmat = jnp.zeros((m + 1, m), dtype=dtype)
        ferr = jnp.zeros((m,), dtype=dtype)
        if certify_true:
            # Certification happens in a DIFFERENT norm (the
            # unpreconditioned residual) — the inner preconditioned
            # estimate must not treat tol as its own floor, or cycles
            # degenerate to single iterations once the preconditioned
            # residual dips below tol while the true residual is still
            # above it (observed: 1000 spinning restarts). Two floors:
            # (a) per-cycle PROGRESS — stop when the work dtype can no
            # longer improve this cycle's correction; (b) the TARGET
            # projected through the preconditioned/true norm ratio
            # measured at the restart boundary (beta/beta0 vs
            # rel_prev): stop near where certification will succeed
            # instead of burning the whole f32 progress budget
            # (measured at 2048² mg, tol 1e-8: the progress-only floor
            # overshot to a 1e-13 true residual, 29 inner iterations
            # where ~20 suffice; safety 0.1 biases toward one extra
            # cycle rather than a rejected certification).
            inner_floor = (beta / beta0) * jnp.maximum(
                inner_gain,
                0.1 * tol / jnp.maximum(
                    rel_prev, jnp.finfo(dtype).tiny
                ),
            )
        elif mixed:
            inner_floor = jnp.maximum(
                jnp.asarray(tol, dtype), (beta / beta0) * inner_gain
            )
        else:
            inner_floor = jnp.asarray(tol, dtype)

        st0 = (
            (jnp.int32(0), p_basis, t_mat, hmat, giv, beta,
             jnp.int32(0), ferr),
            jnp.array(False),
        )
        (t, p_basis, t_mat, hmat, giv, h_val, n_out, ferr), _ = (
            jax.lax.while_loop(
                inner_cond, make_inner_body(inner_floor), st0
            )
        )

        y = masked_back_substitution(hmat, giv.g, n_out)
        # Update direction: Q [y; 0] (gmres_hh.f90:537-558) — one
        # compact-WY application instead of n_out reflector sweeps.
        # y is β-scaled (g carries β): normalize before the work-dtype
        # cast and rescale the linear application's output in f64, so
        # the mixed path stays exactly scale invariant.
        bsafe = jnp.where(beta > 0, beta, jnp.ones_like(beta))
        yvec = (
            jnp.zeros((n,), dtype=dtype).at[: m].set(y / bsafe)
            .reshape(shape)
        ).astype(work_dtype)
        dx = wy.wy_apply(p_basis, t_mat, yvec)
        x = x + bsafe * dx.astype(dtype)
        return x, n_out, ferr, h_val, (p_basis, t_mat)

    basis_init = (
        jnp.zeros((m + 1,) + shape, dtype=work_dtype),
        jnp.zeros((m + 1, m + 1), dtype=work_dtype),
    )
    x, k, n_out, ferr, (p_basis, t_mat), status, residual = _restarted(
        cycle, A, b, x0, m, tol, max_restarts, M, mixed,
        breakdown_check=breakdown_check, basis_init=basis_init,
        certify_true=certify_true, work_dtype=work_dtype,
    )

    if compute_v_err:
        v = wy.wy_basis(p_basis, t_mat, m)  # (m, n)
        gram = (v @ v.T).astype(dtype)
        v_err = _v_err_householder(gram, n_out, dtype)
    else:
        v_err = jnp.zeros((m + 1,), dtype=dtype)

    return GmresResult(
        x=x, iterations=n_out, restarts=k, residual=residual,
        status=status, residual_history=ferr, v_err=v_err,
    )


# ---------------------------------------------------------------------------
# Public entry point.
# ---------------------------------------------------------------------------


def gmres(
    A,
    b: jnp.ndarray,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 1000,
    M: Optional[Preconditioner] = None,
    variant: str = "householder",
    orthogonalization: str = "cgs2",
    check_inner: bool = True,
    compute_v_err: bool = True,
    breakdown_check: bool = True,
    inner_dtype=None,
    x0: Optional[jnp.ndarray] = None,
    certify: str = "preconditioned",
) -> GmresResult:
    """Solve A x = b with restarted GMRES(restart).

    Args:
      A: callable operator y = A(x) over arrays of any shape, or a dense
        (n, n) matrix (reference dense path, gmres_hh.f90:10).
      b: right-hand side array (any shape; GMRES treats it as a vector).
      restart: Krylov dimension m per cycle (reference argv `m`).
      tol: relative-residual tolerance |g(j+1)|/‖b‖ (gmres_hh.f90:85).
      max_restarts: restart cap (reference `stages=1000`,
        gmres_hh.f90:8 / `max_restarts=1000`, gmres_mgsr.f90:6).
      M: optional left preconditioner callable z = M(r).
      variant: "householder" (compact-WY Walker '84) or "mgsr".
      orthogonalization: for mgsr — "cgs2" (fast, one all-reduce per
        pass) or "mgs2" (faithful sequential MGS, gmres_mgsr.f90:341).
      check_inner: test convergence every inner iteration (True matches
        gmres_hh_prec_omp / gmres_mgsr_omp; False reproduces the
        gmres_hh_omp quirk of restart-boundary-only checks,
        gmres_hh.f90:340-344).
      compute_v_err: run the per-variant orthogonality audit.
      breakdown_check: exit on lucky breakdown h_val < tol
        (gmres_mgsr.f90:69; gmres_hh_prec_omp omits it — set False for
        exact parity with that routine).
      inner_dtype: dtype for the Arnoldi-cycle basis work. None = same
        as b (reference-faithful). jnp.float32 with f64 b enables the
        mixed-precision iterative-refinement fast path: convergence is
        then certified by the f64 true residual at restart boundaries,
        NOT the inner estimate — same 1e-8 answer at f32 speed.
        In mixed mode the restart-boundary preconditioner application
        itself runs at work precision (on the f64-normalized residual,
        so scale invariance is exact); with certify="preconditioned"
        the certification norm ‖M(r)‖ is therefore work-precision
        accurate (~1e-7 relative) — use certify="true" for an
        f64-exact certification norm.
      x0: initial guess, defaults to zeros (all reference drivers use 0).
      certify: norm for restart-boundary convergence certification.
        "preconditioned" (default, reference semantics): ‖M(b−Ax)‖/β₀.
        "true": ‖b−Ax‖/β₀ — the unpreconditioned residual users and
        benchmarks measure; with a deep polynomial M the two norms
        differ by large factors, and certifying on the true norm stops
        exactly when the meaningful quantity crosses tol. Overrides
        the inner Givens estimate in pure mode too.
    """
    if certify not in ("preconditioned", "true"):
        raise ValueError(f"unknown certify {certify}")
    certify_true = certify == "true"
    if (jnp.issubdtype(b.dtype, jnp.complexfloating)
            and variant == "householder"):
        raise ValueError(
            "variant='householder' is real-only (the Walker sign "
            "convention and reflector algebra assume real arithmetic) "
            "— use variant='mgsr' for complex operators"
        )
    op = _as_operator(A)
    if b.size == 1:
        # Degenerate 1×1 system: the Householder machinery needs
        # n ≥ m+1 ≥ 2; solve directly.
        a_val = op(jnp.ones_like(b))
        singular = a_val == 0
        x = jnp.where(~singular, b / jnp.where(~singular, a_val, 1.0),
                      jnp.zeros_like(b))
        if x0 is not None:
            x = jnp.where(~singular, x, x0)
        # Residual in the norm the certify mode documents: the default
        # "preconditioned" semantics measure ‖M(b − Ax)‖/β₀ (reference
        # restart criterion), "true" the unpreconditioned norm.
        r = b - op(x)
        w = M(r) if (M is not None and not certify_true) else r
        residual = jnp.sqrt(jnp.real(tree_vdot(w, w))) / jnp.maximum(
            jnp.sqrt(jnp.real(tree_vdot(b, b))), jnp.finfo(b.dtype).tiny
        )
        # BREAKDOWN is reserved for the singular a == 0 case; a solvable
        # system that misses tol (only possible through M's scaling or
        # roundoff) is MAX_ITERATIONS, as everywhere else.
        status = jnp.where(
            residual < tol,
            jnp.int32(SolverStatus.CONVERGED),
            jnp.where(
                jnp.squeeze(singular),
                jnp.int32(SolverStatus.BREAKDOWN),
                jnp.int32(SolverStatus.MAX_ITERATIONS),
            ),
        )
        rdt = jnp.finfo(b.dtype).dtype
        return GmresResult(
            x=x, iterations=jnp.int32(1), restarts=jnp.int32(1),
            residual=residual, status=status,
            residual_history=jnp.full((1,), residual, dtype=rdt),
            v_err=jnp.zeros((2,), dtype=rdt),
        )
    # Clamp the Krylov dimension to n−1: the reference allocates
    # P(n, m+1) with m > n for e.g. Hilbert n=12, m=90 and relies on
    # the `j < n` branch never producing a reflector (gmres_hh.f90:60);
    # we keep the buffers well-formed instead (SURVEY §7 quirk 7).
    restart = min(restart, b.size - 1)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    work_dtype = jnp.dtype(inner_dtype) if inner_dtype is not None \
        else b.dtype
    if variant == "householder":
        return _gmres_householder(
            op, b, x0, restart, tol, max_restarts, M,
            check_inner, compute_v_err, breakdown_check, work_dtype,
            certify_true,
        )
    elif variant == "mgsr":
        if orthogonalization not in ("cgs2", "mgs2"):
            raise ValueError(
                f"unknown orthogonalization {orthogonalization}"
            )
        return _gmres_mgsr(
            op, b, x0, restart, tol, max_restarts, M,
            orthogonalization, check_inner, compute_v_err, work_dtype,
            certify_true,
        )
    raise ValueError(f"unknown variant {variant}")
