"""LOBPCG: preconditioned block eigensolver for SPD operators.

Beyond the reference: its README claims "Lanczos eigenvalue
estimation" that the Fortran never implements (README.md:11, SURVEY
C10). This library first answered with rigorous bound estimation
(solvers/lanczos.py); `lobpcg` completes the capability — k smallest
eigenpairs of an SPD operator, preconditioned, to solver accuracy
(Knyazev 2001, locally optimal block preconditioned conjugate
gradient).

Why LOBPCG and not Lanczos on an accelerator: Lanczos is a scalar
three-term recurrence — one matvec, two dots, strictly sequential.
LOBPCG is a BLOCK method: one iteration applies the operator to 3k
stacked vectors in a single batched dispatch, forms one (3k, 3k) Gram
matrix (a single matmul riding the row-sharded long axis + ONE
all-reduce), and solves a replicated 3k×3k dense eigenproblem — the
same small-replicated/large-sharded split as every solver here
(docs/DESIGN.md §2). Convergence is governed by the preconditioner:
with the multigrid V-cycle it is grid-independent, exactly like the
linear solves.

Robustness, fixed-shape (everything lives in one ``lax.while_loop``):

* the [X | W | P] basis is orthonormalized JOINTLY by SVQB²
  (Stathopoulos-Wu, shared with solvers/block_gmres.py) — no
  per-block Gram-Schmidt cascade, two matmuls + two 3k×3k ``eigh``;
* degenerate directions (W rows of converged pairs, the zero initial
  P) are replaced by deterministic pseudo-random fallback vectors
  BEFORE orthonormalization — the fixed-shape substitute for the
  dynamic basis shrinking dense-library implementations do; clamped
  SVQB then absorbs any remaining near-dependence;
* P is the implicit difference P⁺ = X⁺ − X(X·X⁺) (Hetmaniuk-Lehoucq
  form), so no extra recurrence state is carried;
* the Rayleigh-Ritz re-uses the basis combination for A·X⁺ — the
  operator is applied once per basis vector per iteration, never to
  reconstruct residuals.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.types import EigResult, SolverStatus


def _svqb_b(w, bw, eps):
    """One SVQB pass in the B-inner product: whitening from the Gram
    g = conj(w)·(B w). Returns (q, bq) with q B-orthonormal and
    bq = B·q obtained by applying the SAME whitening combination to
    the bw block — recombination instead of fresh B applications.
    With bw = w this reproduces block_gmres._svqb's standard-product
    whitening bit-for-bit (the real/complex Gram of identical rows is
    exactly Hermitian, so no symmetrization is needed)."""
    s = w.shape[0]
    flat = w.reshape(s, -1)
    bflat = bw.reshape(s, -1)
    g = jnp.conj(flat) @ bflat.T
    d = jnp.sqrt(jnp.maximum(jnp.real(jnp.diagonal(g)), 0.0))
    dinv = jnp.where(d > 0, 1.0 / jnp.where(d > 0, d, 1.0), 0.0)
    gs = g * dinv[:, None] * dinv[None, :]
    lam, u = jnp.linalg.eigh(0.5 * (gs + jnp.conj(gs.T)))
    lmax = jnp.maximum(lam[-1], eps)
    lam_c = jnp.maximum(lam, eps * lmax)
    smat = (dinv[:, None] * u) / jnp.sqrt(lam_c)[None, :]
    q = jnp.tensordot(smat, w, axes=(0, 0))
    bq = jnp.tensordot(smat, bw, axes=(0, 0))
    return q, bq


def _orthonormalize_block_b(w, bw, eps):
    """SVQB² in the B-inner product (the joint-basis robustness of
    block_gmres._orthonormalize_block, generalized)."""
    q1, bq1 = _svqb_b(w, bw, eps)
    return _svqb_b(q1, bq1, eps)


def _rows_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(p, *shape) × (q, *shape) → (p, q) Gram block: one matmul over
    the flattened (possibly sharded) long axis, one all-reduce."""
    return jnp.tensordot(
        jnp.conj(a.reshape(a.shape[0], -1)), b.reshape(b.shape[0], -1),
        axes=(1, 1),
    )


def _combine(c: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """rows_out[j] = Σ_a c[a, j] · s[a] — basis recombination."""
    return jnp.tensordot(c, s, axes=(0, 0))


def lobpcg(
    A: Callable[[jnp.ndarray], jnp.ndarray],
    X0: jnp.ndarray,
    *,
    tol: float = 1e-6,
    rtol: float = 0.0,
    max_iterations: int = 200,
    M: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    B: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    guard: int = 0,
) -> EigResult:
    """Compute the k smallest eigenpairs of the SPD (real) or HPD
    (complex Hermitian — every Gram/Ritz quantity stays
    Hermitian/real through the conjugating reductions) operator A —
    or of the GENERALIZED pencil A x = λ B x when the SPD mass
    operator ``B`` is given (FEM mass matrices, weighted norms): the
    basis is B-orthonormalized (SVQB² on the B-Gram; B·q maintained
    by recombination, so B is applied once per basis vector per
    iteration), the residual is A x − λ B x, and eigenvectors come
    out B-orthonormal.

    A acts on a single vector (same contract as the solvers); it is
    vmapped over the block internally. X0 is the (k, *shape) initial
    block — its row count fixes k; rows may be anything (even
    duplicates or zeros: degenerate rows are replaced by deterministic
    fallback directions). M, if given, must be SPD and approximate
    A⁻¹ (e.g. ``poisson_multigrid_preconditioner`` — the same cycles
    that precondition the linear solves).

    Convergence: every pair must reach
    ‖A xᵢ − λᵢ B xᵢ‖₂ < max(tol, rtol·|λᵢ|) with B-unit-norm xᵢ —
    tol is absolute (the house convention, cg.f90:37); rtol scales the
    threshold per pair by its own eigenvalue, the right knob when the
    wanted eigenvalues carry a grid factor (Poisson λ₁ = 2π²h²:
    demanding 1e-8 ABSOLUTE at 1024² means 5e-4 RELATIVE and slowed
    an earlier recorded run past its iteration cap at eigenvalues
    already accurate to 6e-9).

    guard: extra trailing pairs computed but not returned (standard
    LOBPCG practice): the LAST pair's residual converges an order or
    two slower than the interior ones (it has no basis vectors beyond
    itself to resolve its coupling to the rest of the spectrum) — one
    or two guard pairs restore the interior rate for all k returned
    pairs, at 3·guard extra basis vectors of cost.
    """
    k_out = X0.shape[0]
    if guard:
        key_g = jax.random.fold_in(jax.random.PRNGKey(1), guard)
        pad = jax.random.normal(
            key_g, (guard,) + X0.shape[1:], X0.dtype
        )
        X0 = jnp.concatenate([X0, pad], axis=0)
    k = X0.shape[0]
    dtype = X0.dtype
    eps = float(jnp.finfo(dtype).eps)
    a_block = jax.vmap(A)
    m_block = jax.vmap(M) if M is not None else (lambda r: r)
    # Identity for the standard problem: bs IS s (no copy), and every
    # B-product formula below reduces bit-for-bit to the standard one.
    b_block = jax.vmap(B) if B is not None else (lambda s: s)
    base_key = jax.random.PRNGKey(0)

    def fill_degenerate(v, i, salt):
        """Replace rows with norm √eps below the BLOCK's largest row
        norm by deterministic pseudo-random directions (fresh per
        iteration). Relative to the block itself: near convergence the
        whole preconditioned-residual block is legitimately tiny and
        must be kept as search directions — an absolute floor would
        noise-replace every row and stall the solve in the
        [√eps·scale, tol] window. An all-zero block (max = 0) is fully
        replaced."""
        norms = jnp.sqrt(
            jnp.sum(jnp.abs(v.reshape(v.shape[0], -1)) ** 2, axis=1)
        )
        floor = jnp.sqrt(eps) * jnp.max(norms)
        key = jax.random.fold_in(jax.random.fold_in(base_key, i), salt)
        noise = jax.random.normal(key, v.shape, dtype)
        keep = norms > floor
        return jnp.where(
            keep.reshape((-1,) + (1,) * (v.ndim - 1)), v, noise
        )

    def rayleigh_ritz(s):
        """Jointly B-orthonormalize the basis rows, then Ritz-extract
        the k smallest pairs. Returns (lam, x, r, resnorm)."""
        q, bq = _orthonormalize_block_b(s, b_block(s), eps)
        aq = a_block(q)
        h = _rows_dot(q, aq)
        lam_all, c = jnp.linalg.eigh(0.5 * (h + jnp.conj(h.T)))
        ck = c[:, :k]
        x = _combine(ck, q)
        ax = _combine(ck, aq)
        bx = _combine(ck, bq)
        lam = lam_all[:k]
        r = ax - lam.reshape((-1,) + (1,) * (x.ndim - 1)) * bx
        resnorm = jnp.sqrt(
            jnp.sum(jnp.abs(r.reshape(k, -1)) ** 2, axis=1)
        )
        # A Ritz vector that lost unit norm (possible only if clamped
        # SVQB zeroed a fully dependent direction) must not pass the
        # convergence test on its trivially-small residual. LARGE
        # FINITE sentinel, not inf: the body's isfinite guard is for
        # genuine NaN breakdowns — a transient rank deficiency is
        # recoverable (the next iteration's fill_degenerate +
        # clamped SVQB repair the basis) and must keep iterating.
        big = jnp.sqrt(jnp.finfo(resnorm.dtype).max)
        # B-norm of each Ritz vector (= plain norm for B=None, where
        # bx IS x up to identical arithmetic).
        xnorm = jnp.sqrt(jnp.abs(jnp.sum(
            jnp.conj(x.reshape(k, -1)) * bx.reshape(k, -1), axis=1
        )))
        resnorm = jnp.where(
            jnp.abs(xnorm - 1.0) < 0.5, resnorm, big
        )
        return lam, x, r, resnorm

    # Setup Rayleigh-Ritz on the initial block alone (degenerate X0
    # rows fall back to pseudo-random directions).
    lam0, x0, r0, res0 = rayleigh_ritz(
        fill_degenerate(X0, jnp.int32(-1), 0)
    )
    # Convergence gates on the RETURNED pairs only — the guard pairs
    # exist to converge slower so the returned ones don't have to.
    def _converged(lam_v, res_v):
        thresh = jnp.maximum(
            jnp.asarray(tol, res_v.dtype),
            jnp.asarray(rtol, res_v.dtype) * jnp.abs(lam_v[:k_out]),
        )
        return jnp.all(res_v[:k_out] < thresh)

    status0 = jnp.where(
        _converged(lam0, res0),
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    p0 = jnp.zeros_like(x0)

    def cond(carry):
        i, _, _, _, _, _, status = carry
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        i, x, r, p, lam, resnorm, status = carry
        w = m_block(r)
        w = fill_degenerate(w, i, 1)
        p_f = fill_degenerate(p, i, 2)
        lam_n, x_n, r_n, res_n = rayleigh_ritz(
            jnp.concatenate([x, w, p_f], axis=0)
        )
        # Implicit conjugate direction: the part of the new Ritz block
        # not in the old one.
        p_n = x_n - _combine(_rows_dot(x, x_n), x)
        status = jnp.where(
            _converged(lam_n, res_n),
            jnp.int32(SolverStatus.CONVERGED),
            status,
        )
        status = jnp.where(
            ~jnp.all(jnp.isfinite(res_n)),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (i + 1, x_n, r_n, p_n, lam_n, res_n, status)

    i, x, r, p, lam, resnorm, status = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, p0, lam0, res0, status0)
    )
    return EigResult(
        eigenvalues=lam[:k_out],
        x=x[:k_out],
        iterations=i,
        residuals=resnorm[:k_out],
        status=status,
    )
