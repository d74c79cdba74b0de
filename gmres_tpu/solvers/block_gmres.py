"""Block GMRES — restarted GMRES for s right-hand sides at once.

No reference counterpart: the reference's operator contract is strictly
single-vector (interfaces.f90:12-18) and its drivers solve one system
per run (tests/*.f90). Block solvers exist here because they are the
canonical accelerator win for multi-RHS workloads (parameter studies, multiple
forcings, inner solves of outer methods):

* The solve cost of single-RHS GMRES is dominated by streaming
  the (m+1, n) basis through HBM for orthogonalization (measured in
  docs/DESIGN.md §1: the CGS2 matmuls are bandwidth-, not FLOP-bound).
  A block of s RHS reuses every streamed basis tile against s vectors:
  the Gram/projection contractions become (s·n)×(m+1)s matmuls with an
  s× better FLOP:byte ratio, matmuls instead of vector passes.
* Operator and preconditioner applications batch through ``jax.vmap``
  — for stencils this fuses into one batched convolution dispatch
  rather than s sequential ones (s× fewer launches).
* Convergence can be FASTER than s independent solves in total matvecs
  when the right-hand sides are related: each RHS minimizes over the
  UNION of the block Krylov spaces.

Design notes:

* One cycle = exactly m block-Arnoldi steps under ``lax.scan`` (fixed
  trip count — no data-dependent early exit inside the cycle; restarts
  are the convergence granularity, certified on true residuals).
* Inter-block orthogonalization is block CGS2 (two batched tensordots,
  one all-reduce each). Intra-block orthonormalization is SVQB
  (Stathopoulos & Wu, SISC 2002) — an s×s Gram + ``eigh`` + scaled
  combination, which unlike TSQR/Householder needs no long-vector
  sequential work, and whose eigenvalue clamp handles rank-deficient
  blocks (converged or duplicate RHS) without dynamic shapes. Two
  passes tighten orthogonality to ~eps.
* The block least-squares ((m+1)s × ms) is solved once per cycle by
  dense QR — replicated small-matrix work, like ops/givens.py.

M must be LINEAR (fixed), applied on the right: the update applies M
once to the combined block correction.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gmres_tpu.solvers.gmres import _as_operator
from gmres_tpu.types import (
    BlockSolveResult,
    Preconditioner,
    SolverStatus,
)


def _svqb(w, eps):
    """One SVQB pass: orthonormalize the s long rows of w.

    Returns (q, r) with w = r^T-free convention: w[b] = sum_a
    r[a, b] * q[a]  (r = S^{-1}, upper-ish s×s, not triangular).
    Rank-deficient directions are clamped to eps*lambda_max and come
    out as orthonormalized noise with ~zero reconstruction weight.
    """
    s = w.shape[0]
    flat = w.reshape(s, -1)
    # Hermitian Gram (conj elided on the real dtypes block_gmres uses;
    # makes the same whitening serve complex blocks — solvers/lobpcg.py).
    g = jnp.conj(flat) @ flat.T
    d = jnp.sqrt(jnp.maximum(jnp.real(jnp.diagonal(g)), 0.0))
    dinv = jnp.where(d > 0, 1.0 / jnp.where(d > 0, d, 1.0), 0.0)
    gs = g * dinv[:, None] * dinv[None, :]
    lam, u = jnp.linalg.eigh(gs)
    lmax = jnp.maximum(lam[-1], eps)
    lam_c = jnp.maximum(lam, eps * lmax)
    # S = D^{-1} U L^{-1/2};  q = S^T w;  r = S^{-1} = L^{1/2} U^T D
    smat = (dinv[:, None] * u) / jnp.sqrt(lam_c)[None, :]
    q = jnp.tensordot(smat, w, axes=(0, 0))
    r = (jnp.sqrt(lam_c)[:, None] * u.T) * d[None, :]
    return q, r


def _orthonormalize_block(w, eps):
    """SVQB², composing the reconstruction factors: w = (r2 r1)ᵀ… —
    i.e. block coefficient H_sub = r2 @ r1 with w[b] = Σ_a H_sub[a, b] q[a]."""
    q1, r1 = _svqb(w, eps)
    q2, r2 = _svqb(q1, eps)
    return q2, r2 @ r1


def block_gmres(
    A,
    B: jnp.ndarray,
    *,
    restart: int = 30,
    tol: float = 1e-8,
    max_restarts: int = 100,
    M: Optional[Preconditioner] = None,
    x0: Optional[jnp.ndarray] = None,
) -> BlockSolveResult:
    """Solve A x_i = b_i for the s stacked right-hand sides B[i].

    Args:
      A: single-vector linear operator (batched internally via vmap)
        or dense (n, n) matrix.
      B: (s, *shape) stacked right-hand sides.
      restart: block-Krylov cycle length m (subspace dim = m·s).
      tol: per-RHS relative true-residual tolerance; the solve stops
        when EVERY RHS satisfies it (checked at restart boundaries).
      M: LINEAR right preconditioner (single-vector callable).
      x0: optional (s, *shape) initial guesses.
    """
    op1 = _as_operator(A)
    s = B.shape[0]
    dtype = B.dtype
    m = max(int(restart), 1)
    eps = float(jnp.finfo(dtype).eps)
    tiny = jnp.finfo(dtype).tiny

    vop = jax.vmap(op1)
    vprec = jax.vmap(M) if M is not None else (lambda v: v)

    if x0 is None:
        x0 = jnp.zeros_like(B)

    bnorms = jnp.sqrt(jnp.sum(B.reshape(s, -1) ** 2, axis=1))
    bsafe = jnp.maximum(bnorms, tiny)

    def residual_block(x):
        r = B - vop(x)
        rel = jnp.sqrt(jnp.sum(r.reshape(s, -1) ** 2, axis=1)) / bsafe
        return r, rel

    def cycle(r):
        """m block-Arnoldi steps; returns the block correction dx."""
        v0, b0 = _orthonormalize_block(r, eps)
        basis = jnp.zeros((m + 1,) + B.shape, dtype=dtype)
        basis = basis.at[0].set(v0)
        hmat = jnp.zeros(((m + 1) * s, m * s), dtype=dtype)

        def step(carry, t):
            basis, hmat = carry
            v_t = jax.lax.dynamic_index_in_dim(
                basis, t, axis=0, keepdims=False
            )
            with jax.named_scope("block_gmres.precond"):
                z = vprec(v_t)
            with jax.named_scope("block_gmres.spmv"):
                w = vop(z)
            with jax.named_scope("block_gmres.orthogonalize"):
                v2 = basis.reshape(m + 1, s, -1)
                w2 = w.reshape(s, -1)
                h1 = jnp.tensordot(v2, w2, axes=(2, 1))   # (m+1, s, s)
                w2 = w2 - jnp.tensordot(h1, v2, axes=((0, 1), (0, 1)))
                h2 = jnp.tensordot(v2, w2, axes=(2, 1))
                w2 = w2 - jnp.tensordot(h2, v2, axes=((0, 1), (0, 1)))
                hcoef = h1 + h2
            q, hsub = _orthonormalize_block(w2.reshape(B.shape), eps)
            basis = basis.at[t + 1].set(q)
            col = jax.lax.dynamic_update_slice(
                hcoef, hsub[None], (t + 1, 0, 0)
            )
            hmat = jax.lax.dynamic_update_slice(
                hmat, col.reshape((m + 1) * s, s),
                (jnp.zeros((), t.dtype), t * s),
            )
            return (basis, hmat), None

        (basis, hmat), _ = jax.lax.scan(
            step, (basis, hmat), jnp.arange(m)
        )
        # Block least-squares: min || E1 B0 - Hbar Y ||_F, dense QR on
        # the replicated ((m+1)s, ms) matrix.
        c = jnp.zeros(((m + 1) * s, s), dtype=dtype).at[:s, :].set(b0)
        qh, rh = jnp.linalg.qr(hmat)
        rhs = qh.T @ c
        diag = jnp.diagonal(rh)
        dfloor = eps * jnp.maximum(jnp.max(jnp.abs(diag)), 1.0)
        dsafe = jnp.where(jnp.abs(diag) > dfloor, diag,
                          jnp.asarray(1.0, dtype))
        rh = rh - jnp.diag(diag) + jnp.diag(dsafe)
        y = jax.scipy.linalg.solve_triangular(rh, rhs, lower=False)
        with jax.named_scope("block_gmres.update"):
            y3 = y.reshape(m, s, s)
            combo = jnp.tensordot(
                y3, basis[:m].reshape(m, s, -1), axes=((0, 1), (0, 1))
            ).reshape(B.shape)
            dx = vprec(combo)
        return dx

    r0, rel0 = residual_block(x0)
    converged0 = jnp.all(rel0 < tol) | jnp.all(bnorms == 0)

    def cond(carry):
        k, converged, breakdown = carry[1], carry[3], carry[4]
        return (k < max_restarts) & (~converged) & (~breakdown)

    def body(carry):
        x, k, r, _, _, _ = carry
        dx = cycle(r)
        x_new = x + dx
        r_new, rel = residual_block(x_new)
        converged = jnp.all(rel < tol)
        breakdown = ~jnp.all(jnp.isfinite(rel))
        return (x_new, k + 1, r_new, converged, breakdown, rel)

    carry0 = (x0, jnp.int32(0), r0, converged0, jnp.array(False), rel0)
    x, k, _, converged, breakdown, rel = jax.lax.while_loop(
        cond, body, carry0
    )
    status = jnp.where(
        converged,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            breakdown,
            jnp.int32(SolverStatus.BREAKDOWN),
            jnp.int32(SolverStatus.MAX_ITERATIONS),
        ),
    )
    return BlockSolveResult(
        x=x, restarts=k, residuals=rel, residual=jnp.max(rel),
        status=status,
    )
