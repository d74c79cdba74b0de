"""IDR(s) — Induced Dimension Reduction (van Gijzen & Sonneveld 2011,
the "elegant" biorthogonal variant).

Beyond the reference (nonsymmetric set: BiCGSTAB only): IDR(s) closes
the gap between BiCGSTAB (= IDR(1) up to roundoff) and full GMRES —
finite termination in at most N + N/s matvecs, with convergence that
approaches GMRES's as s grows, at short-recurrence memory (2s+3 long
vectors).

Device shape: the s-dimensional shadow space makes the hot reductions
BLOCK-shaped — (P, r) and (P, g) are (s, n)·(n,) matmuls, ONE fused
all-reduce for s dot products (the same basis-block trick as
block_gmres/lobpcg) where BiCGSTAB reduces scalars one or two at a
time. The k-sweep over the s directions is unrolled at trace time
(s is small and static); the outer loop is one ``lax.while_loop``.
Per outer iteration: s+1 operator (and preconditioner) applications,
s+2 reduction points.

Convergence: absolute ‖r‖ < tol at outer-iteration boundaries
(cg.f90:37 semantics), with the van Gijzen ω-stabilization
(κ = |⟨t, r⟩|/(‖t‖‖r‖) floored at 0.7) guarding the Sonneveld-space
step. Exit certification recomputes b − Ax (PARITY.md quirk 8).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.tri import solve_small
from gmres_tpu.ops.blas import (
    tree_axpy,
    tree_norm,
    tree_sub,
    tree_vdot,
    tree_zeros_like,
)
from gmres_tpu.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def idrs(
    A: LinearOperator,
    b: jnp.ndarray,
    *,
    s: int = 4,
    tol: float = 1e-9,
    max_iterations: int = 10_000,
    M: Optional[Preconditioner] = None,
    x0: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Solve A x = b (A nonsymmetric) by preconditioned IDR(s).

    s: shadow-space dimension (s=1 ≈ BiCGSTAB; 4-8 typical — higher s
      trades memory/blockwork for fewer matvecs on hard spectra).
    `iterations` counts OUTER iterations (s+1 matvecs each); the
    residual history records ‖r‖ per outer iteration.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))

    dtype = jnp.result_type(*jax.tree.leaves(b))
    rdtype = jnp.finfo(dtype).dtype
    history = jnp.zeros((max_iterations,), dtype=rdtype)
    tiny = jnp.finfo(dtype).tiny
    shape = b.shape
    flat_axes = tuple(range(b.ndim))

    def m_apply(v):
        return M(v) if M is not None else v

    # Shadow block P: s fixed pseudo-random directions, orthonormalized
    # (deterministic PRNG — CLAUDE.md forbids wall-clock randomness).
    from gmres_tpu.solvers.block_gmres import _orthonormalize_block

    p_raw = jax.random.normal(
        jax.random.PRNGKey(7), (s,) + shape, dtype
    )
    p_block, _ = _orthonormalize_block(p_raw, float(jnp.finfo(dtype).eps))

    def pdot(v):
        """(P, v): s inner products as one matmul + ONE all-reduce."""
        return jnp.tensordot(
            jnp.conj(p_block), v, axes=(tuple(range(1, b.ndim + 1)),
                                        flat_axes)
        )

    def safe_div(num, den):
        return num / jnp.where(jnp.abs(den) > 0, den,
                               jnp.ones_like(den))

    res0 = tree_norm(r)
    status0 = jnp.where(
        res0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    g0 = jnp.zeros((s,) + shape, dtype)
    u0 = jnp.zeros((s,) + shape, dtype)
    m0 = jnp.eye(s, dtype=dtype)

    def cond(carry):
        (i, *_), status, _ = carry
        return (i < max_iterations) & (status == SolverStatus.MAX_ITERATIONS)

    def body(carry):
        (i, x, r, g_blk, u_blk, m_mat, om), status, hist = carry
        f = pdot(r)
        # s direction sweeps, unrolled (s static and small).
        for k in range(s):
            # c solves the trailing (s-k) lower-triangular-ish block
            # M[k:, k:] c = f[k:]; with the masked full solve the
            # leading entries come out exactly zero, so the
            # combinations below can run over the FULL block (zero
            # rows contribute nothing) — fixed shapes throughout.
            rows = jnp.arange(s)[:, None]
            cols = jnp.arange(s)[None, :]
            act = (rows >= k) & (cols >= k)
            m_masked = jnp.where(act, m_mat, jnp.eye(s, dtype=dtype))
            f_masked = jnp.where(jnp.arange(s) >= k, f, 0.0)
            c = solve_small(m_masked, f_masked)  # pure-jnp LU (ops/tri.py)
            v = r - jnp.tensordot(c, g_blk, axes=(0, 0))
            v = m_apply(v)
            u_k = jnp.tensordot(c, u_blk, axes=(0, 0)) + om * v
            g_k = A(u_k)
            # Biorthogonalize g_k against the leading shadow
            # directions; the projections reuse ONE block reduction.
            proj = pdot(g_k)  # (s,)
            for i_lead in range(k):
                alpha = safe_div(proj[i_lead],
                                 m_mat[i_lead, i_lead])
                g_k = g_k - alpha * g_blk[i_lead]
                u_k = u_k - alpha * u_blk[i_lead]
                # one-rotation update of the remaining projections
                proj = proj - alpha * m_mat[:, i_lead]
            m_col = pdot(g_k)
            m_mat = m_mat.at[:, k].set(
                jnp.where(jnp.arange(s) >= k, m_col, m_mat[:, k])
            )
            beta = safe_div(f[k], m_mat[k, k])
            r = tree_axpy(-beta, g_k, r)
            x = tree_axpy(beta, u_k, x)
            f = jnp.where(jnp.arange(s) > k, f - beta * m_col, 0.0)
            g_blk = g_blk.at[k].set(g_k)
            u_blk = u_blk.at[k].set(u_k)

        # Sonneveld-space step: r ∈ G_{j+1} requires one (I − ωA) with
        # a fresh ω; κ-stabilization keeps ω from collapsing when t ⊥ r
        # (van Gijzen-Sonneveld 2011 §3; same role as BiCGSTAB's
        # half-step degeneracy guard).
        v = m_apply(r)
        t = A(v)
        tt = jnp.real(tree_vdot(t, t))
        tr = tree_vdot(t, r)
        om_raw = safe_div(tr, tt.astype(dtype))
        kappa = jnp.abs(tr) / jnp.maximum(
            jnp.sqrt(tt) * tree_norm(r), tiny
        )
        om = jnp.where(
            kappa < 0.7,
            om_raw * safe_div(jnp.asarray(0.7, rdtype), kappa),
            om_raw,
        )
        x = tree_axpy(om, v, x)
        r = tree_axpy(-om, t, r)

        res = tree_norm(r)
        hist = hist.at[i].set(res)
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & ~jnp.isfinite(res),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return ((i + 1, x, r, g_blk, u_blk, m_mat, om), status, hist)

    carry0 = (
        (jnp.int32(0), x, r, g0, u0, m0, jnp.asarray(1.0, dtype)),
        status0,
        history,
    )
    (i, x, *_), status, history = jax.lax.while_loop(cond, body, carry0)

    # Exit certification (PARITY.md quirk 8).
    r_true = tree_sub(b, A(x))
    true_res = tree_norm(r_true)
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (true_res >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    res = jnp.where(i > 0, true_res, res0)
    history = jnp.where(jnp.arange(max_iterations) < i, history, res)
    return SolveResult(
        x=x,
        iterations=i,
        residual=res,
        status=status,
        residual_history=history,
    )
