"""GCRO-DR: Krylov subspace RECYCLING for sequences of linear systems
(Parks, de Sturler, Mackey, Johnson, Maiti — SISC 2006).

Beyond the reference (one solver call per system, no state carried):
production workloads solve SEQUENCES of slowly varying systems — Newton
steps (solvers/newton_krylov.py), time stepping, parameter sweeps,
optimization loops (solvers/implicit.py). GCRO-DR carries a
k-dimensional approximate invariant subspace between solves, so each
new system starts with the slow eigenmodes already deflated: the
second-and-later solves skip the part of the convergence history the
first solve already paid for.

Structure per cycle, in the library's fixed-shape single-dispatch
style:
  * Recycle pair (U, C): op·U = C with C orthonormal (k long vectors
    each). Projection step x += U·(Cᵀr), r −= C·(Cᵀr) makes the
    remaining iteration run in range(C)⊥.
  * m − k Arnoldi steps on (I − C·Cᵀ)·op, tracking the coupling
    B = Cᵀ·op·V alongside the Hessenberg (one extra fused block
    reduction per step). The combined relation is
        op·[U V_m] = [C V_{m+1}]·G,   G = [[I, B], [0, H̄]]
    and the least-squares solution separates: the Givens recurrence on
    H̄ alone drives the residual (the C block is zeroed exactly by
    y_U = −B·y_V) — same incremental Ω machinery as GMRES
    (ops/givens.py).
  * Deflation update: harmonic Ritz pairs of the COMBINED pencil
        GᵀG·z = θ·GᵀF·z,   F = [C V_{m+1}]ᵀ[U V_m]
    solved by the in-jit dense eigensolver (ops/hessenberg_eig.py);
    the k smallest-|θ| vectors are realified (conjugate pairs →
    Re/Im, the GMRES-DR pattern) and become the next U — with
    op·U_new reconstructed MATVEC-FREE from Ŵ·(G·Z), then SVQB
    re-orthonormalization gives the new (U, C). Recycle maintenance
    costs zero operator applications.

First call (recycle=None) bootstraps with one full-width GMRES-DR
cycle (harmonic Ritz of the plain Hessenberg, gmres_dr.py:223-227's
formula). Importing an external recycle costs k matvecs once (op·U to
rebuild C).

Exit: CONVERGED requires the certified true residual (PARITY.md
quirk 8): ‖rhs − op·x‖/β₀ < tol recomputed at exit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, row_contract
from gmres_tpu.ops.givens import givens_init, givens_step
from gmres_tpu.ops.hessenberg_eig import (
    eig_select,
    smallest_invariant_subspace,
)
from gmres_tpu.ops.tri import masked_back_substitution, solve_small
from gmres_tpu.solvers.block_gmres import _orthonormalize_block
from gmres_tpu.types import LinearOperator, Preconditioner, SolverStatus


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RecycledResult:
    """GmresResult-shaped result plus the recycle subspace to pass to
    the next solve in the sequence.

    Attributes:
      x: solution.
      iterations: inner iterations in the final cycle.
      restarts: cycles performed (incl. the bootstrap cycle).
      residual: certified relative true residual ‖rhs − op·x‖/β₀.
      status: SolverStatus int32.
      residual_history: per-cycle relative residual (max_restarts,),
        padded with the final value.
      recycle: (k, *shape) U block — pass as ``recycle=`` to the next
        ``gcrodr`` call (systems may differ; the import re-derives C
        with k matvecs).
    """

    x: Any
    iterations: jnp.ndarray
    restarts: jnp.ndarray
    residual: jnp.ndarray
    status: jnp.ndarray
    residual_history: jnp.ndarray
    recycle: jnp.ndarray

    @property
    def converged(self) -> jnp.ndarray:
        return self.status == SolverStatus.CONVERGED


def _realify(vals, vecs, k, eps):
    """Columns for the k smallest harmonic Ritz vectors as a REAL
    block: conjugate-pair second members take Im of the first
    (gmres_dr.py's realification pattern)."""
    ptol = 64.0 * eps
    prev = jnp.roll(vals[:k], 1)
    mods = jnp.abs(vals[:k])
    pair_second = (
        (jnp.arange(k) >= 1)
        & (jnp.abs(vals[:k] - jnp.conj(prev)) <= ptol * (mods + 1.0))
        & (jnp.abs(vals[:k].imag) > ptol * (mods + 1.0))
    )
    cols = jnp.where(
        pair_second[None, :],
        jnp.roll(vecs, 1, axis=1).imag,
        vecs.real,
    )
    return cols  # (dim, k) real


def gcrodr(
    A,
    b: jnp.ndarray,
    *,
    k: int = 10,
    restart: int = 40,
    tol: float = 1e-8,
    max_restarts: int = 200,
    M: Optional[Preconditioner] = None,
    recycle: Optional[jnp.ndarray] = None,
    x0: Optional[jnp.ndarray] = None,
    deflation: str = "eig",
    inner_dtype=None,
) -> RecycledResult:
    """Solve A x = b with GCRO-DR(restart, k).

    Args:
      A: linear operator callable (or dense matrix is NOT accepted —
        wrap it: ``lambda v: a @ v``).
      b: right-hand side (real; complex recycling needs conjugate
        bookkeeping this implementation does not carry).
      k: recycle-space dimension (k ≥ 1; k + 2 ≤ restart).
      restart: TOTAL subspace width per cycle — k recycled directions
        plus m = restart − k new Arnoldi vectors (same memory budget
        as GMRES(restart)).
      tol: relative tolerance on ‖rhs − op·x‖/β₀ (op = M∘A when M is
        given — the reference's preconditioned-residual semantics).
      max_restarts: cycle cap.
      M: optional left preconditioner.
      recycle: (k, *shape) U block from a previous RecycledResult (the
        previous system may have been different); None bootstraps. An
        ALL-ZERO block is accepted as "no recycle yet": the first
        cycle runs deflation-free and seeds U from its own Hessenberg
        — the valid initial carry for lax.while_loop callers that
        cannot branch on None (solvers/newton_krylov.py).
      x0: initial guess (zeros default).
      deflation: how the harmonic-Ritz deflation space is extracted.
        "eig" = the exact route (in-jit complex QR eigensolver +
        realified eigenvector columns); "subspace" = REAL-only inverse
        subspace iteration (ops/hessenberg_eig.py:
        smallest_invariant_subspace), for runtimes without a complex
        datapath. Default "eig".
        Deflation QUALITY differs only by the extraction accuracy;
        every exit is still certified on the true residual.
      inner_dtype: dtype for the cycle work (basis, recycle pair,
        small matrices) — same iterative-refinement contract as
        ``gmres(inner_dtype=...)``: None (default) = b's dtype,
        reference-faithful recursive residual; jnp.float32 with f64 b
        runs every cycle at f32 speed while x and the
        residual stay f64 — each cycle boundary RECOMPUTES the true
        preconditioned residual in f64 (one extra op application per
        m-step cycle) and convergence is decided on it, never on the
        f32 Givens estimate (which floors near 1e-7). The returned
        ``recycle`` block is cast back to b's dtype so sequence
        carries are precision-agnostic.
    """
    if jnp.issubdtype(b.dtype, jnp.complexfloating):
        raise ValueError("gcrodr supports real dtypes only")
    m = restart - k
    if k < 1 or m < 2:
        raise ValueError(
            f"need k >= 1 and restart >= k + 2, got k={k}, "
            f"restart={restart}"
        )
    op: LinearOperator = (lambda v: M(A(v))) if M is not None else A
    dtype = b.dtype
    wdtype = (jnp.dtype(inner_dtype) if inner_dtype is not None
              else dtype)
    mixed = wdtype != dtype
    # eps thresholds guard the WORK-precision small matrices
    # (deflation pencil conditioning, block renormalization).
    eps = float(jnp.finfo(wdtype).eps)
    shape = b.shape
    baxes = tuple(range(1, b.ndim + 1))

    def bdot(block, v):
        """(s,) block inner products — ONE fused all-reduce
        (row_contract, ops/blas.py)."""
        return row_contract(block, v)

    def bmatdot(block_a, block_b):
        """(s, t) cross-Gram of two long blocks."""
        return jnp.tensordot(block_a, block_b, axes=(baxes, baxes))

    def comb(coefs, block):
        return row_combine(coefs, block)

    def vnorm(v):
        return jnp.sqrt(jnp.sum(v * v))

    rhs = M(b) if M is not None else b
    beta0 = vnorm(rhs)
    beta0s = jnp.where(beta0 > 0, beta0, 1.0)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = rhs - op(x) if x0 is not None else rhs

    if deflation not in ("eig", "subspace"):
        raise ValueError(f"unknown deflation {deflation!r}")

    def _deflation_coefs(mat, nvec):
        """(dim, nvec) REAL combination matrix spanning the
        smallest-|theta| harmonic-Ritz space, by the configured
        extraction route (see the deflation arg)."""
        if deflation == "subspace":
            return smallest_invariant_subspace(mat, nvec)
        vals, vecs, okc = eig_select(mat, nvec, which="smallest")
        return _realify(vals, vecs, nvec, eps).astype(wdtype), okc

    def renormalize(u_block, au_block):
        """(U, op·U) → (U', C) with op·U' = C orthonormal."""
        c, rmat = _orthonormalize_block(au_block, eps)
        # rmat is the (dense, SVQB-derived — NOT triangular) block
        # reconstruction factor; invert via the pivoted-elimination
        # solve_small: jnp.linalg.inv lowers to LuDecomposition, which
        # some backends implement only for F32/C64.
        t = solve_small(rmat, jnp.eye(rmat.shape[0], dtype=rmat.dtype))
        u_new = row_combine(t, u_block)
        good = jnp.all(jnp.isfinite(u_new)) & jnp.all(jnp.isfinite(c))
        return (
            jnp.where(good, u_new, jnp.zeros_like(u_new)),
            jnp.where(good, c, jnp.zeros_like(c)),
        )

    # ------------------------------------------------------------------
    # Deflated Arnoldi cycle over (I − C·Cᵀ)·op with coupling B.
    # ------------------------------------------------------------------
    def arnoldi_cycle(r, u_blk, c_blk):
        r = r.astype(wdtype)
        beta = vnorm(r)
        bsafe = jnp.where(beta > 0, beta, 1.0)
        basis = jnp.zeros((m + 1,) + shape, wdtype)
        basis = basis.at[0].set(r / bsafe)
        hraw = jnp.zeros((m + 1, m), wdtype)
        hrot = jnp.zeros((m + 1, m), wdtype)
        bmat = jnp.zeros((k, m), wdtype)
        g0 = jnp.zeros((m + 1,), wdtype).at[0].set(beta)
        giv = givens_init(m, g0, beta0=beta0s.astype(wdtype))

        def cond(st):
            (t, *_), rel = st
            return (t < m) & (rel >= tol)

        def body(st):
            (t, basis, hraw, hrot, bmat, giv), _ = st
            v_t = jax.lax.dynamic_index_in_dim(basis, t, 0,
                                               keepdims=False)
            w = op(v_t)
            bcol = bdot(c_blk, w)
            w = w - comb(bcol, c_blk)
            mask = (jnp.arange(m + 1) <= t).astype(wdtype)

            def cgs_pass(w):
                h = bdot(basis, w) * mask
                w = w - comb(h, basis)
                # second C-deflation folded into the pass (cheap, and
                # keeps range(C)⊥ exact under roundoff)
                b2 = bdot(c_blk, w)
                return h, b2, w - comb(b2, c_blk)

            h1, b1, w = cgs_pass(w)
            h2, b2, w = cgs_pass(w)
            bcol = bcol + b1 + b2
            hval = vnorm(w)
            hcol = (h1 + h2).at[t + 1].add(hval)
            giv, col, g_next = givens_step(giv, hcol, t)
            hraw = jax.lax.dynamic_update_slice(
                hraw, hcol[:, None], (jnp.zeros((), t.dtype), t)
            )
            hrot = jax.lax.dynamic_update_slice(
                hrot, col[:, None], (jnp.zeros((), t.dtype), t)
            )
            bmat = jax.lax.dynamic_update_slice(
                bmat, bcol[:, None], (jnp.zeros((), t.dtype), t)
            )
            basis = basis.at[t + 1].set(
                w / jnp.where(hval > 0, hval, 1.0)
            )
            rel = jnp.abs(g_next) / beta0s.astype(wdtype)
            return ((t + 1, basis, hraw, hrot, bmat, giv), rel)

        st0 = ((jnp.int32(0), basis, hraw, hrot, bmat, giv),
               jnp.asarray(jnp.inf, wdtype))
        (t, basis, hraw, hrot, bmat, giv), rel = jax.lax.while_loop(
            cond, body, st0
        )
        y = masked_back_substitution(hrot, giv.g, t)
        resid_coefs = g0 - hraw @ y
        return basis, hraw, bmat, y, resid_coefs, t, rel

    # ------------------------------------------------------------------
    # Harmonic Ritz update of the recycle pair from the combined pencil.
    # ------------------------------------------------------------------
    def update_recycle(u_blk, c_blk, basis, hraw, bmat):
        km = k + m
        gmat = jnp.zeros((km + 1, km), wdtype)
        gmat = gmat.at[:k, :k].set(jnp.eye(k, dtype=wdtype))
        gmat = gmat.at[:k, k:].set(bmat)
        gmat = gmat.at[k:, k:].set(hraw)
        cu = bmatdot(c_blk, u_blk)           # (k, k)
        vu = bmatdot(basis, u_blk)           # (m+1, k)
        fmat = jnp.zeros((km + 1, km), wdtype)
        fmat = fmat.at[:k, :k].set(cu)
        fmat = fmat.at[k:, :k].set(vu)
        fmat = fmat.at[k:, k:].set(
            jnp.eye(m + 1, m, dtype=wdtype)
        )
        m1 = gmat.T @ gmat
        m2 = gmat.T @ fmat
        pencil = solve_small(m2, m1)  # pure-jnp LU (ops/tri.py)
        z, okc = _deflation_coefs(pencil, k)  # (km, k)
        z = z.astype(wdtype)
        u_new = row_combine(
            z, jnp.concatenate([u_blk, basis[:m]], axis=0)
        )
        au_new = row_combine(
            gmat @ z, jnp.concatenate([c_blk, basis], axis=0)
        )
        u_new, c_new = renormalize(u_new, au_new)
        good = (
            okc
            & jnp.all(jnp.isfinite(z))
            & jnp.any(jnp.abs(u_new) > 0)
        )
        u_out = jnp.where(good, u_new, u_blk)
        c_out = jnp.where(good, c_new, c_blk)
        return u_out, c_out

    def seed_from_hessenberg(basis, hraw):
        """Harmonic Ritz of the PLAIN Hessenberg seeds (U, C) — the
        GMRES-DR last-column formula (gmres_dr.py:223), used at
        bootstrap and whenever the carried recycle pair is still the
        zero block (a zero import means "no recycle yet"; see below).
        Matvec-free: A·(V z) = V_{m+1}·(H̄ z)."""
        hm = hraw[:m, :m]
        em = jnp.zeros((m,), wdtype).at[m - 1].set(1.0)
        f = solve_small(hm.T, em)  # pure-jnp LU (ops/tri.py)
        cmat = hm.at[:, m - 1].add(hraw[m, m - 1] ** 2 * f)
        z, okc = _deflation_coefs(cmat, k)  # (m, k)
        z = z.astype(wdtype)
        u_new = row_combine(z, basis[:m])
        au_new = row_combine(hraw @ z, basis)
        u_blk, c_blk = renormalize(u_new, au_new)
        u_blk = jnp.where(okc, u_blk, jnp.zeros_like(u_blk))
        c_blk = jnp.where(okc, c_blk, jnp.zeros_like(c_blk))
        return u_blk, c_blk

    # ------------------------------------------------------------------
    # Bootstrap / import of the recycle pair.
    # ------------------------------------------------------------------
    rdtype = dtype
    history = jnp.zeros((max_restarts,), rdtype)
    if recycle is not None:
        if recycle.shape != (k,) + shape:
            raise ValueError(
                f"recycle must be (k, *shape) = {(k,) + shape}, got "
                f"{recycle.shape}"
            )
        rec_w = recycle.astype(wdtype)
        au = jax.vmap(op)(rec_w)  # the one import cost: k matvecs
        u_blk, c_blk = renormalize(rec_w, au)
        cyc0 = jnp.int32(0)
        rel0 = vnorm(r) / beta0s
    else:
        # Bootstrap: one plain m-step GMRES cycle (the recycle slots
        # enter as zero blocks — all projections are no-ops); harmonic
        # Ritz of the plain Hessenberg seeds U (gmres_dr.py:223's
        # last-column formula) — matvec-free via A·(V y) = V_{m+1}·(H̄ y).
        u0 = jnp.zeros((k,) + shape, wdtype)
        c0 = jnp.zeros((k,) + shape, wdtype)
        basis, hraw, _, y, resid_coefs, t, rel0 = arnoldi_cycle(
            r, u0, c0
        )
        x = x + comb(y, basis[:m])
        if mixed:
            # IR boundary: true preconditioned residual in the
            # caller's precision decides convergence, not the
            # work-precision estimate.
            r = rhs - op(x)
            rel0 = vnorm(r) / beta0s
        else:
            r = comb(resid_coefs, basis)
        u_blk, c_blk = seed_from_hessenberg(basis, hraw)
        history = history.at[0].set(rel0)
        cyc0 = jnp.int32(1)

    status0 = jnp.where(
        rel0 < tol,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )

    # ------------------------------------------------------------------
    # Main recycled cycles.
    # ------------------------------------------------------------------
    def cond(carry):
        (cyc, *_), status, _ = carry
        return (cyc < max_restarts) & (
            status == SolverStatus.MAX_ITERATIONS
        )

    def body(carry):
        (cyc, x, r, u_blk, c_blk, n_out), status, hist = carry
        d = bdot(c_blk, r.astype(wdtype))
        x = x + comb(d, u_blk)
        r = r - comb(d, c_blk)
        basis, hraw, bmat, y, resid_coefs, t, rel = arnoldi_cycle(
            r, u_blk, c_blk
        )
        yu = -(bmat @ y)
        x = x + comb(y, basis[:m]) + comb(yu, u_blk)
        if mixed:
            # IR boundary: recompute the true preconditioned residual
            # in the caller's precision (one extra op application per
            # m-step cycle) — convergence is decided on THIS, never
            # on the work-precision Givens estimate.
            r = rhs - op(x)
            rel = vnorm(r) / beta0s
        else:
            r = comb(resid_coefs, basis)
        # With a live recycle pair, update via the combined pencil.
        # When (U, C) is still the zero block — a zero-block import,
        # or a failed import/update — the combined pencil is singular
        # (cu = 0 zeroes m2's first k columns), so update_recycle
        # would keep the zero pair FOREVER; seed from the plain
        # Hessenberg instead, exactly as the bootstrap does. This
        # makes a zero block a valid "no recycle yet" carry for
        # while_loop callers (solvers/newton_krylov.py).
        u2, c2 = update_recycle(u_blk, c_blk, basis, hraw, bmat)
        us, cs = seed_from_hessenberg(basis, hraw)
        live = jnp.any(jnp.abs(c_blk) > 0)
        u_blk = jnp.where(live, u2, us)
        c_blk = jnp.where(live, c2, cs)
        hist = hist.at[cyc].set(rel)
        status = jnp.where(
            rel < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & ~jnp.isfinite(rel),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return ((cyc + 1, x, r, u_blk, c_blk, t), status, hist)

    carry0 = (
        (cyc0, x, r, u_blk, c_blk, jnp.int32(0)),
        status0,
        history,
    )
    (cyc, x, r, u_blk, c_blk, n_out), status, history = (
        jax.lax.while_loop(cond, body, carry0)
    )

    # Exit certification on the true (preconditioned) residual.
    r_true = rhs - op(x)
    rel_true = vnorm(r_true) / beta0s
    status = jnp.where(
        (status == SolverStatus.CONVERGED) & (rel_true >= tol),
        jnp.int32(SolverStatus.BREAKDOWN),
        status,
    )
    history = jnp.where(
        jnp.arange(max_restarts) < cyc, history, rel_true
    )
    return RecycledResult(
        x=x,
        iterations=n_out,
        restarts=cyc,
        residual=rel_true,
        status=status,
        residual_history=history,
        recycle=u_blk.astype(dtype),
    )
