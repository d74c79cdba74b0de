"""Communication-avoiding (s-step) preconditioned CG.

Standard PCG pays 2 all-reduce points per iteration ((r,z) and
(p,Ap) — cg.f90:118-123 fuses them into one OpenMP region, our
solvers/cg.py into one stacked psum); on a latency-bound mesh the
solve is bounded by those reduction points, not FLOPs. The s-step reformulation (Chronopoulos–Gear 1989; Carson–
Demmel–Hoemmen CA-KSM form) runs s CG iterations per SINGLE stacked
all-reduce:

  1. generate two monomial chains with B = M∘A and ZERO communication:
       W_p = [p, Bp, …, Bˢp]           (s+1 columns)
       W_z = [z, Bz, …, Bˢ⁻¹z]         (s columns),
     keeping the A-images U = A·[chains] — they are free intermediates
     of each B application (B w = M(A w));
  2. ONE all-reduce: the Gram of the stacked block S = [r₀, V, U]
     (V = [W_p, W_z], so G carries every inner product s steps can
     ask for: (r_j, z_j) = r₀ᵀVẑ − x̂ᵀUᵀVẑ, (p_j, A p_j) = p̂ᵀVᵀUp̂,
     and the per-step residual estimate ‖r_j‖² = r₀ᵀr₀ − 2x̂ᵀUᵀr₀
     + x̂ᵀUᵀUx̂ — all closed under the basis-shift matrix T with
     B·Vĉ = V·Tĉ);
  3. run the s α/β/x̂/ẑ/p̂ recurrences on REPLICATED (2s+1)-vectors
     (a lax.scan of tiny matmuls — no long vectors touched);
  4. reconstruct x locally, recompute the TRUE residual and z = M r
     (the certification reduction), carry p = V p̂_s across the cycle
     boundary (exact-arithmetic equivalence to unrestarted CG), loop.

Exact-arithmetic equivalence: each cycle reproduces s steps of
solvers/cg.py's recurrence bit-for-bit in exact arithmetic (pinned to
~1e-12 in f64 by tests/test_sstep_cg.py). In floating point the
monomial chains square the basis conditioning, κ(G) ≈ κ(chain)² —
the intended pairing is a spectrum-clustering preconditioner (the MG
cycles: κ(B) = O(1) makes the monomial basis benign for s ≤ ~8); the
Gram is diagonally equilibrated (removes the ρ(B)^i column growth
without per-column norm reductions) and a failed/indefinite pivot
exits BREAKDOWN honestly. Convergence is certified ONLY on the
recomputed true residual at cycle boundaries — a sloppy basis can
slow convergence but never produce a false CONVERGED (the library-wide
certification contract, PARITY quirk 8).

Cost, stated honestly: ~2s operator and ~2s−1 preconditioner
applications per s iterations (the two chains) + the certification
pair — DOUBLE the matvec count of standard PCG. Communication per s
iterations: 1 stacked Gram all-reduce + 1 certification reduction,
vs 2s reduction points — the trade wins exactly when latency, not
bandwidth, bounds the solve (the same regime as sstep_gmres and
pipelined CG; see docs/DESIGN.md §4).

No reference counterpart (the reference has no communication-avoiding
machinery; its CG is cg.f90:88-140).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import tree_vdot
from gmres_tpu.types import (
    LinearOperator,
    Preconditioner,
    SolveResult,
    SolverStatus,
)


def sstep_cg(
    A,
    b: jnp.ndarray,
    *,
    s: int = 4,
    tol: float = 1e-9,
    max_cycles: int = 2500,
    M: Optional[Preconditioner] = None,
    x0: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Solve A x = b (A SPD) by s-step PCG (see module docstring).

    Args:
      A: SPD linear operator callable (or dense matrix).
      b: right-hand side (any shape; treated as a vector).
      s: inner steps per communication cycle. Keep ≤ ~8; with a
        clustering preconditioner (MG) s = 4 loses nothing.
      tol: ABSOLUTE ‖r‖₂ target (cg.f90:37 semantics, matching
        solvers/cg.py); certified on the recomputed true residual.
      max_cycles: outer cycle cap (≥ ceil(max_iterations / s)).
      M: SPD left preconditioner callable.
      x0: initial guess (zeros default).
    """
    op = A if callable(A) else (lambda v, m=jnp.asarray(A): m @ v)
    prec = M if M is not None else (lambda v: v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    dtype = b.dtype
    shape = b.shape
    nb = 2 * s + 1  # basis columns: s+1 p-chain + s z-chain

    # Basis-shift matrix T: coordinates of B·(V ĉ) for ĉ supported on
    # shiftable columns (p-degree < s, z-degree < s−1) — exactly the
    # supports the recurrences produce.
    t_np = jnp.zeros((nb, nb), dtype=dtype)
    for i in range(s):
        t_np = t_np.at[i + 1, i].set(1.0)          # B·(Bⁱp) = Bⁱ⁺¹p
    for i in range(s - 1):
        t_np = t_np.at[s + 1 + i + 1, s + 1 + i].set(1.0)
    t_mat = t_np

    def cycle(x, r, z, p):
        # --- chains (zero communication) -------------------------------
        # B w = M(A w): the A-image of every chain column is the free
        # intermediate of generating the NEXT column, so U costs nothing
        # beyond the chains themselves.
        def gen(carry, _):
            w = carry
            aw = op(w)
            bw = prec(aw)
            return bw, (w, aw)

        bp_last, (pv, pu) = jax.lax.scan(gen, p, None, length=s)
        bz_last, (zv, zu) = jax.lax.scan(gen, z, None, length=s)
        del bz_last  # Bˢz itself is never used
        # V columns: [p, Bp, …, Bˢ⁻¹p, Bˢp | z, Bz, …, Bˢ⁻¹z]
        # (scan records the carry INPUT, so pv = [p..Bˢ⁻¹p] and the
        # final carry is Bˢp; zv = [z..Bˢ⁻¹z]). U holds the aligned
        # A-images: pu[i] = A·Bⁱp for i ≤ s−1; the Bˢp slot is zero
        # because no coordinate vector U ever multiplies carries
        # p-degree s (p̂_j, x̂_j degrees stay ≤ j ≤ s−1); zu[i] = A·Bⁱz.
        zero = jnp.zeros_like(p)[None]
        v_cols = jnp.concatenate([pv, bp_last[None], zv], axis=0)
        u_cols = jnp.concatenate([pu, zero, zu], axis=0)

        vf = v_cols.reshape(nb, -1)
        uf = u_cols.reshape(nb, -1)
        rf = r.reshape(1, -1)
        stacked = jnp.concatenate([rf, vf, uf], axis=0)
        # --- ONE all-reduce: the (2nb+1)² Gram --------------------------
        # HIGHEST: an f32 dot may otherwise run in TF32 on the GPU,
        # and the Gram feeds every scalar the cycle computes.
        g = jnp.matmul(stacked, stacked.T,
                       precision=jax.lax.Precision.HIGHEST)
        g_rr = g[0, 0]
        g_rv = g[1: 1 + nb, 0]
        g_ru = g[1 + nb:, 0]
        g_vu = g[1: 1 + nb, 1 + nb:]
        g_uu = g[1 + nb:, 1 + nb:]
        # Do NOT symmetrize g_vu: U's Bˢp slot is deliberately zero
        # (its image is never needed because every coordinate vector
        # that multiplies U stays at p-degree ≤ s−1), so VᵀU has a
        # zero COLUMN there but a nonzero mirror ROW — averaging the
        # two leaks 0.5·(A·v)ᵀBˢp into coordinates that DO reach
        # p-degree s on the V side (ẑ at cycle end) and breaks the
        # recurrence (measured: cycle 2 diverges from CG).

        # --- s replicated scalar steps ---------------------------------
        e_p = jnp.zeros((nb,), dtype).at[0].set(1.0)
        e_z = jnp.zeros((nb,), dtype).at[s + 1].set(1.0)

        def inner(carry, _):
            xh, zh, ph, ok = carry
            # r_j = r₀ − U x̂_j, so (r_j, z_j) = (r_j, V ẑ_j) =
            # g_rv·ẑ − x̂ᵀ(UᵀV)ẑ with UᵀV = g_vuᵀ.
            rz = (g_rv @ zh) - xh @ (g_vu.T @ zh)
            pap = ph @ (g_vu @ ph)
            bad = (pap <= 0) | ~jnp.isfinite(pap) | ~jnp.isfinite(rz)
            alpha = jnp.where(bad, 0.0, rz / jnp.where(pap == 0, 1.0,
                                                       pap))
            xh2 = xh + alpha * ph
            zh2 = zh - alpha * (t_mat @ ph)
            rz2 = (g_rv @ zh2) - xh2 @ (g_vu.T @ zh2)
            beta = jnp.where(
                (rz == 0) | bad, 0.0, rz2 / jnp.where(rz == 0, 1.0, rz)
            )
            ph2 = zh2 + beta * ph
            # per-step residual estimate (free, from the same Gram)
            res_sq = g_rr - 2.0 * (xh2 @ g_ru) + xh2 @ (g_uu @ xh2)
            return (xh2, zh2, ph2, ok & ~bad), jnp.sqrt(
                jnp.maximum(res_sq, 0.0)
            )

        (xh, zh, ph, ok), ests = jax.lax.scan(
            inner, (jnp.zeros((nb,), dtype), e_z, e_p,
                    jnp.array(True)), None, length=s,
        )
        # --- local reconstruction --------------------------------------
        x_new = x + jnp.tensordot(xh, v_cols, axes=(0, 0)).reshape(
            shape)
        p_new = jnp.tensordot(ph, v_cols, axes=(0, 0)).reshape(shape)
        return x_new, p_new, ok, ests

    r0 = b - op(x0)
    res0 = jnp.sqrt(tree_vdot(r0, r0))
    z0_ = prec(r0)
    converged0 = res0 < tol
    hist0 = jnp.full((max_cycles,), res0, dtype)

    def cond(carry):
        k, *_, status, _ = carry
        return (k < max_cycles) & (
            status == SolverStatus.MAX_ITERATIONS
        )

    def body(carry):
        k, x, r, z, p, status, hist = carry
        x_new, p_new, ok, _ = cycle(x, r, z, p)
        # certification pair (the cycle's one extra A and M)
        r_new = b - op(x_new)
        res = jnp.sqrt(tree_vdot(r_new, r_new))
        z_new = prec(r_new)
        hist = hist.at[k].set(res)
        status = jnp.where(
            res < tol, jnp.int32(SolverStatus.CONVERGED), status
        )
        status = jnp.where(
            (status == SolverStatus.MAX_ITERATIONS)
            & ((~ok) | ~jnp.isfinite(res)),
            jnp.int32(SolverStatus.BREAKDOWN),
            status,
        )
        return (k + 1, x_new, r_new, z_new, p_new, status, hist)

    status0 = jnp.where(
        converged0,
        jnp.int32(SolverStatus.CONVERGED),
        jnp.int32(SolverStatus.MAX_ITERATIONS),
    )
    k, x, r, z, p, status, hist = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), x0, r0, z0_, z0_, status0, hist0),
    )
    res = jnp.sqrt(tree_vdot(r, r))
    hist = jnp.where(jnp.arange(max_cycles) < k, hist, res)
    return SolveResult(
        x=x,
        iterations=k * s,
        residual=res,
        status=status,
        residual_history=hist,
    )
