"""Krylov-Schur eigensolver (Stewart 2001) for NONSYMMETRIC operators.

Completes the library's eigensolver pair: LOBPCG (solvers/lobpcg.py)
covers SPD/Hermitian pencils; this covers the general case — complex
eigenpairs of convection-diffusion-like operators (the reference README
claims eigenvalue estimation it never implemented, README.md:11 /
SURVEY C10; the build extends the answer from bound estimation
(solvers/lanczos.py) through Ritz values (arnoldi_hessenberg) to actual
certified eigenpairs).

Why Krylov-Schur and not explicit restarts: single-vector restarting
(Ritz-sum or exact-shift polynomial filters) provably stalls on
clustered nonnormal spectra — measured here at ~1e-3 residuals on a
16² convection-diffusion operator where ARPACK reaches 1e-14. Thick
restarting keeps the whole wanted INVARIANT SUBSPACE across restarts:

  cycle:  A·V_m = V_m·S + v_{m+1}·sᵀ          (Arnoldi-like relation)
          S = Z T Zᴴ  (Hessenberg-reduce + Schur + reorder so the
                        `which`-wanted eigenvalues lead)
          truncate: keep W_k = V_m·Z[:, :k] plus v_{m+1}; the new
          Rayleigh block is [[T_k], [s̃ᵀ]] (triangular + spike row);
          expand back to m columns with plain Arnoldi steps.

Everything runs IN-JIT with fixed shapes: the CGS2 expansion
(`arnoldi_expand`, solvers/lanczos.py — one fused all-reduce per
orthogonalization pass under sharding), the Hessenberg reduction and
shifted-QR Schur iteration with accumulated Q, the bubble-network
eigenvalue reordering, and the triangular eigenvector back-solves
(`ops/hessenberg_eig.py`) — JAX's `eig`/`schur` are CPU-only
callbacks, so this is the library's replicated small-matrix machinery
doing the LAPACK work on device; one dispatch per solve.

Real operators run on a complex basis via linearity (A(re) + i·A(im) —
A never sees a complex input), 2 real stencil applications per complex
matvec. Exit residuals are CERTIFIED by applying A to each returned
eigenvector (PARITY.md quirk-8 discipline extended to eigenpairs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gmres_tpu.ops.hessenberg_eig import (
    hessenberg_reduce,
    hessenberg_schur,
    schur_eigvec,
    schur_sort,
)
from gmres_tpu.solvers.lanczos import arnoldi_expand
from gmres_tpu.types import EigResult, LinearOperator, SolverStatus

_WHICH_KEYS = ("LM", "SM", "LR", "SR")


def _sort_key(vals: jnp.ndarray, which: str) -> jnp.ndarray:
    return {
        "LM": lambda v: -jnp.abs(v),
        "SM": lambda v: jnp.abs(v),
        "LR": lambda v: -v.real,
        "SR": lambda v: v.real,
    }[which](vals)


def arnoldi_eigs(
    A: LinearOperator,
    probe: jnp.ndarray,
    *,
    nev: int = 6,
    steps: int = 40,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 100,
    thick: int | None = None,
) -> EigResult:
    """nev eigenpairs of a (possibly nonsymmetric) operator by
    Krylov-Schur restarted Arnoldi.

    Args:
      A: linear operator (real or complex). Real operators are applied
        to the real and imaginary parts separately (A never sees a
        complex input).
      probe: start vector (shape defines the problem; nonzero).
      nev: eigenpairs wanted (static).
      steps: Krylov subspace dimension m per cycle (ARPACK's ncv);
        must satisfy nev + 2 ≤ steps.
      which: "LM" | "SM" | "LR" | "SR" (modulus/real-part extremes).
        Un-preconditioned Arnoldi targets EXTERIOR eigenvalues; for
        interior/smallest-modulus targets pass a shift-inverted
        operator (a solver closure) with which="LM".
      tol: absolute per-pair residual ‖A x − λ x‖₂ (x unit norm) —
        the same convention as LOBPCG's `residuals`.
      max_restarts: restart-cycle cap.
      thick: restart subspace size k (wanted Schur vectors kept per
        restart). Default min(max(nev + 1, 2·nev), steps − 2) — the
        standard Krylov-Schur heuristic.

    Returns an EigResult with COMPLEX `eigenvalues` (nev,) sorted by
    the `which` criterion (most-wanted first), complex unit
    eigenvectors `x` (nev, *shape), and CERTIFIED `residuals`.
    `iterations` counts restart cycles.
    """
    if which not in _WHICH_KEYS:
        raise ValueError(f"which must be one of {_WHICH_KEYS}")
    m = steps
    if not 0 < nev <= m - 2:
        raise ValueError(f"need 0 < nev <= steps - 2, got {nev}, {m}")
    k = thick if thick is not None else min(max(nev + 1, 2 * nev),
                                            m - 2)
    if not nev <= k <= m - 2:
        raise ValueError(f"need nev <= thick <= steps - 2, got {k}")

    dtype = probe.dtype
    is_complex = jnp.issubdtype(dtype, jnp.complexfloating)
    rdtype = jnp.finfo(dtype).dtype
    cdtype = dtype if is_complex else (
        jnp.complex64 if rdtype == jnp.dtype(jnp.float32)
        else jnp.complex128
    )
    shape = probe.shape
    axes_v = tuple(range(1, probe.ndim + 1))

    def a_c(v):
        if is_complex:
            return A(v)
        return A(v.real) + 1j * A(v.imag)

    def _unit(v):
        n = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2))
        return v / jnp.where(n > 0, n, 1.0)

    def analyze(basis, smat):
        """Reduce the (m, m) Rayleigh block to sorted Schur form and
        return (t, z, s_row, rest): S = Z T Zᴴ with wanted eigenvalues
        leading, s_row the residual coupling (A V Z = V Z T + v_{m+1}
        s_row with s_rowᵀ meaning the row vector smat[m, :] Z), and
        rest the top-nev Ritz residual estimates |s_row · y_i|."""
        s_m = smat[:m, :m]
        h, p = hessenberg_reduce(s_m)
        t, q, ok = hessenberg_schur(h)
        key = _sort_key(jnp.diagonal(t), which).real.astype(
            jnp.finfo(cdtype).dtype
        )
        t, q = schur_sort(t, q, key)
        z = p @ q  # S = Z T Zᴴ
        s_row = smat[m, :m] @ z  # residual coupling in the new frame
        ys = jax.vmap(lambda i: schur_eigvec(t, i))(jnp.arange(nev))
        rest = jnp.abs(ys @ s_row)
        return t, z, s_row, rest, ok

    def truncate(basis, smat, t, z, s_row):
        """Thick restart: keep the leading k Schur directions plus the
        residual direction; rebuild the (m+1, m) Rayleigh buffer with
        the triangular block and its spike row."""
        head = jnp.tensordot(z.T[:k], basis[:m], axes=(1, 0))  # (k,…)
        new_basis = jnp.zeros_like(basis)
        new_basis = jax.lax.dynamic_update_slice(
            new_basis, head, (0,) + (0,) * probe.ndim
        )
        new_basis = new_basis.at[k].set(basis[m])
        new_smat = jnp.zeros_like(smat)
        new_smat = new_smat.at[:k, :k].set(t[:k, :k])
        new_smat = new_smat.at[k, :k].set(s_row[:k])
        return new_basis, new_smat

    def cycle(basis, smat, start):
        basis, smat = arnoldi_expand(a_c, basis, smat, start)
        t, z, s_row, rest, ok = analyze(basis, smat)
        new_basis, new_smat = truncate(basis, smat, t, z, s_row)
        return (new_basis, new_smat), (basis, t, z), rest, ok

    basis0 = jnp.zeros((m + 1,) + shape, dtype=cdtype)
    basis0 = basis0.at[0].set(_unit(probe.astype(cdtype)))
    smat0 = jnp.zeros((m + 1, m), dtype=cdtype)
    (b_tr, s_tr), frame0, rest0, ok0 = cycle(basis0, smat0, 0)

    def cond(carry):
        i, _, _, rest, ok, _ = carry
        return (i < max_restarts) & jnp.any(rest >= tol) & ok

    def body(carry):
        i, b_tr, s_tr, _, _, _ = carry
        (b_new, s_new), frame, rest, ok = cycle(b_tr, s_tr, k)
        return (i + 1, b_new, s_new, rest, ok, frame)

    i, _, _, rest, ok, (basis_f, t_f, z_f) = jax.lax.while_loop(
        cond, body, (jnp.int32(1), b_tr, s_tr, rest0, ok0, frame0)
    )

    # Recover eigenpairs from the last full frame: x_i = V Z y_i with
    # y_i the triangular eigenvector of T for its i-th (wanted-sorted)
    # diagonal entry.
    ys = jax.vmap(lambda j: schur_eigvec(t_f, j))(jnp.arange(nev))
    zy = ys @ z_f.T  # (nev, m): rows are Z y_i
    x = jnp.tensordot(zy, basis_f[:m], axes=(1, 0))
    xn = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=axes_v))
    x = x / jnp.where(xn > 0, xn, 1.0).reshape(
        (-1,) + (1,) * probe.ndim
    )
    wanted = jnp.diagonal(t_f)[:nev]

    # Certification: true per-pair residuals.
    ax = jax.vmap(a_c)(x)
    lam_x = wanted.reshape((-1,) + (1,) * probe.ndim) * x
    resid = jnp.sqrt(
        jnp.sum(jnp.abs(ax - lam_x) ** 2, axis=axes_v)
    ).astype(rdtype)

    status = jnp.where(
        jnp.all(resid < tol),
        jnp.int32(SolverStatus.CONVERGED),
        jnp.where(
            ok,
            jnp.int32(SolverStatus.MAX_ITERATIONS),
            jnp.int32(SolverStatus.BREAKDOWN),
        ),
    )
    return EigResult(
        eigenvalues=wanted,
        x=x,
        iterations=i,
        residuals=resid,
        status=status,
    )
