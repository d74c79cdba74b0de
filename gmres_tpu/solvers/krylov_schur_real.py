"""Krylov-Schur on a REAL Schur basis — the route for sharp
nonsymmetric eigenpairs on runtimes without a complex datapath.

Why this exists: `arnoldi_eigs` (solvers/arnoldi.py) runs the whole
thick-restarted Krylov-Schur in ONE jit on a COMPLEX basis — the right
design where complex compiles. A runtime without a complex datapath
compiles none of it, and the earlier stopgap — `subspace_eigs`, real block iteration — is
estimation-grade on CLUSTERED spectra (its linear rate cannot split
eigenvalues 0.2% apart; 17-50% errors were recorded on
convection-dominated convdiff). Stewart's ORIGINAL
Krylov-Schur (SIMAX 2001) needs no complex arithmetic at all: the
REAL Schur form keeps conjugate pairs as 2×2 diagonal blocks, and the
restart algebra (truncate to the leading k Schur directions + the
residual direction) is identical. So:

  device jit #1 (`arnoldi_expand`): real CGS2 Arnoldi expansion of the
    fixed (m+1, *shape) basis buffer from column `start` — all the
    O(n) work, sharding-transparent (one fused all-reduce per pass).
  host (numpy/scipy, between dispatches): REAL sorted Schur of the
    (m, m) Rayleigh block S = Z T Zᵀ (LAPACK gees with a top-k
    selector; k grows by one when it would split a 2×2 block), Ritz
    residual estimates |s_row·y_i| from T's small eigenvectors. The
    matrix is m×m — replicated small-matrix work, the same division
    of labor as `subspace_eigs` (host math lives between jits, one
    host round trip per restart).
  device jit #2: basis compression V ← V·Z[:, :k] (`row_combine`, one
    pass over the basis) with the residual vector moved to row k.

The eigenvalues/eigenvectors are COMPLEX results assembled host-side;
eigenvectors and certified residuals ‖A x − λ x‖ are computed on
device in SPLIT real/imaginary form (two real operator applications
per pair — A never sees a complex input), mirroring `subspace_eigs`.

No reference counterpart (the reference has no eigensolver; README's
"Lanczos estimation" claim is vapor — SURVEY C10). Algorithm source:
Stewart 2001, "A Krylov–Schur Algorithm for Large Eigenproblems".
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.ops.blas import row_combine
from gmres_tpu.solvers.lanczos import arnoldi_expand
from gmres_tpu.types import EigResult, SolverStatus

_WHICH_KEYS = ("LM", "SM", "LR", "SR")


def _key(vals: np.ndarray, which: str) -> np.ndarray:
    """Descending sort key: larger = more wanted."""
    return {
        "LM": lambda v: np.abs(v),
        "SM": lambda v: -np.abs(v),
        "LR": lambda v: v.real,
        "SR": lambda v: -v.real,
    }[which](vals)


def _sorted_real_schur(s: np.ndarray, k: int, which: str):
    """Real Schur S = Z T Zᵀ with (at least) the top-k wanted
    eigenvalues in the leading block. Returns (t, z, k_eff) with
    k_eff ≤ m−2 never splitting a 2×2 block; raises LinAlgError only
    when every selection attempt fails (caller maps it to BREAKDOWN).

    Robustness: LAPACK gees re-checks the sort predicate against the
    eigenvalues RECOMPUTED after reordering, which shift by
    O(eps·‖S‖) — a sharp threshold on a clustered spectrum then
    raises "Leading eigenvalues do not satisfy sort condition"
    (observed on the convection-dominated convdiff Rayleigh blocks).
    The ladder below retries with growing margins: selecting a few
    EXTRA eigenvalues is harmless (the restart just keeps a slightly
    larger subspace), so the margin only ever loosens the cut."""
    import scipy.linalg as sla

    m = s.shape[0]
    lam = np.linalg.eigvals(s)
    key = np.sort(_key(lam, which))[::-1]
    scale = float(np.max(np.abs(lam))) or 1.0
    for kk in range(k, 0, -1):
        # Threshold at the kk-th key; exact ties (conjugate pairs
        # share |λ|) select the whole tie group — exactly the "don't
        # split a pair" adjustment.
        thresh = key[kk - 1]
        for margin in (0.0, 1e-12 * scale, 1e-9 * scale,
                       1e-6 * scale):
            try:
                t, z, sdim = sla.schur(
                    s, output="real",
                    sort=lambda ar, ai: _key(ar + 1j * ai, which)
                    >= thresh - margin,
                )
            except np.linalg.LinAlgError:
                continue
            if kk <= sdim <= m - 2:
                return t, z, int(sdim)
    raise np.linalg.LinAlgError(
        "no selection threshold produced a valid leading block"
    )


def arnoldi_eigs_real(
    A: Callable,
    probe: jnp.ndarray,
    *,
    nev: int = 6,
    steps: int = 40,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 100,
    thick: int | None = None,
) -> EigResult:
    """nev eigenpairs of a REAL (possibly nonsymmetric) operator by
    Krylov-Schur with a real Schur basis — same contract as
    `arnoldi_eigs` (complex eigenvalues/eigenvectors, most-wanted
    first, certified residuals), but NO complex arithmetic ever
    reaches the device, so it runs on complex-free runtimes.

    Unlike `arnoldi_eigs` (one dispatch per solve) this pays 2 device
    dispatches per restart cycle plus tiny host Schur solves,
    amortized by the Krylov rate
    (typically ≤ tens of cycles where subspace iteration needs
    hundreds and still cannot separate clustered moduli).
    """
    if which not in _WHICH_KEYS:
        raise ValueError(f"which must be one of {_WHICH_KEYS}")
    m = steps
    if not 0 < nev <= m - 2:
        raise ValueError(f"need 0 < nev <= steps - 2, got {nev}, {m}")
    k0 = thick if thick is not None else min(max(nev + 1, 2 * nev),
                                             m - 2)
    if not nev <= k0 <= m - 2:
        raise ValueError(f"need nev <= thick <= steps - 2, got {k0}")
    if jnp.issubdtype(probe.dtype, jnp.complexfloating):
        raise ValueError(
            "arnoldi_eigs_real is the REAL-operator route; use "
            "arnoldi_eigs (complex basis) on complex-capable backends"
        )
    shape = probe.shape
    rdtype = probe.dtype

    expand = jax.jit(partial(arnoldi_expand, A))

    @jax.jit
    def compress(basis, zk):
        """V ← [V_m·Z[:, :k]; v_m at row k; zeros] — one basis pass.
        zk is (m, k); k is static per compile (it varies by at most a
        couple of values across restarts, so the jit cache holds a
        handful of tiny variants)."""
        k = zk.shape[1]
        head = row_combine(zk, basis[:m])  # (k, *shape)
        new_basis = jnp.zeros_like(basis)
        new_basis = jax.lax.dynamic_update_slice(
            new_basis, head, (0,) + (0,) * probe.ndim
        )
        return new_basis.at[k].set(basis[m])

    @jax.jit
    def device_eigvecs(basis, wr, wi, lr, li):
        """Ritz vectors x = V_m (Z y) and certified residuals in SPLIT
        form: wr + i·wi are the (m, nev) coefficient columns."""
        xr = row_combine(wr, basis[:m])  # (nev, *shape)
        xi = row_combine(wi, basis[:m])
        axr = jax.vmap(A)(xr)
        axi = jax.vmap(A)(xi)
        axes = tuple(range(1, probe.ndim + 1))
        rr = axr - (lr.reshape((-1,) + (1,) * probe.ndim) * xr
                    - li.reshape((-1,) + (1,) * probe.ndim) * xi)
        ri = axi - (lr.reshape((-1,) + (1,) * probe.ndim) * xi
                    + li.reshape((-1,) + (1,) * probe.ndim) * xr)
        res = jnp.sqrt(jnp.sum(rr * rr + ri * ri, axis=axes))
        return xr, xi, res

    nrm = float(jnp.sqrt(jnp.sum(probe.astype(rdtype) ** 2)))
    basis = jnp.zeros((m + 1,) + shape, dtype=rdtype)
    basis = basis.at[0].set(probe.astype(rdtype) / (nrm if nrm > 0
                                                    else 1.0))
    hmat_np = np.zeros((m + 1, m), dtype=np.dtype(rdtype))
    start = 0
    status = SolverStatus.MAX_ITERATIONS
    t_np = z_np = s_row = None
    cycles = 0
    for cycles in range(1, max_restarts + 1):
        basis, hmat = expand(basis, jnp.asarray(hmat_np), start)
        hmat_np = np.asarray(hmat)
        s_m = hmat_np[:m, :m]
        if not np.all(np.isfinite(s_m)):
            status = SolverStatus.BREAKDOWN
            break
        try:
            t_np, z_np, k = _sorted_real_schur(s_m, k0, which)
        except Exception:
            status = SolverStatus.BREAKDOWN
            break
        s_row = hmat_np[m, :m] @ z_np
        # Ritz residual estimates for the nev most-wanted pairs:
        # |s_row · y_i| with y_i T's unit eigenvectors.
        lam, y = np.linalg.eig(t_np)
        order = np.argsort(-_key(lam, which))
        rest = np.abs(s_row @ y[:, order[:nev]])
        if np.all(rest < tol):
            status = SolverStatus.CONVERGED
            break
        if cycles == max_restarts:
            break
        basis = compress(
            basis, jnp.asarray(np.ascontiguousarray(z_np[:, :k]))
        )
        hmat_np = np.zeros((m + 1, m), dtype=np.dtype(rdtype))
        hmat_np[:k, :k] = t_np[:k, :k]
        hmat_np[k, :k] = s_row[:k]
        start = int(k)

    if t_np is None:  # first expansion already broke down
        nan = np.full((nev,), np.nan)
        return EigResult(
            eigenvalues=nan.astype(complex),
            x=np.full((nev,) + shape, np.nan, dtype=complex),
            iterations=jnp.int32(cycles),
            residuals=jnp.full((nev,), jnp.nan, dtype=rdtype),
            status=jnp.int32(SolverStatus.BREAKDOWN),
        )

    # Recover the nev most-wanted pairs from the LAST full frame:
    # x_i = V_m (Z y_i), λ_i from T's spectrum (host, tiny).
    lam, y = np.linalg.eig(t_np)
    order = np.argsort(-_key(lam, which))[:nev]
    lam = lam[order]
    zy = z_np @ y[:, order]  # (m, nev) complex
    zy = zy / np.linalg.norm(zy, axis=0, keepdims=True)
    wr = jnp.asarray(np.ascontiguousarray(zy.real), dtype=rdtype)
    wi = jnp.asarray(np.ascontiguousarray(zy.imag), dtype=rdtype)
    lr = jnp.asarray(lam.real, dtype=rdtype)
    li = jnp.asarray(lam.imag, dtype=rdtype)
    xr, xi, res = device_eigvecs(basis, wr, wi, lr, li)
    # Normalize exactly (zy columns are unit only up to the basis's
    # orthonormality): x/‖x‖ on the host, complex.
    x = np.asarray(xr) + 1j * np.asarray(xi)
    xn = np.sqrt(np.sum(np.abs(x) ** 2,
                        axis=tuple(range(1, x.ndim)), keepdims=True))
    x = x / np.where(xn > 0, xn, 1.0)
    res = jnp.asarray(np.asarray(res)
                      / np.where(xn.reshape(-1) > 0,
                                 xn.reshape(-1), 1.0), dtype=rdtype)

    if status == SolverStatus.CONVERGED and not bool(
        np.all(np.asarray(res) < tol)
    ):
        # The estimate said converged but certification disagrees —
        # report what the true residuals support.
        status = SolverStatus.MAX_ITERATIONS
    # Complex results stay HOST numpy (this runtime cannot device_put
    # complex arrays; they are final outputs) — same contract as
    # subspace_eigs.
    return EigResult(
        eigenvalues=lam,
        x=x.reshape((nev,) + shape),
        iterations=jnp.int32(cycles),
        residuals=res,
        status=jnp.int32(status),
    )
