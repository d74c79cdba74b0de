"""Variable-coefficient diffusion: −∇·(c(x)∇u) on the unit square.

Beyond the reference (constant-coefficient stencils only,
test_poisson_mf.f90): heterogeneous media — layered geology,
composite materials, bubbly flow — are the production diffusion
problems. The finite-volume discretization with HARMONIC-mean face
coefficients (the flux-continuous choice; arithmetic means
overestimate coupling across material jumps) gives the h²-scaled
5-point form

    (A u)ᵢⱼ = Σ_faces c_face (uᵢⱼ − u_nbr),   c_face = 2 c₁c₂/(c₁+c₂)

which reduces to ``poisson_operator``'s stencil at c ≡ 1 (pinned to
roundoff in tests/test_varcoef.py; summation order differs). Dirichlet boundaries: the ghost
coefficient is the cell's own c (harm(c, c) = c), matching the unit
stencil's boundary row.

Device shape: the operator is four shifted multiplies over materialized
face-coefficient arrays — same memory traffic class as the constant
stencil (5 reads, 1 write vs 2/1; XLA fuses the axpys), shards by
grid rows like every other stencil here, and the coefficient arrays
ride the closure as jit constants.

The multigrid cycle rediscretizes each level from 2×2 cell-averaged
coefficients (restrict_sum(c)/4) — the standard rediscretization
coarse grid. Honest caveat recorded from measurement: for SMOOTH or
moderate-contrast c the cycle is grid-independent like the Poisson
one, but extreme-contrast inclusions (≥1e4) degrade rediscretized
coarse grids (the arithmetic cell average smears interfaces) — that
regime is what `coarse_space_preconditioner`'s indicator deflation is
for (precond/deflation.py), stacked on this cycle or on Jacobi.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

from gmres_tpu.precond.multigrid import prolong_repeat, restrict_sum


def varcoef_faces(
    c: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Harmonic-mean face couplings (cn, cs, cw, ce) from (n, n) cell
    coefficients; each (n, n), coupling cell (i, j) to its
    north/south/west/east neighbor (Dirichlet ghost = own c)."""

    def harm(a, b):
        return 2.0 * a * b / (a + b)

    cpx = jnp.pad(c, ((1, 1), (0, 0)), mode="edge")
    cpy = jnp.pad(c, ((0, 0), (1, 1)), mode="edge")
    cn = harm(cpx[:-2, :], c)
    cs = harm(cpx[2:, :], c)
    cw = harm(cpy[:, :-2], c)
    ce = harm(cpy[:, 2:], c)
    return cn, cs, cw, ce


def varcoef_apply(c: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """One application of the variable-coefficient 5-point operator."""
    cn, cs, cw, ce = varcoef_faces(c)
    xp = jnp.pad(x, 1)
    return (cn * (x - xp[:-2, 1:-1]) + cs * (x - xp[2:, 1:-1])
            + cw * (x - xp[1:-1, :-2]) + ce * (x - xp[1:-1, 2:]))


def varcoef_operator(c: jnp.ndarray) -> Callable:
    """Matrix-free operator closure; face coefficients precomputed
    once (they'd otherwise be re-derived per matvec — 4 pads + 4
    divides the Krylov loop doesn't need)."""
    cn, cs, cw, ce = varcoef_faces(c)

    def apply(x: jnp.ndarray) -> jnp.ndarray:
        xp = jnp.pad(x, 1)
        return (cn * (x - xp[:-2, 1:-1]) + cs * (x - xp[2:, 1:-1])
                + cw * (x - xp[1:-1, :-2]) + ce * (x - xp[1:-1, 2:]))

    return apply


def varcoef_diagonal(c: jnp.ndarray) -> jnp.ndarray:
    """The operator's diagonal cn+cs+cw+ce — the Jacobi scaling
    (= 4 at c ≡ 1)."""
    cn, cs, cw, ce = varcoef_faces(c)
    return cn + cs + cw + ce


def varcoef_matrix(c, dtype=jnp.float64) -> jnp.ndarray:
    """Dense assembly (C-order flattening) for small-n oracles —
    symmetric by face construction (ce[i,j] = cw[i,j+1], both the
    harmonic mean of the same cell pair)."""
    import numpy as np

    cn, cs, cw, ce = (np.asarray(f, dtype=np.float64)
                      for f in varcoef_faces(c))
    n = cn.shape[0]
    N = n * n
    a = np.zeros((N, N))
    d = (cn + cs + cw + ce).ravel()
    a[np.arange(N), np.arange(N)] = d
    idx = np.arange(N).reshape(n, n)
    a[idx[1:, :].ravel(), idx[:-1, :].ravel()] = -cn[1:, :].ravel()
    a[idx[:-1, :].ravel(), idx[1:, :].ravel()] = -cs[:-1, :].ravel()
    a[idx[:, 1:].ravel(), idx[:, :-1].ravel()] = -cw[:, 1:].ravel()
    a[idx[:, :-1].ravel(), idx[:, 1:].ravel()] = -ce[:, :-1].ravel()
    return jnp.asarray(a, dtype=dtype)


def varcoef_multigrid_preconditioner(
    c: jnp.ndarray,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    omega: float = 0.8,
    coarse_iters: int = 64,
    min_size: int = 16,
    max_levels: int | None = None,
) -> Callable:
    """V-cycle preconditioner with per-level rediscretized
    coefficients (2×2 cell averages) and pointwise damped-Jacobi
    smoothing e ← e + ω D⁻¹ (r − A e) — D the SPATIALLY VARYING
    diagonal, so the smoother adapts to local stiffness with zero
    reductions; the whole cycle stays collective-free like the
    Poisson one (precond/multigrid.py:61).

    SPD by construction at every level (harmonic faces of positive
    averaged c), hence a legal CG preconditioner."""
    levels_c = [jnp.asarray(c)]
    n = c.shape[0]
    while n % 2 == 0 and n > min_size and (
        max_levels is None or len(levels_c) < max_levels
    ):
        levels_c.append(restrict_sum(levels_c[-1]) / 4.0)
        n //= 2
    faces = [varcoef_faces(cl) for cl in levels_c]
    diags = [f[0] + f[1] + f[2] + f[3] for f in faces]
    n_levels = len(levels_c)

    def apply_l(x, l):
        cn, cs, cw, ce = faces[l]
        xp = jnp.pad(x, 1)
        return (cn * (x - xp[:-2, 1:-1]) + cs * (x - xp[2:, 1:-1])
                + cw * (x - xp[1:-1, :-2]) + ce * (x - xp[1:-1, 2:]))

    def smooth(r, l, iters):
        e = jnp.zeros_like(r)
        winv = omega / diags[l]
        for _ in range(iters):
            e = e + winv * (r - apply_l(e, l))
        return e

    def v_cycle(r, l):
        if l == n_levels - 1:
            return smooth(r, l, coarse_iters)
        e = smooth(r, l, pre_smooth)
        resid = r - apply_l(e, l)
        e = e + prolong_repeat(v_cycle(restrict_sum(resid), l + 1))
        resid = r - apply_l(e, l)
        return e + smooth(resid, l, post_smooth)

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(r, 0)

    return m_inv
