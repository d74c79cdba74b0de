"""Masked triangular solve for the projected GMRES system.

The reference back-substitutes the leading k×k block of the rotated
Hessenberg by hand (gmres_hh.f90:93-98, gmres_mgsr.f90:75-80) with k
known at runtime. Under jit, k is a traced value, so instead the full
static (m, m) system is solved after masking: rows/cols ≥ k are replaced
by the identity with zero rhs, making the extra unknowns exactly zero
while the leading block is untouched. One ``solve_triangular`` on a
replicated small matrix — no communication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def masked_back_substitution(
    h: jnp.ndarray, g: jnp.ndarray, k
) -> jnp.ndarray:
    """Solve H[:k,:k] y = g[:k]; return (m,) y padded with zeros.

    h: (m+1, m) rotated (upper-triangular) Hessenberg storage.
    g: (m+1,) rotated rhs.
    k: number of valid columns (traced int).
    """
    m = h.shape[1]
    rows = jnp.arange(m)[:, None]
    cols = jnp.arange(m)[None, :]
    active = (rows < k) & (cols < k)
    hm = jnp.where(active, h[:m, :m], jnp.eye(m, dtype=h.dtype))
    gm = jnp.where(jnp.arange(m) < k, g[:m], 0.0)
    return jax.scipy.linalg.solve_triangular(hm, gm, lower=False)


def solve_small(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dense solve for small REPLICATED systems, in pure jnp.

    ``jnp.linalg.solve`` lowers to XLA's LuDecomposition, which some
    backends implement only for F32/C64, so the x64 solvers carrying a
    small dense solve (GCRO-DR's harmonic-Ritz pencil, GMRES-DR's Hᵀ
    solve, IDR(s)'s shadow system) use this instead:
    partially-pivoted Gaussian elimination (fori_loop + dynamic row
    ops + rank-1 updates) finished by a triangular solve: every op is elementwise/matmul, so it compiles
    for any dtype (f32/f64/c64/c128-on-CPU) on any backend. O(k³) on a
    replicated k ≲ 100 matrix — noise next to one stencil apply.

    Singular input: zero pivots are tracked and the result is
    NaN-poisoned (matching jnp.linalg.solve's inf/nan behavior rather
    than silently returning garbage).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    k = a.shape[0]
    bvec = b.ndim == 1
    bm = b[:, None] if bvec else b
    aug0 = jnp.concatenate([a, bm.astype(a.dtype)], axis=1)

    def elim(i, carry):
        aug, ok = carry
        col = jnp.abs(aug[:, i])
        col = jnp.where(jnp.arange(k) >= i, col, -jnp.inf)
        piv = jnp.argmax(col)
        ri, rp = aug[i], aug[piv]
        aug = aug.at[i].set(rp).at[piv].set(ri)
        pivval = aug[i, i]
        ok = ok & (jnp.abs(pivval) > 0)
        safe = jnp.where(jnp.abs(pivval) > 0, pivval,
                         jnp.ones_like(pivval))
        factors = jnp.where(
            jnp.arange(k) > i, aug[:, i] / safe, jnp.zeros((), a.dtype)
        )
        aug = aug - factors[:, None] * aug[i][None, :]
        return aug, ok

    aug, ok = jax.lax.fori_loop(0, k, elim, (aug0, jnp.array(True)))
    x = jax.scipy.linalg.solve_triangular(
        aug[:, :k], aug[:, k:], lower=False
    )
    x = jnp.where(ok, x, jnp.full_like(x, jnp.nan))
    return x[:, 0] if bvec else x
