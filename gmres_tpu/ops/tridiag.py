"""Batched tridiagonal solves by parallel cyclic reduction (PCR).

Line relaxation — the smoother anisotropic problems require
(precond/multigrid.py:anisotropic_multigrid_preconditioner) — needs
MANY independent tridiagonal solves, one per grid line. The textbook
Thomas algorithm is a strictly sequential O(n) recurrence that
serializes the vector units inside a fused cycle. PCR
(Hockney–Golub) instead eliminates odd/even couplings in
⌈log₂ n⌉ steps of PURELY ELEMENTWISE arithmetic over the whole
batch — each step is 9 multiplies + shifts on (batch, n) arrays, so
the entire line sweep is log-depth vector work with no gathers, no
scans, and no per-line control flow. O(n log n) flops versus Thomas'
O(n) is the right trade here: flops are free relative to the
serialization (the same argument as DESIGN.md §1's bandwidth cost
model).

Shifts are jnp.roll + mask (out-of-range neighbors
contribute zero — the identity row they'd couple to), so the op works
on any backend and shards trivially over the BATCH axes: lines along
the last axis are device-local when the mesh shards leading axes,
which is how the line smoother stays collective-free.

Stability: PCR performs no pivoting — intended for the diagonally
dominant systems line relaxation produces (diag = 2ε + 2 vs
off-diagonals −1). Verified against dense solves to 1e-12 in
tests/test_tridiag.py, including non-power-of-two n.
"""

from __future__ import annotations

import jax.numpy as jnp


def tridiag_solve_pcr(
    dl: jnp.ndarray,
    dd: jnp.ndarray,
    du: jnp.ndarray,
    rhs: jnp.ndarray,
) -> jnp.ndarray:
    """Solve T x = rhs along the LAST axis for a batch of tridiagonal
    systems.

    Args:
      dl: sub-diagonal, same shape as rhs (dl[..., 0] ignored).
      dd: main diagonal.
      du: super-diagonal (du[..., -1] ignored).
      rhs: right-hand sides, (..., n).

    Returns:
      x with rhs's shape. All arithmetic is elementwise over the full
      batch; ⌈log₂ n⌉ reduction steps.
    """
    n = rhs.shape[-1]
    i = jnp.arange(n)
    a = jnp.where(i > 0, dl, 0.0)
    b = dd
    c = jnp.where(i < n - 1, du, 0.0)
    d = rhs

    s = 1
    while s < n:
        # Neighbors s away; rows outside the system act as identity
        # rows (a=c=0 there after masking), contributing nothing.
        b_m = jnp.roll(b, s, axis=-1)
        c_m = jnp.roll(c, s, axis=-1)
        d_m = jnp.roll(d, s, axis=-1)
        a_m = jnp.roll(a, s, axis=-1)
        b_p = jnp.roll(b, -s, axis=-1)
        a_p = jnp.roll(a, -s, axis=-1)
        d_p = jnp.roll(d, -s, axis=-1)
        c_p = jnp.roll(c, -s, axis=-1)
        has_m = i >= s
        has_p = i < n - s
        alpha = jnp.where(has_m, -a / b_m, 0.0)
        gamma = jnp.where(has_p, -c / b_p, 0.0)
        a = alpha * jnp.where(has_m, a_m, 0.0)
        c = gamma * jnp.where(has_p, c_p, 0.0)
        b = b + alpha * jnp.where(has_m, c_m, 0.0) \
            + gamma * jnp.where(has_p, a_p, 0.0)
        d = d + alpha * jnp.where(has_m, d_m, 0.0) \
            + gamma * jnp.where(has_p, d_p, 0.0)
        s *= 2
    return d / b
