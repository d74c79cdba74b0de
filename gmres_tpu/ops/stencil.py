"""5-point stencil kernels.

Implementations:

* ``stencil_5pt_general`` / ``stencil_5pt_apply`` — pure jnp shifted-pad
  formulation. XLA fuses the shifted adds into a single HBM pass; under
  sharded inputs the row shifts lower to collective-permute halo
  exchanges automatically.
* ``stencil_5pt_halo`` — jnp local stencil taking explicit one-row halos
  (used by the shard_map path in ``gmres_tpu.parallel.halo``).

One sweep must read x and write y once; XLA:GPU's loop fusion does
exactly that, so there is no hand-written single-sweep kernel. Several
sweeps fuse in ``ops/smoother.py``.

Reference: ``src/problems/poisson.f90:33-77`` (stvec) — its interior /
edge / corner OpenMP loop split is the serial shadow of this halo
decomposition. Generalized coefficients (center, west, east, south,
north) also serve the convection-diffusion operator
(models/convection_diffusion.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(x: jnp.ndarray, dr: int, dc: int) -> jnp.ndarray:
    """x shifted by (dr, dc) with zero fill (Dirichlet truncation).

    Implemented as roll + boundary mask rather than pad + slice: roll
    keeps the array shape, so under a sharded input it lowers to a
    collective-permute of the boundary rows (the halo exchange), while
    pad would change the sharded dimension size (unsupported)."""

    def roll_mask(y, shift, axis):
        if shift == 0:
            return y
        y = jnp.roll(y, shift, axis=axis)
        idx = jax.lax.broadcasted_iota(jnp.int32, y.shape, axis)
        if shift > 0:
            return jnp.where(idx >= shift, y, 0)
        return jnp.where(idx < y.shape[axis] + shift, y, 0)

    return roll_mask(roll_mask(x, dr, 0), dc, 1)


def stencil_5pt_general(
    x: jnp.ndarray,
    center: float,
    west: float,
    east: float,
    south: float,
    north: float,
) -> jnp.ndarray:
    """y(i,j) = center·x(i,j) + west·x(i,j−1) + east·x(i,j+1)
    + south·x(i−1,j) + north·x(i+1,j), zero outside the grid."""
    return (
        center * x
        + west * _shift(x, 0, 1)
        + east * _shift(x, 0, -1)
        + south * _shift(x, 1, 0)
        + north * _shift(x, -1, 0)
    )


def stencil_5pt_apply(x: jnp.ndarray) -> jnp.ndarray:
    """Laplacian special case: y = 4x − (W+E+S+N) (poisson.f90:38-76)."""
    return stencil_5pt_general(x, 4.0, -1.0, -1.0, -1.0, -1.0)


def _shift3(x: jnp.ndarray, d0: int, axis: int) -> jnp.ndarray:
    """Single-axis shift with zero fill (3-D analogue of _shift's
    roll+mask — same reason: roll keeps the sharded dimension size, so
    a sharded axis lowers to a collective-permute halo exchange)."""
    if d0 == 0:
        return x
    y = jnp.roll(x, d0, axis=axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, y.shape, axis)
    if d0 > 0:
        return jnp.where(idx >= d0, y, 0)
    return jnp.where(idx < y.shape[axis] + d0, y, 0)


def stencil_7pt_general(x: jnp.ndarray, center: float,
                        off: float = -1.0) -> jnp.ndarray:
    """3-D 7-point stencil y = center·x + off·(sum of 6 face
    neighbors), zero outside the grid. No reference counterpart (the
    reference is 2-D only, src/problems/poisson.f90); exists because
    every solver here is shape-agnostic — a 3-D operator is just
    another pytree vector."""
    s = (
        _shift3(x, 1, 0) + _shift3(x, -1, 0)
        + _shift3(x, 1, 1) + _shift3(x, -1, 1)
        + _shift3(x, 1, 2) + _shift3(x, -1, 2)
    )
    return center * x + off * s


def stencil_7pt_apply(x: jnp.ndarray) -> jnp.ndarray:
    """3-D Laplacian special case: y = 6x − Σ face neighbors."""
    return stencil_7pt_general(x, 6.0)


def stencil_5pt_halo(
    x: jnp.ndarray,
    top: jnp.ndarray,
    bottom: jnp.ndarray,
    coefs=(4.0, -1.0, -1.0, -1.0, -1.0),
) -> jnp.ndarray:
    """Local stencil over a (rows, N) block with explicit halo rows.

    ``top`` is the row above the block (x(i−1) for the first block row),
    ``bottom`` the row below; pass zeros at the physical boundary.
    Used by the distributed row-partitioned operator
    (parallel/halo.py) — the reference's interior/edge split
    (poisson.f90:38-67) done across devices instead of loops.
    """
    c0, cw, ce, cs, cn = coefs
    ext = jnp.concatenate([top[None, :], x, bottom[None, :]], axis=0)
    mid = ext[1:-1, :]
    up = ext[:-2, :]
    down = ext[2:, :]
    left = jnp.pad(mid[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(mid[:, 1:], ((0, 0), (0, 1)))
    return c0 * mid + cw * left + ce * right + cs * up + cn * down
