"""Explicit halo-exchange distributed stencil operator (shard_map).

The reference's hand-split interior / edge / corner OpenMP loops
(poisson.f90:38-76) are the serial shadow of this decomposition: the
(N, N) grid is row-partitioned over the mesh, each device owns a
(rows_local, N) block, and the 5-point stencil needs exactly one row
from each neighbor per application.

Two routes exist for the same math:

* The pure-jnp operator (``gmres_tpu.models.poisson``) relies on GSPMD:
  under a sharded input the roll-based shifts lower to collective
  permutes automatically. Zero code, compiler-chosen schedule.
* This module does it **explicitly** with ``jax.shard_map``: the two
  one-row ``ppermute`` sends are issued first, the interior rows (which
  need no remote data) are computed while the halos are in flight, and
  only the first/last row correction waits on the transfers — the
  communication/compute overlap XLA's latency-hiding scheduler is free
  to exploit because the data dependence is expressed at row
  granularity. On GPUs XLA hands the ``ppermute`` to NCCL.

Boundary semantics: ``ppermute`` leaves zeros on devices that receive
no message, which IS the homogeneous-Dirichlet truncation of the
reference (poisson.f90:47-67) — physical boundaries need no special
case.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gmres_tpu.parallel.mesh import GRID_AXIS
from gmres_tpu.precond.chebyshev import (
    chebyshev_preconditioner,
    chebyshev_ref_scalars,
)

LAPLACE_COEFS = (4.0, -1.0, -1.0, -1.0, -1.0)


def halo_exchange(
    blk: jnp.ndarray, axis: str = GRID_AXIS
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exchange one-row halos along a 1-D mesh axis.

    Returns (top, bottom), each (1, ncols): ``top`` is the neighbor row
    above this shard (zeros on shard 0), ``bottom`` the row below
    (zeros on the last shard). Two sends of one row each.
    """
    n = jax.lax.axis_size(axis)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    top = jax.lax.ppermute(blk[-1:, :], axis, down)
    bottom = jax.lax.ppermute(blk[:1, :], axis, up)
    return top, bottom


def _local_stencil_overlapped(blk, top, bottom, coefs):
    """Interior-first stencil on a local block: rows 1..r−2 use only
    local data (computable while halos are in flight); the first and
    last rows are corrected with the received halo rows afterwards."""
    c0, cw, ce, cs, cn = coefs
    rows = blk.shape[0]
    left = jnp.pad(blk[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(blk[:, 1:], ((0, 0), (0, 1)))
    up_local = jnp.pad(blk[:-1, :], ((1, 0), (0, 0)))  # row i−1, 0 at top
    down_local = jnp.pad(blk[1:, :], ((0, 1), (0, 0)))  # row i+1, 0 at bot
    y = c0 * blk + cw * left + ce * right + cs * up_local + cn * down_local
    # Halo corrections touch only the boundary rows — these adds are the
    # only ops data-dependent on the ppermute results.
    y = y.at[0, :].add(cs * top[0])
    y = y.at[rows - 1, :].add(cn * bottom[0])
    return y


def halo_stencil_operator(
    mesh: Mesh,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
) -> Callable:
    """Matrix-free 5-point stencil over a row-partitioned (N, N) grid
    with explicit ppermute halo exchange.

    The returned callable has the standard LinearOperator contract and
    composes with every solver — the solvers never know the operator is
    distributed (interfaces.f90:12-18 inversion of control).
    """
    spec = P(axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=spec, out_specs=spec,
    )
    def apply(blk):
        top, bottom = halo_exchange(blk, axis)
        return _local_stencil_overlapped(blk, top, bottom, coefs)

    return apply


def halo_poisson_operator(mesh: Mesh) -> Callable:
    """Distributed Laplacian (poisson.f90:33-77 semantics)."""
    return halo_stencil_operator(mesh, LAPLACE_COEFS)


def halo_chebyshev_preconditioner(
    mesh: Mesh,
    lam_min: float,
    lam_max: float,
    coefs=LAPLACE_COEFS,
    axis: str = GRID_AXIS,
    order: int = 2,
) -> Callable:
    """Distributed Chebyshev preconditioner over the halo operator.

    order=2 (default) is fused: one halo exchange + ONE pass producing
    z = r/d + α(r − A(r)/d) — the three loops of cbpr2
    (chebyshev.f90:27-37) collapsed by linearity, A(r/d) = A(r)/d.
    order>2 composes the general semi-iteration over the halo stencil
    operator (one halo exchange per sweep — the unavoidable
    communication of a deep polynomial across shards).
    """
    if order != 2:
        a_halo = halo_stencil_operator(mesh, coefs, axis=axis)
        return chebyshev_preconditioner(
            a_halo, lam_min, lam_max, order=order, reference_form=False
        )

    d, alpha = chebyshev_ref_scalars(lam_min, lam_max)
    spec = P(axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=spec, out_specs=spec,
    )
    def m_inv(r_blk):
        top, bottom = halo_exchange(r_blk, axis)
        ar = _local_stencil_overlapped(r_blk, top, bottom, coefs)
        return r_blk / d + alpha * (r_blk - ar / d)

    return m_inv
