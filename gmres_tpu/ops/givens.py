"""Incremental Givens-rotation QR of the Hessenberg matrix.

The reference applies the stored rotation sequence cs/sn to each new
Hessenberg column with a sequential loop (gmres_hh.f90:68-84,
gmres_mgsr.f90:52-67), then generates one new rotation via ``hypot`` and
rotates the rhs ``g``. A sequential O(j) scalar loop is poison inside a
device ``while_loop``, so here the *accumulated* rotation product is kept
as a small dense orthogonal matrix Ω (m+1, m+1): applying all previous
rotations to a new column is one replicated (m+1)² matvec (fully
vectorized, identical rotations → identical values up to summation
order), and the Ω/g updates per step touch just two rows/elements.
This small-matrix work runs redundantly on every chip — it is O(m²)
per iteration with no communication, exactly the reference's
``!$omp single`` sections mapped to replicated compute (SURVEY §2 C14).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GivensState(NamedTuple):
    """Carries the rotation product and rotated rhs through Arnoldi.

    omega: (m+1, m+1) product G_{t-1}···G_0 of all rotations so far.
    g: (m+1,) rotated rhs; |g[t+1]| is the running residual norm
       (gmres_hh.f90:85: final_err(j) = abs(g(j+1))/beta0).
    beta0: the ‖b‖ normalizer for relative residuals (gmres_hh.f90:237).
    """

    omega: jnp.ndarray
    g: jnp.ndarray
    beta0: jnp.ndarray


def givens_init(m: int, g0: jnp.ndarray, beta0=None) -> GivensState:
    """Fresh state for a restart cycle; g0 is the initial (m+1,) rhs."""
    if beta0 is None:
        beta0 = jnp.ones((), dtype=g0.dtype)
    return GivensState(
        omega=jnp.eye(m + 1, dtype=g0.dtype), g=g0,
        beta0=jnp.asarray(beta0, dtype=g0.dtype),
    )


def givens_step(state: GivensState, hcol: jnp.ndarray, t) -> tuple[
    GivensState, jnp.ndarray, jnp.ndarray
]:
    """Process Hessenberg column t (0-based).

    hcol: (m+1,) raw column (entries beyond t+1 must be zero).
    Returns (new_state, rotated_column, residual_component) where
    rotated_column is upper-triangular (zeros below t) and
    residual_component = g[t+1] after the new rotation.
    """
    omega, g, beta0 = state
    hrot = omega @ hcol  # apply all previous rotations at once

    ct = hrot[t]
    ct1 = hrot[t + 1]
    # hypot(|H(j+1,j)|, |H(j,j)|), gmres_hh.f90:74 — abs() makes the
    # same formula serve complex Hessenbergs (the reference is
    # real-only); for real inputs hypot takes magnitudes anyway.
    ds = jnp.hypot(jnp.abs(ct1), jnp.abs(ct))
    safe = jnp.where(ds > 0, ds, 1.0)
    # Complex Givens G = [[c, s], [-conj(s), conj(c)]] with
    # c = conj(ct)/ρ, s = conj(ct1)/ρ: unitary, zeroes the
    # subdiagonal, and reduces EXACTLY to the reference's real
    # rotation when conj is the identity.
    cs = jnp.where(ds > 0, jnp.conj(ct) / safe, jnp.ones_like(ct))
    sn = jnp.where(ds > 0, jnp.conj(ct1) / safe, jnp.zeros_like(ct1))

    col = hrot.at[t].set(cs * ct + sn * ct1).at[t + 1].set(0.0)

    # Ω ← G_t Ω : rotate rows t and t+1 of Ω.
    row_t = jax.lax.dynamic_slice_in_dim(omega, t, 1, axis=0)[0]
    row_t1 = jax.lax.dynamic_slice_in_dim(omega, t + 1, 1, axis=0)[0]
    new_t = cs * row_t + sn * row_t1
    new_t1 = -jnp.conj(sn) * row_t + jnp.conj(cs) * row_t1
    omega = jax.lax.dynamic_update_slice_in_dim(omega, new_t[None], t, axis=0)
    omega = jax.lax.dynamic_update_slice_in_dim(
        omega, new_t1[None], t + 1, axis=0
    )

    # Rotate the rhs (gmres_hh.f90:79-83).
    gt = g[t]
    gt1 = g[t + 1]
    g = g.at[t].set(cs * gt + sn * gt1).at[t + 1].set(
        -jnp.conj(sn) * gt + jnp.conj(cs) * gt1
    )

    return GivensState(omega=omega, g=g, beta0=beta0), col, g[t + 1]
