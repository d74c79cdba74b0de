"""Compact-WY representation of a Householder reflector product.

The reference applies j reflectors to a vector with a *sequential*
dot/axpy sweep — 2j dot products (→ 2j all-reduces when distributed)
per Arnoldi step (gmres_hh.f90:453-485). That is the core performance
problem of Householder GMRES on a mesh (SURVEY §3.1).

The answer here: keep the accumulated product in compact-WY form

    Q_k = (I − 2p₁p₁ᵀ)···(I − 2p_kp_kᵀ) = I − Pᵀ T P

with P (m+1, n) holding reflector rows and T (m+1, m+1) upper
triangular (LAPACK's blocked-Householder representation). Then

    Q v  = v − Pᵀ (T  (P v))     — two (m+1)×n matmuls and ONE
    Qᵀ v = v − Pᵀ (Tᵀ (P v))       all-reduce of an (m+1,) vector,

independent of j. Zero rows of P and zero rows/cols of T make the
representation valid at every prefix without masking. T grows by one
column per reflector:

    T_{k} = [[T_{k-1}, −2·T_{k-1}(P_{k-1}·p_k)], [0, 2]].

In exact arithmetic this equals the reference's sweep; in floating
point it is the standard backward-stable blocked form.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import row_combine, row_contract


def _contract(p: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(m+1, *shape) × (*shape) → (m+1,): P v (one all-reduce,
    ops/blas.py `row_contract`)."""
    return row_contract(p, v)


def _expand(t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """(m+1,) × (m+1, *shape) → (*shape): Pᵀ t (local)."""
    return row_combine(t, p)


def wy_apply(p: jnp.ndarray, t: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Q v = v − Pᵀ(T(P v))."""
    return v - _expand(t @ _contract(p, v), p)


def wy_apply_transpose(
    p: jnp.ndarray, t: jnp.ndarray, v: jnp.ndarray
) -> jnp.ndarray:
    """Qᵀ v = v − Pᵀ(Tᵀ(P v))."""
    return v - _expand(t.T @ _contract(p, v), p)


def wy_basis_vector(p: jnp.ndarray, t: jnp.ndarray, idx) -> jnp.ndarray:
    """Q e_idx — the Arnoldi basis vector at flat index idx.

    Formulated as the one-hot application Q e = e − Pᵀ(T (P e)): the
    contraction P e is mathematically just column idx of P, but
    READING that column directly forces either a flatten-then-slice
    relayout of the basis or an N-D `dynamic_slice` with runtime
    starts; the masked contraction streams P once at full bandwidth
    instead (neither form has been timed on the GPU). The
    reference reads the same column implicitly through its reflector
    sweep (gmres_hh.f90:453-467)."""
    from gmres_tpu.ops.flat import flat_iota

    idx = jnp.asarray(idx)
    e = (flat_iota(p[0]) == idx).astype(p.dtype)
    return e - _expand(t @ _contract(p, e), p)


def wy_append(
    p: jnp.ndarray, t: jnp.ndarray, p_new: jnp.ndarray, k
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Append reflector p_new as row k (traced index) of P; update T.

    Must be called with P still holding zeros at row k (the update term
    uses only rows < k, which zero rows guarantee automatically).
    """
    k = jnp.asarray(k)
    zero = jnp.zeros((), dtype=k.dtype)
    tcol = -2.0 * (t @ _contract(p, p_new))  # −2·T(P·p_new), (m+1,)
    t = jax.lax.dynamic_update_slice(t, tcol[:, None], (zero, k))
    t = t.at[k, k].set(2.0)
    p = jax.lax.dynamic_update_slice(
        p, p_new[None], (k,) + (zero,) * p_new.ndim
    )
    return p, t


def wy_basis(p: jnp.ndarray, t: jnp.ndarray, m: int) -> jnp.ndarray:
    """Explicit orthonormal basis V (m, n_flat): V[i] = Q e_i.

    Used only by the orthogonality audit (calculate_verr,
    gmres_hh.f90:568-593). Valid because reflector p_j has zero
    components at flat indices < j, so Q_k e_i = Q_i e_i for k ≥ i.
    """
    pf = p.reshape(p.shape[0], -1)  # (m+1, n)
    pe = pf[:, :m]  # P e_i for i < m, (m+1, m)
    return jnp.eye(m, pf.shape[1], dtype=p.dtype) - (t @ pe).T @ pf
